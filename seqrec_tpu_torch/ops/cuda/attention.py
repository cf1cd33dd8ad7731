"""Causal self-attention forward kernels (`csrc/attention.cu`), joined to a
recompute backward by a `torch.autograd.Function`.

Replaces `seqrec_tpu/ops/pallas/attention.py::causal_attention` (the TPU
kernel `_attn_kernel`, launched at :98) and its custom VJP `_attn_core_bwd`.
Forward: a kernel, on the [B, T, N, Dh] layout as it comes (the slices of
the qkv projection need no copy) and any T: the ragged last tile is
zero-filled in shared memory, where the TPU wrapper pads T to its 128-row
tile in device memory. Any Dh: q, k and v are staged in the widest
unit of 16, 8, 4 or (bf16) 2 bytes that divides a head's row, their bases
and their strides (SASRec at d = 50 reads 100-byte bf16 rows, 300 bytes
apart, in 4-byte pieces), zero-padded in shared memory, never copied.
From Dh = 257 to 2,048 (one SASRec head of d = 512, the JAX package's
wide SASRec at `embed_dim=512`) both dtypes take the Dh-cluster layout
(`layout` "dh-cluster", counted again in `.cluster_launches`): one thread
block cluster of ceil(Dh / SLICE_COLS) CTAs a query tile, CTA z owning
columns [256 z, 256 z + 256) of Q, K, V and O; each CTA keeps its Q slice
resident, streams its K and V slices, computes its partial S over its own
columns and publishes it; every CTA sums all the cluster's partials, read
through distributed shared memory, in rank order, so all hold the same S,
m, l and P bits, and each accumulates O for its own slice. S is computed
once. Past 2,048 (more CTAs than a portable cluster holds) the Dh-sliced
layout (`layout` "dh-sliced", counted again in `.sliced_launches`): a third
grid axis over the output's columns in slices of SLICE_COLS; each CTA
computes the whole of S = Q K^T in chunks of SLICE_CHUNK columns of Q and K
staged through shared memory, keeps the online softmax's m and l, and
accumulates O for its own slice of V's columns. Every slice computes S in
the same order, so every slice gets the same m and l bits; there S is
recomputed once a slice.

Backward, as `_attn_core_bwd`: a recompute of the
materialized [T, T] attention in plain tensor code
(`reference.causal_attention`) and its autograd; a flash backward kernel is
ROADMAP.md Queue 2 speed work.

Two hand-written kernels, chosen by dtype (each computes the whole function
in its own numerics; neither gives way to the other):

- bf16 (`design` "mma.sync"): FlashAttention-2 on the tensor cores. Four
  warps of 16 query rows; Q K^T and P V as mma.sync.m16n8k16 (bf16 products,
  f32 sums), the softmax on the accumulator fragments in registers, P handed
  to P V in registers, K and V tiles double-buffered by cp.async. The head
  dim is zero-padded in shared memory to 16, 32, 64, 128 or 256 (mma's depth
  is 16); rows past T are zero-filled. What bounds it: bytes (q, k, v, o).
- f32 (`design` "flash-fma"): FlashAttention-2's structure with f32 FMAs
  on the CUDA cores (TF32 tensor cores would keep ~3 digits, not the f32
  products of the contract): 32-row query tiles (the grid fills the card at
  SASRec's shapes and the causal triangle wastes less), four warps of 8
  rows, key tiles of 32 double-buffered by cp.async, Q read as broadcasts,
  4-row register tiles a lane (4 rows x 2 keys of S, 4 rows x 4 columns of
  O a float4 group) and a per-warp key-major P tile. What bounds it: its
  operations (f32 FMAs fed from shared memory).

The cluster layout has a kernel of each dtype too: bf16 (`design` "wgmma")
one warpgroup on wgmma, Q, K and V by TMA; f32 (`design` "flash-fma") 16
warps of FMAs on TMA-fed tiles (launch_config).

The JAX package gates its Pallas kernel off by default (`supported`, a TPU
measurement); the port has no gates, so a CUDA tensor always takes a kernel.

Numerics, as the TPU kernel: scores in f32 from f32 sums of products, the
causal mask at -1e30, an online (max, sum) in f32 over the unrounded
probabilities, the probabilities rounded to v's dtype for the product with
v, an f32 accumulator and a divide at the end. The plain version (the JAX
oracle's formula) computes the scores in the input dtype, so in bf16 the two
differ by bf16 rounding of the scores.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import torch

from seqrec_tpu_torch.ops import _build
from seqrec_tpu_torch.ops import reference
from seqrec_tpu_torch.ops.cuda import unit_bytes

plain = reference.causal_attention

SMEM_LIMIT = 232_448  # shared memory one block may opt in to on sm_90 (227 KB)
TILE = 64  # kTile in csrc/attention.cu: the bf16 kernel's query rows a block, keys a tile
F32_TILE = 32  # kF32Rows: the f32 kernel's query rows a block, keys a tile
F32_LANE_ROWS = 4  # kLR: the f32 kernel's query rows a lane (4 warps a block)
MAX_HEAD_DIM = 256  # kMaxDh: the widest Dh of the designs above; past it the cluster layout
SLICE_COLS = 256  # kSliceCols: the columns a CTA of the cluster and sliced layouts owns
SLICE_CHUNK = 64  # kSlChunk: the columns of Q and K a stage of the sliced layout's ring
CLUSTER_MAX_SLICES = 8  # kClusterMaxSlices: the portable cluster size
CLUSTER_BAND_BYTES = 24 << 20  # K and V of a band of (b, n) pairs: about half of the 50 MB L2
MAX_CLUSTER_HEAD_DIM = CLUSTER_MAX_SLICES * SLICE_COLS  # kClusterMaxDh; past it the sliced layout
# The cluster layout's shared memory (kClSmem, kClF32Floats): two items' Q
# and the [2][K, V] ring in 32 KB tiles (bf16 64 rows, f32 32 rows of 256
# columns) and 1,024 bytes to align; bf16 two 16 KB slots; f32 four
# [32][36] quarter partials, two [32][32] slots, P [32][36] and two rows of
# 32.
CLUSTER_SMEM = {torch.bfloat16: 6 * 32_768 + 2 * 16_384 + 1_024,
                torch.float32: 6 * 32_768 + (4 * 32 * 36 + 2 * 32 * 32 + 32 * 36 + 64) * 4
                + 1_024}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LAYOUT_CODE = {None: 0, "dh-sliced": 1, "dh-cluster": 2}  # layout_of in csrc/attention.cu


def _lib() -> ctypes.CDLL:
    lib = _build.load("attention")
    fn = lib.seqrec_attention_forward
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_longlong] * 6 + [ctypes.c_float, ctypes.c_longlong, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.seqrec_attention_max_active_clusters.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.seqrec_attention_max_active_clusters.restype = ctypes.c_int
    lib.seqrec_attention_error_string.argtypes = [ctypes.c_int]
    lib.seqrec_attention_error_string.restype = ctypes.c_char_p
    return lib


def head_dim_padded(Dh: int) -> int:
    """The head dim the bf16 kernel pads Dh to in shared memory (kD in
    csrc/attention.cu): the least of 16, 32, 64, 128, 256 that holds it."""
    return next(d for d in (16, 32, 64, 128, 256) if d >= Dh)


def cluster_band(BN: int, n_tiles: int, clusters: int, pair_bytes: int) -> int:
    """The (b, n) pairs a band of the cluster layout's items: of every pair
    and of `clusters` // k pairs (k = 1, 2, ...), the band whose deal
    (cluster_item in csrc/attention.cu) gives the fewest key tiles to the
    busiest cluster, a band whose K and V (`pair_bytes` a pair) exceed
    CLUSTER_BAND_BYTES counted 5% dearer (it reads them from DRAM again);
    the smaller on a tie."""
    return _cluster_band(BN, n_tiles, clusters, max(1, CLUSTER_BAND_BYTES // pair_bytes))


@functools.lru_cache(maxsize=512)
def _cluster_band(BN: int, n_tiles: int, clusters: int, fits: int) -> int:
    items = BN * n_tiles

    def busiest(band: int) -> int:
        per = band * n_tiles
        tiles = [0] * clusters
        for w in range(items):
            j, p = divmod(w, clusters)
            c = clusters - 1 - p if j % 2 else p
            bi, r = divmod(w, per)
            tiles[c] += n_tiles - r // min(band, BN - bi * band)
        return max(tiles)

    bands = sorted({BN} | {min(BN, max(1, clusters // k)) for k in range(1, clusters + 1)})
    return min(bands, key=lambda b: (busiest(b) * (1.0 if b <= fits else 1.05), b))


def launch_config(B: int, T: int, N: int, Dh: int, dtype: torch.dtype,
                  align: int = 16, clusters_at_once: int = 0) -> Dict:
    """Design, grid, block, staging unit and shared memory of one launch;
    ValueError only for an empty shape, another dtype or operands off their
    element size.
    `align`: what the operands' bases and batch and time strides (in bytes)
    are all multiples of (`operand_align`; 16 for contiguous tensors of
    16-byte multiples). `unit_bytes`: the widest of 16, 8, 4 and 2 that
    divides Dh * element size and `align`, the piece q, k and v are staged
    in (an f32 operand is 4-byte aligned at least, so f32 takes 16, 8 or 4).
    bf16: a [64-row query tiles, B N] grid of 128 threads; Q and
    double-buffered K and V tiles of 64 rows of kD + 8 bf16 (at Dh = 64:
    45 KB; at 256: 165 KB). f32: a one-dimensional grid of ceil(T / 32) B N
    blocks (the tiles with the most keys first) of four warps, 4 query rows
    a lane; Q and double-buffered K and V tiles of 32 rows of Dh4 + 4 f32
    (Dh4: Dh rounded up to the float4 groups, zero-padded) and each warp's
    [32][12] f32 P tile (at Dh = 64: 49 KB, four blocks an SM; at 256:
    168 KB).

    From MAX_HEAD_DIM + 1 to MAX_CLUSTER_HEAD_DIM (`layout` "dh-cluster"):
    clusters of `cluster` = `slices` = ceil(Dh / SLICE_COLS) CTAs, one CTA
    a 256-column slice; `items` = query tiles x B N (query tile, b n)
    pairs in bands of `band` (b n) pairs, each band from its longest query
    tiles down, dealt to `clusters` persistent clusters in rounds forward
    and backward (the least of the items and `clusters_at_once`, the
    clusters the card holds at once, or one an item where it is 0), a
    one-dimensional grid of slices x clusters CTAs; `band` is
    cluster_band's (with one cluster an item, the most pairs whose K and V
    fit CLUSTER_BAND_BYTES).
    bf16 (`design` "wgmma"): 64-row query and key tiles, one warpgroup (128
    threads), `route` "tma" where the unit is 16 bytes, else "cp.async";
    shared memory two items' Q slices and a two-stage ring of K's and V's
    (32 KB tiles) and two 16 KB exchange slots, 225 KB. f32 (`design`
    "flash-fma"): 32-row tiles, 16 warps (512 threads), `route` as bf16's,
    224 KB. One CTA an SM either way.

    Past MAX_CLUSTER_HEAD_DIM (`layout` "dh-sliced"): the grid gains a third
    axis, `slices` = ceil(Dh / SLICE_COLS); the designs' query tiles, warps
    and threads as above, each CTA over SLICE_COLS output columns. Shared
    memory: a two-stage ring of Q's and K's SLICE_CHUNK-column chunks and
    V's slice of a key tile (bf16: [2][2][64][72] and [64][264] bf16, 70 KB;
    f32: [2][2][32][68] and [32][260] f32 and the warps' P tiles, 73 KB)."""
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"attention: dtype {dtype} not in float32/bfloat16")
    if min(B, T, N, Dh) <= 0:
        raise ValueError(f"attention: empty shape B={B} T={T} N={N} Dh={Dh}")
    es = dtype.itemsize
    unit = unit_bytes(Dh * es, align)
    if unit < es or align < es:
        raise ValueError(f"attention: {dtype} operands must be {es}-byte aligned "
                         f"(align={align})")
    if MAX_HEAD_DIM < Dh <= MAX_CLUSTER_HEAD_DIM:
        slices = -(-Dh // SLICE_COLS)
        tile = TILE if dtype == torch.bfloat16 else F32_TILE
        items = -(-T // tile) * B * N
        clusters = min(items, clusters_at_once) if clusters_at_once > 0 else items
        # One cluster an item: the bands only order them; K and V of a band in L2.
        pair_bytes = 2 * T * Dh * es
        band = (cluster_band(B * N, -(-T // tile), clusters, pair_bytes) if clusters < items
                else max(1, min(B * N, CLUSTER_BAND_BYTES // pair_bytes)))
        cfg = {"design": "wgmma" if dtype == torch.bfloat16 else "flash-fma",
               "layout": "dh-cluster", "cluster": slices, "slices": slices,
               "slice_cols": SLICE_COLS, "items": items, "clusters": clusters,
               "grid": [slices * clusters],
               "threads": 128 if dtype == torch.bfloat16 else 512, "query_tile": tile,
               "key_tile": tile, "band": band, "unit_bytes": unit,
               "smem_bytes": CLUSTER_SMEM[dtype]}
        cfg["route"] = "tma" if unit == 16 else "cp.async"
        return cfg
    if Dh > MAX_HEAD_DIM:
        slices = -(-Dh // SLICE_COLS)
        if dtype == torch.bfloat16:
            return {"design": "mma.sync", "layout": "dh-sliced",
                    "grid": [-(-T // TILE), B * N, slices], "threads": 128, "slices": slices,
                    "slice_cols": SLICE_COLS, "k_chunk": SLICE_CHUNK, "unit_bytes": unit,
                    "smem_bytes": (4 * TILE * (SLICE_CHUNK + 8) + TILE * (SLICE_COLS + 8)) * 2}
        warps = F32_TILE // (2 * F32_LANE_ROWS)
        p_tiles = warps * F32_TILE * (2 * F32_LANE_ROWS + 4)
        return {"design": "flash-fma", "layout": "dh-sliced",
                "grid": [-(-T // F32_TILE) * B * N, slices], "threads": 32 * warps,
                "query_tile": F32_TILE, "key_tile": F32_TILE, "slices": slices,
                "slice_cols": SLICE_COLS, "k_chunk": SLICE_CHUNK, "unit_bytes": unit,
                "smem_bytes": (4 * F32_TILE * (SLICE_CHUNK + 4) + F32_TILE * (SLICE_COLS + 4)
                               + p_tiles) * 4}
    if dtype == torch.bfloat16:
        kD = head_dim_padded(Dh)
        return {"design": "mma.sync", "grid": [-(-T // TILE), B * N], "threads": 128,
                "head_dim_padded": kD, "unit_bytes": unit,
                "smem_bytes": 5 * TILE * (kD + 8) * 2}
    warps = F32_TILE // (2 * F32_LANE_ROWS)
    p_tiles = warps * F32_TILE * (2 * F32_LANE_ROWS + 4)  # kPFloats
    dh4 = -(-Dh // 4) * 4
    return {"design": "flash-fma", "grid": [-(-T // F32_TILE) * B * N], "threads": 32 * warps,
            "query_tile": F32_TILE, "key_tile": F32_TILE, "head_dim_padded": dh4,
            "unit_bytes": unit, "smem_bytes": (5 * F32_TILE * (dh4 + 4) + p_tiles) * 4}


def operand_align(*ts: torch.Tensor) -> int:
    """The widest of 16, 8, 4 and 2 bytes that the base addresses and the
    batch and time strides (in bytes) of every [B, T, N, Dh] operand are
    multiples of."""
    return unit_bytes(16, *(t.data_ptr() for t in ts),
                      *(t.stride(d) * t.element_size() for t in ts for d in (0, 1)))


def _kernel_view(t: torch.Tensor) -> torch.Tensor:
    """`t` itself where the kernel can read it in place (Dh contiguous and
    the head stride Dh: a strided view of Dh-contiguous rows at any
    alignment), else a contiguous copy."""
    B, T, N, Dh = t.shape
    ok = t.stride(3) == 1 and (N == 1 or t.stride(2) == Dh)
    return t if ok else t.contiguous()


def _forward_kernel(q, k, v, scale: float) -> torch.Tensor:
    B, T, N, Dh = q.shape
    for name, t in (("k", k), ("v", v)):
        if tuple(t.shape) != (B, T, N, Dh) or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"attention: {name} {tuple(t.shape)} {t.dtype} on {t.device} "
                             f"does not match q {tuple(q.shape)} {q.dtype} on {q.device}")
    q, k, v = (_kernel_view(t) for t in (q, k, v))
    at_once = (clusters_at_once(q.device, Dh, q.dtype)
               if MAX_HEAD_DIM < Dh <= MAX_CLUSTER_HEAD_DIM else 0)
    cfg = launch_config(B, T, N, Dh, q.dtype, operand_align(q, k, v), at_once)
    out = torch.empty((B, T, N, Dh), dtype=q.dtype, device=q.device)
    layout = cfg.get("layout")
    lib = _lib()
    with torch.cuda.device(q.device):
        rc = lib.seqrec_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, N, T, Dh, _DTYPE_CODE[q.dtype],
            q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
            float(scale), cfg["smem_bytes"], cfg["unit_bytes"], _LAYOUT_CODE[layout],
            cfg.get("band", 0), cfg.get("clusters", 0),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if rc != 0:
        msg = lib.seqrec_attention_error_string(rc).decode()
        raise RuntimeError(f"attention kernel launch failed: CUDA error {rc} ({msg})")
    causal_attention.launches += 1
    if layout == "dh-cluster":
        causal_attention.cluster_launches += 1
    elif layout == "dh-sliced":
        causal_attention.sliced_launches += 1
    return out


class _Attention(torch.autograd.Function):
    """Causal attention of q, k, v [B, T, N, Dh]; the counterpart of the JAX
    package's `_attn_core`."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        if q.device.type == "cpu":
            out = plain(q, k, v, scale=scale)
        else:
            out = _forward_kernel(q, k, v, scale)
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out = plain(*leaves, scale=ctx.scale)
        return (*torch.autograd.grad(out, leaves, g), None)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Causal attention [B, T, N, Dh] -> [B, T, N, Dh] in q.dtype,
    differentiable in q, k and v. A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel or raises."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"attention: no kernel for device {q.device}")
    if q.dim() != 4:
        raise ValueError(f"attention: q must be [B, T, N, Dh], got {tuple(q.shape)}")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _Attention.apply(q, k, v, float(scale))


causal_attention.launches = 0
causal_attention.cluster_launches = 0  # the Dh-cluster layout's, 257..2,048 (in .launches too)
causal_attention.sliced_launches = 0  # the Dh-sliced layout's, past 2,048 (in .launches too)


def max_active_clusters(Dh: int, dtype: torch.dtype) -> int:
    """The most clusters of the Dh-cluster layout at Dh that the current
    card holds at once (cudaOccupancyMaxActiveClusters; bf16 on its TMA
    route); RuntimeError outside 257..2,048, or where the card holds none."""
    lib = _lib()
    n = lib.seqrec_attention_max_active_clusters(_DTYPE_CODE[dtype], Dh)
    if n < 0:
        msg = lib.seqrec_attention_error_string(-n).decode()
        raise RuntimeError(f"attention: max active clusters at Dh={Dh}: CUDA error {-n} ({msg})")
    if n == 0:
        raise RuntimeError(f"attention: the card holds no cluster of {-(-Dh // SLICE_COLS)} "
                           f"CTAs of the Dh-cluster layout ({dtype})")
    return n


def clusters_at_once(device: torch.device, Dh: int, dtype: torch.dtype) -> int:
    """max_active_clusters on `device`, asked once a device, dtype and
    cluster size (the persistent clusters the cluster layout launches)."""
    return _clusters_at_once(device.index, dtype, -(-Dh // SLICE_COLS) * SLICE_COLS)


@functools.lru_cache(maxsize=None)
def _clusters_at_once(index: int, dtype: torch.dtype, Dh: int) -> int:
    with torch.cuda.device(index):
        return max_active_clusters(Dh, dtype)
