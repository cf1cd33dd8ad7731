"""Probes of the port's kernels on one NVIDIA GPU.

    python3 kernel_probes.py clusters [--out FILE]
    python3 kernel_probes.py xproj [--out FILE]
    python3 kernel_probes.py fma [--shapes gru_w3,step_gru_fwd_w3] [--out FILE]
    python3 kernel_probes.py head [--out FILE]
    python3 kernel_probes.py scatter [--out FILE]
    python3 kernel_probes.py gather [--out FILE]
    python3 kernel_probes.py gru_wide [--out FILE]
    python3 kernel_probes.py step_gemm [--out FILE]
    python3 kernel_probes.py xproj_bf16 [--shapes rsc15_gru,d52_gru] [--out FILE]
    python3 kernel_probes.py attention [--out FILE]
    python3 kernel_probes.py grid_f32 [--out FILE]

`clusters` sweeps the f32 cluster recurrences over their cluster size C and
rows a cluster R (each launch checked against its plain version first):
the GRU forward at B=64 and 128, T=200, D=H=128 and its reset variant at
B=256, T=50, D=H=100, the LSTM forward at B=64 and 128, T=200, D=H=128 and
its reset variant at B=128 and at B=256, T=50, D=H=100 (each forward with
its f32 input projection, as the wrapper runs it), the LSTM reverse
recurrence at B=128, T=200, H=128 with and without a keep plane, and the
GRU reverse recurrence (its gates recomputed inside) at B=64 and 128,
T=200, H=128, at B=128, T=200, H=100 and at B=256, T=50, H=100 with and
without a keep plane; median of 21 CUDA-event runs (chip_smoke.time_ms)
for each (C, R) that fits, beside the launch_config default.

`xproj` builds kernel_probes.cu (nvcc, into seqrec_tpu_torch/build/) and
times, at M=12,800 and 25,600 with N=384 and N=512 (D=128) and at
M=12,800, D=100, N=300, each against x @ W_x + b in f64 first: the
package's f32 input projection beside torch.addmm f32, and an 8 x 8
outer-product loop (simt_gemm.cuh's) with its refills, its shared-memory
reads and its stores switched off one by one; the card's f32 FMA rate on
independent register chains; and what holds that loop under the FMA peak
("ceiling", `fma_ceiling`): the rate, the SM clock under the load (clock64
over %globaltimer a CTA, and nvidia-smi sampled meanwhile) and each hot
loop's instructions from `cuobjdump -sass` (`sass_loop`).

`fma` builds kernel_probes_fma.cu and times the f32 FMA GEMM
(csrc/fma_gemm.cuh) at FMA_SHAPES (the f32 projection at kernel_turns.py's
XPROJ_ROWS; the step GEMM at w3's step, forward and reverse, at the serving
batch B=64, at B=128 and at the stepped edge's B=16): at its K split and
others, each checked against f64 first, beside the package's wrapper (at
M <= 128 the step GEMM's SIMT kernel: its planes must be the FMA GEMM's
bits at the same split) and torch.addmm / torch.mm in f32, with ptxas's
registers,
the consumer loop's instruction mix, the loop alone on one chunk in shared
memory (its reads switched off in turn, and one step ahead by hand) and
the TMA control (A's box coordinates exchanged), which must fail.

`head` builds kernel_probes.cu too and times variants of the f32
sampled-softmax head (rows a block, k chunk, ring stages, CTAs a SM; the
shipped ones are head_m128_k32_s2_c2 at H <= 128 and N >= 12,288, else
head_m64_k32_s2_c3), each checked against the plain version
first (1e-4), at N=25,600, S=256, H=128 (ML-1M GRU4Rec's step), N=6,400,
S=256, H=256 (beauty's), N=300, S=2,048, H=128 and N=12,800, S=256, H=100,
beside the wrapper, the plain version and f32 `h @ neg.T` alone (TF32
off), with ptxas's registers and spills of each variant.

`scatter` times the deterministic scatter-add (csrc/gather.cu) at chunks
of 256 and 512 positions (scatter_add_plan's choice beside the other), each checked bit for bit against plain_ordered first, on Zipf(1.0)
ids at ML-1M GRU4Rec's step (25,600 ids into [3418, 128], also with half the
positions on the padding row), beauty's (6,400 into [12102, 256]) and
rsc15's (12,800 into [37484, 100]): the call by CUDA events, each of its two
kernels by torch.profiler, beside index_add_.

`gather` builds kernel_probes_gather.cu and times the gather from an f32
[3418, D] table into bf16 and f32 with 1, 2, 4 (shipped) or 8 rows in
flight a lane group, and the row-group design tried first (1 to 8
vectors in flight a lane, with and without its one-wave grid), each
checked bit for bit against the plain version first, beside the design
the redesign replaced (f32 out; with its separate cast for bf16),
F.embedding (then .to(bf16)), the wrapper and an empty kernel (the floor
of a launch timed this way), at training's [128, 200] ids at D=64 and
128, serving's [64, 200] at D=128 and the 256 negatives at D=64.

`gru_wide` times the bf16 GRU recurrences above Hp = 128 (csrc/gru.cu's
cluster layouts, 4 CTAs of 64 units, every fragment in registers), each
checked against its plain version first (forward 3e-2 absolute, reverse
1e-4 relative) and twice bit for bit: the forward
(gru_scan, the projection and the fragment packing included) at B=64 and
128, T=50, D=H=256 and B=128, T=20, D=H=200, and the reverse recurrence
(gru_backward on seeded projections) at B=128, T=50, H=256 with h_in in
bf16, and with a keep plane and h_in in f32; beside the
packing of the fragments alone and torch.nn.GRU in bf16 (forward;
forward + backward - forward).

`step_gemm` builds kernel_probes.cu and times the stepped layouts' bf16
step GEMM (csrc/step_gemm.cuh) at w3's steps (B=256, D=H=2,304: the GRU's
and the LSTM's reverse, K = 3H and 4H two terms deep on W_h as stored, and
forward, N = 3H and 4H) and at the edges (B=16 at the bf16 limits + 4,
B=64 at 2,304): each variant (the package's wgmma in the 128-byte swizzle,
fed by TMA or by cp.async in 16- or 8-byte pieces; an mma.sync design;
wgmma without the swizzle; rows a block, ring stages) at its plan's K split, the shipped ones over other
splits too, each checked against torch.matmul in f32 first (a variant
past 1e-5 relative is listed untimed), beside the package's wrapper and
torch.matmul in bf16.

`xproj_bf16` builds kernel_probes.cu and times the bf16 input projection
(csrc/rnn.cuh xproj_wgmma_kernel) at w3's GRU shape (M=51,200, D=2,304,
N=6,912), the wide GRU4Rec's (D=512, N=1,536), the narrow GRU's (M=12,800,
D=128, N=384) and the 8-byte rows of rsc15 (D=100, N=300) and d = 52
(N=156), or at --shapes (XP_SHAPES' keys, comma-separated): tiles of
128 x 128, 128 x 256 and 256 x 128, ring stages, bands, TMA or cp.async,
8-byte rows zero-padded onto TMA (with and without the pads' time), and the
step GEMM's kernel as the design without a producer warpgroup, each
checked against torch.addmm(...,
out_dtype=torch.float32) first, beside the wrapper, that addmm and
descriptor controls that must fail (probe_xproj_bf16).

`attention` prints the clusters of the Dh-cluster attention (csrc/attention.cu)
the card holds at once at 2, 4 and 8 slices, bf16 and f32, and times it on
its persistent clusters in bands of its own size, of one (b, n) pair and of
every pair, and on one cluster an item and on twice the clusters the card
holds (w1's step at B = 256 and 64, Dh = 1,000 at B = 32; each checked
against the plain version first), beside the wrapper and SDPA, with the
cycles of each phase of one call in CTA 0 (the probe build's clocks); and
builds
kernel_probes_attention.cu, whose descriptor control (every wgmma
descriptor's byte offsets exchanged) must fail the check at w1's step.

`grid_f32` builds kernel_probes_grid.cu twice (csrc/gru.cu and csrc/lstm.cu
with the f32 grid forwards' phase clocks compiled in) and runs the f32 GRU
and LSTM forwards through them in the package library's place at the wide
step (B=256, T=200, D=H=512), rsc15's reset shape at H = 1,000 (B=256,
T=50) and ml1m_lstm's (B=128, T=200, H=512), each checked against its plain
version first: the cycles a step of each phase of the step in CTA 0 (the
first chunk's wait, the later chunks' waits, the products, the partial
sums, the gate math, the barrier's arrive, the next step's operands, the
barrier's wait), as built, without h's copies and without the products,
beside the projection alone and the package's build.

Each prints one JSON object as its last line, beside the card's name and
power limit, and exits non-zero without CUDA.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def _smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def probe_clusters() -> dict:
    import numpy as np
    import torch

    import chip_smoke as cs
    from seqrec_tpu_torch.ops import _build, reference
    from seqrec_tpu_torch.ops.cuda import gru as k_gru
    from seqrec_tpu_torch.ops.cuda import lstm as k_lstm

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    _build.build(["gru", "lstm"])
    rng = np.random.default_rng(0)
    out = {"gru_forward": {}, "lstm_forward": {}, "lstm_backward": {}, "gru_backward": {}}

    def sweep(module, attr, run, want, B, H, tol, key, group):
        real = getattr(module, attr)
        default = real(B, 200, H, torch.float32) if attr == "backward_launch_config" else \
            real(B, 200, H, H, torch.float32)
        rows = {"default": {k: default[k] for k in ("cluster_size", "rows_per_cluster")}}
        for C in (2, 4, 8):
            for R in (4, 8, 16):
                try:
                    real(*((B, 200, H) if attr == "backward_launch_config" else (B, 200, H, H)),
                         torch.float32, rows_per_cluster=R, cluster_size=C)
                except ValueError:
                    continue
                setattr(module, attr, lambda *a, **kw: real(*a, rows_per_cluster=R,
                                                             cluster_size=C))
                try:
                    got = run()
                    torch.cuda.synchronize()
                    err = max(cs.rel_err(g, w) for g, w in zip(got, want))
                    if err > tol:
                        raise AssertionError(f"{key} C={C} R={R}: relative err {err} > {tol}")
                    rows[f"C{C}_R{R}"] = {"ms": cs.time_ms(run)["median"], "rel_err": err}
                finally:
                    setattr(module, attr, real)
        out[group][key] = rows

    for B, T, H, reset in ((64, 200, 128, False), (128, 200, 128, False), (256, 50, 100, True)):
        x = cs._zipf_embeddings(rng, dev, B, T, H)
        w_x, w_h, b_x, b_h = (w.to(dev) for w in cs.gru_weights(rng, H, H))
        h0 = cs._state(rng, dev, B, H)
        keep = None if not reset else 1.0 - cs._reset_plane(rng, B, T, dev)

        def run_fwd():
            return (k_gru._forward_kernel(x, h0, w_x, w_h, b_x, b_h, keep),)

        want = (reference.gru_scan(x, h0, w_x, w_h, b_x, b_h,
                                   reset_mask=None if keep is None else 1.0 - keep)[0],)
        sweep(k_gru, "launch_config", run_fwd, want, B, H, 1e-5,
              f"B{B}_T{T}_H{H}" + ("_reset" if reset else ""), "gru_forward")

    for B, T, H, reset in ((64, 200, 128, False), (128, 200, 128, False),
                           (128, 200, 128, True), (256, 50, 100, True)):
        x = cs._zipf_embeddings(rng, dev, B, T, H)
        w_x, w_h, b = (w.to(dev) for w in cs.lstm_weights(rng, H, H))
        h0, c0 = cs._state(rng, dev, B, H), cs._state(rng, dev, B, H)
        plane = cs._reset_plane(rng, B, T, dev) if reset else None

        def run_lstm():
            return k_lstm._forward_kernel(x, h0, c0, w_x, w_h, b, False,
                                          None if plane is None else 1.0 - plane)[:2]

        ys, (_, c_last) = reference.lstm_scan(x, h0, c0, w_x, w_h, b, reset_mask=plane)
        sweep(k_lstm, "launch_config", run_lstm, (ys, c_last), B, H, 1e-5,
              f"B{B}_T{T}_H{H}" + ("_reset" if reset else ""), "lstm_forward")

    B, T, H = 128, 200, 128
    planes = [torch.from_numpy(rng.uniform(0.05, 0.95, size=(B, T, H)).astype(np.float32))
              .to(dev) for _ in range(4)]
    i_, f_, o_ = planes[:3]
    g_ = torch.tanh(planes[3] * 4 - 2)
    tc = torch.tanh(cs._state(rng, dev, B * T, H).reshape(B, T, H))
    c_in = cs._state(rng, dev, B * T, H).reshape(B, T, H)
    g_ys = cs._state(rng, dev, B * T, H).reshape(B, T, H) * 0.02
    w_h = cs.lstm_weights(rng, H, H)[1].to(dev)
    dcl = cs._state(rng, dev, B, H) * 0.02
    for key, keep in (("B128_T200_H128", None),
                      ("B128_T200_H128_keep", (1.0 - cs._reset_plane(rng, B, T, dev))[..., None])):
        args = (i_, f_, g_, o_, tc, c_in, g_ys, w_h, keep, dcl)
        want = reference.lstm_bwd_scan(*args)
        sweep(k_lstm, "backward_launch_config", lambda: k_lstm.lstm_backward(*args), want, B, H,
              1e-4, key, "lstm_backward")

    for B, T, H, reset in ((64, 200, 128, False), (128, 200, 128, False),
                           (128, 200, 100, False), (256, 50, 100, False), (256, 50, 100, True)):
        x_proj = cs._state(rng, dev, B * T, 3 * H).reshape(B, T, 3 * H) * 4
        h_proj = cs._state(rng, dev, B * T, 3 * H).reshape(B, T, 3 * H) * 4
        h_in = torch.tanh(cs._state(rng, dev, B * T, H).reshape(B, T, H))
        g_ys = cs._state(rng, dev, B * T, H).reshape(B, T, H) * 0.02
        w_h = cs.gru_weights(rng, H, H)[1].to(dev)
        keep = (1.0 - cs._reset_plane(rng, B, T, dev))[..., None] if reset else None
        args = (x_proj, h_proj, h_in, g_ys, w_h, keep)
        want = k_gru.plain_backward(*args)
        sweep(k_gru, "backward_launch_config", lambda: k_gru.gru_backward(*args), want, B, H,
              1e-4, f"B{B}_T{T}_H{H}" + ("_keep" if reset else ""), "gru_backward")
    return out


def probe_gru_wide() -> dict:
    import numpy as np
    import torch

    import chip_smoke as cs
    from seqrec_tpu_torch.ops import _build
    from seqrec_tpu_torch.ops.cuda import gru as k_gru

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    _build.build(["gru"])
    rng = np.random.default_rng(0)
    out = {"forward": {}, "backward": {}}

    def timed(run, check, key, group):
        got = run()
        again = run()
        torch.cuda.synchronize()
        err = check(got)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{group} {key}: two launches differ")
        out[group][key] = {"ms": cs.time_ms(run)["median"], "err": err,
                           "cluster_size": k_gru.WIDE_CLUSTER}

    for B, T, H in ((64, 50, 256), (128, 50, 256), (128, 20, 200)):
        x = cs._zipf_embeddings(rng, dev, B, T, H).bfloat16()
        w_x, w_h, b_x, b_h = (w.to(dev) for w in cs.gru_weights(rng, H, H))
        h0 = cs._state(rng, dev, B, H).bfloat16()
        args = (x, h0, w_x.bfloat16(), w_h.bfloat16(), b_x, b_h)
        want = k_gru.plain(*args)[0].float()

        def check_fwd(got):
            err = cs.max_err(got[0], want)
            if err > cs.GRU_BF16_TOL:
                raise AssertionError(f"gru_wide forward B{B}: max abs err {err}")
            return err

        timed(lambda: (k_gru.gru_scan(*args)[0],), check_fwd, f"B{B}_T{T}_H{H}", "forward")
        lib = torch.nn.GRU(H, H, batch_first=True, device=dev, dtype=torch.bfloat16)
        with torch.no_grad():
            lib.weight_ih_l0.copy_(w_x.T)
            lib.weight_hh_l0.copy_(w_h.T)
            lib.bias_ih_l0.copy_(b_x)
            lib.bias_hh_l0.copy_(b_h)
            out["forward"][f"B{B}_T{T}_H{H}"]["nn_gru_bf16_ms"] = cs.time_ms(
                lambda: lib(x, h0[None]))["median"]
        out["forward"][f"B{B}_T{T}_H{H}"]["pack_fragments_ms"] = cs.time_ms(
            lambda: k_gru.forward_fragments(args[3]))["median"]

    B, T, H = 128, 50, 256
    x_proj = cs._state(rng, dev, B * T, 3 * H).reshape(B, T, 3 * H) * 4
    h_proj = cs._state(rng, dev, B * T, 3 * H).reshape(B, T, 3 * H) * 4
    h_in = torch.tanh(cs._state(rng, dev, B * T, H).reshape(B, T, H))
    g_ys = (cs._state(rng, dev, B * T, H).reshape(B, T, H) * 0.02).bfloat16()
    w_h = cs.gru_weights(rng, H, H)[1].to(dev).bfloat16()
    for key, keep in (("B128_T50_H256", None),
                      ("B128_T50_H256_keep", (1.0 - cs._reset_plane(rng, B, T, dev))[..., None])):
        hin = h_in.bfloat16() if keep is None else h_in * keep
        bargs = (x_proj, h_proj, hin, g_ys, w_h, keep)
        want_b = k_gru.plain_backward(*bargs)

        def check_bwd(got):
            err = max(cs.rel_err(a, b) for a, b in zip(got, want_b))
            if err > cs.GRU_BWD_TOL:
                raise AssertionError(f"gru_wide backward {key}: relative err {err}")
            return err

        timed(lambda: k_gru.gru_backward(*bargs), check_bwd, key, "backward")
    out["backward"]["B128_T50_H256"]["pack_fragments_ms"] = cs.time_ms(
        lambda: k_gru.wide_backward_fragments(w_h))["median"]
    # nn.GRU bf16 (cuDNN): backward as (forward + backward) - forward.
    x = cs._zipf_embeddings(rng, dev, B, T, H).bfloat16().requires_grad_(True)
    lib = torch.nn.GRU(H, H, batch_first=True, device=dev, dtype=torch.bfloat16)
    h0 = torch.zeros(1, B, H, device=dev, dtype=torch.bfloat16)
    g = (cs._state(rng, dev, B * T, H).reshape(B, T, H) * 0.02).bfloat16()
    fb = cs.time_ms(lambda: lib(x, h0)[0].backward(g))["median"]
    fw = cs.time_ms(lambda: lib(x, h0)[0])["median"]
    out["backward"]["B128_T50_H256"]["nn_gru_bf16_backward_ms"] = fb - fw
    return out


def probe_build(source: str = "kernel_probes.cu", defines=()):
    """Build `source` (a file beside this script), with each of `defines`
    defined, into seqrec_tpu_torch/build/ without loading it; (library
    path, ptxas log)."""
    from seqrec_tpu_torch.ops import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = _build.BUILD_DIR / f"lib{Path(source).stem}{''.join('-' + d for d in defines)}.so"
    r = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, *(f"-D{d}" for d in defines),
                        "-I", str(HERE), "-o", str(lib_path), str(HERE / source)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc {source} failed:\n{r.stdout}{r.stderr}")
    return lib_path, r.stdout + r.stderr


def _probe_lib(source: str = "kernel_probes.cu"):
    """`source` built and loaded; (library, ptxas log)."""
    import ctypes

    lib_path, log = probe_build(source)
    return ctypes.CDLL(str(lib_path)), log


ATTENTION_CONTROL = "kernel_probes_attention.cu"


def attention_control_lib(built=None):
    """kernel_probes_attention.cu loaded (from `built`, a probe_build path,
    else built now), its entry points bound: the bf16 Dh-cluster attention
    with its descriptors' byte offsets exchanged (`attn_cluster_control`,
    seqrec_attention_forward's arguments from q to scale, its band and
    clusters, then the stream) and the epilogue's quotient beside a divide
    (`attn_epilogue_quotients`, see `epilogue_quotients`)."""
    import ctypes

    lib = ctypes.CDLL(str(built or probe_build(ATTENTION_CONTROL)[0]))
    lib.attn_cluster_control.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_longlong] * 6 + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.attn_cluster_control.restype = ctypes.c_int
    lib.attn_epilogue_quotients.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int,
                                                                    ctypes.c_void_p]
    lib.attn_epilogue_quotients.restype = ctypes.c_int
    return lib


def epilogue_quotients(lib, a, l):
    """The bf16 Dh-cluster epilogue's quotients of a by max(l, 1e-30) (its
    reciprocal and one Markstein correction, csrc/attention.cu
    markstein_quotient) and __fdiv_rn's, on f32 CUDA tensors of one shape:
    (got, want)."""
    import torch

    got, want = torch.empty_like(a), torch.empty_like(a)
    rc = lib.attn_epilogue_quotients(a.data_ptr(), l.data_ptr(), got.data_ptr(), want.data_ptr(),
                                     a.numel(), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"attn_epilogue_quotients: CUDA error {rc}")
    return got, want


def attention_control(lib, q, k, v):
    """The control's output on q, k, v [B, T, N, Dh] bf16 (read in place,
    every stride a 16-byte multiple), launched on the current stream with
    the package's band and clusters."""
    import torch

    from seqrec_tpu_torch.ops.cuda import attention as k_attn

    B, T, N, Dh = q.shape
    cfg = k_attn.launch_config(B, T, N, Dh, q.dtype, k_attn.operand_align(q, k, v),
                               k_attn.clusters_at_once(q.device, Dh, q.dtype))
    out = torch.empty((B, T, N, Dh), dtype=q.dtype, device=q.device)
    rc = lib.attn_cluster_control(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, N,
                                  T, Dh, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                                  v.stride(0), v.stride(1), Dh ** -0.5, cfg["band"],
                                  cfg["clusters"], torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"attn_cluster_control: CUDA error {rc}")
    return out


def probe_xproj() -> dict:
    import ctypes

    import numpy as np
    import torch

    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    from seqrec_tpu_torch.ops.cuda import gru as k_gru

    lib_path, _ = probe_build()
    lib = ctypes.CDLL(str(lib_path))
    loops = ["loop_full", "loop_no_refill", "loop_no_smem_reads", "loop_no_stores", "loop_bare"]
    for name in loops:
        getattr(lib, name).argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.ffma_rate.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    sink = torch.zeros(1, device=dev)
    iters, blocks = 20000, 2 * sms
    ms = cs.time_ms(lambda: lib.ffma_rate(sink.data_ptr(), iters, blocks), reps=5)["median"]
    out = {"ffma_tflops": 2.0 * blocks * 256 * iters * 8 * 16 / ms / 1e9, "shapes": {},
           "ceiling": fma_ceiling(lib, lib_path)}
    rng = np.random.default_rng(0)
    for M, D, N in ((12800, 128, 384), (25600, 128, 384), (12800, 128, 512), (25600, 128, 512),
                    (12800, 100, 300)):
        x = torch.from_numpy(rng.normal(size=(M, D)).astype(np.float32)).to(dev)
        w = torch.from_numpy((rng.normal(size=(D, N)) * D ** -0.5).astype(np.float32)).to(dev)
        b = torch.from_numpy(rng.normal(size=N).astype(np.float32)).to(dev)
        want = x.double() @ w.double() + b.double()
        got = k_gru.gru_input_projection(x, w, b)
        rec = {"addmm_ms": cs.time_ms(lambda: torch.addmm(b, x, w))["median"],
               "bound_ms": 2.0 * M * D * N / cs.PEAK_FLOPS[torch.float32] * 1e3,
               "package": {"ms": cs.time_ms(lambda: k_gru.gru_input_projection(x, w, b))["median"],
                           "max_abs_err_vs_f64": (got.double() - want).abs().max().item()}}
        for name in loops:
            xp = torch.empty(M, N, device=dev)
            fn = getattr(lib, name)

            def call():
                rc = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), xp.data_ptr(), M, D, N,
                        torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"{name}: CUDA error {rc}")

            call()
            torch.cuda.synchronize()
            err = (xp.double() - want).abs().max().item() if name == loops[0] else None
            if err is not None and err > 1e-5:
                raise AssertionError(f"xproj {name} {M}x{D}x{N}: max abs err {err} vs f64")
            rec[name] = {"ms": cs.time_ms(call)["median"], "max_abs_err_vs_f64": err}
        out["shapes"][f"M{M}_D{D}_N{N}"] = rec
    return out


def sass_loop(lib_path, kernel: str) -> dict:
    """The hot loop of the first function in `lib_path` whose mangled name
    holds `kernel`, from `cuobjdump -sass`: of the backward branches, the
    span with the most FFMAs; its instructions by opcode, its FFMAs with a
    `.reuse` operand, and every instruction of the function by opcode."""
    import re
    from collections import Counter

    from seqrec_tpu_torch.ops import _build

    tool = Path(_build.find_nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True).stdout
    body = next((f for f in text.split("Function : ")[1:] if kernel in f.split("\n", 1)[0]), None)
    if body is None:
        return {"kernel": kernel, "found": False}
    ins = []  # (address, opcode, text)
    for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body):
        txt = m.group(2).strip()
        op = re.sub(r"^@!?U?P\w+\s+", "", txt).split()[0]
        ins.append((int(m.group(1), 16), op, txt))
    best = None
    for addr, op, txt in ins:
        t = re.search(r"BRA\s+(?:`\()?\.?L?_?x?_?(0x[0-9a-f]+|\d+)", txt)
        if op.startswith("BRA") and t:
            target = int(t.group(1), 0)
            if target < addr:
                span = [i for i in ins if target <= i[0] <= addr]
                ffma = sum(i[1].startswith("FFMA") for i in span)
                if best is None or ffma > best[0]:
                    best = (ffma, span)
    out = {"kernel": kernel, "found": True,
           "function_opcodes": dict(Counter(op.split(".")[0] for _, op, _ in ins).most_common())}
    if best:
        span = best[1]
        ops = Counter(op.split(".")[0] for _, op, _ in span)
        ffma = ops.get("FFMA", 0)
        out["loop"] = {"instructions": len(span), "ffma": ffma,
                       "other": len(span) - ffma, "ffma_share": ffma / max(1, len(span)),
                       "ffma_with_reuse": sum("FFMA" in op and ".reuse" in t for _, op, t in span),
                       "opcodes": dict(ops.most_common())}
    return out


class SmiSampler:
    """nvidia-smi's SM clock, its maximum, power draw and temperature,
    sampled in a thread while the `with` block runs."""

    QUERY = "clocks.sm,clocks.max.sm,power.draw,power.limit,temperature.gpu"

    def __enter__(self):
        import threading

        self.rows, self._stop = [], threading.Event()

        def run():
            while not self._stop.is_set():
                r = subprocess.run(["nvidia-smi", f"--query-gpu={self.QUERY}",
                                    "--format=csv,noheader,nounits"], capture_output=True,
                                   text=True)
                if r.returncode == 0 and r.stdout.strip():
                    self.rows.append([float(v) for v in r.stdout.split("\n")[0].split(",")])
                self._stop.wait(0.05)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()

    def summary(self) -> dict:
        if not self.rows:
            return {"samples": 0}
        cols = list(zip(*self.rows))
        med = [sorted(c)[len(c) // 2] for c in cols]
        return {"samples": len(self.rows), "sm_mhz_median": med[0], "sm_mhz_min": min(cols[0]),
                "sm_mhz_max": max(cols[0]), "max_sm_mhz": med[1], "power_w_median": med[2],
                "power_limit_w": med[3], "temperature_c_median": med[4]}


def fma_ceiling(lib, lib_path, seconds: float = 2.0) -> dict:
    """What holds an 8 x 8 FMA loop under the FMA peak: for the card's FMA
    rate on register chains (ffma_bench) and for the loop with every copy,
    shared-memory read and store switched off (loop_bare) and with all of
    them (loop_full), at the wide projection's shape (M=51,200, D=512,
    N=1,536): the rate, the SM clock under that load (each CTA's clock64
    cycles over its %globaltimer nanoseconds, and nvidia-smi sampled while
    the kernel runs back to back for `seconds`), the FMA peak at that
    clock (SMs x 128 lanes x 2 x the clock) and the share of it reached;
    and each kernel's hot loop from the built library (`sass_loop`):
    FFMAs against every other instruction, and FFMAs with a `.reuse`
    operand."""
    import ctypes
    import time

    import torch

    import chip_smoke as cs

    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lib.read_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    for name in ("loop_bare_clocked", "loop_full_clocked"):
        getattr(lib, name).argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    M, D, N = 51_200, 512, 1_536
    x = torch.randn(M, D, device=dev)
    w = torch.randn(D, N, device=dev) * D ** -0.5
    b = torch.randn(N, device=dev)
    xp = torch.empty(M, N, device=dev)
    sink = torch.zeros(1, device=dev)
    iters = 200_000

    def loop(name):
        fn = getattr(lib, name)

        def call():
            rc = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), xp.data_ptr(), M, D, N,
                    torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"{name}: CUDA error {rc}")
        return call, 2.0 * M * D * N, min(-(-M // 128) * -(-N // 128), 2 * sms)

    def bench():
        def call():
            rc = lib.ffma_rate(sink.data_ptr(), iters, 2 * sms)
            if rc != 0:
                raise RuntimeError(f"ffma_rate: CUDA error {rc}")
        return call, 2.0 * 2 * sms * 256 * iters * 8 * 16, 2 * sms

    out = {"sms": sms}
    for label, (call, flops, ctas) in (("ffma_bench", bench()),
                                       ("loop_bare", loop("loop_bare_clocked")),
                                       ("loop_full", loop("loop_full_clocked"))):
        ms = cs.time_ms(call, reps=7)["median"]
        with SmiSampler() as smi:
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                for _ in range(max(1, int(20 / ms))):
                    call()
                torch.cuda.synchronize()
        raw = (ctypes.c_ulonglong * (2 * ctas))()
        rc = lib.read_clocks(raw, ctas)
        if rc != 0:
            raise RuntimeError(f"read_clocks: CUDA error {rc}")
        ghz = sorted(raw[2 * i] / raw[2 * i + 1] for i in range(ctas) if raw[2 * i + 1])
        clock = ghz[len(ghz) // 2]
        tflops = flops / ms / 1e9
        peak_at_clock = sms * 128 * 2 * clock * 1e9 / 1e12
        out[label] = {"ms": ms, "tflops": tflops,
                      "share_of_67_tflops": tflops / (cs.PEAK_FLOPS[torch.float32] / 1e12),
                      "cta_clock_ghz_median": clock, "cta_clock_ghz_min": ghz[0],
                      "cta_clock_ghz_max": ghz[-1], "fma_peak_at_clock_tflops": peak_at_clock,
                      "share_of_peak_at_clock": tflops / peak_at_clock, "smi": smi.summary()}
    out["sass"] = {label: sass_loop(lib_path, kernel) for label, kernel in (
        ("ffma_bench", "ffma_bench"),
        ("loop_bare", "xproj_t_kernelILi3ELi2ELb0ELb0ELb0ELb1E"),
        ("loop_full", "xproj_t_kernelILi3ELi2ELb1ELb1ELb1ELb1E"),
        ("xproj_f32_simt", "xproj_f32_kernelILi64ELi32ELi2ELi4E"))}
    return out


# The f32 FMA GEMM's shapes (M, K, N, split): the f32 projection at
# kernel_turns.py's XPROJ_ROWS, and the f32 stepped layouts' step GEMM at
# w3's step (B = 256, H = 2,304; forward h @ W_h, reverse d @ W_h^T) and at
# a serving batch (B = 64).
FMA_SHAPES = {"gru_B64": (12800, 128, 384, 0), "gru_B128": (25600, 128, 384, 0),
              "lstm_B128": (25600, 128, 512, 0), "gru_rsc15": (12800, 100, 300, 0),
              "gru_d52": (25600, 52, 156, 0), "gru_wide": (51200, 512, 1536, 0),
              "lstm_wide": (51200, 512, 2048, 0), "gru_w3": (51200, 2304, 6912, 0),
              "lstm_w3": (51200, 2304, 9216, 0),
              "step_gru_fwd_w3": (256, 2304, 6912, 1), "step_lstm_fwd_w3": (256, 2304, 9216, 1),
              "step_gru_rev_w3": (256, 6912, 2304, 1), "step_lstm_rev_w3": (256, 9216, 2304, 1),
              "step_gru_fwd_B64": (64, 2304, 6912, 1), "step_lstm_fwd_B64": (64, 2304, 9216, 1),
              "step_gru_rev_B64": (64, 6912, 2304, 1), "step_gru_fwd_B128": (128, 2304, 6912, 1),
              "step_gru_fwd_B16": (16, 1060, 3180, 1), "step_lstm_fwd_B16": (16, 1060, 4240, 1)}
FMA_CONTROL = "kernel_probes_fma.cu"


def fma_lib(built=None):
    """kernel_probes_fma.cu loaded (from `built`, a probe_build path, else
    built now), its entry points bound: `fma_variant` (csrc/fma_gemm.cuh at
    a plan with forced K splits, 0: the rule's) and `fma_control` (the same
    with A's box coordinates exchanged): a, w, b,
    out; M, K, N, split, warps (0 or 8), splits; the plan used (int[4]: warps,
    splits, grid, smem); the stream. `fma_reference`: out = a @ w + b, each
    output summed by FMA in k order from 0, then b (a, w, b, out; M, K, N;
    the stream)."""
    import ctypes

    lib = ctypes.CDLL(str(built or probe_build(FMA_CONTROL)[0]))
    for name in ("fma_variant", "fma_control"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
    lib.fma_reference.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.fma_reference.restype = ctypes.c_int
    lib.fma_loop.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.fma_loop.restype = ctypes.c_int
    return lib


def probe_fma(shapes=tuple(FMA_SHAPES)) -> dict:
    """The f32 FMA GEMM (csrc/fma_gemm.cuh) at FMA_SHAPES: at the rule's
    split, and for the step GEMM at other K splits too, each checked first (the projection against x @ w + b in f64, within
    1e-5 of the largest value; a split's planes summed in split order, the
    same), beside the package's wrapper, torch.addmm / torch.mm in f32 (TF32
    off) and the bound; ptxas's registers and spills of each instantiation;
    the control (A's box coordinates exchanged), which must fail the check;
    and the consumer loop's instruction mix (`sass_loop`)."""
    import ctypes
    import re

    import numpy as np
    import torch

    import chip_smoke as cs
    from seqrec_tpu_torch.ops.cuda import gru as k_gru

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    path, log = probe_build(FMA_CONTROL)
    lib = fma_lib(path)
    ptxas = {}
    for block in re.split(r"Compiling entry function ", log):
        m = re.match(r"'\S*fma_gemm_kernelILb(\d)E\S*'", block)
        name = ("control" if m.group(1) == "1" else "kernel") if m else None
        if name:
            regs = re.search(r"Used (\d+) registers", block)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", block)
            ptxas[name] = {"registers": int(regs.group(1)) if regs else None,
                           "spill_stores": int(spill.group(1)) if spill else None,
                           "spill_loads": int(spill.group(2)) if spill else None}
    out = {"ptxas": ptxas, "sass": {"kernel": sass_loop(path, "fma_gemm_kernelILb0E")},
           "shapes": {}}
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    # The consumer loop alone, one CTA of 8 warps a SM, its reads switched off.
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    sink = torch.zeros(1, device=dev)
    loop = {}
    for mode, name in enumerate(("a_and_b", "b_only", "a_only", "bare", "a_and_b_ahead")):
        chunks = 2000
        fn = lambda: lib.fma_loop(sink.data_ptr(), chunks, sms, mode, stream())  # noqa: E731
        if fn() != 0:
            raise RuntimeError(f"fma_loop {name}: launch failed")
        ms = cs.time_ms(fn, reps=5)["median"]
        tflops = 2.0 * sms * 256 * 128 * 32 * chunks / ms / 1e9
        loop[name] = {"ms": ms, "tflops": tflops,
                      "share_of_67_tflops": tflops / (cs.PEAK_FLOPS[torch.float32] / 1e12)}
    out["loop"] = loop
    out["loop_sass"] = {m: sass_loop(path, f"fma_loop_kernelILb{a}ELb{b}E") for m, a, b in (
        ("a_and_b", 1, 1), ("bare", 0, 0))}
    out["loop_sass"]["a_and_b_ahead"] = sass_loop(path, "fma_loop_ahead_kernel")
    rng = np.random.default_rng(0)
    plan = (ctypes.c_int * 4)()
    for label in shapes:
        M, K, N, split = FMA_SHAPES[label]
        x = torch.from_numpy(rng.normal(scale=K ** -0.5, size=(M, K)).astype(np.float32)).to(dev)
        w = torch.from_numpy(rng.normal(scale=K ** -0.5, size=(K, N)).astype(np.float32)).to(dev)
        b = torch.from_numpy(rng.normal(scale=0.1, size=N).astype(np.float32)).to(dev)
        want = x.double() @ w.double() + (0 if split else b.double())
        scale = want.abs().max().item()
        flops = 2.0 * M * K * N
        rec = {"M": M, "K": K, "N": N, "split": split,
               "bound_ms": flops / cs.PEAK_FLOPS[torch.float32] * 1e3,
               "library_ms": cs.time_ms((lambda: torch.mm(x, w)) if split else
                                        (lambda: torch.addmm(b, x, w)))["median"],
               "variants": {}}
        if split:
            cfg = k_gru.step_gemm_f32_config(M, K, N)
            rec["config"] = cfg
            rec["wrapper_ms"] = cs.time_ms(lambda: k_gru.step_gemm_f32(x, w))["median"]
            wrapped = k_gru.step_gemm_f32(x, w)
            err = (wrapped.double().sum(0) - want).abs().max().item() / scale
            rec["wrapper_rel_err"] = float("inf") if err != err else err
        else:
            cfg = k_gru.xproj_f32_config(M, K, N)
            rec["config"] = cfg
            rec["wrapper_ms"] = cs.time_ms(lambda: k_gru.gru_input_projection(x, w, b))["median"]
        runs = [0] + ([1, 2, 3, 4, 6, 8, 12] if split else [])
        buf = torch.empty(16 * M * N if split else M * N, device=dev)
        for sp in runs:
            def call(fn=lib.fma_variant, sp=sp):
                rc = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), buf.data_ptr(), M, K, N, split,
                        0, sp, plan, stream())
                if rc != 0:
                    raise RuntimeError(f"fma {label} s{sp}: CUDA error {rc}")
            buf.fill_(float("nan"))
            call()
            torch.cuda.synchronize()
            used = list(plan)
            planes = buf[:used[1] * M * N].view(used[1], M, N) if split else buf.view(M, N)
            got = planes.sum(0) if split else planes
            err = ((got.double() - want).abs().max().item() / scale)
            err = float("inf") if err != err else err
            name = "fma" + (f"_s{used[1]}" + ("_rule" if sp == 0 else "") if split else "")
            r = {"plan": used, "rel_err": err}
            if split and sp == 0:  # the rule's split: the wrapper's planes, bit for bit
                r["wrapper_same_bits"] = (tuple(wrapped.shape) == tuple(planes.shape)
                                          and bool(torch.equal(wrapped, planes)))
            if err <= 1e-5:
                r["ms"] = cs.time_ms(call)["median"]
                r["tflops"] = flops / r["ms"] / 1e9
            rec["variants"][name] = r
        if label in ("gru_wide", "step_gru_fwd_w3"):
            def control():
                rc = lib.fma_control(x.data_ptr(), w.data_ptr(), b.data_ptr(), buf.data_ptr(), M,
                                     K, N, split, 0, 0, plan, stream())
                if rc != 0:
                    raise RuntimeError(f"fma control {label}: CUDA error {rc}")
            buf.fill_(float("nan"))
            control()
            torch.cuda.synchronize()
            got = buf[:plan[1] * M * N].view(plan[1], M, N).sum(0) if split else buf.view(M, N)
            err = (got.double() - want).abs().max().item() / scale
            rec["control_rel_err"] = float("inf") if err != err else err
            rec["control_fails"] = not err <= 1e-5
        out["shapes"][label] = rec
        del x, w, b, want, buf
        torch.cuda.empty_cache()
    return out


def probe_head() -> dict:
    import ctypes
    import re

    import numpy as np
    import torch

    import chip_smoke as cs
    from seqrec_tpu_torch.ops.cuda import head as k_head

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    lib, log = _probe_lib()
    variants = ["head_m64_k32_s2_c3", "head_m64_k16_s2_c4", "head_m64_k32_s3_c2",
                "head_m64_k32_s2_c4", "head_m128_k32_s2_c2", "head_m128_k16_s2_c2"]
    for name in variants:
        getattr(lib, name).argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
    # ptxas's registers and spills of each head_f32_kernel instantiation.
    ptxas = {}
    for block in re.split(r"Compiling entry function ", log):
        m = re.match(r"'(\S*head_f32_kernelILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E\S*)'", block)
        if m:
            regs = re.search(r"Used (\d+) registers", block)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", block)
            ptxas["m{}_k{}_s{}_c{}".format(*m.groups()[1:])] = {
                "registers": int(regs.group(1)) if regs else None,
                "spill_stores": int(spill.group(1)) if spill else None,
                "spill_loads": int(spill.group(2)) if spill else None}
    out = {"ptxas": ptxas, "shapes": {}}
    rng = np.random.default_rng(0)
    for N, S, H in ((25_600, 256, 128), (6_400, 256, 256), (300, 2_048, 128),
                    (12_800, 256, 100)):
        V = cs.VOCAB
        table = torch.from_numpy(rng.normal(scale=H ** -0.5, size=(V, H))
                                 .astype(np.float32)).to(dev)
        targets = torch.from_numpy(cs.zipf_items(rng, N, ranked=True).astype(np.int32)).to(dev)
        neg_ids = torch.from_numpy(cs.zipf_items(rng, S, ranked=True).astype(np.int32)).to(dev)
        h = torch.tanh(torch.from_numpy(rng.normal(size=(N, H)).astype(np.float32))).to(dev)
        plq = torch.from_numpy(rng.normal(size=N).astype(np.float32) - 6).to(dev)
        nlq = torch.from_numpy(rng.normal(size=S).astype(np.float32) - 6).to(dev)
        args = (h, table[targets.long()], table[neg_ids.long()], targets, neg_ids, plq, nlq)
        want = k_head.plain(*args)
        neg = args[2]
        flops = 2.0 * N * S * H + 2.0 * N * H
        rec = {"wrapper_ms": cs.time_ms(lambda: k_head.sampled_softmax_nll(*args))["median"],
               "plain_ms": cs.time_ms(lambda: k_head.plain(*args))["median"],
               "matmul_f32_ms": cs.time_ms(lambda: h @ neg.T)["median"],
               "bound_ms": cs.bound((2 * N * H + S * H) * 4 + N * 12 + S * 8, flops,
                                    torch.float32)[0]}
        for name in variants:
            nll = torch.empty(N, device=dev)
            fn = getattr(lib, name)

            def call():
                rc = fn(*(a.data_ptr() for a in args), nll.data_ptr(), N, S, H,
                        torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"{name}: CUDA error {rc}")

            call()
            torch.cuda.synchronize()
            err = (nll - want).abs().max().item()
            if not err <= 1e-4:
                raise AssertionError(f"{name} {N}x{S}x{H}: max abs err {err} vs plain")
            ms = cs.time_ms(call)["median"]
            rec[name] = {"ms": ms, "max_abs_err": err, "tflops": flops / ms / 1e9}
        out["shapes"][f"N{N}_S{S}_H{H}"] = rec
    return out


def probe_scatter() -> dict:
    import re

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from seqrec_tpu_torch.ops.cuda import gather as k_gather

    dev = torch.device("cuda", 0)
    lib = k_gather._lib()
    rng = np.random.default_rng(0)
    out = {}
    for n, V, D, pad in ((25_600, 3_418, 128, 0.0), (25_600, 3_418, 128, 0.5),
                         (6_400, 12_102, 256, 0.0), (12_800, 37_484, 100, 0.0)):
        p = 1.0 / np.arange(1, V)
        ids_np = rng.choice(np.arange(1, V), size=n, p=p / p.sum())
        ids_np[rng.random(n) < pad] = 0
        ids = torch.from_numpy(ids_np).to(dev)
        g = torch.from_numpy(rng.normal(scale=1e-2, size=(n, D)).astype(np.float32)).to(dev)
        rec = {"max_ids_per_row": int(np.bincount(ids_np, minlength=V).max()),
               "plan_chunk": k_gather.scatter_add_plan(n, V, D)["chunk"],
               "index_add_ms": cs.time_ms(
                   lambda: torch.zeros(V, D, device=dev).index_add_(0, ids, g))["median"]}
        for chunk in k_gather.CHUNKS:
            nbytes = lib.seqrec_scatter_add_scratch_bytes(n, D, chunk)
            scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
            res = torch.empty(V, D, device=dev)

            def call():
                rc = lib.seqrec_scatter_add_rows(
                    g.data_ptr(), 0, ids.data_ptr(), 1, n, V, D, chunk,
                    scratch.data_ptr(), nbytes, res.data_ptr(),
                    torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"scatter chunk {chunk}: CUDA error {rc}")

            call()
            torch.cuda.synchronize()
            if not torch.equal(res, k_gather.plain_ordered(g, ids, V, chunk)):
                raise AssertionError(f"scatter n={n} chunk={chunk}: not plain_ordered's bits")
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    call()
                torch.cuda.synchronize()
            kernels = {}
            for e in prof.key_averages():
                name = re.search(r"\w+_kernel", e.key)
                if name and e.self_device_time_total > 0:
                    kernels[name.group(0)] = e.self_device_time_total / 20 / 1e3
            rec[f"chunk{chunk}"] = {"ms": cs.time_ms(call)["median"], "kernels_ms": kernels}
        out[f"n{n}_V{V}_D{D}_pad{pad}"] = rec
    return out


def probe_gather() -> dict:
    import ctypes

    import numpy as np
    import torch

    import chip_smoke as cs
    from seqrec_tpu_torch.ops import _build
    from seqrec_tpu_torch.ops.cuda import gather as k_gather

    dev = torch.device("cuda", 0)
    lib_path = _build.BUILD_DIR / "libkernel_probes_gather.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    r = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", str(HERE), "-o",
                        str(lib_path), str(HERE / "kernel_probes_gather.cu")],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc kernel_probes_gather.cu failed:\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    variants = ["rows_1", "rows_2", "rows_4", "rows_8", "row_groups_u1", "row_groups_u2",
                "row_groups_u4", "row_groups_u8", "row_groups_u4_full_grid", "gather_previous"]
    for name in variants:
        getattr(lib, name).argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                                       ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                                       ctypes.c_int, ctypes.c_void_p]
    lib.empty_launch.argtypes = [ctypes.c_void_p]
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    out = {"empty_kernel_ms": cs.time_ms(lambda: lib.empty_launch(stream()))["median"],
           "shapes": {}}
    rng = np.random.default_rng(0)
    for D, shape in ((64, (128, 200)), (128, (128, 200)), (128, (64, 200)), (64, (256,))):
        table = torch.from_numpy(rng.normal(scale=D ** -0.5, size=(cs.VOCAB, D))
                                 .astype(np.float32)).to(dev)
        n = int(np.prod(shape))
        ids = torch.from_numpy(cs.zipf_items(rng, n).reshape(shape).astype(np.int32)).to(dev)
        rec = {"f32_embedding_ms": cs.time_ms(
                   lambda: torch.nn.functional.embedding(ids, table))["median"],
               "bf16_embedding_to_ms": cs.time_ms(
                   lambda: torch.nn.functional.embedding(ids, table).bfloat16())["median"]}
        for dtype in (torch.bfloat16, torch.float32):
            want = k_gather.plain(table, ids, dtype=dtype)
            dn = str(dtype).split(".")[-1]
            rec[f"wrapper_{dn}_ms"] = cs.time_ms(
                lambda: k_gather.embedding_gather(table, ids, dtype=dtype))["median"]
            for name in variants:
                if name == "gather_previous" and dtype == torch.bfloat16:
                    continue
                res = torch.empty((*shape, D), dtype=dtype, device=dev)
                fn = getattr(lib, name)

                def call():
                    rc = fn(table.data_ptr(), cs.VOCAB, D, ids.data_ptr(), n, res.data_ptr(),
                            int(dtype == torch.bfloat16), stream())
                    if rc != 0:
                        raise RuntimeError(f"gather {name}: CUDA error {rc}")

                call()
                torch.cuda.synchronize()
                if not torch.equal(res, want):
                    raise AssertionError(f"gather {name} {dn} D={D} {shape}: not the plain bits")
                rec[f"{name}_{dn}_ms"] = cs.time_ms(call)["median"]
                if name == "gather_previous":
                    rec["gather_previous_then_cast_bf16_ms"] = cs.time_ms(
                        lambda: (call(), res.bfloat16()))["median"]
        out["shapes"][f"D{D}_{'x'.join(map(str, shape))}"] = rec
    return out


def probe_step_gemm() -> dict:
    """The stepped layouts' bf16 step GEMM (csrc/step_gemm.cuh) at w3's
    steps and at the stepped edges: each variant of kernel_probes.cu's
    (the package's wgmma kernel fed by TMA or cp.async; rows a block, ring
    stages, copy unit) at step_gemm_plan's rule for its rows,
    the shipped ones also over other K splits, each checked against
    torch.matmul in f32 on the same bf16 values (forward h @ W_h; reverse
    (hi + lo) @ W_h^T) first; beside the package's wrapper (the plan it
    ships) and torch.matmul in bf16 (the reverse on [hi | lo] and W_h^T
    stacked twice)."""
    import ctypes

    import numpy as np
    import torch

    import chip_smoke as cs
    from seqrec_tpu_torch.ops.cuda import gru as k_gru

    dev = torch.device("cuda", 0)
    lib, log = _probe_lib()
    names = ("sg_rev_sw_m128_s3_u16", "sg_rev_sw_m128_s4_u16", "sg_rev_sw_m128_s4_u8",
             "sg_rev_sw_m128_s3_u8", "sg_rev_sw_m256_s2_u16", "sg_fwd_sw_m128_s3_u16",
             "sg_fwd_sw_m128_s3_u8", "sg_fwd_sw_m128_s4_u16", "sg_fwd_sw_m256_s3_u16",
             "sg_fwd_sw_m256_s3_u8", "sg_fwd_sw_m256_s4_u16", "sg_fwd_sw_m128_s4_u8",
             "sg_fwd_sw_m256_s4_u8", "sg_rev_tma_m128_s3_u16", "sg_rev_tma_m128_s4_u16",
             "sg_fwd_tma_m128_s3_u16", "sg_fwd_tma_m256_s3_u16", "sg_fwd_tma_m256_s4_u16")
    for n in names:
        getattr(lib, n).argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p, ctypes.c_void_p]
    rng = np.random.default_rng(0)
    out = {"ptxas": [ln for ln in log.splitlines() if "sg_" in ln or "step_gemm" in ln][-80:],
           "shapes": {}}
    for label, B, H, G, terms in (("w3_gru_reverse", 256, 2304, 3, 2),
                                  ("w3_lstm_reverse", 256, 2304, 4, 2),
                                  ("w3_gru_forward", 256, 2304, 3, 1),
                                  ("w3_lstm_forward", 256, 2304, 4, 1),
                                  ("edge_gru_reverse_B16", 16, 2116, 3, 2),
                                  ("edge_lstm_reverse_B16", 16, 1796, 4, 2),
                                  ("edge_gru_forward_B16", 16, 2116, 3, 1),
                                  ("gru_reverse_B64", 64, 2304, 3, 2),
                                  ("gru_forward_B64", 64, 2304, 3, 1)):
        K, N = (G * H, H) if terms == 2 else (H, G * H)
        w = torch.from_numpy(rng.normal(scale=H ** -0.5, size=(H, G * H)).astype(np.float32))
        w = w.to(dev, torch.bfloat16)
        if terms == 2:
            d = torch.from_numpy(rng.normal(scale=1e-2, size=(B, K)).astype(np.float32)).to(dev)
            hi = d.bfloat16()
            lo = (d - hi.float()).bfloat16()
            a = torch.cat([hi, lo], dim=1)
            want = (hi.float() + lo.float()) @ w.float().T
            stacked = torch.cat([w.T, w.T]).contiguous()
            library = lambda: a @ stacked  # noqa: E731
        else:
            a = torch.from_numpy(rng.normal(size=(B, H)).astype(np.float32)).to(dev, torch.bfloat16)
            want = a.float() @ w.float()
            library = lambda: a @ w  # noqa: E731
        cfg = k_gru.step_gemm_config(B, K, N, terms)
        flops = 2.0 * B * K * N * terms
        rec = {"M": B, "K": K, "N": N, "terms": terms, "config": cfg,
               "bound_ms": max(flops / cs.PEAK_FLOPS[torch.bfloat16],
                               (a.numel() * 2 + w.numel() * 2 + B * N * 4) / cs.HBM_BYTES_PER_S)
               * 1e3,
               "torch_matmul_bf16_ms": cs.time_ms(library)["median"],
               "wrapper_ms": cs.time_ms(lambda: k_gru.step_gemm(a, w, terms))["median"],
               "variants": {}}
        ws = torch.empty((16, B, N), dtype=torch.float32, device=dev)
        scale = want.abs().max().item()
        ship = "sg_{}_{}_m{}_s{}".format("rev" if terms == 2 else "fwd",
                                         "tma" if cfg["tma"] else "sw", cfg["block"][0],
                                         cfg["stages"])
        for n in names:
            if (n.startswith("sg_rev") != (terms == 2) or
                    (n.endswith("u16") and cfg["unit_bytes"] != 16)):
                continue
            fn = getattr(lib, n)
            sweep = (0, 1, 2, 3, 4, 6, 8, 12) if n.startswith(ship) else (0,)
            for splits in sweep:
                used = ctypes.c_int(0)

                def call():
                    rc = fn(a.data_ptr(), w.data_ptr(), ws.data_ptr(), B, K, N, splits,
                            ctypes.byref(used), torch.cuda.current_stream().cuda_stream)
                    if rc != 0:
                        raise RuntimeError(f"{n}: CUDA error {rc}")

                call()
                torch.cuda.synchronize()
                got = ws[:used.value].sum(dim=0)
                err = (got - want).abs().max().item() / scale
                ms = cs.time_ms(call)["median"] if err <= 1e-5 else None
                rec["variants"][f"{n}_S{used.value}" + ("_auto" if splits == 0 else "")] = {
                    "splits": used.value, "rel_err": err, "ok": err <= 1e-5, "ms": ms,
                    "tflops": None if ms is None else flops / ms / 1e9}
        out["shapes"][label] = rec
        print(json.dumps({label: {k: v for k, v in rec.items() if k != "config"}}), flush=True)
    return out


# The bf16 input projection's shapes (M, D, N): the narrow GRU and LSTM
# (serving's B=64 and training's B=128 at T=200, D=128), rsc15 (D=100),
# d = 50 padded to 52, the wide GRU4Rec and LSTM (D=512), w3 (D=2,304) and
# the stepped GRU's edge (B=16, T=20, D=64, H=2,116).
XP_SHAPES = {"narrow_gru_B64": (12800, 128, 384), "narrow_gru_B128": (25600, 128, 384),
             "narrow_lstm_B64": (12800, 128, 512), "narrow_lstm_B128": (25600, 128, 512),
             "rsc15_gru": (12800, 100, 300), "d52_gru": (25600, 52, 156),
             "d52_lstm": (25600, 52, 208), "wide_gru": (51200, 512, 1536),
             "wide_lstm": (51200, 512, 2048), "w3_gru": (51200, 2304, 6912),
             "w3_lstm": (51200, 2304, 9216), "edge_gru_B16": (320, 64, 6348)}


def probe_xproj_bf16(shapes=("w3_gru", "wide_gru", "narrow_gru_B64", "rsc15_gru",
                             "d52_gru")) -> dict:
    """The bf16 input projection (csrc/rnn.cuh xproj_wgmma_kernel) at
    `shapes` (XP_SHAPES' keys): each variant of kernel_probes.cu's xp_bf16
    (tiles of 128 x 128, 128 x 256 and 256 x 128; 2 to 4 ring stages, and
    the most that fit; TMA or cp.async where the rows allow TMA; at w3 the
    column tiles in three bands too; 128 x 64 tiles, two CTAs a SM); on 8-byte rows, x and W_x zero-padded
    to multiples of 8 columns and fed by TMA (xp_bf16_padded: the kernel
    alone, and with the two pads before it); and, as the design without a
    producer warpgroup, the step GEMM's kernel (csrc/step_gemm.cuh: two warpgroups
    that load and multiply in turn, wgmma.wait_group 0, 128 or 256 rows a
    block; no bias), each checked against torch.addmm(b, x, w,
    out_dtype=torch.float32) first (1e-5 of the largest value; a variant
    past it is listed untimed); beside the package's wrapper, that addmm and
    the descriptor controls (W_x's two byte offsets exchanged; at 128 x 64,
    one atom of W_x, its 8-line groups' offset 0), which must fail the
    check."""
    import ctypes

    import numpy as np
    import torch

    import chip_smoke as cs
    from seqrec_tpu_torch.ops.cuda import gru as k_gru

    dev = torch.device("cuda", 0)
    lib, log = _probe_lib()
    lib.xp_bf16.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p] * 2
    lib.xp_bf16_padded.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p] * 2
    sg = ("sg_fwd_tma_m128_s3_u16", "sg_fwd_tma_m256_s3_u16", "sg_fwd_sw_m128_s3_u8",
          "sg_fwd_sw_m256_s3_u8")
    for n in sg:
        getattr(lib, n).argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p, ctypes.c_void_p]
    rng = np.random.default_rng(0)
    out = {"ptxas": [ln for ln in log.splitlines() if "xproj_wgmma" in ln][-40:], "shapes": {}}
    for label in shapes:
        M, D, N = XP_SHAPES[label]
        x = torch.from_numpy(rng.normal(size=(M, D)).astype(np.float32)).to(dev, torch.bfloat16)
        w = torch.from_numpy(rng.normal(scale=D ** -0.5, size=(D, N)).astype(np.float32))
        w = w.to(dev, torch.bfloat16)
        b = torch.from_numpy(rng.normal(scale=0.1, size=N).astype(np.float32)).to(dev)
        want = torch.addmm(b, x, w, out_dtype=torch.float32)
        scale = want.abs().max().item()
        cfg = k_gru.xproj_config(M, D, N)
        flops = 2.0 * M * D * N
        nbytes = (M * D + D * N) * 2 + N * 4 + M * N * 4
        rec = {"M": M, "D": D, "N": N, "config": cfg,
               "bound_ms": max(flops / cs.PEAK_FLOPS[torch.bfloat16],
                               nbytes / cs.HBM_BYTES_PER_S) * 1e3,
               "addmm_out_f32_ms": cs.time_ms(
                   lambda: torch.addmm(b, x, w, out_dtype=torch.float32))["median"],
               "wrapper_ms": cs.time_ms(lambda: k_gru.gru_input_projection(x, w, b))["median"],
               "variants": {}}
        got = k_gru.gru_input_projection(x, w, b)
        rec["wrapper_rel_err"] = (got - want).abs().max().item() / scale
        xp = torch.empty(M, N, dtype=torch.float32, device=dev)
        plan = (ctypes.c_int * 7)()

        def run(bm, bn, stages, band, tma, swap):
            def call():
                rc = lib.xp_bf16(x.data_ptr(), w.data_ptr(), b.data_ptr(), xp.data_ptr(), M, D,
                                 N, bm, bn, stages, band, tma, swap, plan,
                                 torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"xp_bf16 {bm}x{bn} s{stages} b{band} tma{tma}: "
                                       f"CUDA error {rc}")
            return call

        runs = []
        for bm, bn in k_gru.XPROJ_TILES:
            most = k_gru.xproj_max_stages(bm, bn)
            for st in sorted({2, 3, 4, most} & set(range(2, most + 1))):
                for tma in ((1, 0) if cfg["tma"] else (0,)):
                    runs.append((bm, bn, st, 0, tma, 0))
        if label == "w3_gru":
            runs += [(bm, bn, 4, -(-N // bn // 3), 1, 0) for bm, bn in k_gru.XPROJ_TILES[:2]]
        if cfg["tma"]:  # the controls
            runs += [(128, 256, 4, 0, 1, 1), (256, 128, 4, 0, 1, 1), (128, 64, 3, 0, 1, 1)]
        for bm, bn, st, band, tma, swap in runs:
            call = run(bm, bn, st, band, tma, swap)
            xp.fill_(float("nan"))
            call()
            torch.cuda.synchronize()
            err = (xp - want).abs().max().item() / scale
            err = float("inf") if err != err else err
            ok = err <= 1e-5
            name = (f"control_{bm}x{bn}_swapped_offsets" if swap else
                    f"{bm}x{bn}_s{st}_{'tma' if tma else 'cpasync'}" +
                    (f"_band{plan[5]}" if band else ""))
            rec["variants"][name] = {"plan": list(plan), "rel_err": err, "ok": ok,
                                     "ms": cs.time_ms(call)["median"] if ok else None}
        ws = torch.empty((1, M, N), dtype=torch.float32, device=dev)
        prod = want - b
        for n in sg:
            if ("tma" in n) != cfg["tma"]:
                continue
            fn = getattr(lib, n)
            used = ctypes.c_int(0)

            def call():
                rc = fn(x.data_ptr(), w.data_ptr(), ws.data_ptr(), M, D, N, 1, ctypes.byref(used),
                        torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"{n}: CUDA error {rc}")

            call()
            torch.cuda.synchronize()
            err = (ws[0] - prod).abs().max().item() / scale
            ok = err <= 1e-5
            rec["variants"][f"no_producer_{n}"] = {"rel_err": err, "ok": ok,
                                                   "ms": cs.time_ms(call)["median"] if ok else None}
        if not cfg["tma"]:  # 8-byte rows padded onto TMA: the kernel alone, and with the pads
            Dp, Np = -(-D // 8) * 8, -(-N // 8) * 8
            pad = torch.nn.functional.pad
            xpad, wpad = pad(x, (0, Dp - D)), pad(w, (0, Np - N, 0, Dp - D))

            def padded(xa, wa):
                rc = lib.xp_bf16_padded(xa.data_ptr(), wa.data_ptr(), b.data_ptr(), xp.data_ptr(),
                                        M, D, N, Dp, Np, plan,
                                        torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"xp_bf16_padded: CUDA error {rc}")

            xp.fill_(float("nan"))
            padded(xpad, wpad)
            torch.cuda.synchronize()
            err = (xp - want).abs().max().item() / scale
            err = float("inf") if err != err else err
            ok = err <= 1e-5
            rec["variants"]["padded_tma"] = {
                "plan": list(plan), "Dp": Dp, "Np": Np, "rel_err": err, "ok": ok,
                "ms": cs.time_ms(lambda: padded(xpad, wpad))["median"] if ok else None,
                "with_pads_ms": cs.time_ms(lambda: padded(pad(x, (0, Dp - D)),
                                                          pad(w, (0, Np - N, 0, Dp - D))))[
                    "median"] if ok else None,
                "x_pad_ms": cs.time_ms(lambda: pad(x, (0, Dp - D)))["median"]}
        out["shapes"][label] = rec
        print(json.dumps({label: {k: v for k, v in rec.items() if k != "config"}}), flush=True)
        del x, w, want, xp, ws, prod
    return out


def probe_attention() -> dict:
    """The Dh-cluster attention (csrc/attention.cu): the clusters the card
    holds at once (cudaOccupancyMaxActiveClusters) at 2, 4 and 8 slices in
    both dtypes; at w1's step (B = 256 and 64, T = 200, one head of Dh =
    512, q, k and v slices of one [B, T, 3, 1, Dh] projection) and at Dh =
    1,000, B = 32, each dtype on the package's persistent clusters (as many
    as the card holds) in bands of the package's `band` (b, n) pairs, of one
    pair and of every pair, and with the package's band on one cluster an
    item and on twice the clusters the card holds, each checked against
    the plain version first
    (chip_smoke's attention limits); beside the wrapper and SDPA; and the
    descriptor control at w1's step in bf16, which must fail the check."""
    import ctypes

    import numpy as np
    import torch

    import chip_smoke as cs
    from seqrec_tpu_torch.ops.cuda import attention as k_attn

    dev = torch.device("cuda", 0)
    out = {"max_active_clusters": {
        f"slices{-(-Dh // 256)}_{cs._dname(dt)}": k_attn.max_active_clusters(Dh, dt)
        for Dh in (512, 1000, 2048) for dt in (torch.bfloat16, torch.float32)},
        "shapes": {}}
    lib = k_attn._lib()
    rng = np.random.default_rng(0)
    for label, B, Dh in (("w1_B256", 256, 512), ("w1_B64", 64, 512), ("Dh1000_B32", 32, 1000)):
        proj = torch.from_numpy(rng.normal(size=(B, 200, 3, 1, Dh)).astype(np.float32)).to(dev)
        for dt in (torch.bfloat16, torch.float32):
            q, k, v = proj.to(dt).unbind(2)
            want = k_attn.plain(q, k, v)
            tol = cs.ATTN_F32_TOL if dt == torch.float32 else cs.ATTN_BF16_TOL
            at_once = k_attn.clusters_at_once(dev, Dh, dt)
            cfg = k_attn.launch_config(B, 200, 1, Dh, dt, k_attn.operand_align(q, k, v), at_once)
            rec = {"launch": cfg, "variants": {},
                   "wrapper_ms": cs.time_ms(lambda: k_attn.causal_attention(q, k, v))["median"]}
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            rec["sdpa_ms"] = cs.time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True))["median"]
            o = torch.empty_like(q)

            def run(band, clusters):
                def call():
                    rc = lib.seqrec_attention_forward(
                        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, 1, 200, Dh,
                        0 if dt == torch.float32 else 1, q.stride(0), q.stride(1), k.stride(0),
                        k.stride(1), v.stride(0), v.stride(1), Dh ** -0.5, cfg["smem_bytes"],
                        cfg["unit_bytes"], 2, band, clusters,
                        torch.cuda.current_stream().cuda_stream)
                    if rc != 0:
                        raise RuntimeError(f"attention band {band}, {clusters} clusters: "
                                           f"CUDA error {rc}")
                return call

            items = cfg["items"]
            band, G = cfg["band"], cfg["clusters"]
            for name, bd, clusters in ((f"band{band}_persistent_{G}", band, G),
                                       (f"band1_persistent_{G}", 1, G),
                                       (f"band{B}_persistent_{G}", B, G),
                                       (f"band{band}_a_cluster_an_item", band, items),
                                       (f"band{band}_twice_the_clusters_held", band,
                                        min(items, 2 * at_once))):
                call = run(bd, clusters)
                o.fill_(float("nan"))
                call()
                torch.cuda.synchronize()
                err = cs.max_err(o, want)
                ok = err <= tol
                rec["variants"][name] = {"max_abs_err": err, "ok": ok,
                                         "ms": cs.time_ms(call)["median"] if ok else None}
            if label == "w1_B256":  # the phases of one call, the probe build's clocks
                ctl = attention_control_lib()
                ctl.seqrec_attention_forward.argtypes = lib.seqrec_attention_forward.argtypes
                clocks = (ctypes.c_ulonglong * 16)()
                ctl.attn_phase_clocks(clocks)
                rc = ctl.seqrec_attention_forward(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, 1, 200, Dh,
                    0 if dt == torch.float32 else 1, q.stride(0), q.stride(1), k.stride(0),
                    k.stride(1), v.stride(0), v.stride(1), Dh ** -0.5, cfg["smem_bytes"],
                    cfg["unit_bytes"], 2, cfg["band"], cfg["clusters"],
                    torch.cuda.current_stream().cuda_stream)
                torch.cuda.synchronize()
                ctl.attn_phase_clocks(clocks)
                n_tiles, G = -(-200 // cfg["query_tile"]), cfg["clusters"]
                steps, j = 0, 0
                while True:
                    w = j * G + (G - 1 if j % 2 else 0)
                    if w >= items:
                        break
                    per = cfg["band"] * n_tiles
                    wb = min(cfg["band"], B - w // per * cfg["band"])
                    steps += n_tiles - (w % per) // wb
                    j += 1
                rec["phase_cycles_cta0"] = {"rc": rc, "steps": steps, "cycles": list(clocks)}
            if dt == torch.bfloat16 and label == "w1_B256":
                ctl = attention_control_lib()
                got = attention_control(ctl, q, k, v)
                torch.cuda.synchronize()
                err = cs.max_err(got, want)
                rec["control_swapped_offsets"] = {"max_abs_err": err, "fails": not err <= tol}
            out["shapes"][f"{label}_{cs._dname(dt)}"] = rec
            print(json.dumps({f"{label}_{cs._dname(dt)}": rec}), flush=True)
    return out


# The f32 grid forwards' phases (csrc/rnn.cuh GRID_PHASE's indices).
GRID_PHASES = ("first_chunk_wait", "chunk_waits", "products", "partial_sums", "gate_math",
               "arrive", "operands", "barrier_wait")
# (cell, B, T, H, reset): the wide step, rsc15's reset shape at H = 1,000,
# ml1m_lstm's at H = 512.
GRID_F32_SHAPES = (("gru", 256, 200, 512, False), ("lstm", 256, 200, 512, False),
                   ("gru", 256, 50, 1000, True), ("lstm", 128, 200, 512, True))


def probe_grid_f32() -> dict:
    """The f32 grid forwards (gru_scan / lstm_scan, the projection included)
    at GRID_F32_SHAPES through kernel_probes_grid.cu's build of the cell's
    library with the phase clocks compiled in, in the package library's
    place: each checked against its plain version first (1e-5), then the
    cycles a step of each of GRID_PHASES in CTA 0's thread 0 (one call),
    as built (mode 0), without h's copies (1: the products on stale
    operands) and without the products (2: the copies alone), each mode's
    kernel ms (the probe's clocks included; medians of chip_smoke.time_ms),
    beside the projection alone and the package's own build."""
    import ctypes

    import numpy as np
    import torch

    import chip_smoke as cs
    from seqrec_tpu_torch.ops import _build
    from seqrec_tpu_torch.ops.cuda import gru as k_gru
    from seqrec_tpu_torch.ops.cuda import lstm as k_lstm

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(3)
    med = lambda fn: cs.time_ms(fn)["median"]  # noqa: E731
    probes = {cell: ctypes.CDLL(str(probe_build("kernel_probes_grid.cu", defines)[0]))
              for cell, defines in (("gru", ()), ("lstm", ("PROBE_LSTM",)))}
    for lib in probes.values():
        lib.grid_phase_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    out = {}
    for cell, B, T, H, reset in GRID_F32_SHAPES:
        mod = k_gru if cell == "gru" else k_lstm
        x = cs._zipf_embeddings(rng, dev, B, T, H)
        plane = cs._reset_plane(rng, B, T, dev) if reset else None
        if cell == "gru":
            w = [t.to(dev) for t in cs.gru_weights(rng, H, H)]
            args = (x, cs._state(rng, dev, B, H), *w)
            project = lambda: k_gru.gru_input_projection(x, w[0], w[2])  # noqa: E731
        else:
            w = [t.to(dev) for t in cs.lstm_weights(rng, H, H)]
            args = (x, cs._state(rng, dev, B, H), cs._state(rng, dev, B, H), *w)
            project = lambda: k_lstm.lstm_input_projection(x, w[0], w[2])  # noqa: E731
        scan = k_gru.gru_scan if cell == "gru" else k_lstm.lstm_scan
        fn = lambda: scan(*args, reset_mask=plane)  # noqa: E731
        rec = {"launch": {k: v for k, v in mod.launch_config(B, T, H, H, torch.float32).items()
                          if not isinstance(v, list)},
               "package_ms": med(fn), "projection_ms": med(project)}
        package_lib = _build.load(cell)
        _build._LIBS[cell] = probes[cell]  # the wrappers now launch the probe build
        try:
            with torch.no_grad():
                err = (fn()[0] - mod.plain(*args, reset_mask=plane)[0]).abs().max().item()
                if not err <= 1e-5:
                    raise RuntimeError(f"grid_f32 {cell} B={B} H={H}: error {err} past 1e-5")
                rec["max_abs_err"] = err
                clocks = (ctypes.c_ulonglong * 16)()
                for mode in (0, 1, 2):
                    probes[cell].grid_phase_clocks(clocks, mode)
                    ms = med(fn)
                    probes[cell].grid_phase_clocks(clocks, mode)  # reset
                    fn()
                    torch.cuda.synchronize()
                    probes[cell].grid_phase_clocks(clocks, 0)
                    rec[f"mode{mode}"] = {"ms": ms, **{name: clocks[i] / T
                                                       for i, name in enumerate(GRID_PHASES)}}
        finally:
            _build._LIBS[cell] = package_lib
        out[f"{cell}_B{B}_T{T}_H{H}" + ("_reset" if reset else "")] = rec
        del x, args, w
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="probe", required=True)
    for name, text in (("clusters", "the f32 cluster recurrences over C and R"),
                       ("xproj", "the f32 input projection's variants and its loop's parts"),
                       ("fma", "the f32 FMA GEMM's variants, splits and control"),
                       ("head", "the f32 sampled-softmax head's variants"),
                       ("scatter", "the deterministic scatter-add's chunk sizes"),
                       ("gather", "the gather's loads in flight, grid and the replaced design"),
                       ("gru_wide", "the bf16 GRU cluster layouts"),
                       ("step_gemm", "the stepped layouts' bf16 step GEMM's variants"),
                       ("xproj_bf16", "the bf16 input projection's variants"),
                       ("attention", "the Dh-cluster attention's bands, clusters and control"),
                       ("grid_f32", "the f32 grid forwards' phase clocks")):
        parser = sub.add_parser(name, help=text)
        parser.add_argument("--out", help="also write the result (indented JSON) to this file")
        if name in ("xproj_bf16", "fma"):
            parser.add_argument("--shapes", help="XP_SHAPES' (fma: FMA_SHAPES') keys, "
                                                 "comma-separated")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("kernel_probes: CUDA is not available; this script runs only on the GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    result = {"clusters": probe_clusters, "xproj": probe_xproj, "fma": probe_fma,
              "head": probe_head,
              "scatter": probe_scatter, "gather": probe_gather,
              "gru_wide": probe_gru_wide, "step_gemm": probe_step_gemm,
              "xproj_bf16": probe_xproj_bf16, "attention": probe_attention,
              "grid_f32": probe_grid_f32}[args.probe]
    shapes = getattr(args, "shapes", None)
    result = result(tuple(shapes.split(","))) if shapes else result()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(_smi(), flush=True)
    print(json.dumps({"probe": args.probe, **result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
