"""Sequence towers: the port of `seqrec_tpu/models/towers.py`.

`RNNTower` maps embedded sequences [B, T, D] to per-step hidden states
[B, T, H] through the fused `ops.gru_scan` (`cell="gru"`, GRU4Rec) or
`ops.lstm_scan` (`cell="lstm"`). `SASRecTower` does it with causal
self-attention blocks through `ops.causal_attention`. Parameters keep the
flax names and layouts (`gru{l}_wx` [D_in, 3H], `gru{l}_wh` [H, 3H],
`gru{l}_bx`, `gru{l}_bh` [3H]; `lstm{l}_wx` [D_in, 4H], `lstm{l}_wh`
[H, 4H], `lstm{l}_b` [4H]; SASRec's `pos_embedding`, `block{i}/...` and
`LayerNorm_0`, dense kernels stored [in, out]), so a JAX parameter tree
loads by name.

Dropout (training only) uses flax's formula with an explicit
`torch.Generator` (`dropout`).

`SASRecTower(remat=True)` rematerializes each block (the JAX package's
`nn.remat(SASRecBlock)`): a block's activations are not kept for the
backward pass but recomputed there (`torch.utils.checkpoint`, non-reentrant).
The replay draws the same dropout masks: the block's generator state is
saved before the forward, set back for the replay, and the state the
generator had before the replay is restored after it, so the draws after
the block (and the next step's) are those of the run without remat. Values
and gradients are the same; only the memory and the work change.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from seqrec_tpu_torch import ops


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """`flax.linen.Dropout` in training mode: keep each element where a
    uniform draw falls below 1 - rate, and scale it by 1 / (1 - rate)."""
    if rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    if generator is None:
        raise ValueError("dropout in training mode needs a torch.Generator")
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


def zero_carry(cell: str, num_layers: int, batch: int, hidden: int,
               dtype: torch.dtype = torch.float32,
               device: str | torch.device = "cpu"):
    """Fresh recurrent state for a session-parallel stream: per-layer h for
    GRU, (h, c) for LSTM. Shape [batch, hidden] per leaf."""
    def z():
        return torch.zeros((batch, hidden), dtype=dtype, device=device)
    if cell == "gru":
        return tuple(z() for _ in range(num_layers))
    return tuple((z(), z()) for _ in range(num_layers))


class RNNTower(nn.Module):
    """Stacked GRU or LSTM encoder (GRU4Rec). `residual` adds a layer's
    input to its output when the widths match; the initial state is zeros
    unless a `carry` (see `zero_carry`) is given."""

    def __init__(self, embed_dim: int, hidden: int, num_layers: int = 1,
                 cell: str = "gru", residual: bool = False,
                 use_pallas: bool = True, param_dtype=torch.float32,
                 device: Optional[torch.device] = None,
                 dropout_rate: float = 0.0):
        super().__init__()
        if cell not in ("gru", "lstm"):
            raise ValueError(f"unknown rnn cell {cell!r}")
        self.cell = cell
        self.hidden = hidden
        self.num_layers = num_layers
        self.residual = residual
        self.use_pallas = use_pallas
        self.dropout_rate = dropout_rate
        G = (3 if cell == "gru" else 4) * hidden
        d_in = embed_dim
        for layer in range(num_layers):
            biases = ((f"gru{layer}_bx", (G,)), (f"gru{layer}_bh", (G,))) \
                if cell == "gru" else ((f"lstm{layer}_b", (G,)),)
            for name, shape in ((f"{cell}{layer}_wx", (d_in, G)),
                                (f"{cell}{layer}_wh", (hidden, G)), *biases):
                self.register_parameter(name, nn.Parameter(
                    torch.zeros(shape, dtype=param_dtype, device=device)))
            d_in = hidden

    def forward(self, x: torch.Tensor, mask: torch.Tensor, *, carry=None,
                reset: Optional[torch.Tensor] = None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        """Encode [B, T, D] -> [B, T, H]; with `carry`, (outputs, new_carry).
        `mask` is unused by the recurrence (pads sit at the tail), as in the
        reference. Unless `deterministic`, dropout between layers draws from
        `generator`."""
        del mask
        B = x.shape[0]
        h = x
        new_carry = []
        zeros = torch.zeros((B, self.hidden), dtype=x.dtype, device=x.device)
        for layer in range(self.num_layers):
            d_in = h.shape[-1]
            w_x = getattr(self, f"{self.cell}{layer}_wx")
            w_h = getattr(self, f"{self.cell}{layer}_wh")
            layer_carry = carry[layer] if carry is not None else None
            if self.cell == "gru":
                h0 = (zeros if layer_carry is None else layer_carry).to(h.dtype)
                y, h_last = ops.gru_scan(
                    h, h0, w_x, w_h,
                    getattr(self, f"gru{layer}_bx"), getattr(self, f"gru{layer}_bh"),
                    reset_mask=reset, use_pallas=self.use_pallas,
                )
                new_carry.append(h_last)
            else:
                h0, c0 = ((zeros, zeros) if layer_carry is None
                          else (s.to(h.dtype) for s in layer_carry))
                y, (h_last, c_last) = ops.lstm_scan(
                    h, h0, c0, w_x, w_h, getattr(self, f"lstm{layer}_b"),
                    reset_mask=reset, use_pallas=self.use_pallas,
                )
                new_carry.append((h_last, c_last))
            h = y + h if (self.residual and d_in == self.hidden) else y
            if not deterministic and layer < self.num_layers - 1:
                h = dropout(h, self.dropout_rate, generator)
        if carry is not None:
            return h, tuple(new_carry)
        return h


class LayerNorm(nn.Module):
    """`flax.linen.LayerNorm(dtype=x.dtype)`: statistics in f32 (variance as
    E[x^2] - E[x]^2, clipped at 0), epsilon 1e-6 (torch's default is 1e-5),
    the normalization, scale and bias in f32, the output in x.dtype."""

    def __init__(self, features: int, param_dtype=torch.float32,
                 device: Optional[torch.device] = None, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features, dtype=param_dtype, device=device))
        self.bias = nn.Parameter(torch.zeros(features, dtype=param_dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale.float()
        return ((xf - mean) * mul + self.bias.float()).to(x.dtype)


class Dense(nn.Module):
    """`flax.linen.Dense` / `DenseGeneral` over the last axis: `kernel`
    stored [in, *out] (flax's layout, not nn.Linear's [out, in]), `bias`
    [*out]; the product and the bias add in x.dtype."""

    def __init__(self, in_features: int, out_shape, param_dtype=torch.float32,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.out_shape = tuple(out_shape)
        self.kernel = nn.Parameter(torch.zeros((in_features, *self.out_shape),
                                               dtype=param_dtype, device=device))
        self.bias = nn.Parameter(torch.zeros(self.out_shape, dtype=param_dtype,
                                             device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.kernel.to(x.dtype).reshape(self.kernel.shape[0], -1)
        y = (x @ w).reshape(*x.shape[:-1], *self.out_shape)
        return y + self.bias.to(x.dtype)


class SASRecBlock(nn.Module):
    """One SASRec transformer block: pre-LN causal multi-head attention and a
    pointwise feed-forward net, each with dropout and a residual."""

    def __init__(self, hidden: int, num_heads: int, mlp_dim: int,
                 dropout_rate: float, use_pallas: bool = True,
                 param_dtype=torch.float32, device: Optional[torch.device] = None):
        super().__init__()
        if hidden % num_heads != 0:
            raise ValueError(f"hidden {hidden} is not a multiple of num_heads {num_heads}")
        self.num_heads = num_heads
        self.dropout_rate = dropout_rate
        self.use_pallas = use_pallas
        Dh = hidden // num_heads
        kw = dict(param_dtype=param_dtype, device=device)
        self.LayerNorm_0 = LayerNorm(hidden, **kw)
        self.qkv = Dense(hidden, (3, num_heads, Dh), **kw)
        self.proj = Dense(num_heads * Dh, (hidden,), **kw)
        self.LayerNorm_1 = LayerNorm(hidden, **kw)
        self.Dense_0 = Dense(hidden, (mlp_dim,), **kw)
        self.Dense_1 = Dense(mlp_dim, (hidden,), **kw)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        B, T, _ = x.shape

        def drop(y):
            return y if deterministic else dropout(y, self.dropout_rate, generator)

        qkv = self.qkv(self.LayerNorm_0(x))  # [B, T, 3, N, Dh]
        attn = ops.causal_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                                    use_pallas=self.use_pallas)
        x = x + drop(self.proj(attn.reshape(B, T, -1)))
        y = drop(torch.relu(self.Dense_0(self.LayerNorm_1(x))))
        return x + drop(self.Dense_1(y))


class SASRecTower(nn.Module):
    """SASRec encoder (Kang & McAuley, ICDM'18): the input scaled by
    sqrt(hidden) plus learned positional embeddings, dropout, then causal
    self-attention blocks and a final LayerNorm. Pad positions (mask 0) are
    zeroed after the input and after every block; their outputs are garbage
    that the loss mask and the serving path drop. Position t never sees
    items after t."""

    def __init__(self, hidden: int, num_layers: int, num_heads: int, mlp_dim: int,
                 max_len: int, dropout_rate: float = 0.1, use_pallas: bool = True,
                 remat: bool = False, param_dtype=torch.float32,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.remat = remat
        self.hidden = hidden
        self.max_len = max_len
        self.dropout_rate = dropout_rate
        self.pos_embedding = nn.Parameter(
            torch.zeros((max_len, hidden), dtype=param_dtype, device=device))
        for i in range(num_layers):
            self.add_module(f"block{i}", SASRecBlock(
                hidden, num_heads, mlp_dim, dropout_rate, use_pallas,
                param_dtype=param_dtype, device=device))
        self.num_layers = num_layers
        self.LayerNorm_0 = LayerNorm(hidden, param_dtype=param_dtype, device=device)

    def forward(self, x: torch.Tensor, mask: torch.Tensor, *,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Encode [B, T, H] -> [B, T, H]; T <= max_len. Unless
        `deterministic`, dropout draws from `generator`."""
        T = x.shape[1]
        if T > self.max_len:
            raise ValueError(f"sasrec: sequence length {T} > max_len {self.max_len}")
        x = x * (self.hidden ** 0.5) + self.pos_embedding[None, :T].to(x.dtype)
        if not deterministic:
            x = dropout(x, self.dropout_rate, generator)
        keep = mask[:, :, None].to(x.dtype)
        x = x * keep
        for i in range(self.num_layers):
            block = getattr(self, f"block{i}")
            if self.remat and torch.is_grad_enabled():
                x = _remat_block(block, x, deterministic, generator)
            else:
                x = block(x, deterministic, generator)
            x = x * keep
        return self.LayerNorm_0(x)


def _remat_block(block: nn.Module, x: torch.Tensor, deterministic: bool,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
    """`block(x, deterministic, generator)` with its activations recomputed
    in the backward pass. The first call is the forward; any later one is
    the replay, which
    - runs on the parameter tensors the forward saw (the trainer's
      `functional_call` has put the module's own back by then);
    - draws from the generator state the forward started from, and then
      gives the generator back the state it had (also when the replay stops
      early, once every saved tensor is recomputed).
    All draws come from `generator`, so the global RNG states are not
    saved."""
    params = dict(block.named_parameters())
    saved = None if generator is None else generator.get_state()
    calls = [0]

    def run(inp):
        calls[0] += 1
        if calls[0] == 1:
            return block(inp, deterministic, generator)
        now = None if saved is None else generator.get_state()
        if saved is not None:
            generator.set_state(saved)
        try:
            return torch.func.functional_call(block, params, (inp, deterministic, generator))
        finally:
            if now is not None:
                generator.set_state(now)

    return checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)
