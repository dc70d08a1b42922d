"""Plain PyTorch building blocks of the benchmark's frozen reference.

Everything runs in the dtype of its inputs (fp32 for the reference, with
TF32 off); no kernel of the measured program is used. Inside `fp8()` the
reference is the correctness check's control: every linear and convolution
quantises its input and its weight to float8 e4m3 with one scale per tensor
before the product (attention and norms stay fp32).

`recording(list)` makes every attention call append
(kind, batch, Lq, Lk, channels, heads, needs_grad) to the list: the work list
from which the benchmark's rooflines take their bounds. `kind` is "packed"
(the spatial, cross and audio attentions), "temporal" (the motion modules)
or "vae" (the VAE's single-head mid-block attention).
"""

from __future__ import annotations

import contextlib
import math
from typing import List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

_STATE = {"precision": "fp32", "record": None, "flop_plan": False}
_ATTN_BYTES = 1 << 30  # the largest logits block one attention call materialises


@contextlib.contextmanager
def fp8():
    """Inside, every linear and convolution computes in fp8 (the control)."""
    prev = _STATE["precision"]
    _STATE["precision"] = "fp8"
    try:
        yield
    finally:
        _STATE["precision"] = prev


@contextlib.contextmanager
def recording(calls: List[tuple]):
    prev = _STATE["record"]
    _STATE["record"] = calls
    try:
        yield calls
    finally:
        _STATE["record"] = prev


@contextlib.contextmanager
def flop_plan():
    """Inside, the CFG-uncond audio branches take the program's plan: their
    context is all zero, so each branch is its output projection's bias
    through the mask and the zero conv, and the attention is not computed
    (an identity of the math, used only to count the work)."""
    prev = _STATE["flop_plan"]
    _STATE["flop_plan"] = True
    try:
        yield
    finally:
        _STATE["flop_plan"] = prev


def planning() -> bool:
    return _STATE["flop_plan"]


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """t through float8 e4m3 with one scale per tensor (amax to 448); the
    gradient passes straight through, as in fp8 training."""
    if t.device.type == "meta":
        return t
    with torch.no_grad():
        amax = t.abs().amax().float().clamp_min(1e-12)
        scale = 448.0 / amax
        q = ((t.float() * scale).to(torch.float8_e4m3fn).float() / scale).to(t.dtype)
    return t + (q - t).detach() if t.requires_grad else q


def _lowp(t: torch.Tensor) -> torch.Tensor:
    return fp8_round(t) if _STATE["precision"] == "fp8" else t


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(_lowp(x), _lowp(self.weight), self.bias)


class Conv2d(nn.Conv2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(_lowp(x), _lowp(self.weight), self.bias)


class Conv1x1Tokens(nn.Conv2d):
    """A 1x1 conv's parameters applied to (..., C) tokens."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(_lowp(x), _lowp(self.weight[:, :, 0, 0]), self.bias)


class GroupNorm(nn.GroupNorm):
    """`inflated`: x is (B, F, C, H, W) and the statistics span (F, H, W).
    The input is made contiguous first (the CPU backward of a strided
    input's weight gradient crashes in some PyTorch builds)."""

    def forward(self, x: torch.Tensor, inflated: bool = False) -> torch.Tensor:
        if inflated:
            y = F.group_norm(x.transpose(1, 2).contiguous(), self.num_groups, self.weight,
                             self.bias, self.eps)
            return y.transpose(1, 2)
        return F.group_norm(x.contiguous(), self.num_groups, self.weight, self.bias, self.eps)


class LayerNorm(nn.LayerNorm):
    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__(dim, eps=eps)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
              bias: Optional[torch.Tensor] = None, kind: str = "packed") -> torch.Tensor:
    """softmax(q k^T / sqrt(d) + bias) v over packed heads: q (N, Lq, C),
    k and v (N, Lk, C), bias (N, Lk) per key or None. Computed in blocks of
    rows so that no logits block passes `_ATTN_BYTES`."""
    n, lq, c = q.shape
    lk = k.shape[1]
    rec = _STATE["record"]
    if rec is not None:
        grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
        rec.append((kind, n, lq, lk, c, heads, grad))
    d = c // heads
    qh = q.unflatten(-1, (heads, d)).transpose(1, 2)
    kh = k.unflatten(-1, (heads, d)).transpose(1, 2)
    vh = v.unflatten(-1, (heads, d)).transpose(1, 2)
    per_row = heads * lq * lk * 4
    rows = max(1, min(n, _ATTN_BYTES // max(per_row, 1)))

    def block(qb, kb, vb, bb):
        logits = torch.matmul(qb, kb.transpose(-1, -2)) * d ** -0.5
        if bb is not None:
            logits = logits + bb[:, None, None, :]
        return torch.matmul(torch.softmax(logits, dim=-1), vb)

    # with grad, each block is recomputed in the backward pass, so that the
    # probabilities are held one block at a time
    remat = torch.is_grad_enabled() and q.requires_grad and n > rows
    outs = []
    for s in range(0, n, rows):
        args = (qh[s:s + rows], kh[s:s + rows], vh[s:s + rows],
                None if bias is None else bias[s:s + rows])
        outs.append(torch.utils.checkpoint.checkpoint(block, *args, use_reentrant=False)
                    if remat else block(*args))
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)
    return out.transpose(1, 2).flatten(2)


def timestep_embedding(t: torch.Tensor, dim: int, flip_sin_to_cos: bool = True,
                       shift: float = 0.0) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                        device=t.device) / (half - shift))
    emb = t.float()[:, None] * freqs[None]
    out = torch.cat([emb.cos(), emb.sin()] if flip_sin_to_cos else [emb.sin(), emb.cos()], -1)
    return F.pad(out, (0, 1)) if dim % 2 else out


def sinusoidal_positions(max_len: int, dim: int, device=None) -> torch.Tensor:
    pos = torch.arange(max_len, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32, device=device)
                    * (-math.log(10000.0) / dim))
    pe = torch.zeros(max_len, dim, dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


class TimestepEmbedding(nn.Module):
    def __init__(self, cin: int, dim: int):
        super().__init__()
        self.linear_1 = Linear(cin, dim)
        self.linear_2 = Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(x)))


class FeedForward(nn.Module):
    """GEGLU feed-forward: net.0.proj, net.2."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        inner = dim * mult
        geglu = nn.Module()
        geglu.proj = Linear(dim, inner * 2)
        self.net = nn.ModuleList([geglu, nn.Identity(), Linear(inner, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        value, gate = self.net[0].proj(x).chunk(2, dim=-1)
        return self.net[2](value * F.gelu(gate))


class Attention(nn.Module):
    """to_q, to_k, to_v (no bias), to_out.0."""

    def __init__(self, dim: int, heads: int, head_dim: int, context_dim: Optional[int] = None,
                 out_dim: Optional[int] = None, qkv_bias: bool = False):
        super().__init__()
        inner = heads * head_dim
        self.heads = heads
        self.to_q = Linear(dim, inner, bias=qkv_bias)
        self.to_k = Linear(context_dim or dim, inner, bias=qkv_bias)
        self.to_v = Linear(context_dim or dim, inner, bias=qkv_bias)
        self.to_out = nn.ModuleList([Linear(inner, out_dim or dim), nn.Identity()])

    def forward(self, x, context=None, bias=None, kind="packed"):
        context = x if context is None else context
        out = attention(self.to_q(x), self.to_k(context), self.to_v(context), self.heads,
                        bias, kind)
        return self.to_out[0](out)
