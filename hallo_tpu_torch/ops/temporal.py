"""Frame-axis (temporal) attention: the CUDA kernel `csrc/temporal_attn.cu`
and its plain PyTorch version.

Counterpart of hallo_tpu/ops/pallas_temporal.py::temporal_attention (K2).
The JAX kernel takes site-major (B, F, C, L) I/O, a TPU lane choice; this
one takes the natural (B, F, L, C) layout of `temporal_attention_packed`
(K7), which is what the motion module's projections produce here.

A CPU tensor takes the plain version (`temporal_reference`); a CUDA tensor
launches the kernel or raises. Launches are counted in `LAUNCHES`.

Training: when grad mode is on and q, k or v needs a gradient, the call goes
through `TemporalAttentionFn`, whose backward recomputes the plain version
and differentiates it. That is JAX's `_temporal_bwd`
(pallas_temporal.py:311-317, an XLA recompute, not a kernel).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from hallo_tpu_torch.ops import _build

LAUNCHES = {"temporal_attn": 0}
MAX_FRAMES = 32  # the kernel keeps one score per frame in registers
_SITE_BUDGET = 640  # sites-per-block x head dim: ~70 KB of shared memory


def temporal_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain version: q/k/v (B, F, L, C), C = heads * d -> (B, F, L, C).
    Scores and softmax in fp32; PV with the probabilities in v's dtype."""
    b, f, l, c = q.shape
    d = c // heads
    if scale is None:
        scale = d ** -0.5
    qh, kh, vh = (t.reshape(b, f, l, heads, d) for t in (q, k, v))
    s = torch.einsum("bflhd,bglhd->blhfg", qh.float(), kh.float()) * scale
    p = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("blhfg,bglhd->bflhd", p.float(), vh.float())
    return o.to(v.dtype).reshape(b, f, l, c)


def temporal_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    heads: int,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Self-attention over the frame axis at every site: q/k/v (B, F, L, C)
    with C = heads * d. Returns (B, F, L, C)."""
    if scale is None:
        scale = (q.shape[3] // heads) ** -0.5
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return TemporalAttentionFn.apply(q, k, v, heads, scale)
    if q.device.type == "cpu":
        return temporal_reference(q, k, v, heads, scale)
    return _temporal_kernel(q, k, v, heads, scale)


def _temporal_kernel(q, k, v, heads: int, scale: float) -> torch.Tensor:
    """K2 on CUDA tensors."""
    b, f, l, c = q.shape
    d = c // heads
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"temporal attention: {name} on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"temporal attention kernel takes bf16, {name} is {t.dtype}")
        if t.shape != q.shape or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"temporal attention: {name} must be contiguous {tuple(q.shape)}")
    if f > MAX_FRAMES or d % 8:
        raise ValueError(f"temporal attention kernel: F={f} (max {MAX_FRAMES}), d={d} (multiple of 8)")
    sites = max(1, min(_SITE_BUDGET // d, 1024 // f))
    out = torch.empty_like(q)
    _build.call(
        "temporal_attn",
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, f, l, heads, d, sites,
        q.stride(0), q.stride(1), q.stride(2),
        float(scale) * math.log2(math.e),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    LAUNCHES["temporal_attn"] += 1
    return out


class TemporalAttentionFn(torch.autograd.Function):
    """K2's forward (the plain version on the CPU); the backward recomputes
    `temporal_reference` on the saved inputs and differentiates it, as JAX's
    `_temporal_bwd` does (pallas_temporal.py:311-317)."""

    @staticmethod
    def forward(ctx, q, k, v, heads, scale):
        ctx.heads, ctx.scale = heads, scale
        ctx.save_for_backward(q, k, v)
        if q.device.type == "cpu":
            return temporal_reference(q, k, v, heads, scale)
        return _temporal_kernel(q, k, v, heads, scale)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = temporal_reference(*inputs, ctx.heads, ctx.scale)
            grads = torch.autograd.grad(out, inputs, g)
        return (*grads, None, None)
