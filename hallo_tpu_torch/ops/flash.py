"""Flash-attention forward: the CUDA kernel `csrc/flash_fwd.cu` and its plain
PyTorch version.

Counterpart of hallo_tpu/ops/pallas_flash.py. One kernel serves both of its
forward layouts:

- `flash_attention_packed` (K1, `_attention_kernel_packed`): natural
  (B, L, C = heads * d) tensors -- every CrossAttention of the UNets;
- `flash_attention` (K4, `_attention_kernel`): heads-major (B, H, L, D) --
  the VAE mid-block attention (one head, d = 512).

A tensor on the CPU takes the plain version (`packed_reference`, and
`ops.attention.attention_reference` for the heads-major layout); a CUDA
tensor launches the kernel or raises. Each wrapper counts its launches in
`LAUNCHES`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from hallo_tpu_torch.ops import _build
from hallo_tpu_torch.ops.attention import attention_reference

MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
LAUNCHES = {"flash_fwd_packed": 0, "flash_fwd": 0}
_LOG2E = math.log2(math.e)


def _key_bias(bias: Optional[torch.Tensor], b: int, lk: int):
    """A per-key bias broadcastable to (B, Lk) -> (B, Lk) fp32 contiguous."""
    if bias is None:
        return None
    return bias.to(torch.float32).expand(b, lk).contiguous()


def packed_reference(q, k, v, heads: int, bias=None, scale=None):
    """Plain version of `flash_attention_packed` on natural (B, L, C)."""
    b, lq, c = q.shape
    d = c // heads

    def split(t):
        return t.reshape(t.shape[0], t.shape[1], heads, d).transpose(1, 2)

    kb = _key_bias(bias, b, k.shape[1])
    kb = None if kb is None else kb[:, None, None, :]
    out = attention_reference(split(q), split(k), split(v), kb, scale)
    return out.transpose(1, 2).reshape(b, lq, c)


def _check(q, k, v, d):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"flash attention: {name} is on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash attention kernel takes bf16, {name} is {t.dtype}")
        strides = [s for s, n in zip(t.stride()[:-1], t.shape[:-1]) if n > 1]
        if t.stride(-1) != 1 or any(s % 8 for s in strides):
            raise ValueError(f"flash attention: {name} strides {t.stride()} unsupported")
        if t.data_ptr() % 16:
            raise ValueError(f"flash attention: {name} is not 16-byte aligned")
    if not (d % 8 == 0 and (d <= 160 or d == 512)):
        raise ValueError(f"flash attention kernel: head dim {d} unsupported")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash attention: q, k, v on different devices")


def _launch(q4, k4, v4, o4, bias, scale):
    """q4/k4/v4/o4: (B, L, H, D) views (any strides, D contiguous)."""
    b, lq, h, d = q4.shape
    lk = k4.shape[1]
    if bias is not None and bias.device != q4.device:
        raise ValueError("flash attention: bias on another device than q")
    _build.call(
        "flash_fwd",
        q4.data_ptr(), k4.data_ptr(), v4.data_ptr(),
        None if bias is None else bias.data_ptr(), o4.data_ptr(),
        b, h, lq, lk, d,
        *(q4.stride(i) for i in range(3)),
        *(k4.stride(i) for i in range(3)),
        *(v4.stride(i) for i in range(3)),
        *(o4.stride(i) for i in range(3)),
        0 if bias is None else bias.stride(0),
        float(scale) * _LOG2E,
        torch.cuda.current_stream(q4.device).cuda_stream,
    )


def flash_attention_packed(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    heads: int,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention on natural (B, L, C) tensors, C = heads * d (K1). `bias`: an
    optional additive per-key logits bias broadcastable to (B, Lk). Returns
    (B, Lq, C) in q's dtype."""
    b, lq, c = q.shape
    lk = k.shape[1]
    d = c // heads
    if scale is None:
        scale = d ** -0.5
    if q.device.type == "cpu":
        return packed_reference(q, k, v, heads, bias, scale)
    _check(q, k, v, d)
    out = torch.empty((b, lq, c), dtype=q.dtype, device=q.device)

    def view(t):
        return t.unflatten(2, (heads, d))

    _launch(view(q), view(k), view(v), view(out), _key_bias(bias, b, lk), scale)
    LAUNCHES["flash_fwd_packed"] += 1
    return out


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention heads-major (K4): q (B, H, Lq, D), k/v (B, H, Lk, D), bias
    an optional per-key logits bias broadcastable to (B, Lk). Returns
    (B, H, Lq, D) in q's dtype."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    if scale is None:
        scale = d ** -0.5
    if q.device.type == "cpu":
        kb = _key_bias(bias, b, lk)
        return attention_reference(
            q, k, v, None if kb is None else kb[:, None, None, :], scale
        )
    _check(q, k, v, d)
    out = torch.empty((b, h, lq, d), dtype=q.dtype, device=q.device)
    _launch(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        out.transpose(1, 2), _key_bias(bias, b, lk), scale,
    )
    LAUNCHES["flash_fwd"] += 1
    return out
