"""Flash-attention forward: the CUDA kernels `csrc/flash_fwd.cu` and
`csrc/flash_int8.cu`, and their plain PyTorch versions.

Counterpart of hallo_tpu/ops/pallas_flash.py. One kernel, `flash_fwd.cu`,
serves its three forward layouts; it reads (batch, token, head) strides:

- `flash_attention_packed` (K1, `_attention_kernel_packed`): natural
  (B, L, C = heads * d) tensors -- every CrossAttention of the UNets, bf16;
- `flash_attention` heads-major (B, H, L, D): K3 (`_attention_kernel_t`)
  when d % 128 != 0 -- the wav2vec2 self-attention, d = 64, fp32 I/O -- and
  K4 (`_attention_kernel`) otherwise -- the VAE mid-block attention (one
  head, d = 512, bf16). The TPU's transposed scores of K3 were an MXU layout
  choice; on the card K3 and K4 are the same function and the same kernel,
  and only the launch counts tell them apart, by JAX's rule.

`flash_attention_int8` (K6, `_attention_kernel_t_q8`) is the int8-score
variant: the quantisation prelude in plain torch ops (XLA outside the
Pallas call in JAX), then `flash_int8.cu`.

A tensor on the CPU takes the plain version (`packed_reference`,
`ops.attention.attention_reference`, `int8_reference`); a CUDA tensor
launches the kernel or raises. Each wrapper counts its launches in
`LAUNCHES`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from hallo_tpu_torch.ops import _build
from hallo_tpu_torch.ops.attention import attention_reference

MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
LAUNCHES = {"flash_fwd_packed": 0, "flash_fwd_t": 0, "flash_fwd": 0, "flash_int8": 0}
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


_DTYPES = {torch.bfloat16: 0, torch.float32: 1}  # the kernels' I/O type codes


def _check_16b(name: str, t: torch.Tensor) -> None:
    """Innermost axis contiguous; every other stride and the base address
    on 16 bytes (the kernels' vector loads)."""
    per16 = 16 // t.element_size()
    strides = [s for s, n in zip(t.stride()[:-1], t.shape[:-1]) if n > 1]
    if t.stride(-1) != 1 or any(s % per16 for s in strides):
        raise ValueError(f"flash attention: {name} strides {t.stride()} unsupported")
    if t.data_ptr() % 16:
        raise ValueError(f"flash attention: {name} is not 16-byte aligned")


def _check(q, k, v, d):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"flash attention: {name} is on {t.device}, q on {q.device}")
        if t.dtype not in _DTYPES or t.dtype != q.dtype:
            raise TypeError(f"flash attention kernel takes bf16 or fp32 q/k/v of one "
                            f"type, {name} is {t.dtype}, q {q.dtype}")
        _check_16b(name, t)
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
        _DTYPES[q4.dtype],
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
    """Attention heads-major (K3 when D % 128 != 0, else K4): q (B, H, Lq, D),
    k/v (B, H, Lk, D) in bf16 or fp32, bias an optional per-key logits bias
    broadcastable to (B, Lk). Returns (B, H, Lq, D) in q's dtype. fp32 q/k/v
    are rounded to bf16 for the tensor cores (the TPU MXU's default
    precision); softmax and accumulation are fp32 either way."""
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
    LAUNCHES["flash_fwd_t" if d % 128 else "flash_fwd"] += 1
    return out


def quantize_int8(q: torch.Tensor, k: torch.Tensor, scale: float):
    """K6's prelude (pallas_flash.py:886-895): K mean-smoothed over the keys
    (a per-query-row shift of the scores, which cancels in the softmax),
    per-row absmax scales (floor 1e-8), round half to even, clip to +-127.
    scale * log2(e) rides in the Q scales. Returns int8 (B, H, L, D) q and k
    (contiguous) and their fp32 (B, H, L) scales."""
    qf = q.float()
    kf = k.float()
    kf = kf - kf.mean(dim=2, keepdim=True)
    qs = torch.clamp(qf.abs().amax(dim=3, keepdim=True) / 127.0, min=1e-8)
    ks = torch.clamp(kf.abs().amax(dim=3, keepdim=True) / 127.0, min=1e-8)
    q8 = torch.clamp(torch.round(qf / qs), -127, 127).to(torch.int8)
    k8 = torch.clamp(torch.round(kf / ks), -127, 127).to(torch.int8)
    qs = (qs * (scale * _LOG2E))[..., 0]
    return (q8.contiguous(), k8.contiguous(), qs.contiguous(), ks[..., 0].contiguous())


def int8_reference(q, k, v, bias=None, scale=None):
    """Plain version of `flash_attention_int8`: the same prelude, then fp32
    products of the integer-valued q and k (exact for the kernel's head dims:
    |sum| <= 160 * 127^2 < 2^24), the same dequantisation, base-2 softmax
    and PV in fp32. A row whose keys are all masked gives 0."""
    b, h, lq, d = q.shape
    if scale is None:
        scale = d ** -0.5
    q8, k8, qs, ks = quantize_int8(q, k, scale)
    s = torch.einsum("bhqd,bhkd->bhqk", q8.float(), k8.float())
    s = s * ks[:, :, None, :] * qs[:, :, :, None]
    kb = _key_bias(bias, b, k.shape[2])
    if kb is not None:
        s = s + (kb * _LOG2E)[:, None, None, :]
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - torch.where(torch.isfinite(m), m, torch.zeros_like(m)))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    out = out / torch.where(l > 0, l, torch.ones_like(l))
    return out.to(v.dtype)


def flash_attention_int8(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Heads-major attention with int8 QK^T scores (K6): q (B, H, Lq, D),
    k/v (B, H, Lk, D), bias an optional per-key logits bias broadcastable
    to (B, Lk). Returns (B, H, Lq, D) in v's dtype (bf16 or fp32): the
    prelude (`quantize_int8`), then the kernel (`flash_int8_quantized`)."""
    d = q.shape[-1]
    if scale is None:
        scale = d ** -0.5
    if q.device.type == "cpu":
        return int8_reference(q, k, v, bias, scale)
    for name, t in (("q", q), ("k", k)):
        if not t.is_cuda or t.device != v.device:
            raise ValueError(f"int8 flash attention: {name} on {t.device}, v on {v.device}")
    return flash_int8_quantized(*quantize_int8(q, k, scale), v, bias=bias)


def flash_int8_quantized(
    q8: torch.Tensor,
    k8: torch.Tensor,
    qs: torch.Tensor,
    ks: torch.Tensor,
    v: torch.Tensor,
    *,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The K6 kernel on `quantize_int8`'s output: q8/k8 int8 (B, H, L, D)
    and their fp32 (B, H, L) scales (contiguous), v (B, H, Lk, D) bf16 or
    fp32, bias as for `flash_attention_int8`. CUDA tensors only."""
    b, h, lq, d = q8.shape
    lk = k8.shape[2]
    for name, t in (("q8", q8), ("k8", k8), ("qs", qs), ("ks", ks), ("v", v)):
        if not t.is_cuda or t.device != v.device:
            raise ValueError(f"int8 flash attention: {name} on {t.device}, v on {v.device}")
    for name, t, dtype in (("q8", q8, torch.int8), ("k8", k8, torch.int8),
                           ("qs", qs, torch.float32), ("ks", ks, torch.float32)):
        if t.dtype != dtype or not t.is_contiguous():
            raise TypeError(f"int8 flash attention: {name} must be contiguous {dtype}")
    if v.dtype not in _DTYPES:
        raise TypeError(f"int8 flash attention kernel takes bf16 or fp32 v, not {v.dtype}")
    _check_16b("v", v)
    if d % 8 or d > 160:
        raise ValueError(f"int8 flash attention kernel: head dim {d} unsupported")
    kb = _key_bias(bias, b, lk)
    if kb is not None and kb.device != v.device:
        raise ValueError("int8 flash attention: bias on another device than v")
    out = torch.empty((b, h, lq, d), dtype=v.dtype, device=v.device)
    _build.call(
        "flash_int8",
        q8.data_ptr(), k8.data_ptr(), v.data_ptr(),
        None if kb is None else kb.data_ptr(), qs.data_ptr(), ks.data_ptr(),
        out.data_ptr(),
        b, h, lq, lk, d, _DTYPES[v.dtype],
        v.stride(0), v.stride(1), v.stride(2),
        0 if kb is None else kb.stride(0),
        torch.cuda.current_stream(v.device).cuda_stream,
    )
    LAUNCHES["flash_int8"] += 1
    return out
