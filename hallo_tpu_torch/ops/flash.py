"""Flash attention: the CUDA kernels `csrc/flash_fwd.cu`,
`csrc/flash_int8.cu` and `csrc/flash_bwd.cu`, and their plain PyTorch
versions.

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

Training: when grad mode is on and q, k or v needs a gradient,
`flash_attention_packed` runs `FlashPackedFn` (JAX's `_flash_packed`
custom_vjp): K1's forward that also stores the base-2 logsumexp, and K5
(`_dkv_kernel_packed`, `_dq_kernel_packed`) as the two passes of
`csrc/flash_bwd.cu` in its backward (`flash_backward`). The bias gets no
gradient, as in JAX. Without a gradient to take, the inference path is
unchanged.

A tensor on the CPU takes the plain version (`packed_reference`,
`flash_lse_reference`, `flash_backward_reference`,
`ops.attention.attention_reference`, `int8_reference`); a CUDA tensor
launches the kernel or raises. K3, K4 and K6 have no backward kernel, so
on the card they raise when grad mode is on and an input needs a gradient
(their output would carry none). Each wrapper counts its launches in
`LAUNCHES`.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from hallo_tpu_torch.ops import _build
from hallo_tpu_torch.ops.attention import attention_reference

MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
LAUNCHES = {"flash_fwd_packed": 0, "flash_fwd_t": 0, "flash_fwd": 0, "flash_int8": 0,
            "flash_bwd_dkv": 0, "flash_bwd_dq": 0}
_LOG2E = math.log2(math.e)
_LN2 = math.log(2.0)


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


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _forward_only(what: str, *tensors) -> None:
    """Raise where a kernel without a backward is given a tensor that needs
    a gradient: autograd would not see the kernel's output."""
    if _needs_grad(*tensors):
        raise RuntimeError(f"{what}: the kernel has no backward; call it under "
                           "torch.no_grad() or on tensors that need no gradient")


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


def _launch(q4, k4, v4, o4, bias, scale, lse=None):
    """q4/k4/v4/o4: (B, L, H, D) views (any strides, D contiguous); lse an
    optional fp32 (B, H, Lq) output."""
    b, lq, h, d = q4.shape
    lk = k4.shape[1]
    if bias is not None and bias.device != q4.device:
        raise ValueError("flash attention: bias on another device than q")
    _build.call(
        "flash_fwd",
        q4.data_ptr(), k4.data_ptr(), v4.data_ptr(),
        None if bias is None else bias.data_ptr(), o4.data_ptr(),
        None if lse is None else lse.data_ptr(),
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
    (B, Lq, C) in q's dtype. When grad mode is on and q, k or v needs a
    gradient, the call goes through `FlashPackedFn` (K1 with its LSE, then
    K5 in the backward)."""
    d = q.shape[2] // heads
    if scale is None:
        scale = d ** -0.5
    if _needs_grad(q, k, v):
        return FlashPackedFn.apply(q, k, v, bias, heads, scale)
    if q.device.type == "cpu":
        return packed_reference(q, k, v, heads, bias, scale)
    return flash_forward_packed(q, k, v, heads, bias, scale)[0]


def flash_forward_packed(q, k, v, heads: int, bias=None, scale=None, with_lse: bool = False):
    """K1 on CUDA tensors: (out (B, Lq, C), lse (B, H, Lq) fp32 or None).
    Forward only: `flash_attention_packed` differentiates it."""
    b, lq, c = q.shape
    lk = k.shape[1]
    d = c // heads
    if scale is None:
        scale = d ** -0.5
    _forward_only("flash_forward_packed", q, k, v)
    _check(q, k, v, d)
    out = torch.empty((b, lq, c), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, heads, lq), dtype=torch.float32, device=q.device)
           if with_lse else None)

    def view(t):
        return t.unflatten(2, (heads, d))

    _launch(view(q), view(k), view(v), view(out), _key_bias(bias, b, lk), scale, lse)
    LAUNCHES["flash_fwd_packed"] += 1
    return out, lse


def _split_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, L, C) -> (B, H, L, d) fp32."""
    return t.float().unflatten(2, (heads, t.shape[2] // heads)).transpose(1, 2)


def _log2_logits(q, k, heads, bias, scale):
    """The forward's logits in log2 units, fp32 (B, H, Lq, Lk):
    (q . k) * scale * log2(e) + bias * log2(e) (MASK_VALUE x log2(e)
    overflows to -inf, as in the kernels)."""
    s = torch.einsum("bhqd,bhkd->bhqk", _split_heads(q, heads), _split_heads(k, heads))
    s = s * (scale * _LOG2E)
    kb = _key_bias(bias, q.shape[0], k.shape[1])
    if kb is not None:
        s = s + (kb * _LOG2E)[:, None, None, :]
    return s


def flash_lse_reference(q, k, heads: int, bias=None, scale=None) -> torch.Tensor:
    """Plain version of K1's LSE output: the base-2 logsumexp of each row of
    logits, fp32 (B, H, Lq); -MASK_VALUE where every key is masked (JAX's
    `with_lse`, pallas_flash.py:311-318)."""
    if scale is None:
        scale = (q.shape[2] // heads) ** -0.5
    lse = torch.logsumexp(_log2_logits(q, k, heads, bias, scale) * _LN2, dim=-1) * _LOG2E
    return torch.where(lse > -math.inf, lse, torch.full_like(lse, -MASK_VALUE))


def flash_backward_reference(q, k, v, bias, out, lse, g, heads: int, scale=None):
    """Plain version of K5: the two-pass recurrence of `csrc/flash_bwd.cu` in
    fp32 torch ops, from the forward's output `out` and base-2 `lse`
    (B, H, Lq) and the output's gradient `g`. Returns (dq, dk, dv) in the
    dtypes of q, k, v. The bias gets no gradient."""
    if scale is None:
        scale = (q.shape[2] // heads) ** -0.5
    p = torch.exp2(_log2_logits(q, k, heads, bias, scale) - lse.float()[..., None])
    gh, vh = _split_heads(g, heads), _split_heads(v, heads)
    delta = (gh * _split_heads(out, heads)).sum(-1)  # (B, H, Lq)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, gh)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", gh, vh) - delta[..., None])
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, _split_heads(k, heads)) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, _split_heads(q, heads)) * scale

    def merge(t, like):
        return t.transpose(1, 2).reshape(like.shape).to(like.dtype)

    return merge(dq, q), merge(dk, k), merge(dv, v)


class BackwardArgs(NamedTuple):
    """K5's checked inputs: contiguous q, k, v, g of one type, the fp32
    per-key bias (or None), lse and Delta = rowsum(g * out), (B, H, Lq)."""

    q: torch.Tensor
    k: torch.Tensor
    v: torch.Tensor
    g: torch.Tensor
    bias: Optional[torch.Tensor]
    lse: torch.Tensor
    delta: torch.Tensor
    heads: int
    scale: float


def backward_args(q, k, v, bias, out, lse, g, heads: int, scale=None) -> BackwardArgs:
    """Check K5's CUDA inputs and compute Delta = rowsum(g * out) in fp32
    torch ops, as JAX computes it in XLA outside its kernels
    (pallas_flash.py:579-581)."""
    b, lq, c = q.shape
    d = c // heads
    if scale is None:
        scale = d ** -0.5
    q, k, v, g = (t.contiguous() for t in (q, k, v, g.to(q.dtype)))
    _check(q, k, v, d)
    _check_16b("g", g)
    if d > 160:
        raise ValueError(f"flash attention backward kernel: head dim {d} unsupported")
    for name, t in (("out", out), ("lse", lse), ("g", g)):
        if t.device != q.device:
            raise ValueError(f"flash attention backward: {name} on {t.device}, q on {q.device}")
    kb = _key_bias(bias, b, k.shape[1])
    if kb is not None and kb.device != q.device:
        raise ValueError("flash attention backward: bias on another device than q")
    delta = (g.float() * out.float()).unflatten(2, (heads, d)).sum(-1).transpose(1, 2)
    return BackwardArgs(q, k, v, g, kb, lse.float().contiguous(), delta.contiguous(), heads,
                        float(scale))


def _bwd_call(entry: str, a: BackwardArgs, *outputs: torch.Tensor) -> None:
    b, lq, c = a.q.shape
    _build.call(
        entry,
        a.q.data_ptr(), a.k.data_ptr(), a.v.data_ptr(), a.g.data_ptr(),
        None if a.bias is None else a.bias.data_ptr(), a.lse.data_ptr(), a.delta.data_ptr(),
        *(t.data_ptr() for t in outputs),
        b, a.heads, lq, a.k.shape[1], c // a.heads, a.scale, a.scale * _LOG2E,
        _DTYPES[a.q.dtype], torch.cuda.current_stream(a.q.device).cuda_stream,
    )


def flash_bwd_dkv(a: BackwardArgs) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5's dK/dV pass (`_dkv_kernel_packed`): (dk, dv)."""
    dk, dv = torch.empty_like(a.k), torch.empty_like(a.v)
    _bwd_call("flash_bwd_dkv", a, dk, dv)
    LAUNCHES["flash_bwd_dkv"] += 1
    return dk, dv


def flash_bwd_dq(a: BackwardArgs) -> torch.Tensor:
    """K5's dQ pass (`_dq_kernel_packed`)."""
    dq = torch.empty_like(a.q)
    _bwd_call("flash_bwd_dq", a, dq)
    LAUNCHES["flash_bwd_dq"] += 1
    return dq


def flash_backward(q, k, v, bias, out, lse, g, heads: int, scale=None):
    """K5 on CUDA tensors: the two passes of `csrc/flash_bwd.cu` from the
    forward's `out` and `lse`. Returns (dq, dk, dv)."""
    a = backward_args(q, k, v, bias, out, lse, g, heads, scale)
    dk, dv = flash_bwd_dkv(a)
    return flash_bwd_dq(a), dk, dv


class FlashPackedFn(torch.autograd.Function):
    """K1 with its LSE forward and K5 backward (JAX's `_flash_packed`
    custom_vjp, pallas_flash.py:701-742). On the CPU both directions take
    the plain versions. The residuals are JAX's: q, k, v, bias, out, lse.
    The bias (a constant mask) gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, bias, heads, scale):
        if q.device.type == "cpu":
            out = packed_reference(q, k, v, heads, bias, scale)
            lse = flash_lse_reference(q, k, heads, bias, scale)
        else:
            out, lse = flash_forward_packed(q, k, v, heads, bias, scale, with_lse=True)
        ctx.heads, ctx.scale = heads, scale
        ctx.save_for_backward(q, k, v, bias, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, out, lse = ctx.saved_tensors
        fn = flash_backward_reference if q.device.type == "cpu" else flash_backward
        dq, dk, dv = fn(q, k, v, bias, out, lse, g, ctx.heads, ctx.scale)
        return dq, dk, dv, None, None, None


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
    precision); softmax and accumulation are fp32 either way. Forward only:
    on the card, an input that needs a gradient raises."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    if scale is None:
        scale = d ** -0.5
    if q.device.type == "cpu":
        kb = _key_bias(bias, b, lk)
        return attention_reference(
            q, k, v, None if kb is None else kb[:, None, None, :], scale
        )
    _forward_only("flash_attention", q, k, v)
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
    prelude (`quantize_int8`), then the kernel (`flash_int8_quantized`).
    Forward only: on the card, an input that needs a gradient raises."""
    d = q.shape[-1]
    if scale is None:
        scale = d ** -0.5
    if q.device.type == "cpu":
        return int8_reference(q, k, v, bias, scale)
    _forward_only("flash_attention_int8", q, k, v)
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
    _forward_only("flash_int8_quantized", qs, ks, v)
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
