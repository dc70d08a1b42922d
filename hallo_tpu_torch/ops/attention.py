"""Scaled dot-product attention: the plain math and the dispatch.

Counterpart of hallo_tpu/ops/attention.py. `attention_reference` is the
plain formulation (`_xla_attention`): scores and softmax in fp32, the
probabilities cast to v's dtype for the PV product. `dot_product_attention`
dispatches heads-major (B, H, L, D) attention:

- the int8 gate, on every device, exactly as the JAX package's
  (`HALLO_INT8_ATTN == "1"` read at call time, Lq >= 256, Lk >= 1024,
  d % 128 != 0, a per-key bias or none): the int8-score kernel K6
  (`flash.flash_attention_int8`), whose plain version the CPU takes;
- otherwise a CPU tensor takes the plain math and a CUDA tensor the flash
  kernel (`flash.flash_attention`: K3 when d % 128 != 0, else K4), which
  raises on what it does not take. There is no fallback between the two.
"""

from __future__ import annotations

import os
from typing import Optional

import torch


def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """q (B, H, Lq, D), k/v (B, H, Lk, D); bias an additive logits bias
    broadcastable to (B, H, Lq, Lk); scale defaults to D**-0.5."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", weights.float(), v.float())
    return out.to(v.dtype)


def _per_key(bias: Optional[torch.Tensor]) -> bool:
    """None, or a bias that varies over the batch and the keys only."""
    return bias is None or bias.ndim != 4 or (bias.shape[1] == 1 and bias.shape[2] == 1)


def int8_gate(q: torch.Tensor, k: torch.Tensor, bias: Optional[torch.Tensor]) -> bool:
    """Whether the JAX package takes the int8-score kernel K6 for this call
    (hallo_tpu/ops/attention.py:98-113, pallas_flash.py:1112-1116)."""
    lq, lk, d = q.shape[2], k.shape[2], q.shape[-1]
    return (os.environ.get("HALLO_INT8_ATTN") == "1" and lq >= 256 and lk >= 4
            and d % 128 != 0 and lk >= 1024 and _per_key(bias))


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Heads-major attention (B, H, L, D) -> (B, H, Lq, D) in v's dtype.
    On the card `bias` must be a per-key bias ((B, Lk) or (B, 1, 1, Lk))."""
    from hallo_tpu_torch.ops import flash

    flat = None if bias is None else bias.reshape(bias.shape[0], -1)
    if int8_gate(q, k, bias):
        return flash.flash_attention_int8(q, k, v, bias=flat, scale=scale)
    if q.device.type == "cpu":
        return attention_reference(q, k, v, bias, scale)
    if not _per_key(bias):
        raise ValueError(f"flash attention takes a per-key bias, not {tuple(bias.shape)}")
    return flash.flash_attention(q, k, v, bias=flat, scale=scale)
