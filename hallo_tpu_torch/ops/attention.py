"""Scaled dot-product attention: the plain math and the dispatch.

Counterpart of hallo_tpu/ops/attention.py. `attention_reference` is the
plain formulation (`_xla_attention`): scores and softmax in fp32, the
probabilities cast to v's dtype for the PV product. `dot_product_attention`
dispatches on the device: a CPU tensor takes the plain math, a CUDA tensor
the flash kernel (`ops.flash.flash_attention`), which raises on what it does
not take. There is no backend switch and no fallback between the two.
"""

from __future__ import annotations

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


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Heads-major attention (B, H, L, D). On the card `bias` must be a
    per-key bias (broadcastable to (B, Lk))."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, bias, scale)
    from hallo_tpu_torch.ops import flash

    return flash.flash_attention(q, k, v, bias=bias, scale=scale)
