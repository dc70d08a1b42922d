"""Transformer blocks of the UNets (counterpart of
hallo_tpu/models/attention_blocks.py). Tokens are (B*F, L, C).

- `BasicTransformerBlock` (ReferenceNet, write side): returns its norm1
  output as the ref feature.
- `SpatialTransformerBlock` (denoiser, read side): self-attention over
  [self tokens, ref tokens]; the CFG-uncond half either runs plain
  self-attention (`cfg_split`) or masks the ref tokens with a per-key bias.
- `AudioTransformerBlock`: hierarchical 3-branch masked audio
  cross-attention with zero-init per-channel projections; with `cfg_split`
  the all-zero uncond audio collapses each branch to zero_conv(mask x bo).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from hallo_tpu_torch.models.layers import (
    CrossAttention,
    FeedForward,
    LayerNorm,
    TokenConv1x1,
)

NEG_INF = -1e9

_BRANCHES = (
    ("attn2_0", "zero_conv_full"),
    ("attn2_1", "zero_conv_face"),
    ("attn2_2", "zero_conv_lip"),
)


class BasicTransformerBlock(nn.Module):
    """norm1 -> self-attn -> norm2 -> cross-attn(context) -> norm3 -> ff.
    Also the parameters of `SpatialTransformerBlock`."""

    def __init__(self, dim: int, heads: int, head_dim: int, context_dim: int):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn1 = CrossAttention(dim, heads, head_dim)
        self.norm2 = LayerNorm(dim)
        self.attn2 = CrossAttention(dim, heads, head_dim, context_dim=context_dim)
        self.norm3 = LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        normed = self.norm1(x)
        x = x + self.attn1(normed)
        x = x + self.attn2(self.norm2(x), context)
        x = x + self.ff(self.norm3(x))
        return x, normed


class SpatialTransformerBlock(BasicTransformerBlock):
    """Denoiser spatial block with reference-feature KV injection (the
    parameters of BasicTransformerBlock, another forward)."""

    def forward(
        self,
        x: torch.Tensor,
        ref_feature: Optional[torch.Tensor],
        context: torch.Tensor,
        frames: int,
        uncond_mask: Optional[torch.Tensor] = None,
        cfg_split: bool = False,
    ) -> torch.Tensor:
        """x (B*F, L, C); ref_feature (B, Lref, C); context (B, T, Dc) or
        (B*F, T, Dc); uncond_mask (B,) marks CFG-uncond entries, whose
        queries must not see the ref tokens. `cfg_split`: the batch is the
        CFG layout [uncond B/2 | cond B/2]."""
        bf, l, c = x.shape
        b = bf // frames
        normed = self.norm1(x)
        if ref_feature is None:
            x = x + self.attn1(normed)
        elif cfg_split:
            # [uncond B/2 | cond B/2]: the uncond half never sees ref tokens,
            # so it runs plain self-attention over its own tokens.
            half = bf // 2
            out_u = self.attn1(normed[:half])
            ref_c = ref_feature[b // 2:].to(normed.dtype).repeat_interleave(frames, dim=0)
            kv_c = torch.cat([normed[half:], ref_c], dim=1)
            out_c = self.attn1(normed[half:], kv_c)
            x = x + torch.cat([out_u, out_c], dim=0)
        else:
            ref = ref_feature.to(normed.dtype).repeat_interleave(frames, dim=0)
            kv = torch.cat([normed, ref], dim=1)
            bias = None
            if uncond_mask is not None:
                blocked = uncond_mask.float().repeat_interleave(frames, dim=0)
                bias = torch.cat(
                    [torch.zeros(bf, l, device=x.device),
                     (blocked * NEG_INF)[:, None].expand(bf, ref.shape[1])],
                    dim=1,
                )
            x = x + self.attn1(normed, kv, bias=bias)

        ctx = context.repeat_interleave(frames, dim=0) if context.shape[0] == b else context
        x = x + self.attn2(self.norm2(x), ctx)
        return x + self.ff(self.norm3(x))


class AudioTransformerBlock(nn.Module):
    """Audio cross-attention block on (B*F, L, C) tokens with audio context
    (B*F, T, Da) and masks full/face/lip (B*F, L)."""

    def __init__(self, dim: int, heads: int, head_dim: int, audio_dim: int,
                 hierarchical: bool = True):
        super().__init__()
        self.hierarchical = hierarchical
        self.norm1 = LayerNorm(dim)
        self.attn1 = CrossAttention(dim, heads, head_dim, out_dim=dim)
        self.norm2 = LayerNorm(dim)
        if hierarchical:
            for attn_name, zc_name in _BRANCHES:
                setattr(self, attn_name, CrossAttention(
                    dim, heads, head_dim, context_dim=audio_dim, out_dim=dim))
                setattr(self, zc_name, TokenConv1x1(dim, dim))
        else:
            self.attn2 = CrossAttention(dim, heads, head_dim, context_dim=audio_dim,
                                        out_dim=dim)
        self.norm3 = LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(
        self,
        x: torch.Tensor,
        audio_context: torch.Tensor,
        full_mask: Optional[torch.Tensor] = None,
        face_mask: Optional[torch.Tensor] = None,
        lip_mask: Optional[torch.Tensor] = None,
        motion_scale: Optional[torch.Tensor] = None,
        cfg_split: bool = False,
    ) -> torch.Tensor:
        c = x.shape[-1]
        x = x + self.attn1(self.norm1(x))
        normed = self.norm2(x)
        half = normed.shape[0] // 2
        if cfg_split:
            normed_c, audio_c = normed[half:], audio_context[half:]
        else:
            normed_c, audio_c = normed, audio_context
        dt = normed.dtype
        if not self.hierarchical:
            out_c = self.attn2(normed_c, audio_c)
            if cfg_split:
                da = audio_context.shape[-1]
                out_u = self.attn2(
                    torch.zeros(half, 1, c, dtype=dt, device=x.device),
                    torch.zeros(half, 1, da, dtype=dt, device=x.device),
                )
                x = torch.cat([x[:half] + out_u, x[half:] + out_c], dim=0)
            else:
                x = x + out_c
            return x + self.ff(self.norm3(x))

        if motion_scale is None:
            motion_scale = torch.ones(3, device=x.device)
        acc_c = acc_u = None
        for i, ((attn_name, zc_name), mask) in enumerate(
            zip(_BRANCHES, (full_mask, face_mask, lip_mask))
        ):
            attn = getattr(self, attn_name)
            zero_conv = getattr(self, zc_name)
            h = attn(normed_c, audio_c)
            if mask is not None:
                m = mask[half:] if cfg_split else mask
                h = h * m[:, :, None].to(dt)
            scale_i = motion_scale[i].to(dt)
            h = scale_i * zero_conv(h)
            acc_c = h if acc_c is None else acc_c + h
            if cfg_split:
                # Uncond audio tokens are all zero, so softmax(.) @ to_v(0) = 0
                # and the branch output is to_out's bias bo at every token:
                # zero_conv(mask * bo), from zero_conv(bo) and zero_conv(0).
                da = audio_context.shape[-1]
                bo = attn(
                    torch.zeros(1, 1, c, dtype=dt, device=x.device),
                    torch.zeros(1, 1, da, dtype=dt, device=x.device),
                )
                zc_bo = zero_conv(bo)
                zc_0 = zero_conv(torch.zeros_like(bo))
                if mask is not None:
                    m_u = mask[:half][:, :, None].to(dt)
                    bias_u = m_u * (zc_bo - zc_0) + zc_0
                else:
                    bias_u = zc_bo
                bias_u = scale_i * bias_u
                acc_u = bias_u if acc_u is None else acc_u + bias_u
        if cfg_split:
            x = torch.cat([x[:half] + acc_u, x[half:] + acc_c], dim=0)
        else:
            x = x + acc_c
        return x + self.ff(self.norm3(x))
