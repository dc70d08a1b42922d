"""Per-resolution attention stages (counterpart of
hallo_tpu/models/transformer_spatial.py): GN -> 1x1 proj_in -> transformer
block -> 1x1 proj_out + residual, with frames folded into the batch. The
1x1 projections keep the reference's Conv2d parameters and run as
token-wise linears (`TokenConv1x1`)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from hallo_tpu_torch.models.attention_blocks import (
    AudioTransformerBlock,
    BasicTransformerBlock,
    SpatialTransformerBlock,
)
from hallo_tpu_torch.models.layers import GroupNorm, TokenConv1x1


def to_tokens(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N, H*W, C)."""
    return x.flatten(2).transpose(1, 2)


def from_tokens(t: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(N, H*W, C) -> (N, C, H, W)."""
    return t.transpose(1, 2).unflatten(2, (h, w))


class _Stage(nn.Module):
    """norm / proj_in / transformer_blocks / proj_out around `blocks`."""

    def __init__(self, channels: int, inner: int, groups: int, block: nn.Module):
        super().__init__()
        self.norm = GroupNorm(groups, channels, eps=1e-6)
        self.proj_in = TokenConv1x1(channels, inner)
        self.transformer_blocks = nn.ModuleList([block])
        self.proj_out = TokenConv1x1(inner, channels)

    def _in(self, x2: torch.Tensor) -> torch.Tensor:
        return self.proj_in(to_tokens(self.norm(x2)))

    def _out(self, hs: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        h, w = residual.shape[-2:]
        return from_tokens(self.proj_out(hs), h, w) + residual


class SpatialTransformer(_Stage):
    """Spatial self + cross attention stage of the denoiser (read side)."""

    def __init__(self, channels: int, heads: int, head_dim: int, context_dim: int,
                 groups: int = 32):
        inner = heads * head_dim
        super().__init__(channels, inner, groups, SpatialTransformerBlock(
            inner, heads, head_dim, context_dim))

    def forward(
        self,
        x: torch.Tensor,
        ref_feature: Optional[torch.Tensor],
        context: torch.Tensor,
        uncond_mask: Optional[torch.Tensor] = None,
        cfg_split: bool = False,
    ) -> torch.Tensor:
        f = x.shape[1]
        x2 = x.flatten(0, 1)
        hs = self.transformer_blocks[0](
            self._in(x2), ref_feature, context, f, uncond_mask, cfg_split
        )
        return self._out(hs, x2).unflatten(0, (-1, f))


class ReferenceTransformer(_Stage):
    """Spatial stage of the 2D ReferenceNet (write side): also returns the
    block's normed hidden states (the ref feature)."""

    def __init__(self, channels: int, heads: int, head_dim: int, context_dim: int,
                 groups: int = 32):
        inner = heads * head_dim
        super().__init__(channels, inner, groups, BasicTransformerBlock(
            inner, heads, head_dim, context_dim))

    def forward(self, x: torch.Tensor, context: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        hs, ref = self.transformer_blocks[0](self._in(x), context)
        return self._out(hs, x), ref


class AudioTransformer(_Stage):
    """Hierarchical audio cross-attention stage. `inner` is the reference's
    head-dim quirk (proj_in maps C -> inner, unet_3d_blocks.py:585-605)."""

    def __init__(self, channels: int, heads: int, inner: int, audio_dim: int,
                 groups: int = 32, hierarchical: bool = True):
        super().__init__(channels, inner, groups, AudioTransformerBlock(
            inner, heads, inner // heads, audio_dim, hierarchical=hierarchical))

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
        """x (B, F, C, H, W); audio_context (B, F, T, Da)."""
        f = x.shape[1]
        x2 = x.flatten(0, 1)
        audio = audio_context.flatten(0, 1)
        hs = self.transformer_blocks[0](
            self._in(x2), audio, full_mask, face_mask, lip_mask, motion_scale,
            cfg_split,
        )
        return self._out(hs, x2).unflatten(0, (-1, f))
