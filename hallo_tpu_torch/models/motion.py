"""AnimateDiff-style temporal motion module (counterpart of
hallo_tpu/models/motion.py; reference motion_module.py). Attention runs over
the frame axis at every spatial site, on (B, T, L, C) with the sinusoidal
positional encoding added to the normed sequence; ReferenceNet motion-frame
features are concatenated ahead of the clip on the time axis and sliced off
afterwards. Parameters follow the reference's
`temporal_transformer.*` keys; the PE table is computed, not stored. With
`remat_inner`, each temporal attention and the feed-forward (over 4 chunks
of the site axis) are recomputed on their own in the backward pass
(hallo_tpu/models/motion.py:134-160).

Clip parallelism (a process `group`, hallo_tpu's `seq_axis`): every other
layer of the denoiser is frame-local, so the clip's frames are split over
the group's ranks and only this module crosses them. After the per-frame
GroupNorm and proj_in (which shrinks the channels first), an all_to_all
turns this rank's frames at every site into every frame at this rank's
1/n of the sites, (B, f, L, C') -> (B, f*n, L/n, C'); the motion-frame
features are sliced to the same sites; the temporal blocks attend over the
whole clip; the motion frames come off and a second all_to_all returns
the frames before proj_out and the residual
(hallo_tpu/models/motion.py:121-131, :163-167)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from hallo_tpu_torch.config import MotionModuleConfig
from hallo_tpu_torch.models.layers import (
    FeedForward,
    GroupNorm,
    LayerNorm,
    TemporalSelfAttention,
    maybe_checkpoint,
    sinusoidal_positions,
)
from hallo_tpu_torch.parallel.collectives import all_to_all, local_slice


class TemporalAttention(TemporalSelfAttention):
    """Frame-axis self-attention with the sinusoidal PE added to its input."""

    def __init__(self, dim: int, heads: int, head_dim: int, max_len: int = 32,
                 use_pe: bool = True):
        super().__init__(dim, heads, head_dim)
        self.max_len = max_len
        self.use_pe = use_pe

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t, c = x.shape[1], x.shape[-1]
        if self.use_pe:
            if t > self.max_len:
                raise ValueError(
                    f"temporal PE max_len={self.max_len} < sequence length {t} "
                    "(clip frames + motion frames)"
                )
            pe = sinusoidal_positions(self.max_len, c, device=x.device)[:t]
            x = x + pe[None, :, None, :].to(x.dtype)
        return super().forward(x)


class _TemporalBlock(nn.Module):
    def __init__(self, dim: int, heads: int, head_dim: int, cfg: MotionModuleConfig,
                 remat_inner: bool = False):
        super().__init__()
        self.remat_inner = remat_inner
        n = len(cfg.attention_block_types)
        if any(t != "Temporal_Self" for t in cfg.attention_block_types):
            raise ValueError(f"attention_block_types {cfg.attention_block_types}: "
                             "the motion module has Temporal_Self blocks only")
        self.attention_blocks = nn.ModuleList([
            TemporalAttention(dim, heads, head_dim,
                              cfg.temporal_position_encoding_max_len,
                              cfg.temporal_position_encoding)
            for _ in range(n)
        ])
        self.norms = nn.ModuleList([LayerNorm(dim) for _ in range(n)])
        # the feed-forward over (B, T, L, C) chunks the sites L by 4 when they
        # divide (FeedForward runs it unchunked otherwise)
        self.ff = FeedForward(dim, chunks=4 if remat_inner else 1)
        self.ff_norm = LayerNorm(dim)

    def forward(self, hs: torch.Tensor) -> torch.Tensor:
        for attn, norm in zip(self.attention_blocks, self.norms):
            hs = hs + maybe_checkpoint(self.remat_inner, lambda z, a=attn, n=norm: a(n(z)), hs)
        return hs + maybe_checkpoint(self.remat_inner, lambda z: self.ff(self.ff_norm(z)), hs)


class _TemporalTransformer(nn.Module):
    def __init__(self, channels: int, cfg: MotionModuleConfig, remat_inner: bool = False):
        super().__init__()
        heads = cfg.num_attention_heads
        head_dim = channels // heads // cfg.temporal_attention_dim_div
        inner = heads * head_dim
        self.norm = GroupNorm(cfg.norm_num_groups, channels, eps=1e-6)
        self.proj_in = nn.Linear(channels, inner)
        self.transformer_blocks = nn.ModuleList([
            _TemporalBlock(inner, heads, head_dim, cfg, remat_inner)
            for _ in range(cfg.num_transformer_block)
        ])
        self.proj_out = nn.Linear(inner, channels)
        nn.init.zeros_(self.proj_out.weight)
        nn.init.zeros_(self.proj_out.bias)


class MotionModule(nn.Module):
    """GN -> proj_in -> temporal blocks -> zero-init proj_out + residual."""

    def __init__(self, channels: int, cfg: MotionModuleConfig, remat_inner: bool = False):
        super().__init__()
        self.temporal_transformer = _TemporalTransformer(channels, cfg, remat_inner)

    def forward(self, x: torch.Tensor, motion_feats: Optional[torch.Tensor] = None,
                group=None) -> torch.Tensor:
        """x (B, F, C, H, W); motion_feats (B, M, L, C) per-site ReferenceNet
        motion-frame features (every site, on every rank), or None; `group`:
        the ranks the clip's frames are split over (F is this rank's
        share), or None."""
        tt = self.temporal_transformer
        b, f, c, h, w = x.shape
        l = h * w

        def prep(z: torch.Tensor) -> torch.Tensor:
            # (B, T, C, H, W) -> (B, T, L, C'): per-frame GN + proj_in
            zn = tt.norm(z.flatten(0, 1)).unflatten(0, (b, -1))
            return tt.proj_in(zn.flatten(3).transpose(2, 3))

        if motion_feats is not None and motion_feats.shape[1] == 0:
            motion_feats = None
        hs = prep(x)
        if group is not None:
            hs = all_to_all(hs, group, split_dim=2, concat_dim=1)  # (B, F*n, L/n, C')
        m = 0
        if motion_feats is not None:
            m = motion_feats.shape[1]
            mf = prep(motion_feats.to(x.dtype).transpose(2, 3).unflatten(3, (h, w)))
            if group is not None:
                mf = local_slice(mf, group, dim=2)
            hs = torch.cat([mf, hs], dim=1)
        for block in tt.transformer_blocks:
            hs = block(hs)
        hs = hs[:, m:]
        if group is not None:
            hs = all_to_all(hs, group, split_dim=1, concat_dim=2)  # (B, F, L, C')
        hs = tt.proj_out(hs)
        return x + hs.transpose(2, 3).unflatten(3, (h, w))
