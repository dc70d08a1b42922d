"""The denoising video UNet (counterpart of hallo_tpu/models/unet_denoise.py;
reference unet_3d.py). Parameters carry the reference's
`denoising_unet.*` key names; video tensors are (B, F, C, H, W).

ReferenceNet features arrive as explicit arguments keyed "down_{i}" / "mid"
/ "up_{i}", one (B, L, C) tensor per attention layer (`ref_features`), and
(B, M, L, C) per layer for the carried motion frames (`motion_features`).
"""

from __future__ import annotations

from functools import partial
from typing import Mapping, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from hallo_tpu_torch.config import UNetConfig
from hallo_tpu_torch.models.layers import (
    GroupNorm, TimestepEmbedding, maybe_checkpoint, timestep_embedding)
from hallo_tpu_torch.models.resnet import fold, unfold
from hallo_tpu_torch.models.unet_blocks import Conditioning, DownBlock, MidBlock, UpBlock

MaskPyramid = Tuple[Tuple[torch.Tensor, torch.Tensor, torch.Tensor], ...]
Features = Mapping[str, Sequence[torch.Tensor]]


def skip_channels(cfg: UNetConfig) -> list:
    """Channel count of each skip state, in the order the encoder pushes them."""
    ch = cfg.block_out_channels
    out = [ch[0]]
    for i in range(len(ch)):
        out += [ch[i]] * cfg.layers_per_block
        if i < len(ch) - 1:
            out.append(ch[i])
    return out


def up_skip_channels(cfg: UNetConfig) -> list:
    """Per up block, the skip channels its layers pop, in layer order."""
    stack = skip_channels(cfg)
    return [[stack.pop() for _ in range(cfg.layers_per_block + 1)]
            for _ in cfg.up_block_types]


def _hierarchical(cfg: UNetConfig, block_name: str, depth: int) -> bool:
    return (block_name in cfg.stack_enable_blocks_name
            and depth in cfg.stack_enable_blocks_depth)


class DenoisingUNet(nn.Module):
    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.config = cfg
        ch = cfg.block_out_channels
        heads = cfg.num_attention_heads
        temb = ch[0] * 4
        mm = cfg.motion_module if cfg.use_motion_module else None
        common = dict(
            temb_channels=temb, heads=heads, groups=cfg.norm_num_groups,
            eps=cfg.norm_eps, inflated=cfg.use_inflated_groupnorm,
            context_dim=cfg.cross_attention_dim, audio_dim=cfg.audio_attention_dim,
            remat_inner=cfg.remat_inner,
        )

        def audio(attn: bool, inners):
            if not (cfg.use_audio_module and attn):
                return None
            return [(c // heads) * heads for c in inners]

        self.conv_in = nn.Conv2d(cfg.in_channels, ch[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(ch[0], temb)

        self.down_blocks = nn.ModuleList()
        for i, kind in enumerate(cfg.down_block_types):
            attn = kind.startswith("CrossAttn")
            in_ch = ch[i - 1] if i > 0 else ch[0]
            use_mm = (mm is not None and 2**i in cfg.motion_module_resolutions
                      and not cfg.motion_module_decoder_only)
            self.down_blocks.append(DownBlock(
                in_ch, ch[i], cfg.layers_per_block, i < len(ch) - 1,
                attention=attn,
                # head-dim quirk: layer 0 derives from the block input
                audio_inner=audio(attn, [in_ch] + [ch[i]] * (cfg.layers_per_block - 1)),
                hierarchical=_hierarchical(cfg, "down", i),
                motion_config=mm if use_mm else None, **common,
            ))
        self.mid_block = MidBlock(
            ch[-1], attention=True, audio_inner=audio(True, [ch[-1]]),
            hierarchical=_hierarchical(cfg, "mid", 3),
            motion_config=mm if (mm is not None and cfg.motion_module_mid_block) else None,
            **common,
        )
        rev = tuple(reversed(ch))
        self.up_blocks = nn.ModuleList()
        for i, (kind, skips) in enumerate(zip(cfg.up_block_types, up_skip_channels(cfg))):
            attn = kind.startswith("CrossAttn")
            use_mm = mm is not None and 2 ** (3 - i) in cfg.motion_module_resolutions
            self.up_blocks.append(UpBlock(
                rev[i - 1] if i > 0 else ch[-1], rev[i], skips, i < len(ch) - 1,
                attention=attn,
                audio_inner=audio(attn, [rev[min(i + 1, len(ch) - 1)]] * len(skips)),
                hierarchical=_hierarchical(cfg, "up", 3 - i),
                motion_config=mm if use_mm else None, **common,
            ))
        self.conv_norm_out = GroupNorm(cfg.norm_num_groups, ch[0], eps=cfg.norm_eps)
        self.conv_out = nn.Conv2d(ch[0], cfg.out_channels, 3, padding=1)

    def forward(
        self,
        sample: torch.Tensor,
        timesteps: torch.Tensor,
        context: torch.Tensor,
        ref_features: Optional[Features] = None,
        motion_features: Optional[Features] = None,
        audio_context: Optional[torch.Tensor] = None,
        face_cond: Optional[torch.Tensor] = None,
        masks: Optional[MaskPyramid] = None,
        motion_scale: Optional[torch.Tensor] = None,
        uncond_mask: Optional[torch.Tensor] = None,
        cfg_split: bool = False,
        train: bool = False,
        seq_group=None,
    ) -> torch.Tensor:
        """sample (B, F, C_in, H, W) noisy latents (B includes the CFG
        doubling); timesteps scalar or (B,); context (B, T, D) identity
        tokens; audio_context (B, F, T_a, D_a); face_cond (B, F, C0, H, W)
        added after conv_in; masks per depth (full, face, lip), each
        (B*F, L_depth); motion_scale (3,); uncond_mask (B,) 1.0 on CFG-uncond
        entries (bias-masked path); cfg_split: the batch is [uncond | cond]
        and the uncond half takes the plain self-attention / zero-audio fast
        paths. Motion-frame features are fused where
        `config.motion_frame_fusion` says ("mid" at inference), or at every
        block with `train` (the reference's training path). With
        `config.remat` and grad mode on, each down, mid and up block is
        recomputed in the backward pass (JAX's `maybe_remat`); with
        `config.remat_inner`, each sub-layer inside a block is too (JAX's
        `inner_remat`), the motion module through its temporal attentions
        and feed-forward chunks (unet_blocks.py).

        With `seq_group` (clip parallelism, hallo_tpu's `seq_axis`), F is
        this rank's share of the clip's frames, and every per-frame input
        (sample, audio_context, face_cond, masks) holds those frames alone;
        the inflated GroupNorms all-reduce their moments over the group and
        the motion modules exchange frames for sites with all_to_all."""
        cfg = self.config
        dtype = self.conv_in.weight.dtype
        b, f = sample.shape[:2]
        t = torch.as_tensor(timesteps, device=sample.device)
        if t.ndim == 0:
            t = t.expand(b)
        temb = timestep_embedding(t, cfg.block_out_channels[0], cfg.flip_sin_to_cos,
                                  cfg.freq_shift)
        temb = self.time_embedding(temb.to(dtype))

        x = unfold(self.conv_in(fold(sample.to(dtype))), f)
        if face_cond is not None:
            x = x + face_cond.to(dtype)

        def feats(key, attn):
            return ref_features[key] if (ref_features is not None and attn) else None

        def mfeats(key, site, attn):
            mode = "all" if train else cfg.motion_frame_fusion
            if (motion_features is None or not cfg.use_motion_module or not attn
                    or not (mode == "all" or site == mode)):
                return None
            return motion_features[key]

        if audio_context is not None:
            audio_context = audio_context.to(dtype)
        cond = Conditioning(context.to(dtype), audio_context, None, motion_scale,
                            uncond_mask, cfg_split, seq_group)

        def at(depth):
            return cond.at_depth(None if masks is None else masks[depth])

        run = partial(maybe_checkpoint, cfg.remat)

        skips = [x]
        for i, blk in enumerate(self.down_blocks):
            attn = hasattr(blk, "attentions")
            x, states = run(blk, x, temb, at(i), feats(f"down_{i}", attn),
                            mfeats(f"down_{i}", "down", attn))
            skips.extend(states)
        x = run(self.mid_block, x, temb, at(3), feats("mid", True),
                mfeats("mid", "mid", True))
        n_up = cfg.layers_per_block + 1
        for i, blk in enumerate(self.up_blocks):
            attn = hasattr(blk, "attentions")
            block_skips, skips = skips[-n_up:], skips[:-n_up]
            x = run(blk, x, block_skips, temb, at(3 - i), feats(f"up_{i}", attn),
                    mfeats(f"up_{i}", "up", attn))

        x = F.silu(self.conv_norm_out(x, inflated=True, group=seq_group)
                   if cfg.use_inflated_groupnorm
                   else unfold(self.conv_norm_out(fold(x)), f))
        return unfold(self.conv_out(fold(x)), f)
