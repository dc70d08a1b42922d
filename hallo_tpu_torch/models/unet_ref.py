"""ReferenceNet: the 2D SD-1.5 UNet that returns its per-block normed hidden
states as an explicit feature dict (counterpart of
hallo_tpu/models/unet_ref.py). Parameters carry the reference's
`reference_unet.*` key names; images are NCHW.

The returned features are keyed like `DenoisingUNet`'s consumption sites:
{"down_{i}": (feat, ...), "mid": (feat,), "up_{i}": (feat, ...)}, each feat
(B', H*W, C).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from hallo_tpu_torch.config import UNetConfig
from hallo_tpu_torch.models.layers import GroupNorm, TimestepEmbedding, timestep_embedding
from hallo_tpu_torch.models.resnet import Downsample, ResnetBlock, Upsample
from hallo_tpu_torch.models.transformer_spatial import ReferenceTransformer
from hallo_tpu_torch.models.unet_denoise import up_skip_channels

RefFeatures = Dict[str, Tuple[torch.Tensor, ...]]


class _Block(nn.Module):
    """resnets [+ attentions] [+ downsamplers | upsamplers]."""

    def __init__(self, in_channels, out_channels, temb, cfg: UNetConfig, attention: bool,
                 sampler: Optional[nn.Module], sampler_name: str, n_attn=None):
        super().__init__()
        heads = cfg.num_attention_heads
        self.resnets = nn.ModuleList([
            ResnetBlock(c, out_channels, temb, cfg.norm_num_groups, cfg.norm_eps,
                        inflated=False)
            for c in in_channels
        ])
        if attention:
            self.attentions = nn.ModuleList([
                ReferenceTransformer(out_channels, heads, out_channels // heads,
                                     cfg.cross_attention_dim, cfg.norm_num_groups)
                for _ in range(len(in_channels) if n_attn is None else n_attn)
            ])
        if sampler is not None:
            setattr(self, sampler_name, nn.ModuleList([sampler]))

    def layer(self, j, x, temb, context, feats):
        x = self.resnets[j](x[:, None], temb)[:, 0]
        if hasattr(self, "attentions"):
            x, ref = self.attentions[j](x, context)
            feats.append(ref)
        return x


class ReferenceNet(nn.Module):
    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.config = cfg
        ch = cfg.block_out_channels
        temb = ch[0] * 4
        n = len(ch)
        self.conv_in = nn.Conv2d(cfg.in_channels, ch[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(ch[0], temb)
        self.down_blocks = nn.ModuleList()
        for i, kind in enumerate(cfg.down_block_types):
            in_ch = ch[i - 1] if i > 0 else ch[0]
            ins = [in_ch] + [ch[i]] * (cfg.layers_per_block - 1)
            self.down_blocks.append(_Block(
                ins, ch[i], temb, cfg, kind.startswith("CrossAttn"),
                Downsample(ch[i]) if i < n - 1 else None, "downsamplers",
            ))
        self.mid_block = _Block([ch[-1], ch[-1]], ch[-1], temb, cfg, True, None, "",
                                n_attn=1)
        rev = tuple(reversed(ch))
        self.up_blocks = nn.ModuleList()
        for i, (kind, skips) in enumerate(zip(cfg.up_block_types, up_skip_channels(cfg))):
            prev = rev[i - 1] if i > 0 else ch[-1]
            ins = [(prev if j == 0 else rev[i]) + s for j, s in enumerate(skips)]
            self.up_blocks.append(_Block(
                ins, rev[i], temb, cfg, kind.startswith("CrossAttn"),
                Upsample(rev[i]) if i < n - 1 else None, "upsamplers",
            ))
        self.conv_norm_out = GroupNorm(cfg.norm_num_groups, ch[0], eps=cfg.norm_eps)
        self.conv_out = nn.Conv2d(ch[0], cfg.out_channels, 3, padding=1)

    def forward(
        self,
        sample: torch.Tensor,
        timesteps: torch.Tensor,
        context: torch.Tensor,
    ) -> Tuple[torch.Tensor, RefFeatures]:
        """sample (B', C_in, H, W) reference + motion-frame latents;
        timesteps scalar or (B',); context (B', T, D) identity tokens, tiled
        by the caller. Returns (noise_pred, ref_features)."""
        cfg = self.config
        dtype = self.conv_in.weight.dtype
        b = sample.shape[0]
        t = torch.as_tensor(timesteps, device=sample.device)
        if t.ndim == 0:
            t = t.expand(b)
        temb = timestep_embedding(t, cfg.block_out_channels[0], cfg.flip_sin_to_cos,
                                  cfg.freq_shift)
        temb = self.time_embedding(temb.to(dtype))
        context = context.to(dtype)
        x = self.conv_in(sample.to(dtype))
        features: RefFeatures = {}

        skips = [x]
        for i, blk in enumerate(self.down_blocks):
            feats: list = []
            for j in range(len(blk.resnets)):
                x = blk.layer(j, x, temb, context, feats)
                skips.append(x)
            if feats:
                features[f"down_{i}"] = tuple(feats)
            if hasattr(blk, "downsamplers"):
                x = blk.downsamplers[0](x[:, None])[:, 0]
                skips.append(x)

        feats = []
        x = self.mid_block.layer(0, x, temb, context, feats)
        features["mid"] = tuple(feats)
        x = self.mid_block.resnets[1](x[:, None], temb)[:, 0]

        for i, blk in enumerate(self.up_blocks):
            feats = []
            for j in range(len(blk.resnets)):
                x = blk.layer(j, torch.cat([x, skips.pop()], dim=1), temb, context, feats)
            if feats:
                features[f"up_{i}"] = tuple(feats)
            if hasattr(blk, "upsamplers"):
                x = blk.upsamplers[0](x[:, None])[:, 0]

        x = self.conv_out(F.silu(self.conv_norm_out(x)))
        return x, features
