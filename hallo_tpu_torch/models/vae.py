"""AutoencoderKL (sd-vae-ft-mse) encoder/decoder on NCHW images
(counterpart of hallo_tpu/models/vae.py). Parameters carry diffusers'
AutoencoderKL key names; callers fold video frames into the batch.

The mid-block attention is one head of d = 512 over the latent's h*w
positions; it goes through `ops.attention.dot_product_attention`, which on
the card is the flash kernel in its heads-major form (K4).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from hallo_tpu_torch.config import VAEConfig
from hallo_tpu_torch.models.layers import GroupNorm, Upsample2x
from hallo_tpu_torch.ops.attention import dot_product_attention


class VAEResnet(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, groups: int = 32):
        super().__init__()
        self.norm1 = GroupNorm(groups, in_channels, eps=1e-6)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.norm2 = GroupNorm(groups, out_channels, eps=1e-6)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        if in_channels != out_channels:
            self.conv_shortcut = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class VAEAttention(nn.Module):
    """Single-head self-attention over spatial positions (SD VAE mid block)."""

    def __init__(self, channels: int, groups: int = 32):
        super().__init__()
        self.group_norm = GroupNorm(groups, channels, eps=1e-6)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels), nn.Identity()])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        normed = self.group_norm(x).flatten(2).transpose(1, 2)  # (B, HW, C)
        q, k, v = (m(normed)[:, None] for m in (self.to_q, self.to_k, self.to_v))
        out = self.to_out[0](dot_product_attention(q, k, v)[:, 0])
        return x + out.transpose(1, 2).reshape(b, c, h, w)


class _Mid(nn.Module):
    def __init__(self, channels: int, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList([VAEResnet(channels, channels, groups) for _ in range(2)])
        self.attentions = nn.ModuleList([VAEAttention(channels, groups)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class _AsymDownsample(nn.Module):
    """diffusers VAE downsample: pad (0, 1) on H and W, then a stride-2 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class _Stage(nn.Module):
    def __init__(self, channels_in: int, channels: int, n: int, groups: int,
                 sampler=None, sampler_name: str = ""):
        super().__init__()
        self.resnets = nn.ModuleList([
            VAEResnet(channels_in if j == 0 else channels, channels, groups)
            for j in range(n)
        ])
        if sampler is not None:
            setattr(self, sampler_name, nn.ModuleList([sampler]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for r in self.resnets:
            x = r(x)
        for name in ("downsamplers", "upsamplers"):
            if hasattr(self, name):
                x = getattr(self, name)[0](x)
        return x


class VAEEncoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        ch, g = cfg.block_out_channels, cfg.norm_num_groups
        self.conv_in = nn.Conv2d(cfg.in_channels, ch[0], 3, padding=1)
        self.down_blocks = nn.ModuleList([
            _Stage(ch[i - 1] if i > 0 else ch[0], ch[i], cfg.layers_per_block, g,
                   _AsymDownsample(ch[i]) if i < len(ch) - 1 else None, "downsamplers")
            for i in range(len(ch))
        ])
        self.mid_block = _Mid(ch[-1], g)
        self.conv_norm_out = GroupNorm(g, ch[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(ch[-1], 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for blk in self.down_blocks:
            h = blk(h)
        h = self.mid_block(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class VAEDecoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        ch, g = tuple(reversed(cfg.block_out_channels)), cfg.norm_num_groups
        self.conv_in = nn.Conv2d(cfg.latent_channels, ch[0], 3, padding=1)
        self.mid_block = _Mid(ch[0], g)
        self.up_blocks = nn.ModuleList([
            _Stage(ch[i - 1] if i > 0 else ch[0], ch[i], cfg.layers_per_block + 1, g,
                   Upsample2x(ch[i]) if i < len(ch) - 1 else None, "upsamplers")
            for i in range(len(ch))
        ])
        self.conv_norm_out = GroupNorm(g, ch[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(ch[-1], cfg.out_channels, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.mid_block(self.conv_in(z))
        for blk in self.up_blocks:
            h = blk(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class AutoencoderKL(nn.Module):
    """encode_mean / decode on NCHW pixels in [-1, 1]."""

    def __init__(self, cfg: VAEConfig = VAEConfig()):
        super().__init__()
        self.config = cfg
        self.encoder = VAEEncoder(cfg)
        self.decoder = VAEDecoder(cfg)
        lc = cfg.latent_channels
        self.quant_conv = nn.Conv2d(2 * lc, 2 * lc, 1)
        self.post_quant_conv = nn.Conv2d(lc, lc, 1)

    def encode_moments(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        dtype = self.quant_conv.weight.dtype
        moments = self.quant_conv(self.encoder(x.to(dtype)))
        mean, logvar = moments.chunk(2, dim=1)
        return mean, logvar

    def encode_mean(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) pixels -> scaled latent posterior mean (B, 4, H/8, W/8)."""
        return self.encode_moments(x)[0] * self.config.scaling_factor

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Scaled latent (B, 4, h, w) -> pixels (B, 3, 8h, 8w) in [-1, 1]."""
        dtype = self.post_quant_conv.weight.dtype
        return self.decoder(self.post_quant_conv((z / self.config.scaling_factor).to(dtype)))
