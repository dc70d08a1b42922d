"""Residual blocks and up/down-sampling (counterpart of
hallo_tpu/models/resnet.py). Video tensors are (B, F, C, H, W); convs fold
frames into the batch, which is the reference's InflatedConv3d."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from hallo_tpu_torch.models.layers import GroupNorm, Upsample2x


def fold(x: torch.Tensor) -> torch.Tensor:
    """(B, F, C, H, W) -> (B*F, C, H, W)."""
    return x.flatten(0, 1)


def unfold(x: torch.Tensor, frames: int) -> torch.Tensor:
    """(B*F, C, H, W) -> (B, F, C, H, W)."""
    return x.unflatten(0, (-1, frames))


class Upsample(Upsample2x):
    """Nearest 2x upsample + 3x3 conv on video (reference resnet.py:104-185)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return unfold(super().forward(fold(x)), x.shape[1])


class Downsample(nn.Module):
    """Stride-2 3x3 conv on video (reference resnet.py:188-252)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return unfold(self.conv(fold(x)), x.shape[1])


class ResnetBlock(nn.Module):
    """GN -> SiLU -> conv -> (+temb) -> GN -> SiLU -> conv -> +shortcut on
    (B, F, C, H, W). `inflated`: GroupNorm statistics span (F, H, W)
    (reference InflatedGroupNorm), and the frames of every rank of `group`
    under clip parallelism (hallo_tpu/models/resnet.py:86-91); otherwise
    they are per frame."""

    def __init__(self, in_channels: int, out_channels: int, temb_channels: int,
                 groups: int = 32, eps: float = 1e-6, inflated: bool = True):
        super().__init__()
        self.inflated = inflated
        self.norm1 = GroupNorm(groups, in_channels, eps=eps)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb_channels, out_channels)
        self.norm2 = GroupNorm(groups, out_channels, eps=eps)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        if in_channels != out_channels:
            self.conv_shortcut = nn.Conv2d(in_channels, out_channels, 1)

    def _norm(self, norm: GroupNorm, x: torch.Tensor, group) -> torch.Tensor:
        if self.inflated:
            return norm(x, inflated=True, group=group)
        return unfold(norm(fold(x)), x.shape[1])

    def forward(self, x: torch.Tensor, temb: torch.Tensor, group=None) -> torch.Tensor:
        f = x.shape[1]
        h = F.silu(self._norm(self.norm1, x, group))
        h = unfold(self.conv1(fold(h)), f)
        h = h + self.time_emb_proj(F.silu(temb))[:, None, :, None, None]
        h = F.silu(self._norm(self.norm2, h, group))
        h = unfold(self.conv2(fold(h)), f)
        if hasattr(self, "conv_shortcut"):
            x = unfold(self.conv_shortcut(fold(x)), f)
        return x + h

