"""FaceLocator: conv encoder from the face-region mask to an additive
conditioning feature at latent resolution (counterpart of
hallo_tpu/models/face_locator.py; reference face_locator.py:34-113)."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from hallo_tpu_torch.config import FaceLocatorConfig


class FaceLocator(nn.Module):
    def __init__(self, cfg: FaceLocatorConfig = FaceLocatorConfig()):
        super().__init__()
        ch = cfg.block_out_channels
        self.conv_in = nn.Conv2d(cfg.conditioning_channels, ch[0], 3, padding=1)
        blocks = []
        for i in range(len(ch) - 1):
            blocks.append(nn.Conv2d(ch[i], ch[i], 3, padding=1))
            blocks.append(nn.Conv2d(ch[i], ch[i + 1], 3, stride=2, padding=1))
        self.blocks = nn.ModuleList(blocks)
        self.conv_out = nn.Conv2d(ch[-1], cfg.conditioning_embedding_channels, 3, padding=1)
        nn.init.zeros_(self.conv_out.weight)
        nn.init.zeros_(self.conv_out.bias)

    def forward(self, mask: torch.Tensor) -> torch.Tensor:
        """(N, C_cond, H, W) mask images -> (N, C_embed, H/8, W/8)."""
        x = F.silu(self.conv_in(mask.to(self.conv_in.weight.dtype)))
        for conv in self.blocks:
            x = F.silu(conv(x))
        return self.conv_out(x)
