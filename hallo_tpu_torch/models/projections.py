"""Identity / audio projection heads (counterpart of
hallo_tpu/models/projections.py; reference image_proj.py, audio_proj.py)."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from hallo_tpu_torch.config import AudioProjConfig, ImageProjConfig
from hallo_tpu_torch.models.layers import LayerNorm


class ImageProj(nn.Module):
    def __init__(self, cfg: ImageProjConfig = ImageProjConfig()):
        super().__init__()
        self.config = cfg
        self.proj = nn.Linear(cfg.clip_embeddings_dim,
                              cfg.clip_extra_context_tokens * cfg.cross_attention_dim)
        self.norm = LayerNorm(cfg.cross_attention_dim)

    def forward(self, image_embeds: torch.Tensor) -> torch.Tensor:
        """(B, clip_embeddings_dim) -> (B, tokens, cross_attention_dim)."""
        cfg = self.config
        x = self.proj(image_embeds.to(self.proj.weight.dtype))
        return self.norm(x.reshape(-1, cfg.clip_extra_context_tokens, cfg.cross_attention_dim))


class AudioProj(nn.Module):
    def __init__(self, cfg: AudioProjConfig = AudioProjConfig()):
        super().__init__()
        self.config = cfg
        self.proj1 = nn.Linear(cfg.seq_len * cfg.blocks * cfg.channels, cfg.intermediate_dim)
        self.proj2 = nn.Linear(cfg.intermediate_dim, cfg.intermediate_dim)
        self.proj3 = nn.Linear(cfg.intermediate_dim, cfg.context_tokens * cfg.output_dim)
        self.norm = LayerNorm(cfg.output_dim)

    def forward(self, audio_embeds: torch.Tensor) -> torch.Tensor:
        """(B, F, window, blocks, channels) -> (B, F, context_tokens, output_dim)."""
        cfg = self.config
        b, f = audio_embeds.shape[:2]
        x = audio_embeds.reshape(b * f, -1).to(self.proj1.weight.dtype)
        x = F.relu(self.proj2(F.relu(self.proj1(x))))
        x = self.proj3(x).reshape(b * f, cfg.context_tokens, cfg.output_dim)
        return self.norm(x).reshape(b, f, cfg.context_tokens, cfg.output_dim)
