"""wav2vec2-base encoder with per-video-frame feature resampling
(counterpart of hallo_tpu/models/wav2vec.py; reference hallo/models/wav2vec.py).

The conv features are linearly resampled to the video frame count (25 fps)
before the transformer encoder, and every encoder layer's hidden state is
returned (the reference's stack of hidden_states[1:]). Parameters carry the
keys of HF's Wav2Vec2Model (facebook/wav2vec2-base-960h, 211 keys), so that
checkpoint loads with `strict=True` and no conversion; the positional conv
keeps its weight-norm pair (weight_g, weight_v) and computes the weight in
`forward`, and `masked_spec_embed` is held but unused, as in HF.

The self-attention goes through `ops.attention.dot_product_attention`
heads-major: the CUDA flash kernel on the card (K3 at d = 64, or K6 under
HALLO_INT8_ATTN=1 for 1024 frames and more), the plain math on the CPU.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from hallo_tpu_torch.config import Wav2Vec2Config
from hallo_tpu_torch.models.layers import LayerNorm
from hallo_tpu_torch.ops.attention import dot_product_attention


def linear_resample(features: torch.Tensor, out_len: int) -> torch.Tensor:
    """(B, T, C) -> (B, out_len, C): linear interpolation with
    align_corners=True (reference wav2vec.py:196-209). The fp32 positions
    may land an ulp away from jnp.linspace's; the interpolation is
    continuous, so the result moves by at most that ulp times the slope."""
    t = features.shape[1]
    if t == out_len:
        return features
    pos = torch.linspace(0.0, t - 1, out_len, device=features.device)
    lo = torch.floor(pos).long()
    hi = torch.clamp(lo + 1, max=t - 1)
    w = (pos - lo.to(pos.dtype))[None, :, None].to(features.dtype)
    return features[:, lo] * (1 - w) + features[:, hi] * w


def normalize_waveform(wave: torch.Tensor) -> torch.Tensor:
    """HF Wav2Vec2FeatureExtractor do_normalize: zero mean, unit variance
    (population variance, eps 1e-7) over the last axis."""
    mean = wave.mean(dim=-1, keepdim=True)
    var = wave.var(dim=-1, unbiased=False, keepdim=True)
    return (wave - mean) / torch.sqrt(var + 1e-7)


class ConvLayer(nn.Module):
    """One feature-encoder layer: Conv1d (+ layer 0's instance norm) + GELU."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int, bias: bool,
                 norm: bool):
        super().__init__()
        self.conv = nn.Conv1d(cin, cout, kernel, stride=stride, bias=bias)
        # HF's GroupNorm(num_groups=C, num_channels=C): an instance norm over
        # time; only its affine parameters are used.
        self.layer_norm = nn.GroupNorm(cout, cout) if norm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv(x)  # (B, C, T)
        if self.layer_norm is not None:
            hf = h.float()
            mean = hf.mean(dim=-1, keepdim=True)
            var = hf.var(dim=-1, unbiased=False, keepdim=True)
            hf = (hf - mean) * torch.rsqrt(var + 1e-5)
            h = (hf * self.layer_norm.weight.float()[:, None]
                 + self.layer_norm.bias.float()[:, None]).to(h.dtype)
        return F.gelu(h)


class FeatureEncoder(nn.Module):
    """The 7-layer conv feature extractor: (B, samples) -> (B, T, C)."""

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        dims = (1,) + tuple(cfg.conv_dim)
        self.conv_layers = nn.ModuleList(
            ConvLayer(dims[i], dims[i + 1], k, s, cfg.conv_bias,
                      norm=i == 0 and cfg.feat_extract_norm == "group")
            for i, (k, s) in enumerate(zip(cfg.conv_kernel, cfg.conv_stride))
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x[:, None, :]
        for layer in self.conv_layers:
            h = layer(h)
        return h.transpose(1, 2)


class FeatureProjection(nn.Module):
    """LayerNorm -> Linear(conv_dim[-1] -> hidden)."""

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.layer_norm = LayerNorm(cfg.conv_dim[-1], eps=cfg.layer_norm_eps)
        self.projection = nn.Linear(cfg.conv_dim[-1], cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.projection(self.layer_norm(x))


class WeightNormConv1d(nn.Module):
    """HF's positional conv: a grouped Conv1d under weight norm over dim 2,
    weight = weight_g * weight_v / ||weight_v|| (norm over out and in)."""

    def __init__(self, channels: int, kernel: int, groups: int):
        super().__init__()
        self.groups = groups
        self.padding = kernel // 2
        v = torch.empty(channels, channels // groups, kernel)
        nn.init.normal_(v, 0.0, 2 * math.sqrt(1.0 / (kernel * channels // groups)))
        self.weight_v = nn.Parameter(v)
        self.weight_g = nn.Parameter(v.norm(dim=(0, 1), keepdim=True))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        v = self.weight_v
        weight = v * (self.weight_g / v.norm(dim=(0, 1), keepdim=True))
        return F.conv1d(x, weight, self.bias, padding=self.padding, groups=self.groups)


class PositionalConvEmbedding(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.conv = WeightNormConv1d(
            cfg.hidden_size, cfg.num_conv_pos_embeddings, cfg.num_conv_pos_embedding_groups
        )
        self.trim = cfg.num_conv_pos_embeddings % 2 == 0

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        """(B, T, C) -> (B, T, C): the conv pads k // 2 on each side, so an
        even kernel yields T + 1 frames and the last is dropped."""
        pos = self.conv(h.transpose(1, 2))
        if self.trim:
            pos = pos[:, :, :-1]
        return F.gelu(pos).transpose(1, 2)


class SelfAttention(nn.Module):
    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(hidden, hidden)
        self.k_proj = nn.Linear(hidden, hidden)
        self.v_proj = nn.Linear(hidden, hidden)
        self.out_proj = nn.Linear(hidden, hidden)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        b, t, c = h.shape

        def heads_major(x):
            return x.unflatten(2, (self.heads, c // self.heads)).transpose(1, 2)

        q, k, v = (heads_major(p(h)) for p in (self.q_proj, self.k_proj, self.v_proj))
        attn = dot_product_attention(q, k, v).transpose(1, 2).reshape(b, t, c)
        return self.out_proj(attn)


class FeedForward(nn.Module):
    def __init__(self, hidden: int, intermediate: int):
        super().__init__()
        self.intermediate_dense = nn.Linear(hidden, intermediate)
        self.output_dense = nn.Linear(intermediate, hidden)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.output_dense(F.gelu(self.intermediate_dense(h)))


class EncoderLayer(nn.Module):
    """Post-norm transformer layer (wav2vec2-base)."""

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.attention = SelfAttention(cfg.hidden_size, cfg.num_attention_heads)
        self.layer_norm = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.feed_forward = FeedForward(cfg.hidden_size, cfg.intermediate_size)
        self.final_layer_norm = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        h = self.layer_norm(h + self.attention(h))
        return self.final_layer_norm(h + self.feed_forward(h))


class Encoder(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.pos_conv_embed = PositionalConvEmbedding(cfg)
        self.layer_norm = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList(EncoderLayer(cfg) for _ in range(cfg.num_hidden_layers))

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        h = self.layer_norm(h + self.pos_conv_embed(h))
        states = []
        for layer in self.layers:
            h = layer(h)
            states.append(h)
        return torch.stack(states, dim=2)


class Wav2Vec2(nn.Module):
    def __init__(self, config: Wav2Vec2Config = Wav2Vec2Config()):
        super().__init__()
        if config.feat_extract_norm != "group" or config.do_stable_layer_norm:
            raise ValueError("the port has wav2vec2-base's post-norm, group-norm encoder")
        self.config = config
        self.feature_extractor = FeatureEncoder(config)
        self.feature_projection = FeatureProjection(config)
        self.encoder = Encoder(config)
        self.masked_spec_embed = nn.Parameter(torch.rand(config.hidden_size))

    def forward(self, input_values: torch.Tensor, seq_len: int) -> torch.Tensor:
        """(B, samples) normalised waveform -> (B, seq_len, layers, hidden).
        The conv features are resampled to `seq_len` video frames before the
        transformer (reference wav2vec.py:64-66)."""
        feats = linear_resample(self.feature_extractor(input_values), seq_len)
        return self.encoder(self.feature_projection(feats))
