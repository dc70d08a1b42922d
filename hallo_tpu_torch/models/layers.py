"""Core building blocks (counterpart of hallo_tpu/models/layers.py).

Modules keep the reference checkpoints' state_dict names (diffusers
`Attention`: to_q/to_k/to_v/to_out.0; GEGLU `FeedForward`: net.0.proj/net.2)
and compute in the dtype of their parameters. Image tensors are NCHW; video
tensors are (B, F, C, H, W), so folding frames into the batch is a view.

Attention goes through `ops/`: on the CPU the plain PyTorch math, on the card
the hand-written kernels (`flash_fwd_sm90.cu`, `temporal_attn_sm90.cu`).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from hallo_tpu_torch.ops.flash import flash_attention_packed
from hallo_tpu_torch.parallel.collectives import all_reduce_sum
from hallo_tpu_torch.ops.temporal import temporal_attention


def maybe_checkpoint(enable: bool, fn, *args):
    """`fn(*args)`, recomputed in the backward pass (a non-reentrant
    checkpoint, which nests inside another) when `enable` and grad mode are
    on."""
    if enable and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def group_norm(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int,
    eps: float,
    channel_dim: int = 1,
    group=None,
) -> torch.Tensor:
    """GroupNorm whose statistics span every axis but the batch (axis 0).

    x is (N, C, ...) for the usual per-image norm, or a video (B, F, C, H, W)
    with `channel_dim=2` for the inflated norm whose statistics span
    (F, H, W) (hallo_tpu layers.group_norm). Moments are one-pass fp32 sums;
    the per-(batch, channel) affine is rounded to x's dtype and applied in it,
    as the JAX reference does. With a process `group` (clip parallelism: the
    frames split over its ranks), the fp32 (B, G) sums are all-reduced over
    it and the count multiplied by its size before the division
    (hallo_tpu/models/layers.py:66-70), so the statistics span the whole
    clip."""
    shape = x.shape
    b, c = shape[0], shape[channel_dim]
    g = num_groups
    lead = math.prod(shape[1:channel_dim])
    xg = x.reshape(b, lead, g, c // g, -1)
    xf = xg.float()
    n = lead * (c // g) * xg.shape[-1]
    s1 = xf.sum(dim=(1, 3, 4))  # (B, G)
    s2 = xf.square().sum(dim=(1, 3, 4))
    if group is not None:
        s1, s2 = all_reduce_sum(torch.stack([s1, s2]), group).unbind(0)
        n *= dist.get_world_size(group)
    mean = s1 / n
    ex2 = s2 / n
    rstd = torch.rsqrt((ex2 - mean.square()).clamp_min(0.0) + eps)
    mean_c = mean.repeat_interleave(c // g, dim=1)  # (B, C)
    rstd_c = rstd.repeat_interleave(c // g, dim=1)
    scale = rstd_c * weight.float()[None]
    shift = bias.float()[None] - mean_c * scale
    view = [b] + [1] * (len(shape) - 1)
    view[channel_dim] = c
    return x * scale.to(x.dtype).view(view) + shift.to(x.dtype).view(view)


class GroupNorm(nn.GroupNorm):
    """nn.GroupNorm's parameters with `group_norm`'s numerics; `inflated`
    takes a (B, F, C, H, W) video with statistics over (F, H, W), and over
    the frames of every rank of `group` with one."""

    def forward(self, x: torch.Tensor, inflated: bool = False, group=None) -> torch.Tensor:
        return group_norm(
            x, self.weight, self.bias, self.num_groups, self.eps,
            channel_dim=2 if inflated else 1, group=group,
        )


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last axis with the JAX reference's one-pass fp32
    variance (E[x^2] - E[x]^2, clamped at 0), normalised in x's dtype."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__(dim, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf.square().mean(dim=-1, keepdim=True) - mean.square()).clamp_min(0.0)
        rstd = torch.rsqrt(var + self.eps)
        cd = x.dtype
        out = (x - mean.to(cd)) * rstd.to(cd)
        return out * self.weight.to(cd) + self.bias.to(cd)


class TokenConv1x1(nn.Conv2d):
    """A 1x1 Conv2d with the reference's parameters (proj_in, proj_out,
    zero_conv) applied as a per-token linear on (..., C) tokens: JAX's
    Dense, and a dense of tensor parallelism's plan (`parallel/tp.py`)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight[:, :, 0, 0], self.bias)


class Upsample2x(nn.Module):
    """Nearest-2x upsample + 3x3 conv on NCHW (reference resnet.py:104-185);
    the parameters live at `conv`."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


def timestep_embedding(
    timesteps: torch.Tensor,
    dim: int,
    flip_sin_to_cos: bool = True,
    downscale_freq_shift: float = 0.0,
    max_period: float = 10000.0,
) -> torch.Tensor:
    """Sinusoidal timestep embedding, diffusers `Timesteps` semantics; fp32."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device
    )
    exponent = exponent / (half - downscale_freq_shift)
    emb = torch.exp(exponent)[None, :] * timesteps.float()[:, None]
    sin, cos = torch.sin(emb), torch.cos(emb)
    out = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        out = F.pad(out, (0, 1))
    return out


class TimestepEmbedding(nn.Module):
    """linear_1 -> SiLU -> linear_2."""

    def __init__(self, in_dim: int, embed_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, embed_dim)
        self.linear_2 = nn.Linear(embed_dim, embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(x)))


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        value, gate = self.proj(x).chunk(2, dim=-1)
        return value * F.gelu(gate)


class FeedForward(nn.Module):
    """GEGLU feed-forward (diffusers keys net.0.proj, net.2).

    `chunks` > 1 splits the second-to-last (token) axis into that many
    equal parts and, with grad on, runs each part under its own checkpoint,
    so that the GEGLU temporaries exist one part at a time in the forward
    and in the backward (JAX's `FeedForward.chunks`, there a `lax.map`). The
    math and the parameters are the same; an axis that does not divide, or
    an input of fewer than 2 axes, runs unchunked."""

    def __init__(self, dim: int, mult: int = 4, chunks: int = 1):
        super().__init__()
        inner = dim * mult
        self.chunks = chunks
        self.net = nn.ModuleList([GEGLU(dim, inner), nn.Identity(), nn.Linear(inner, dim)])

    def ff(self, x: torch.Tensor) -> torch.Tensor:
        return self.net[2](self.net[0](x))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = self.chunks
        if n <= 1 or x.ndim < 2 or x.shape[-2] % n:
            return self.ff(x)
        return torch.cat([maybe_checkpoint(True, self.ff, part)
                          for part in x.chunk(n, dim=-2)], dim=-2)


class CrossAttention(nn.Module):
    """Multi-head attention (self- when context is None): to_q/to_k/to_v
    without bias, to_out.0 with bias. Tokens stay in the natural (B, L, C)
    layout; the heads are split inside the flash kernel (K1)."""

    def __init__(self, query_dim: int, heads: int, head_dim: int,
                 context_dim: Optional[int] = None, out_dim: Optional[int] = None):
        super().__init__()
        inner = heads * head_dim
        context_dim = query_dim if context_dim is None else context_dim
        out_dim = query_dim if out_dim is None else out_dim
        self.heads = heads
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, out_dim), nn.Identity()])

    def forward(
        self,
        x: torch.Tensor,
        context: Optional[torch.Tensor] = None,
        bias: Optional[torch.Tensor] = None,
        extra_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    ) -> torch.Tensor:
        """bias: additive per-key logits bias (B, Lk) over the (concatenated)
        keys. extra_kv: pre-projected (B, L_extra, inner) key/value rows
        appended after this call's own projections, as wide as they are
        (under tensor parallelism, the heads this rank runs)."""
        context = x if context is None else context
        q = self.to_q(x)
        k = self.to_k(context)
        v = self.to_v(context)
        if extra_kv is not None:
            if extra_kv[0].shape[-1] != k.shape[-1]:
                raise ValueError(f"extra_kv of width {extra_kv[0].shape[-1]} for projections "
                                 f"of width {k.shape[-1]} ({self.heads} heads)")
            k = torch.cat([k, extra_kv[0].to(k.dtype)], dim=1)
            v = torch.cat([v, extra_kv[1].to(v.dtype)], dim=1)
        out = flash_attention_packed(q, k, v, heads=self.heads, bias=bias)
        return self.to_out[0](out)


class TemporalSelfAttention(nn.Module):
    """Self-attention over the frame axis at every site of a (B, F, L, C)
    tensor (K2 on the card); same parameters as CrossAttention."""

    def __init__(self, dim: int, heads: int, head_dim: int):
        super().__init__()
        inner = heads * head_dim
        self.heads = heads
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_k = nn.Linear(dim, inner, bias=False)
        self.to_v = nn.Linear(dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, dim), nn.Identity()])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        o = temporal_attention(self.to_q(x), self.to_k(x), self.to_v(x), heads=self.heads)
        return self.to_out[0](o)


def sinusoidal_positions(max_len: int, dim: int, device=None) -> torch.Tensor:
    """Motion-module positional encoding table (max_len, dim), fp32."""
    position = torch.arange(max_len, dtype=torch.float32, device=device)[:, None]
    div_term = torch.exp(
        torch.arange(0, dim, 2, dtype=torch.float32, device=device)
        * (-math.log(10000.0) / dim)
    )
    pe = torch.zeros(max_len, dim, dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(position * div_term)
    pe[:, 1::2] = torch.cos(position * div_term)
    return pe
