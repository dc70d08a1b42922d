"""Encoder/mid/decoder stages of the denoising video UNet (counterpart of
hallo_tpu/models/unet_blocks.py; reference unet_3d_blocks.py). Per layer:
resnet -> spatial attention (ref-feature KV injection) -> audio attention ->
motion module. Video tensors are (B, F, C, H, W). The motion module takes
the ReferenceNet motion-frame features itself (hallo_tpu's
`fuse_motion_frames`: concatenated on the time axis, sliced back off).

With `remat_inner` and grad on, the resnet, spatial and audio transformers
each run under their own checkpoint, nested inside the denoiser's per-block
one (JAX's `inner_remat`, hallo_tpu/models/unet_blocks.py:48-61): the
backward's replay of a block then holds one sub-layer's temporaries at a
time, for one more forward of each sub-layer. The motion module is the one
sub-layer without a checkpoint of its own, where JAX's has one: its
temporal attentions and feed-forward chunks hold theirs, so a fourth run of
them would bound no more memory (on an H100: the same peak at stage2.yaml's
B 4, and less time a step; PERF.md)."""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn

from hallo_tpu_torch.config import MotionModuleConfig
from hallo_tpu_torch.models.layers import maybe_checkpoint
from hallo_tpu_torch.models.motion import MotionModule
from hallo_tpu_torch.models.resnet import Downsample, ResnetBlock, Upsample
from hallo_tpu_torch.models.transformer_spatial import AudioTransformer, SpatialTransformer

Masks = Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


@dataclasses.dataclass
class Conditioning:
    """What every layer of one denoiser call sees besides its own features:
    context (B, T, Dc) identity tokens; audio_context (B, F, T, Da); masks
    (full, face, lip), each (B*F, L) at this block's depth; motion_scale
    (3,); uncond_mask (B,); cfg_split: the batch is [uncond | cond];
    seq_group: the process group the clip's frames are split over (clip
    parallelism), or None."""

    context: torch.Tensor
    audio_context: Optional[torch.Tensor] = None
    masks: Masks = None
    motion_scale: Optional[torch.Tensor] = None
    uncond_mask: Optional[torch.Tensor] = None
    cfg_split: bool = False
    seq_group: Optional[object] = None

    def at_depth(self, masks: Masks) -> "Conditioning":
        return dataclasses.replace(self, masks=masks)


class _Layers(nn.Module):
    """One UNet stage: `n` x (resnet [-> attention -> audio] [-> motion])."""

    def __init__(
        self,
        in_channels: Sequence[int],  # per layer, skip concat included
        out_channels: int,
        temb_channels: int,
        heads: int,
        groups: int,
        eps: float,
        inflated: bool,
        context_dim: int,
        attention: bool,
        audio_inner: Optional[Sequence[int]],  # per layer; None: no audio
        audio_dim: int,
        hierarchical: bool,
        motion_config: Optional[MotionModuleConfig],
        n_attn: Optional[int] = None,  # layers with attention/audio/motion
        remat_inner: bool = False,
    ):
        super().__init__()
        self.remat_inner = remat_inner
        n = len(in_channels) if n_attn is None else n_attn
        self.resnets = nn.ModuleList([
            ResnetBlock(c, out_channels, temb_channels, groups, eps, inflated)
            for c in in_channels
        ])
        if attention:
            self.attentions = nn.ModuleList([
                SpatialTransformer(out_channels, heads, out_channels // heads,
                                   context_dim, groups)
                for _ in range(n)
            ])
        if audio_inner is not None:
            self.audio_modules = nn.ModuleList([
                AudioTransformer(out_channels, heads, inner, audio_dim, groups,
                                 hierarchical)
                for inner in audio_inner
            ])
        if motion_config is not None:
            self.motion_modules = nn.ModuleList([
                MotionModule(out_channels, motion_config, remat_inner) for _ in range(n)
            ])

    def layer(self, i, x, temb, cond, ref_feature, motion_feature):
        sub = partial(maybe_checkpoint, self.remat_inner)
        x = sub(self.resnets[i], x, temb, cond.seq_group)
        if hasattr(self, "attentions"):
            x = sub(self.attentions[i], x, ref_feature, cond.context, cond.uncond_mask,
                    cond.cfg_split)
        if hasattr(self, "audio_modules") and cond.audio_context is not None:
            x = sub(partial(self.audio_modules[i], motion_scale=cond.motion_scale,
                            cfg_split=cond.cfg_split),
                    x, cond.audio_context,
                    *(cond.masks if cond.masks is not None else (None,) * 3))
        if hasattr(self, "motion_modules"):
            x = self.motion_modules[i](x, motion_feature, cond.seq_group)
        return x


class DownBlock(_Layers):
    """CrossAttnDownBlock / DownBlock: returns (x, skip states)."""

    def __init__(self, in_channels: int, out_channels: int, num_layers: int,
                 add_downsample: bool, **kw):
        ins = [in_channels] + [out_channels] * (num_layers - 1)
        super().__init__(ins, out_channels, **kw)
        if add_downsample:
            self.downsamplers = nn.ModuleList([Downsample(out_channels)])

    def forward(self, x, temb, cond: "Conditioning", ref_features=None,
                motion_features=None):
        states = []
        for i in range(len(self.resnets)):
            x = self.layer(
                i, x, temb, cond,
                None if ref_features is None else ref_features[i],
                None if motion_features is None else motion_features[i],
            )
            states.append(x)
        if hasattr(self, "downsamplers"):
            x = self.downsamplers[0](x)
            states.append(x)
        return x, states


class MidBlock(_Layers):
    """resnets_0 -> attention -> audio -> motion -> resnets_1."""

    def __init__(self, channels: int, **kw):
        super().__init__([channels, channels], channels, n_attn=1, **kw)

    def forward(self, x, temb, cond: "Conditioning", ref_features=None,
                motion_features=None):
        x = self.layer(
            0, x, temb, cond,
            None if ref_features is None else ref_features[0],
            None if motion_features is None else motion_features[0],
        )
        return maybe_checkpoint(self.remat_inner, self.resnets[1], x, temb, cond.seq_group)


class UpBlock(_Layers):
    """CrossAttnUpBlock / UpBlock: concatenates one skip per layer."""

    def __init__(self, prev_channels: int, out_channels: int,
                 skip_channels: Sequence[int], add_upsample: bool, **kw):
        ins = [(prev_channels if i == 0 else out_channels) + s
               for i, s in enumerate(skip_channels)]
        super().__init__(ins, out_channels, **kw)
        if add_upsample:
            self.upsamplers = nn.ModuleList([Upsample(out_channels)])

    def forward(self, x, skips, temb, cond: "Conditioning", ref_features=None,
                motion_features=None):
        skips = list(skips)
        for i in range(len(self.resnets)):
            x = torch.cat([x, skips.pop()], dim=2)
            x = self.layer(
                i, x, temb, cond,
                None if ref_features is None else ref_features[i],
                None if motion_features is None else motion_features[i],
            )
        if hasattr(self, "upsamplers"):
            x = self.upsamplers[0](x)
        return x
