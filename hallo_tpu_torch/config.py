"""Typed model configurations of the port.

The port's own copy of the dataclasses and helpers of hallo_tpu/config.py
that it uses (the port imports nothing of the JAX package). Field names,
defaults and semantics are the JAX package's, less the fields the port does
not implement (UNetConfig's `use_linear_projection` and `upcast_attention`,
which SD-1.5 leaves off; SchedulerConfig's `clip_sample`, off in the
reference's DDIM). A port configuration's `dataclasses.asdict` builds the
same JAX configuration.

The YAML helpers (`unet_config_from_yaml_kwargs`, `DotDict`, `load_yaml`,
`load_config`, `merge_cli_overrides`, `to_container`) are copies of the JAX package's without
OmegaConf: configs load as `DotDict`s.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Mapping, Tuple


@dataclass(frozen=True)
class MotionModuleConfig:
    """AnimateDiff-style temporal module (reference motion_module.py:126-268,
    configs/inference/default.yaml:60-68)."""

    num_attention_heads: int = 8
    num_transformer_block: int = 1
    attention_block_types: Tuple[str, ...] = ("Temporal_Self", "Temporal_Self")
    temporal_position_encoding: bool = True
    temporal_position_encoding_max_len: int = 32
    temporal_attention_dim_div: int = 1
    norm_num_groups: int = 32


@dataclass(frozen=True)
class UNetConfig:
    """Shared by the ReferenceNet (2D) and the denoising (3D) UNet; fields
    follow the reference UNets (unet_3d.py:120-361) so that the SD-1.5 /
    AnimateDiff / hallo checkpoints line up one to one."""

    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    down_block_types: Tuple[str, ...] = (
        "CrossAttnDownBlock",
        "CrossAttnDownBlock",
        "CrossAttnDownBlock",
        "DownBlock",
    )
    up_block_types: Tuple[str, ...] = (
        "UpBlock",
        "CrossAttnUpBlock",
        "CrossAttnUpBlock",
        "CrossAttnUpBlock",
    )
    # SD-1.5 quirk: `attention_head_dim=8` means 8 *heads*
    # (reference unet_3d_blocks.py:572-573 divides the channels by it).
    num_attention_heads: int = 8
    cross_attention_dim: int = 768
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    flip_sin_to_cos: bool = True
    freq_shift: int = 0
    use_inflated_groupnorm: bool = True

    # --- temporal / motion ---
    use_motion_module: bool = False
    motion_module_resolutions: Tuple[int, ...] = (1, 2, 4, 8)
    motion_module_mid_block: bool = True
    motion_module_decoder_only: bool = False
    motion_module: MotionModuleConfig = field(default_factory=MotionModuleConfig)

    # --- audio ---
    use_audio_module: bool = False
    audio_attention_dim: int = 768
    stack_enable_blocks_name: Tuple[str, ...] = ("up", "down", "mid")
    stack_enable_blocks_depth: Tuple[int, ...] = (0, 1, 2, 3)

    # Where motion-frame features are fused before the motion module: "mid"
    # is the reference's inference, "all" its training
    # (unet_3d_blocks.py:482-490 vs :750-770, :1203-1229).
    motion_frame_fusion: str = "mid"

    # Per-block gradient checkpointing in training (the reference's
    # solver.gradient_checkpointing): each down, mid and up block of the
    # denoiser is recomputed in the backward pass.
    remat: bool = False
    # Nested per-layer checkpointing inside each denoiser block (the
    # solver's gradient_checkpointing_inner): each resnet, spatial and audio
    # transformer and motion module, and inside a motion module each
    # temporal attention and the feed-forward (over 4 chunks of the site
    # axis), is recomputed on its own. The backward's replay of a block then
    # holds one sub-layer's temporaries at a time, for one more forward of
    # each sub-layer. The ReferenceNet does not take it.
    remat_inner: bool = False


@dataclass(frozen=True)
class VAEConfig:
    """sd-vae-ft-mse / SD-1.5 AutoencoderKL architecture."""

    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215  # reference face_animate.py:234,336


@dataclass(frozen=True)
class Wav2Vec2Config:
    """facebook/wav2vec2-base-960h encoder architecture (HF semantics)."""

    conv_dim: Tuple[int, ...] = (512, 512, 512, 512, 512, 512, 512)
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = False
    feat_extract_norm: str = "group"  # "group" for -base
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    do_stable_layer_norm: bool = False  # post-norm for -base
    layer_norm_eps: float = 1e-5


@dataclass(frozen=True)
class SchedulerConfig:
    """DDIM with zero-SNR rescale, v-prediction and trailing spacing
    (reference configs/inference/default.yaml:79-90; its inference scheduler
    is built with beta_schedule="linear")."""

    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "linear"
    steps_offset: int = 1
    prediction_type: str = "v_prediction"
    rescale_betas_zero_snr: bool = True
    timestep_spacing: str = "trailing"


@dataclass(frozen=True)
class AudioProjConfig:
    """AudioProjModel dims (reference audio_proj.py:40-124)."""

    seq_len: int = 5  # +-2-frame window
    blocks: int = 12  # wav2vec2 hidden layers
    channels: int = 768
    intermediate_dim: int = 512
    output_dim: int = 768
    context_tokens: int = 32


@dataclass(frozen=True)
class ImageProjConfig:
    """ImageProjModel dims (reference image_proj.py:23-76)."""

    cross_attention_dim: int = 768
    clip_embeddings_dim: int = 512  # ArcFace embedding
    clip_extra_context_tokens: int = 4


@dataclass(frozen=True)
class FaceLocatorConfig:
    conditioning_embedding_channels: int = 320
    conditioning_channels: int = 3
    block_out_channels: Tuple[int, ...] = (16, 32, 64, 128)


def reference_unet_config(**overrides: Any) -> UNetConfig:
    """The 2D ReferenceNet: plain SD-1.5 UNet, no motion or audio modules."""
    base = dict(use_motion_module=False, use_audio_module=False,
                use_inflated_groupnorm=False)
    base.update(overrides)
    return UNetConfig(**base)


def denoising_unet_config(**overrides: Any) -> UNetConfig:
    """The 3D denoising UNet with motion and hierarchical audio modules
    (configs/inference/default.yaml:46-74)."""
    base = dict(use_motion_module=True, use_audio_module=True,
                use_inflated_groupnorm=True)
    base.update(overrides)
    return UNetConfig(**base)


def _tupled(value: Any) -> Any:
    if isinstance(value, (list, tuple)):
        return tuple(_tupled(v) for v in value)
    return value


def unet_config_from_yaml_kwargs(kwargs: Mapping[str, Any], **extra: Any) -> UNetConfig:
    """Build a UNetConfig from the reference's `unet_additional_kwargs` YAML
    sub-tree (configs/inference/default.yaml:46-74)."""
    kwargs = dict(kwargs)
    mm_kwargs = kwargs.pop("motion_module_kwargs", {}) or {}
    motion = MotionModuleConfig(
        num_attention_heads=int(mm_kwargs.get("num_attention_heads", 8)),
        num_transformer_block=int(mm_kwargs.get("num_transformer_block", 1)),
        attention_block_types=_tupled(
            mm_kwargs.get("attention_block_types", ("Temporal_Self", "Temporal_Self"))
        ),
        temporal_position_encoding=bool(mm_kwargs.get("temporal_position_encoding", True)),
        temporal_position_encoding_max_len=int(
            mm_kwargs.get("temporal_position_encoding_max_len", 32)
        ),
        temporal_attention_dim_div=int(mm_kwargs.get("temporal_attention_dim_div", 1)),
        norm_num_groups=int(mm_kwargs.get("norm_num_groups", 32)),
    )
    known = {f.name for f in dataclasses.fields(UNetConfig)}
    # Reference-only knobs are ignored (always false in its configs):
    # use_landmark, unet_use_cross_frame_attention, unet_use_temporal_attention,
    # motion_module_type ("Vanilla" is the only implementation).
    picked = {key: _tupled(value) for key, value in kwargs.items() if key in known}
    picked.update(extra)
    picked["motion_module"] = motion
    return UNetConfig(**picked)


class DotDict(dict):
    """Attribute-access dict, so that YAML configs read like the reference's
    OmegaConf objects (cfg.data.n_sample_frames)."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    @classmethod
    def wrap(cls, value: Any) -> Any:
        if isinstance(value, Mapping):
            return cls({k: cls.wrap(v) for k, v in value.items()})
        if isinstance(value, list):
            return [cls.wrap(v) for v in value]
        return value


def load_yaml(path: str) -> Any:
    """A YAML file as a `DotDict` (needs PyYAML)."""
    try:
        import yaml
    except ImportError as e:
        raise ImportError(
            f"loading {path} needs PyYAML (the `yaml` module), which is not installed"
        ) from e
    with open(path) as f:
        return DotDict.wrap(yaml.safe_load(f))


def load_config(path: str) -> Any:
    """A training or inference config from YAML, or from a Python module
    that exposes `cfg` (reference scripts/train_stage1.py:765-780)."""
    if path.endswith(".py"):
        import importlib.util

        spec = importlib.util.spec_from_file_location("hallo_cfg_module", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return DotDict.wrap(getattr(module, "cfg"))
    if path.endswith((".yaml", ".yml")):
        return load_yaml(path)
    raise ValueError(f"config must be .yaml/.yml or .py, got: {path}")


def filter_non_none(mapping: Mapping[str, Any]) -> dict:
    """Drop unset CLI arguments before they merge into a YAML config
    (reference hallo/utils/config.py:8-25)."""
    return {k: v for k, v in mapping.items() if v is not None}


def _deep_merge(base: Any, override: Mapping[str, Any]) -> Any:
    out = DotDict(dict(base))
    for key, value in override.items():
        if key in out and isinstance(out[key], Mapping) and isinstance(value, Mapping):
            out[key] = _deep_merge(out[key], value)
        else:
            out[key] = DotDict.wrap(value)
    return out


def merge_cli_overrides(config: Any, args: Mapping[str, Any]) -> Any:
    """`config` with the CLI arguments that are set laid over it."""
    return _deep_merge(config, filter_non_none(dict(args)))


def to_container(config: Any) -> dict:
    return dict(config)
