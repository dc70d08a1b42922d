"""Model factory (counterpart of hallo_tpu/utils/factory.py): the full
SD-1.5-based configuration, or the tiny one the CPU tests use, and the
wav2vec2 encoder at full or tiny width. The `TINY_*` widths are the JAX
package's (restated here; a test holds them equal). Models are built on the
card unless the caller asks for another device."""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from hallo_tpu_torch.config import (
    AudioProjConfig,
    FaceLocatorConfig,
    ImageProjConfig,
    MotionModuleConfig,
    VAEConfig,
    Wav2Vec2Config,
    denoising_unet_config,
    reference_unet_config,
)
from hallo_tpu_torch.models.wav2vec import Wav2Vec2
from hallo_tpu_torch.pipelines.face_animate import HalloModels

TINY_UNET_KW = dict(
    block_out_channels=(8, 16, 16, 16),
    layers_per_block=1,
    num_attention_heads=2,
    cross_attention_dim=12,
    norm_num_groups=4,
    audio_attention_dim=6,
    motion_module=MotionModuleConfig(
        num_attention_heads=2,
        temporal_position_encoding_max_len=8,
        norm_num_groups=4,
    ),
)

TINY_AUX = dict(
    vae_config=VAEConfig(
        block_out_channels=(8, 8, 8, 8), layers_per_block=1, norm_num_groups=4
    ),
    face_locator_config=FaceLocatorConfig(
        conditioning_embedding_channels=8, block_out_channels=(4, 4, 4, 4)
    ),
    image_proj_config=ImageProjConfig(cross_attention_dim=12, clip_embeddings_dim=16),
    audio_proj_config=AudioProjConfig(
        seq_len=3, blocks=2, channels=4, intermediate_dim=8, output_dim=6,
        context_tokens=3,
    ),
)


# wav2vec2 widths by scale. "tiny" is tests/test_wav2vec_golden.py's HF
# config; "tiny_slice" emits TINY_AUX's audio-proj input (blocks = layers,
# channels = hidden), so that the tiny pipeline can take its embeddings.
WAV2VEC_CONFIGS = {
    "full": Wav2Vec2Config(),
    "tiny": Wav2Vec2Config(
        conv_dim=(8, 8), conv_kernel=(3, 3), conv_stride=(2, 2), hidden_size=16,
        num_hidden_layers=2, num_attention_heads=2, intermediate_size=24,
        num_conv_pos_embeddings=4, num_conv_pos_embedding_groups=2,
    ),
    "tiny_slice": Wav2Vec2Config(
        conv_dim=(8, 8), conv_kernel=(3, 3), conv_stride=(2, 2),
        hidden_size=TINY_AUX["audio_proj_config"].channels,
        num_hidden_layers=TINY_AUX["audio_proj_config"].blocks,
        num_attention_heads=2, intermediate_size=8,
        num_conv_pos_embeddings=4, num_conv_pos_embedding_groups=2,
    ),
}


def build_models(
    scale: str = "full",
    device: torch.device = torch.device("cuda"),
    dtype: torch.dtype = torch.float32,
    seed: int = 0,
    remat: bool = False,
    unet_overrides: Optional[Dict[str, Any]] = None,
) -> HalloModels:
    """Random-initialised models from `seed`, built on `device` in `dtype`.
    "full" is the production configuration; "tiny" the test widths. `remat`:
    per-block gradient checkpointing of the denoiser in training.
    `unet_overrides` apply to both UNets' configs, as the JAX factory's do:
    the stage-1 (2D) models are `use_motion_module=False,
    use_audio_module=False` (plus `use_inflated_groupnorm=False` for the
    static bench)."""
    if scale == "tiny":
        kw, aux = dict(TINY_UNET_KW), TINY_AUX
    elif scale == "full":
        kw, aux = {}, {}
    else:
        raise ValueError(scale)
    kw.update(unet_overrides or {})
    return HalloModels.create(
        reference_unet_config(**kw), denoising_unet_config(**{"remat": remat, **kw}),
        device=device, dtype=dtype, seed=seed, **aux,
    )


def build_wav2vec(
    scale: str = "full",
    device: torch.device = torch.device("cuda"),
    seed: int = 0,
) -> Wav2Vec2:
    """A random-initialised `Wav2Vec2` of `WAV2VEC_CONFIGS[scale]` from
    `seed`, built on `device` in fp32 (the audio path runs in fp32 only, as
    JAX's does)."""
    if scale not in WAV2VEC_CONFIGS:
        raise ValueError(scale)
    device = torch.device(device)
    with torch.random.fork_rng(devices=[device] if device.type == "cuda" else []):
        torch.manual_seed(seed)
        with torch.device(device):
            model = Wav2Vec2(WAV2VEC_CONFIGS[scale])
    return model.eval().requires_grad_(False)


def dummy_clip_inputs(
    models: HalloModels,
    height: int,
    width: int,
    clip_length: int,
    batch: int = 1,
    seed: int = 0,
) -> Dict[str, Any]:
    """Random `FaceAnimatePipeline.__call__` inputs (numpy) of the right
    shapes: one clip of audio windows."""
    ip = models.image_proj.config
    ap = models.audio_proj.config
    rng = np.random.default_rng(seed)
    hl, wl = height // 8, width // 8
    return dict(
        ref_image=rng.uniform(-1, 1, size=(batch, height, width, 3)).astype(np.float32),
        audio_windows=rng.normal(
            size=(clip_length, ap.seq_len, ap.blocks, ap.channels)
        ).astype(np.float32),
        face_emb=rng.normal(size=(batch, ip.clip_embeddings_dim)).astype(np.float32),
        face_region=np.ones((batch, height, width, 3), np.float32),
        masks=tuple(
            tuple(
                np.ones((batch, (hl // 2**d) * (wl // 2**d)), np.float32)
                for _ in range(3)
            )
            for d in range(4)
        ),
    )
