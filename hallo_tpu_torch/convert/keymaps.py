"""Reference checkpoint keys -> hallo_tpu parameter paths, and the layout
transforms between the two.

The port's own copy of the per-key maps of hallo_tpu/convert/torch_to_jax.py
(the port imports nothing of the JAX package). Each `map_*_key` takes a
reference (diffusers / HF) state_dict key and returns the flax path of the
same parameter in a hallo_tpu tree with the transform from the torch layout
to the flax one, or "skip" for keys with no flax parameter, or None for keys
it does not know. `from_jax` runs them backwards.

Layout transforms: Conv2d OIHW -> HWIO; Conv1d OIK -> KIO;
Linear (out, in) -> (in, out); a 1x1 Conv2d used as a per-token linear ->
Dense (in, out).
"""

from __future__ import annotations

import re
from typing import Callable, Optional, Tuple

import numpy as np

FlaxPath = Tuple[str, ...]


def t_conv2d(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (2, 3, 1, 0))  # OIHW -> HWIO


def t_conv1d(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (2, 1, 0))  # OIK -> KIO


def t_linear(w: np.ndarray) -> np.ndarray:
    return np.transpose(w)  # (out, in) -> (in, out)


def t_conv1x1_to_dense(w: np.ndarray) -> np.ndarray:
    return np.transpose(w[:, :, 0, 0])  # (O, I, 1, 1) -> (I, O)


# ---------------------------------------------------------------------------
# shared sub-module mappers
# ---------------------------------------------------------------------------


def _map_norm(rest: str, base: FlaxPath):
    kind = "scale" if rest == "weight" else "bias"
    return base + (kind,), None


def _map_conv(rest: str, base: FlaxPath) -> Tuple[FlaxPath, Optional[Callable]]:
    if rest == "weight":
        return base + ("Conv_0", "kernel"), t_conv2d
    return base + ("Conv_0", "bias"), None


def _map_dense(rest: str, base: FlaxPath) -> Tuple[FlaxPath, Optional[Callable]]:
    if rest == "weight":
        return base + ("Dense_0", "kernel"), t_linear
    return base + ("Dense_0", "bias"), None


def _map_proj_1x1(rest: str, base: FlaxPath) -> Tuple[FlaxPath, Optional[Callable]]:
    """SD's proj_in / proj_out / zero_conv are 1x1 Conv2d; hallo_tpu's Dense."""
    if rest == "weight":
        return base + ("Dense_0", "kernel"), t_conv1x1_to_dense
    return base + ("Dense_0", "bias"), None


def _map_resnet(rest: str, base: FlaxPath):
    m = re.match(r"(norm1|norm2)\.(weight|bias)$", rest)
    if m:
        return _map_norm(m.group(2), base + (m.group(1),))
    m = re.match(r"(conv1|conv2|conv_shortcut)\.(weight|bias)$", rest)
    if m:
        return _map_conv(m.group(2), base + (m.group(1),))
    m = re.match(r"time_emb_proj\.(weight|bias)$", rest)
    if m:
        return _map_dense(m.group(1), base + ("time_emb_proj",))
    return None


def _map_attention(rest: str, base: FlaxPath):
    """diffusers Attention: to_q / to_k / to_v (no bias), to_out.0."""
    m = re.match(r"(to_q|to_k|to_v)\.(weight|bias)$", rest)
    if m:
        return _map_dense(m.group(2), base + (m.group(1),))
    m = re.match(r"to_out\.0\.(weight|bias)$", rest)
    if m:
        return _map_dense(m.group(1), base + ("to_out",))
    return None


def _map_ff(rest: str, base: FlaxPath):
    m = re.match(r"net\.0\.proj\.(weight|bias)$", rest)
    if m:
        return _map_dense(m.group(1), base + ("proj_in",))
    m = re.match(r"net\.2\.(weight|bias)$", rest)
    if m:
        return _map_dense(m.group(1), base + ("proj_out",))
    return None


def _map_transformer_block(rest: str, base: FlaxPath):
    """BasicTransformerBlock / TemporalBasicTransformerBlock /
    AudioTemporalBasicTransformerBlock internals."""
    m = re.match(r"(norm1|norm2|norm3)\.(weight|bias)$", rest)
    if m:
        return _map_norm(m.group(2), base + (m.group(1),))
    m = re.match(r"(attn1|attn2|attn2_0|attn2_1|attn2_2)\.(.+)$", rest)
    if m:
        return _map_attention(m.group(2), base + (m.group(1),))
    m = re.match(r"(zero_conv_full|zero_conv_face|zero_conv_lip)\.(weight|bias)$", rest)
    if m:
        return _map_proj_1x1(m.group(2), base + (m.group(1),))
    m = re.match(r"ff\.(.+)$", rest)
    if m:
        return _map_ff(m.group(1), base + ("ff",))
    return None


def _map_spatial_transformer(rest: str, base: FlaxPath):
    """Transformer2D/3D wrapper: norm, proj_in/out (1x1 conv), blocks."""
    m = re.match(r"norm\.(weight|bias)$", rest)
    if m:
        return _map_norm(m.group(1), base + ("norm",))
    m = re.match(r"(proj_in|proj_out)\.(weight|bias)$", rest)
    if m:
        return _map_proj_1x1(m.group(2), base + (m.group(1),))
    m = re.match(r"transformer_blocks\.(\d+)\.(.+)$", rest)
    if m:
        return _map_transformer_block(m.group(2), base + (f"blocks_{m.group(1)}",))
    return None


def _map_motion_module(rest: str, base: FlaxPath):
    """VanillaTemporalModule.temporal_transformer internals
    (reference motion_module.py:200-316)."""
    rest = rest.removeprefix("temporal_transformer.")
    m = re.match(r"norm\.(weight|bias)$", rest)
    if m:
        return _map_norm(m.group(1), base + ("norm",))
    m = re.match(r"(proj_in|proj_out)\.(weight|bias)$", rest)
    if m:
        return _map_dense(m.group(2), base + (m.group(1),))
    m = re.match(r"transformer_blocks\.(\d+)\.attention_blocks\.(\d+)\.(.+)$", rest)
    if m:
        k, a, inner = m.groups()
        if "pos_encoder" in inner:
            return "skip"
        return _map_attention(inner, base + (f"blocks_{k}_attn_{a}", "attn"))
    m = re.match(r"transformer_blocks\.(\d+)\.norms\.(\d+)\.(weight|bias)$", rest)
    if m:
        return _map_norm(m.group(3), base + (f"blocks_{m.group(1)}_norm_{m.group(2)}",))
    m = re.match(r"transformer_blocks\.(\d+)\.ff\.(.+)$", rest)
    if m:
        return _map_ff(m.group(2), base + (f"blocks_{m.group(1)}_ff",))
    m = re.match(r"transformer_blocks\.(\d+)\.ff_norm\.(weight|bias)$", rest)
    if m:
        return _map_norm(m.group(2), base + (f"blocks_{m.group(1)}_ff_norm",))
    return None


# ---------------------------------------------------------------------------
# UNet mappers ("flavor": reference = flat names, denoise = nested names)
# ---------------------------------------------------------------------------


def map_unet_key(key: str, flavor: str):
    """diffusers-style UNet key -> (flax path, transform) or 'skip'."""
    if flavor not in ("reference", "denoise"):
        raise ValueError(f"flavor {flavor!r}")
    flat = flavor == "reference"

    def block_base(kind: str, i: str, sub: str, j: str) -> FlaxPath:
        if flat:
            return (f"{kind}_{i}_{sub}_{j}",) + (("block",) if sub == "resnets" else ())
        return (f"{kind}_{i}", f"{sub}_{j}")

    m = re.match(r"conv_in\.(weight|bias)$", key)
    if m:
        return _map_conv(m.group(1), ("conv_in",))
    m = re.match(r"time_embedding\.(linear_1|linear_2)\.(weight|bias)$", key)
    if m:
        return _map_dense(m.group(2), ("time_embedding", m.group(1)))
    m = re.match(r"conv_norm_out\.(weight|bias)$", key)
    if m:
        return _map_norm(m.group(1), ("conv_norm_out",))
    m = re.match(r"conv_out\.(weight|bias)$", key)
    if m:
        return _map_conv(m.group(1), ("conv_out",))
    if key.startswith("time_proj"):
        return "skip"  # sinusoid table, no params

    m = re.match(r"(down_blocks|up_blocks)\.(\d+)\.resnets\.(\d+)\.(.+)$", key)
    if m:
        kind, i, j, rest = m.groups()
        return _map_resnet(rest, block_base(kind, i, "resnets", j))
    m = re.match(r"(down_blocks|up_blocks)\.(\d+)\.attentions\.(\d+)\.(.+)$", key)
    if m:
        kind, i, j, rest = m.groups()
        return _map_spatial_transformer(rest, block_base(kind, i, "attentions", j))
    m = re.match(r"(down_blocks|up_blocks)\.(\d+)\.audio_modules\.(\d+)\.(.+)$", key)
    if m:
        kind, i, j, rest = m.groups()
        return _map_spatial_transformer(rest, block_base(kind, i, "audio_modules", j))
    m = re.match(r"(down_blocks|up_blocks)\.(\d+)\.motion_modules\.(\d+)\.(.+)$", key)
    if m:
        kind, i, j, rest = m.groups()
        return _map_motion_module(rest, block_base(kind, i, "motion_modules", j))
    m = re.match(r"down_blocks\.(\d+)\.downsamplers\.0\.conv\.(weight|bias)$", key)
    if m:
        i, wb = m.groups()
        base = (
            (f"down_blocks_{i}_downsamplers_0",)
            if flat
            else (f"down_blocks_{i}", "downsamplers_0")
        )
        return _map_conv(wb, base + ("conv",))
    m = re.match(r"up_blocks\.(\d+)\.upsamplers\.0\.conv\.(weight|bias)$", key)
    if m:
        i, wb = m.groups()
        base = (
            (f"up_blocks_{i}_upsamplers_0",)
            if flat
            else (f"up_blocks_{i}", "upsamplers_0")
        )
        return _map_conv(wb, base + ("conv",))

    m = re.match(r"mid_block\.resnets\.(\d+)\.(.+)$", key)
    if m:
        j, rest = m.groups()
        base = (f"mid_block_resnets_{j}", "block") if flat else ("mid_block", f"resnets_{j}")
        return _map_resnet(rest, base)
    m = re.match(r"mid_block\.attentions\.(\d+)\.(.+)$", key)
    if m:
        j, rest = m.groups()
        base = (f"mid_block_attentions_{j}",) if flat else ("mid_block", f"attentions_{j}")
        return _map_spatial_transformer(rest, base)
    m = re.match(r"mid_block\.audio_modules\.(\d+)\.(.+)$", key)
    if m:
        j, rest = m.groups()
        return _map_spatial_transformer(rest, ("mid_block", f"audio_modules_{j}"))
    m = re.match(r"mid_block\.motion_modules\.(\d+)\.(.+)$", key)
    if m:
        j, rest = m.groups()
        return _map_motion_module(rest, ("mid_block", f"motion_modules_{j}"))
    return None


# ---------------------------------------------------------------------------
# small-module mappers
# ---------------------------------------------------------------------------


def map_face_locator_key(key: str):
    m = re.match(r"(conv_in|conv_out)\.(weight|bias)$", key)
    if m:
        return _map_conv(m.group(2), (m.group(1),))
    m = re.match(r"blocks\.(\d+)\.(weight|bias)$", key)
    if m:
        return _map_conv(m.group(2), (f"blocks_{m.group(1)}",))
    return None


def map_image_proj_key(key: str):
    m = re.match(r"proj\.(weight|bias)$", key)
    if m:
        return _map_dense(m.group(1), ("proj",))
    m = re.match(r"norm\.(weight|bias)$", key)
    if m:
        return _map_norm(m.group(1), ("norm",))
    return None


def map_audio_proj_key(key: str):
    m = re.match(r"(proj1|proj2|proj3)\.(weight|bias)$", key)
    if m:
        return _map_dense(m.group(2), (m.group(1),))
    m = re.match(r"norm\.(weight|bias)$", key)
    if m:
        return _map_norm(m.group(1), ("norm",))
    return None


def map_vae_key(key: str):
    """diffusers AutoencoderKL -> hallo_tpu AutoencoderKL paths."""
    # old checkpoints name the attention's q/k/v differently
    attn_renames = {
        "query": "to_q", "key": "to_k", "value": "to_v", "proj_attn": "to_out",
    }

    def vae_attn(rest, base):
        m = re.match(r"group_norm\.(weight|bias)$", rest)
        if m:
            return _map_norm(m.group(1), base + ("group_norm",))
        m = re.match(r"(to_q|to_k|to_v|query|key|value)\.(weight|bias)$", rest)
        if m:
            name = attn_renames.get(m.group(1), m.group(1))
            path = base + (name, m.group(2).replace("weight", "kernel"))
            return path, (t_linear if m.group(2) == "weight" else None)
        m = re.match(r"(to_out\.0|proj_attn)\.(weight|bias)$", rest)
        if m:
            path = base + ("to_out", m.group(2).replace("weight", "kernel"))
            return path, (t_linear if m.group(2) == "weight" else None)
        return None

    m = re.match(r"quant_conv\.(weight|bias)$", key)
    if m:
        return _map_conv(m.group(1), ("encoder", "quant_conv"))
    m = re.match(r"post_quant_conv\.(weight|bias)$", key)
    if m:
        return _map_conv(m.group(1), ("decoder", "post_quant_conv"))

    m = re.match(r"(encoder|decoder)\.(.+)$", key)
    if not m:
        return None
    side, rest = m.groups()
    base = (side,)
    m = re.match(r"conv_in\.(weight|bias)$", rest)
    if m:
        return _map_conv(m.group(1), base + ("conv_in",))
    m = re.match(r"conv_norm_out\.(weight|bias)$", rest)
    if m:
        return _map_norm(m.group(1), base + ("conv_norm_out",))
    m = re.match(r"conv_out\.(weight|bias)$", rest)
    if m:
        return _map_conv(m.group(1), base + ("conv_out",))
    m = re.match(r"(down|up)_blocks\.(\d+)\.resnets\.(\d+)\.(.+)$", rest)
    if m:
        kind, i, j, r2 = m.groups()
        return _map_resnet(r2, base + (f"{kind}_{i}_resnets_{j}",))
    m = re.match(r"down_blocks\.(\d+)\.downsamplers\.0\.conv\.(weight|bias)$", rest)
    if m:
        i, wb = m.groups()
        # a raw nn.Conv (no wrapper) in the VAE encoder
        path = base + (f"down_{i}_downsample", "kernel" if wb == "weight" else "bias")
        return path, (t_conv2d if wb == "weight" else None)
    m = re.match(r"up_blocks\.(\d+)\.upsamplers\.0\.conv\.(weight|bias)$", rest)
    if m:
        i, wb = m.groups()
        return _map_conv(wb, base + (f"up_{i}_upsample",))
    m = re.match(r"mid_block\.resnets\.(\d+)\.(.+)$", rest)
    if m:
        return _map_resnet(m.group(2), base + (f"mid_resnets_{m.group(1)}",))
    m = re.match(r"mid_block\.attentions\.0\.(.+)$", rest)
    if m:
        return vae_attn(m.group(1), base + ("mid_attn",))
    return None


def map_wav2vec_key(key: str):
    """HF Wav2Vec2Model key -> hallo_tpu Wav2Vec2 path. The weight-normed
    positional conv ("special_pos_conv") has no one-to-one path: its
    weight_g / weight_v make one flax kernel (see from_jax)."""
    key = key.removeprefix("wav2vec2.")
    m = re.match(r"feature_extractor\.conv_layers\.(\d+)\.conv\.(weight|bias)$", key)
    if m:
        i, wb = m.groups()
        path = ("feature_extractor", f"conv_{i}", "kernel" if wb == "weight" else "bias")
        return path, (t_conv1d if wb == "weight" else None)
    m = re.match(r"feature_extractor\.conv_layers\.0\.layer_norm\.(weight|bias)$", key)
    if m:
        name = "gn0_scale" if m.group(1) == "weight" else "gn0_bias"
        return ("feature_extractor", name), None
    m = re.match(r"feature_projection\.layer_norm\.(weight|bias)$", key)
    if m:
        return _map_norm(m.group(1), ("fp_layer_norm",))
    m = re.match(r"feature_projection\.projection\.(weight|bias)$", key)
    if m:
        return _map_dense(m.group(1), ("fp_projection",))
    if "pos_conv_embed" in key:
        return "special_pos_conv"
    m = re.match(r"encoder\.layer_norm\.(weight|bias)$", key)
    if m:
        return _map_norm(m.group(1), ("encoder_layer_norm",))
    m = re.match(
        r"encoder\.layers\.(\d+)\.attention\.(q_proj|k_proj|v_proj|out_proj)\.(weight|bias)$",
        key,
    )
    if m:
        i, name, wb = m.groups()
        path = (f"layers_{i}", name, "kernel" if wb == "weight" else "bias")
        return path, (t_linear if wb == "weight" else None)
    m = re.match(r"encoder\.layers\.(\d+)\.(layer_norm|final_layer_norm)\.(weight|bias)$", key)
    if m:
        return _map_norm(m.group(3), (f"layers_{m.group(1)}", m.group(2)))
    m = re.match(
        r"encoder\.layers\.(\d+)\.feed_forward\.(intermediate_dense|output_dense)\.(weight|bias)$",
        key,
    )
    if m:
        i, name, wb = m.groups()
        short = "intermediate" if name == "intermediate_dense" else "output"
        path = (f"layers_{i}", short, "kernel" if wb == "weight" else "bias")
        return path, (t_linear if wb == "weight" else None)
    if key.startswith(("masked_spec_embed", "feature_projection.dropout")):
        return "skip"
    return "skip" if key.startswith(("adapter", "quantizer", "project_")) else None
