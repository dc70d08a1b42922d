"""hallo_tpu parameter trees -> hallo_tpu_torch state_dicts.

The inverse of hallo_tpu/convert/torch_to_jax.py: the port's modules carry
the reference checkpoints' key names, so each key is looked up with the same
per-key maps (`convert.keymaps`: `map_unet_key`, `map_vae_key`, ...) and the
layout transform is undone (`t_conv2d`: HWIO -> OIHW, `t_conv1d`:
KIO -> OIK, `t_linear`: (in, out) -> (out, in), `t_conv1x1_to_dense`:
(in, out) -> (out, in, 1, 1)). Trees are nested dicts of numpy arrays (a
leading "params" collection is accepted).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch

from hallo_tpu_torch.convert import keymaps as km

MAPPERS: Dict[str, Callable[[str], Any]] = {
    "vae": km.map_vae_key,
    "reference_net": lambda k: km.map_unet_key(k, "reference"),
    "denoising_net": lambda k: km.map_unet_key(k, "denoise"),
    "face_locator": km.map_face_locator_key,
    "image_proj": km.map_image_proj_key,
    "audio_proj": km.map_audio_proj_key,
}

# Inverse layout transforms, by the forward transform's name (a mapper may
# come from the port's `keymaps` or from the JAX package's torch_to_jax).
_INVERSE = {
    "t_conv2d": lambda a: np.transpose(a, (3, 2, 0, 1)),
    "t_conv1d": lambda a: np.transpose(a, (2, 1, 0)),
    "t_linear": np.transpose,
    "t_conv1x1_to_dense": lambda a: np.transpose(a)[:, :, None, None],
}

_POS_CONV = "encoder.pos_conv_embed.conv."


def _lookup(tree: Mapping[str, Any], path) -> np.ndarray:
    node = tree.get("params", tree)
    for part in path:
        node = node[part]
    return np.asarray(node, dtype=np.float32)


def state_dict_from_jax(
    module: torch.nn.Module,
    tree: Mapping[str, Any],
    mapper: Callable[[str], Any],
    special: Optional[Mapping[str, np.ndarray]] = None,
) -> Dict[str, torch.Tensor]:
    """The state_dict of `module` with every entry taken from `tree`, or
    from `special` for the keys that no per-key map covers."""
    out = {}
    for key, ref in module.state_dict().items():
        if special is not None and key in special:
            arr, path = special[key], ("(special)",)
        else:
            result = mapper(key)
            if result is None or isinstance(result, str):
                raise KeyError(f"no hallo_tpu parameter maps to {key}")
            path, transform = result
            arr = _lookup(tree, path)
            if transform is not None:
                arr = _INVERSE[transform.__name__](arr)
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"{key}: {arr.shape} from {'/'.join(path)} vs {tuple(ref.shape)}")
        out[key] = torch.tensor(arr, dtype=ref.dtype)
    return out


def load_jax_params(models, params: Mapping[str, Mapping[str, Any]]) -> None:
    """Load hallo_tpu's six parameter trees (`HalloModels.params`, keyed
    vae / reference_net / denoising_net / face_locator / image_proj /
    audio_proj) into the port's `HalloModels`, strictly."""
    for name, module in models.modules().items():
        sd = state_dict_from_jax(module, params[name], MAPPERS[name])
        module.load_state_dict(sd, strict=True)


def wav2vec_state_dict_from_jax(
    module: torch.nn.Module, tree: Mapping[str, Any]
) -> Dict[str, torch.Tensor]:
    """The port's `Wav2Vec2` state_dict (HF keys) from a hallo_tpu
    `Wav2Vec2.init` tree; the inverse of `torch_to_jax.convert_wav2vec`.

    The positional conv's one kernel W (K, I/groups, O) becomes
    weight_v = W in OIK and weight_g = ||W|| over (O, I/groups), keepdims,
    so that weight_g * weight_v / ||weight_v|| = W. `masked_spec_embed` is
    unused at inference and has no JAX counterpart: it is set to 0."""
    w = _INVERSE["t_conv1d"](_lookup(tree, ("pos_conv", "kernel")))
    special = {
        _POS_CONV + "weight_v": w,
        _POS_CONV + "weight_g": np.sqrt(np.sum(w**2, axis=(0, 1), keepdims=True)),
        _POS_CONV + "bias": _lookup(tree, ("pos_conv", "bias")),
        "masked_spec_embed": np.zeros(module.masked_spec_embed.shape, np.float32),
    }
    return state_dict_from_jax(module, tree, km.map_wav2vec_key, special)
