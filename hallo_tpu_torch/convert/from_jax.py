"""hallo_tpu parameter trees -> hallo_tpu_torch state_dicts.

The inverse of hallo_tpu/convert/torch_to_jax.py: the port's modules carry
the reference checkpoints' key names, so each key is looked up with the same
per-key maps (`map_unet_key`, `map_vae_key`, ...) and the layout transform
is undone (`t_conv2d`: HWIO -> OIHW, `t_linear`: (in, out) -> (out, in),
`t_conv1x1_to_dense`: (in, out) -> (out, in, 1, 1)). Trees are nested dicts
of numpy arrays (a leading "params" collection is accepted).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping

import numpy as np
import torch

from hallo_tpu.convert import torch_to_jax as tj

MAPPERS: Dict[str, Callable[[str], Any]] = {
    "vae": tj.map_vae_key,
    "reference_net": lambda k: tj.map_unet_key(k, "reference"),
    "denoising_net": lambda k: tj.map_unet_key(k, "denoise"),
    "face_locator": tj.map_face_locator_key,
    "image_proj": tj.map_image_proj_key,
    "audio_proj": tj.map_audio_proj_key,
}

_INVERSE = {
    tj.t_conv2d: lambda a: np.transpose(a, (3, 2, 0, 1)),
    tj.t_linear: np.transpose,
    tj.t_conv1x1_to_dense: lambda a: np.transpose(a)[:, :, None, None],
}


def _lookup(tree: Mapping[str, Any], path) -> np.ndarray:
    node = tree.get("params", tree)
    for part in path:
        node = node[part]
    return np.asarray(node, dtype=np.float32)


def state_dict_from_jax(
    module: torch.nn.Module, tree: Mapping[str, Any], mapper: Callable[[str], Any]
) -> Dict[str, torch.Tensor]:
    """The state_dict of `module` with every entry taken from `tree`."""
    out = {}
    for key, ref in module.state_dict().items():
        result = mapper(key)
        if result is None or result == "skip":
            raise KeyError(f"no hallo_tpu parameter maps to {key}")
        path, transform = result
        arr = _lookup(tree, path)
        if transform is not None:
            arr = _INVERSE[transform](arr)
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
