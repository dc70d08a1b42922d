"""Read the reference's checkpoint files (counterpart of
hallo_tpu/convert/torch_to_jax.py:539-634's file readers and
`split_net_pth`).

Tensors stay on the host in the file's dtype: `convert.load_pretrained`
copies them into the port's modules one module at a time, so no
full-width fp32 copy of a checkpoint is ever made. A zip-format torch file
is memory-mapped (`mmap=True`): its pages are read as the tensors are
copied. A .safetensors file is read by the safetensors library
(`safetensors.torch.load_file`, as the JAX package reads it), tensor by
tensor from its mapped file, with no second copy of the file's bytes.
"""

from __future__ import annotations

import zipfile
from typing import Dict

import safetensors.torch
import torch

NET_PTH_PARTS = ("reference_unet", "denoising_unet", "face_locator", "imageproj", "audioproj")


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A `torch.save`d state dict (weights only), or its "state_dict"
    entry."""
    sd = torch.load(path, map_location="cpu", weights_only=True,
                    mmap=zipfile.is_zipfile(path))
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return sd


def load_any(path: str) -> Dict[str, torch.Tensor]:
    if path.endswith(".safetensors"):
        return safetensors.torch.load_file(path, device="cpu")
    return load_torch_checkpoint(path)


def split_net_pth(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Dict[str, torch.Tensor]]:
    """hallo's fused net.pth -> one state dict per part, by the reference
    `Net`'s attribute names (scripts/inference.py:51-94)."""
    groups: Dict[str, Dict[str, torch.Tensor]] = {p: {} for p in NET_PTH_PARTS}
    for key, value in state_dict.items():
        for prefix in groups:
            if key.startswith(prefix + "."):
                groups[prefix][key[len(prefix) + 1:]] = value
                break
    return groups
