"""Load the reference's pretrained-model layout into the port's modules
(counterpart of hallo_tpu/convert/load_pretrained.py).

The port's modules carry the reference checkpoints' own keys
(tests/test_torch_weights.py), so each file's tensors are copied into the
module state dict of the same names, in the module's dtype and on its
device, one module at a time. The merge order is the JAX package's
(load_pretrained.py:95-120), a later file winning:
- VAE: sd-vae-ft-mse;
- ReferenceNet: SD-1.5's UNet, then net.pth's `reference_unet.*`;
- denoising UNet: SD-1.5's UNet, then AnimateDiff's motion module, then
  net.pth's `denoising_unet.*`;
- face locator, image and audio projections: net.pth's `face_locator.*`,
  `imageproj.*`, `audioproj.*`.
The expected directory layout is the reference's `pretrained_models/`.

Each module's report holds `loaded`, `missing_in_ckpt`, `shape_mismatch`,
`unused_ckpt` (keys meant for the module that it does not hold) and
`unmapped_ckpt_keys` (keys no per-key map knows). A key whose shape does not
match keeps its initial value and is reported, as the reference's
`from_pretrained_2d` does (unet_3d.py:776-830) and the JAX package's loader
by default.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from hallo_tpu_torch.convert import keymaps as km
from hallo_tpu_torch.convert.checkpoint_io import (
    load_any, load_torch_checkpoint, split_net_pth)
from hallo_tpu_torch.convert.from_jax import MAPPERS

logger = logging.getLogger(__name__)

Report = Dict[str, List[str]]


def _first_existing(root: str, names: Sequence[str]) -> Optional[str]:
    for name in names:
        path = os.path.join(root, name)
        if os.path.exists(path):
            return path
    return None


def find_unet_weights(base_model_path: str) -> Optional[str]:
    return _first_existing(base_model_path, (
        "unet/diffusion_pytorch_model.safetensors", "unet/diffusion_pytorch_model.bin"))


def find_vae_weights(vae_path: str) -> Optional[str]:
    return _first_existing(vae_path, (
        "diffusion_pytorch_model.safetensors", "diffusion_pytorch_model.bin"))


def find_wav2vec_weights(model_path: str) -> Optional[str]:
    return _first_existing(model_path, ("model.safetensors", "pytorch_model.bin"))


@torch.no_grad()
def load_module(
    module: torch.nn.Module,
    state_dicts: Sequence[Mapping[str, torch.Tensor]],
    mapper: Callable[[str], Any],
) -> Report:
    """Copy the keys of `state_dicts` (merged in order, a later one winning)
    into `module`'s state dict of the same names. `mapper` (the per-key map
    of `convert.keymaps`) names the keys to skip ("skip") and the unknown
    ones (None)."""
    merged: Dict[str, torch.Tensor] = {}
    unmapped: List[str] = []
    for sd in state_dicts:
        for key, value in sd.items():
            result = mapper(key)
            if result == "skip":
                continue
            if result is None:
                unmapped.append(key)
                continue
            merged[key] = value
    own = module.state_dict()
    report: Report = {"loaded": [], "missing_in_ckpt": [], "shape_mismatch": [],
                      "unused_ckpt": [k for k in merged if k not in own],
                      "unmapped_ckpt_keys": unmapped}
    for key, target in own.items():
        if key not in merged:
            report["missing_in_ckpt"].append(key)
        elif tuple(merged[key].shape) != tuple(target.shape):
            report["shape_mismatch"].append(key)
        else:
            target.copy_(merged[key])
            report["loaded"].append(key)
    return report


def load_pretrained(
    models,
    base_model_path: Optional[str] = None,
    motion_module_path: Optional[str] = None,
    vae_model_path: Optional[str] = None,
    net_pth_path: Optional[str] = None,
    min_loaded_fraction: float = 0.0,
) -> Dict[str, Report]:
    """Overlay every pretrained file that exists onto `models` (a
    `HalloModels`, in place); returns the report per module loaded. Missing
    files are skipped with a warning (smoke runs go on with the initial
    weights).

    `min_loaded_fraction`: a module for which a file was found must load at
    least this fraction of its tensors, or RuntimeError (the reference
    asserts load completeness, inference.py:250). It is checked as each
    module is loaded, so a wrong-layout file fails before the next file is
    read."""
    reports: Dict[str, Report] = {}

    def load(name: str, sds: List[Mapping[str, torch.Tensor]]) -> None:
        report = load_module(getattr(models, name), sds, MAPPERS[name])
        _log(name, report)
        reports[name] = report
        if min_loaded_fraction > 0.0:
            check_load_completeness({name: report}, min_loaded_fraction)

    if vae_model_path:
        vae_file = find_vae_weights(vae_model_path)
        if vae_file:
            load("vae", [load_any(vae_file)])

    unet_sd = None
    if base_model_path:
        unet_file = find_unet_weights(base_model_path)
        if unet_file:
            unet_sd = load_any(unet_file)
        else:
            logger.warning("no SD-1.5 UNet weights under %s", base_model_path)
    net_groups = None
    if net_pth_path and os.path.exists(net_pth_path):
        net_groups = split_net_pth(load_torch_checkpoint(net_pth_path))

    ref_sds = [sd for sd in (unet_sd,) if sd is not None]
    if net_groups and net_groups["reference_unet"]:
        ref_sds.append(net_groups["reference_unet"])
    if ref_sds:
        load("reference_net", ref_sds)

    motion_sd = None
    if motion_module_path and os.path.exists(motion_module_path):
        motion_sd = load_torch_checkpoint(motion_module_path)
    den_sds = [sd for sd in (unet_sd, motion_sd) if sd is not None]
    if net_groups and net_groups["denoising_unet"]:
        den_sds.append(net_groups["denoising_unet"])
    if den_sds:
        load("denoising_net", den_sds)
    del unet_sd, motion_sd, den_sds, ref_sds

    if net_groups:
        for part, name in (("face_locator", "face_locator"), ("imageproj", "image_proj"),
                           ("audioproj", "audio_proj")):
            if net_groups[part]:
                load(name, [net_groups[part]])
    return reports


def check_load_completeness(reports: Mapping[str, Report], min_loaded_fraction: float) -> None:
    """Fail when a module with a found checkpoint loaded below the
    threshold: a wrong-layout checkpoint must not render garbage with rc 0
    (reference inference.py:250)."""
    failures = []
    for name, report in reports.items():
        loaded = len(report["loaded"])
        total = loaded + len(report["missing_in_ckpt"]) + len(report["shape_mismatch"])
        frac = loaded / max(total, 1)
        if frac < min_loaded_fraction:
            sample = (report["shape_mismatch"] + report["missing_in_ckpt"])[:5]
            failures.append(f"{name}: loaded {loaded}/{total} ({frac:.1%}) — e.g. {sample}")
    if failures:
        raise RuntimeError("checkpoint load incomplete (pass --allow-partial to override):\n  "
                           + "\n  ".join(failures))


def _wav2vec_key(key: str) -> str:
    """The port's Wav2Vec2 key of an HF checkpoint key: the ForCTC wrapper's
    `wav2vec2.` prefix off, newer exports' weight-norm parametrisation under
    its weight_g / weight_v names (the port keeps the pair, as HF's module
    does, and computes the weight in `forward`)."""
    return (key.removeprefix("wav2vec2.")
            .replace("pos_conv_embed.conv.parametrizations.weight.original0",
                     "pos_conv_embed.conv.weight_g")
            .replace("pos_conv_embed.conv.parametrizations.weight.original1",
                     "pos_conv_embed.conv.weight_v"))


def load_wav2vec_state_dict(
    model_path: str, init_state_dict: Mapping[str, torch.Tensor]
) -> Tuple[Dict[str, torch.Tensor], Report]:
    """wav2vec2-base-960h's HF directory -> the port's Wav2Vec2 state dict
    (`overlay_wav2vec`). FileNotFoundError when the directory holds no
    weights file."""
    path = find_wav2vec_weights(model_path)
    if path is None:
        raise FileNotFoundError(f"no wav2vec weights under {model_path}")
    return overlay_wav2vec(load_any(path), init_state_dict)


def overlay_wav2vec(
    checkpoint: Mapping[str, torch.Tensor], init_state_dict: Mapping[str, torch.Tensor]
) -> Tuple[Dict[str, torch.Tensor], Report]:
    """`init_state_dict` with every tensor of an HF wav2vec2 checkpoint laid
    over it (a shape mismatch raises, as the JAX package's strict load
    does)."""
    sd = {_wav2vec_key(k): v for k, v in checkpoint.items()}
    out = dict(init_state_dict)
    report: Report = {"loaded": [], "missing_in_ckpt": [], "shape_mismatch": [],
                      "unused_ckpt": [], "unmapped_ckpt_keys": []}
    for key, value in sd.items():
        result = km.map_wav2vec_key(key)
        if result is None:
            report["unmapped_ckpt_keys"].append(key)
        elif key not in out:
            report["unused_ckpt"].append(key)
        elif tuple(value.shape) != tuple(out[key].shape):
            raise ValueError(f"shape mismatch at {key}: ckpt {tuple(value.shape)} "
                             f"vs model {tuple(out[key].shape)}")
        else:
            out[key] = value
            report["loaded"].append(key)
    report["missing_in_ckpt"] = [k for k in out if k not in report["loaded"]]
    _log("wav2vec", report)
    return out, report


def _log(name: str, report: Report) -> None:
    logger.info(
        "%s: loaded=%d missing=%d mismatched=%d unused=%d unmapped=%d", name,
        len(report["loaded"]), len(report["missing_in_ckpt"]), len(report["shape_mismatch"]),
        len(report["unused_ckpt"]), len(report["unmapped_ckpt_keys"]))
    for key in report["shape_mismatch"][:8]:
        logger.warning("%s: shape mismatch (kept the initial value): %s", name, key)
