"""What both drivers share: the measured program built with the seed's
weights, the reference built with the same, the numbers the check
compares, and the FLOP count of the reference at a cell's shapes."""

from __future__ import annotations

import dataclasses
import gc
import json
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import weights
from benchmark.reference import models as ref_models
from benchmark.reference import nn as ref_nn

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _plain(x):
    return json.loads(json.dumps(x))


def build_program(cfg: dict, seed: int, device, remat: bool = False, remat_inner: bool = False):
    """The port's six modules from `utils.factory.build_models`, with the
    seed's weights. Raises where the port's configuration differs from the
    configuration file."""
    from hallo_tpu_torch.utils.factory import build_models

    fac = cfg["factory"]
    overrides = dict(fac.get("unet_overrides", {}))
    if remat_inner:
        overrides["remat_inner"] = True
    models = build_models(fac["scale"], device="meta", dtype=DTYPES[cfg["dtype"]],
                          remat=remat, unet_overrides=overrides)
    for key, got in (("unet", models.denoising_net.config), ("vae", models.vae.config),
                     ("image_proj", models.image_proj.config),
                     ("audio_proj", models.audio_proj.config)):
        have = _plain(dataclasses.asdict(got))
        for k, v in cfg[key].items():
            if k in ("remat", "remat_inner"):
                continue
            if have.get(k) != v:
                raise ValueError(f"the port's {key}.{k} is {have.get(k)!r}, the "
                                 f"configuration file's {v!r}")
    for mod in models.modules().values():
        mod.to_empty(device=device)
    weights.load(models.modules(), weights.make(cfg, seed, device, DTYPES[cfg["dtype"]]))
    return models


def build_reference(cfg: dict, seed: int, device) -> Dict[str, torch.nn.Module]:
    """The frozen reference in fp32 with the seed's weights (the served
    dtype's values, widened)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mods = ref_models.build(cfg, "meta")
    state = weights.make(cfg, seed, device, DTYPES[cfg["dtype"]])
    for top, mod in mods.items():
        mod.to_empty(device=device)
        mod.load_state_dict({k: v.float() for k, v in state.pop(top).items()}, strict=True)
        mod.eval()
    return mods


def sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def reset_peak() -> None:
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()


def peak_bytes() -> int:
    return torch.cuda.max_memory_allocated() if torch.cuda.is_available() else 0


def free() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """|a - b| / |b| in fp64."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def judged(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict]:
    """(correct, {name: {"value", "limit"}}): correct when every number is
    finite and at most its limit, and every limit has its number (a
    missing or non-finite number is null)."""
    checks = {}
    for k, limit in limits.items():  # the numbers without a limit are details
        v = numbers.get(k)
        checks[k] = {"value": float(v) if v is not None and np.isfinite(v) else None,
                     "limit": limit}
    ok = all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


def count(fn: Callable[[], object]) -> Tuple[int, List[tuple]]:
    """(FLOPs, attention calls) of `fn` run on meta tensors."""
    calls: List[tuple] = []
    with FlopCounterMode(display=False) as fc, ref_nn.recording(calls):
        fn()
    return int(fc.get_total_flops()), calls
