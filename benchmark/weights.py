"""The measured models' weights, made from the seed on the device.

One spec per parameter, taken from the frozen reference's module tree
(name, shape, kind): a weight or a bias is uniform in +-1/sqrt(fan_in)
(PyTorch's default initialisation scale, with the fan-in of the weight the
bias belongs to), a norm's scale 1 + U(-0.1, 0.1) and its shift
U(-0.1, 0.1). Every head that the models zero-initialise (the motion
modules' proj_out, the audio zero convs, the face locator's conv_out) is
drawn like any other weight, so that every path carries a signal. The
values come from one torch.Generator in a few large calls, in the dtype
the models are served in, so that the same seed gives the same state on
every run; the reference takes the same values in fp32.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn as nn

from benchmark.reference import models as ref_models

CHUNK = 1 << 27  # elements a generator call draws
Spec = List[Tuple[str, str, Tuple[int, ...], str, float]]


def spec(cfg: dict) -> Spec:
    """(module, name, shape, kind, bound) for every parameter, in a fixed
    order; kind is "uniform" (+-bound) or "norm_scale" (1 +- bound)."""
    out = []
    for top, mod in ref_models.build(cfg, "meta").items():
        for mname, sub in mod.named_modules():
            for pname, p in sub.named_parameters(recurse=False):
                name = f"{mname}.{pname}" if mname else pname
                shape = tuple(p.shape)
                if isinstance(sub, (nn.GroupNorm, nn.LayerNorm)):
                    kind, bound = ("norm_scale" if pname == "weight" else "uniform"), 0.1
                else:
                    w = sub.weight if pname == "bias" else p
                    fan_in = math.prod(w.shape[1:]) if w.ndim > 1 else w.shape[0]
                    kind, bound = "uniform", 1.0 / math.sqrt(fan_in)
                out.append((top, name, shape, kind, bound))
    return out


def make(cfg: dict, seed: int, device, dtype) -> Dict[str, Dict[str, torch.Tensor]]:
    """{module: state dict} of the seed, on `device` in `dtype`."""
    sp = spec(cfg)
    total = sum(math.prod(s[2]) for s in sp)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.empty(total, dtype=dtype, device=device)
    for start in range(0, total, CHUNK):
        n = min(CHUNK, total - start)
        flat[start:start + n] = torch.rand(n, generator=gen, device=device, dtype=dtype)
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    pos = 0
    for top, name, shape, kind, bound in sp:
        n = math.prod(shape)
        t = flat[pos:pos + n].view(shape)
        pos += n
        t.sub_(0.5).mul_(2.0 * bound)
        if kind == "norm_scale":
            t.add_(1.0)
        out.setdefault(top, {})[name] = t
    return out


def load(modules: Dict[str, nn.Module], state: Dict[str, Dict[str, torch.Tensor]]) -> None:
    """Copy `state` into `modules` by name; every key must match both ways."""
    for top, mod in modules.items():
        mod.load_state_dict(state[top], strict=True)
