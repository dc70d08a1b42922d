"""Train-state snapshots and weight exports (counterpart of
hallo_tpu/utils/checkpoint.py, on `torch.save` instead of orbax).

- `save_train_state`: the whole `TrainState` (step, fp32 masters, optimizer
  state) as `checkpoint-N/train_state.pt`, keeping the newest `keep`
  (reference `accelerator.save_state` + util.py:120-151's rotation);
- `load_train_state` / `latest_step`: resume from "latest"
  (reference util.py:784-819);
- `save_params` / `load_params`: per-module weight exports (stage 2's
  `final_net`, stage 1's `final_{module}`) and their read-back. The port
  reads its own export format; the JAX package's orbax exports need JAX.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Dict, List, Mapping, Optional, Tuple

import torch

from hallo_tpu_torch.train.state import TrainState

_STATE_FILE = "train_state.pt"


def _ckpt_dir(root: str, step: int) -> str:
    return os.path.join(root, f"checkpoint-{step}")


def _steps(root: str):
    if not os.path.isdir(root):
        return []
    return sorted(int(m.group(1)) for name in os.listdir(root)
                  if (m := re.fullmatch(r"checkpoint-(\d+)", name)))


def latest_step(root: str) -> Optional[int]:
    steps = _steps(root)
    return steps[-1] if steps else None


def rotate(root: str, keep: int) -> None:
    """Keep the newest `keep` checkpoints (util.py:120-151)."""
    for step in _steps(root)[:-keep] if keep > 0 else []:
        shutil.rmtree(_ckpt_dir(root, step), ignore_errors=True)


def save_train_state(root: str, step: int, state: TrainState, keep: int = 3) -> str:
    """Snapshot the full train state into root/checkpoint-{step}."""
    path = _ckpt_dir(root, step)
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, _STATE_FILE + ".tmp")
    torch.save(state.state_dict(), tmp)
    os.replace(tmp, os.path.join(path, _STATE_FILE))
    rotate(root, keep)
    return path


def load_train_state(root: str, step: Optional[int] = None,
                     device=None) -> Tuple[TrainState, int]:
    """The train state of checkpoint-{step} (None: the latest), on `device`
    (where it was saved from, by default)."""
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoint-* under {root}")
    sd = torch.load(os.path.join(_ckpt_dir(root, step), _STATE_FILE), map_location=device)
    return TrainState.from_state_dict(sd), step


def save_params(path: str, modules: Dict[str, torch.nn.Module],
                masters: Optional[Mapping[str, torch.Tensor]] = None) -> str:
    """Export each module's state_dict as path/{name}.pt; a tensor that
    `masters` holds under "name.key" (a `TrainState`'s fp32 masters) is
    written in its place."""
    os.makedirs(path, exist_ok=True)
    masters = masters or {}
    for name, module in modules.items():
        sd = {k: masters.get(f"{name}.{k}", v) for k, v in module.state_dict().items()}
        torch.save(sd, os.path.join(path, f"{name}.pt"))
    return path


@torch.no_grad()
def load_params(path: str, modules: Dict[str, torch.nn.Module],
                strict: bool = True) -> Dict[str, List[str]]:
    """Read path/{name}.pt into each module (a `save_params` export), in the
    module's dtype and on its device: an export of the module's own dtype
    reads back bit for bit. A key the module lacks raises. With
    `strict=False` a module's tensors that the export lacks keep their
    values (stage 2's denoiser, whose motion and audio modules a stage-1
    export does not hold; the reference loads it with strict=False).
    Returns each module's kept (missing) keys."""
    missing = {}
    for name, module in modules.items():
        sd = torch.load(os.path.join(path, f"{name}.pt"), map_location="cpu",
                        weights_only=True)
        result = module.load_state_dict(sd, strict=strict)
        if result.unexpected_keys:
            raise RuntimeError(f"{path}/{name}.pt: keys {name} does not hold: "
                               f"{result.unexpected_keys[:5]}")
        missing[name] = list(result.missing_keys)
    return missing
