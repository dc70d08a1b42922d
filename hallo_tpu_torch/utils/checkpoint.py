"""Train-state snapshots and weight exports (counterpart of
hallo_tpu/utils/checkpoint.py, on `torch.save` instead of orbax).

- `save_train_state`: the whole `TrainState` (step, fp32 masters, optimizer
  state) as `checkpoint-N/train_state.pt`, keeping the newest `keep`
  (reference `accelerator.save_state` + util.py:120-151's rotation);
- `load_train_state` / `latest_step`: resume from "latest"
  (reference util.py:784-819);
- `save_params`: per-module weight exports (`final_net`).
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Dict, Optional, Tuple

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


def save_params(path: str, modules: Dict[str, torch.nn.Module]) -> str:
    """Export each module's state_dict as path/{name}.pt."""
    os.makedirs(path, exist_ok=True)
    for name, module in modules.items():
        torch.save(module.state_dict(), os.path.join(path, f"{name}.pt"))
    return path
