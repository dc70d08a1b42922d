"""The stage-2 trainer with a resume, run again and again on the card: how
often a step goes non-finite, and where.

    python -m hallo_tpu_torch.train.bench_trainer [--runs 5] [--watch]

Each run is `chip_smoke.py`'s trainer phase over one synthetic 20-frame
512^2 clip (sampled with replacement) in place of the dataset phase's:
`train_stage2_process` on configs/train/stage2.yaml at its batch of 4, no
validation renders, 2 steps with a checkpoint at step 2, then a resume
from it for a third step. A run is non-finite when a step's loss or
gradient norm is (the trainer's NaN guard then skips the step). With
`--watch`, max |x| of the outputs of every launch of K1, K2, K3/K4 and
K5's two passes, and of every trainable gradient, is kept on the device
(read after the run, no sync in the step), and each non-finite run is held
launch by launch against the first finite one: the first outputs and the
gradients that depart (more than 8x, or not finite) place the fault. It prints the
card's name and power limit, a line a run, then one JSON line. Copied into
an older tree of the port, it runs that tree.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import time
from typing import Optional

import numpy as np
import torch

from hallo_tpu_torch import config as cfglib
from hallo_tpu_torch.config import AudioProjConfig, ImageProjConfig
from hallo_tpu_torch.ops import _build, flash, temporal
from hallo_tpu_torch.train import step as step_module
from hallo_tpu_torch.train.stage2 import train_stage2_process

STAGE2_YAML = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "configs", "train", "stage2.yaml")


def write_trainer_clip(root: str, frames: int, size: int, seed: int) -> str:
    """One synthetic clip in `data/datasets.py`'s .npz format, at the input
    sizes of the full-width ImageProj and AudioProj, and its meta.json
    (returned)."""
    ap, ip = AudioProjConfig(), ImageProjConfig()
    rng = np.random.default_rng(seed)
    data = dict(
        frames=rng.integers(0, 256, (frames, size, size, 3), dtype=np.uint8),
        audio_emb=rng.normal(size=(frames, ap.blocks, ap.channels)).astype(np.float32),
        face_emb=rng.normal(size=(ip.clip_embeddings_dim,)).astype(np.float32),
        face_region=np.ones((size, size, 3), np.float32),
    )
    for level in range(4):
        tokens = (size // 8 >> level) ** 2
        for kind in ("full", "face", "lip"):
            data[f"{kind}_mask_{level}"] = (rng.uniform(size=(1, tokens)) > 0.3).astype(
                np.float32)
    os.makedirs(root, exist_ok=True)
    clip = os.path.join(root, "clip0.npz")
    np.savez(clip, **data)
    meta = os.path.join(root, "meta.json")
    with open(meta, "w") as fh:
        json.dump([{"clip_path": clip}], fh)
    return meta


def trainer_config(root: str, meta_path: Optional[str] = None):
    """configs/train/stage2.yaml with the cuts above, writing under `root`
    (emptied first), over `meta_path`'s clips or else the synthetic clip;
    `solver.max_train_steps` is set by the caller."""
    shutil.rmtree(root, ignore_errors=True)
    cfg = cfglib.load_config(STAGE2_YAML)
    size = int(cfg.data.train_width)
    cfg.data.meta_paths = [meta_path or write_trainer_clip(os.path.join(root, "data"), 20,
                                                           size, seed=3)]
    cfg.checkpointing_steps = 2
    cfg.val.validation_steps = 0
    cfg.output_dir = root
    cfg.log_every = 1
    return cfg


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, tuple):  # (out, lse), (dk, dv)
        for y in x:
            yield from _tensors(y)


def _amax(ts) -> torch.Tensor:
    """max |x| of each non-empty tensor, as one fp32 device vector."""
    return torch.stack([t.detach().abs().amax().float() for t in ts if t.numel()])


class Watch:
    """max |x| of every output of every K1, K2, K3/K4 and K5 launch, and of every trainable gradient, by step (device vectors until
    `read`): a run that went non-finite is held launch by launch against
    one that did not, and the first launch whose values depart names the
    place."""

    def __init__(self):
        self.records = []  # (kernel or "grads", step, max |x| of each output, names)
        self.step = 0

    def wrap(self, module, attr, name):
        real = getattr(module, attr)

        def watched(*args, **kwargs):
            out = real(*args, **kwargs)
            self.records.append((name, self.step, _amax(list(_tensors(out))), None))
            return out

        setattr(module, attr, watched)

    def install(self):
        for attr, name in (("flash_forward_packed", "K1"), ("flash_bwd_dkv", "K5 dK/dV"),
                           ("flash_bwd_dq", "K5 dQ"), ("flash_attention", "K3/K4")):
            self.wrap(flash, attr, name)
        self.wrap(temporal, "_temporal_kernel", "K2")
        real_norm = step_module.global_norm

        def norm(tensors):
            names = list(getattr(tensors, "mapping", {}))
            tensors = list(tensors)
            self.records.append(("grads", self.step, _amax(tensors), names))
            self.step += 1
            return real_norm(tensors)

        step_module.global_norm = norm

    def read(self):
        """This run's records on the host; starts the next run's."""
        out = [(name, step, vals.tolist(), extra) for name, step, vals, extra in self.records]
        self.records, self.step = [], 0
        return out


def _departs(a: float, b: float) -> bool:
    if not (np.isfinite(a) and np.isfinite(b)):
        return not a == b
    return max(a, b) > 8 * min(a, b) + 1e-3


def first_departures(bad, good, limit: int = 8) -> dict:
    """A non-finite run's first `limit` kernel outputs and first `limit`
    gradients that depart from a finite run's (more than 8x apart, or one
    not finite), launch by launch: (launch index, kernel, step, output,
    value, the finite run's) and (step, gradient, value, the finite run's)."""
    found = dict(kernels=[], grads=[])
    for i, ((name, step, vals, names), (_, _, ref, _)) in enumerate(zip(bad, good)):
        for j, (a, b) in enumerate(zip(vals, ref)):
            if _departs(a, b):
                if name == "grads" and len(found["grads"]) < limit:
                    found["grads"].append((step, names[j], a, b))
                elif name != "grads" and len(found["kernels"]) < limit:
                    found["kernels"].append((i, name, step, j, a, b))
    return found


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--watch", action="store_true",
                    help="record max |x| of every kernel output and every gradient, and "
                         "place a non-finite run's first departures")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_trainer: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    watch = Watch() if args.watch else None
    if watch:
        watch.install()
    root = os.path.join(_build.BUILD_DIR, "trainer")
    runs = []
    for i in range(args.runs):
        cfg = trainer_config(root)
        t0 = time.perf_counter()
        for steps in (2, 3):  # then the resume from checkpoint-2
            cfg.solver.max_train_steps = steps
            train_stage2_process(cfg, dev)
            torch.cuda.empty_cache()
        seconds = time.perf_counter() - t0
        with open(os.path.join(root, str(cfg.exp_name), "metrics.jsonl")) as fh:
            lines = [json.loads(line) for line in fh]
        bad = [r["step"] for r in lines
               if not (np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]))]
        run = dict(seconds=seconds, loss=[r["loss"] for r in lines],
                   grad_norm=[r["grad_norm"] for r in lines], non_finite_steps=bad)
        print(f"run {i}: {run}", flush=True)
        if watch:
            run["records"] = watch.read()
        runs.append(run)
    shutil.rmtree(root, ignore_errors=True)
    good = [r for r in runs if not r["non_finite_steps"]]
    for i, run in enumerate(runs):
        if watch and run["non_finite_steps"] and good:
            print(f"run {i}, first departures from a finite run (launch, kernel, step, "
                  f"which, value, the finite run's): "
                  f"{first_departures(run['records'], good[0]['records'])}", flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "watch": bool(watch),
                      "runs": len(runs), "non_finite_runs": sum(bool(r["non_finite_steps"])
                                                               for r in runs)}), flush=True)


if __name__ == "__main__":
    main()
