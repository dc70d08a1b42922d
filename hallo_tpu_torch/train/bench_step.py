"""Seconds per stage-2 train step on the card (counterpart of
scripts/bench_train_step.py, BASELINE.json config 5).

    python -m hallo_tpu_torch.train.bench_step [--batch 4 --remat-inner]

The full-width models (random weights from a seed, bf16, per-block
gradient checkpointing, with `--remat-inner` per-layer too, as stage2.yaml
trains) take 12 steps of `make_train_step` at 512^2, `--batch` samples (1
by default; stage2.yaml's is 4), 14 + 2 frames, on a synthetic batch from
a seed; then one more step under `utils.profiling.trace` counts the kernel
launches and the device's busy time, by category too. It prints the card's
name and power limit, then one JSON line. Times on one card spread between
runs (PERF.md): compare two versions of the code only within one machine
session, in turns.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from hallo_tpu_torch.pipelines.face_animate import HalloModels
from hallo_tpu_torch.train.state import (
    AdamW, OptimizerConfig, TrainState, stage2_trainable, unfreeze)
from hallo_tpu_torch.train.step import TrainConfig, make_train_step, step_generator
from hallo_tpu_torch.utils import profiling
from hallo_tpu_torch.utils.factory import build_models

STEPS = 12  # timed steps; the median leaves out the first two (warm-up)


def synthetic_batch(models: HalloModels, b: int, size: int, frames: int, motion: int,
                    seed: int, fixed: bool) -> dict:
    """A synthetic stage-2 batch of `b` samples (numpy, the JAX layouts) from
    `seed`, at scripts/bench_train_step.py's shapes; with `fixed`, its noise
    and timesteps too, and masks and face region that are not all ones."""
    ip, ap = models.image_proj.config, models.audio_proj.config
    rng = np.random.default_rng(seed)
    hl = size // 8

    def uniform(*shape):
        return rng.uniform(-1, 1, shape).astype(np.float32)

    batch = dict(
        pixel_values=uniform(b, frames, size, size, 3),
        ref_pixels=uniform(b, size, size, 3),
        motion_pixels=uniform(b, motion, size, size, 3),
        audio_windows=rng.normal(
            size=(b, frames, ap.seq_len, ap.blocks, ap.channels)).astype(np.float32),
        face_emb=rng.normal(size=(b, ip.clip_embeddings_dim)).astype(np.float32),
        face_region=np.ones((b, size, size, 3), np.float32),
        masks=tuple(tuple(np.ones((b, (hl >> d) ** 2), np.float32) for _ in range(3))
                    for d in range(4)),
    )
    if fixed:
        batch.update(
            face_region=rng.uniform(0, 1, (b, size, size, 3)).astype(np.float32),
            masks=tuple(tuple((rng.uniform(size=(b, (hl >> d) ** 2)) > 0.3).astype(np.float32)
                              for _ in range(3)) for d in range(4)),
            noise=rng.normal(size=(b, frames, hl, hl, 4)).astype(np.float32),
            timesteps=np.full(b, 400),
        )
    return batch


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--remat-inner", action="store_true",
                    help="nested per-layer checkpointing inside each block")
    ap.add_argument("--trace-dir", default=".cache/bench_step",
                    help="where the profiled step's Chrome trace is written")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_step: no CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    models = build_models("full", device=dev, dtype=torch.bfloat16, seed=0, remat=True,
                          unet_overrides=dict(remat_inner=args.remat_inner))
    trainable = unfreeze(models.modules(), stage2_trainable)
    opt = AdamW(OptimizerConfig(learning_rate=1e-5, lr_warmup_steps=1))  # stage2.yaml
    state = TrainState.create(trainable, opt)
    step = make_train_step(models, trainable, opt, TrainConfig())
    batch = synthetic_batch(models, args.batch, 512, 14, 2, seed=0, fixed=False)

    torch.cuda.reset_peak_memory_stats()
    seconds, losses = [], []
    for i in range(STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch, step_generator(0, i, dev))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        losses.append(metrics["loss"])
    peak = torch.cuda.max_memory_allocated()

    with profiling.trace(args.trace_dir):
        t0 = time.perf_counter()
        step(state, batch, step_generator(0, STEPS, dev))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    summary = profiling.summarize_device_time(args.trace_dir)
    print(json.dumps(dict(
        batch=args.batch, remat_inner=args.remat_inner, seconds=seconds,
        median_after_warmup=float(np.median(seconds[2:])), losses=losses,
        peak_gib=peak / 2**30, profiled_wall_ms=wall * 1e3, device_busy_ms=summary["total_ms"],
        kernel_launch_calls=summary["launch_calls"],
        device_ms_by_category=summary["by_category_ms"])), flush=True)


if __name__ == "__main__":
    main()
