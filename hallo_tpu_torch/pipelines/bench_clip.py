"""Seconds per denoiser step and per clip of the inference path on the card.

    python -m hallo_tpu_torch.pipelines.bench_clip [--clips 3] [--steps 4]
        [--batch 2] [--sampler unipc] [--timestep-schedule logsnr]
        [--step-cache dynamic]
        [--step-cache-threshold 0.1] [--cfg-cache-stride 2] [--cfg-tail 2]

The full-width models (random weights from a seed, bf16) drive
`FaceAnimatePipeline` at 512^2 over `--clips` clips of 16 frames (2 motion
frames, CFG) for `--batch` identities at once (bench.py's
HALLO_BENCH_BATCH: distinct references and embeddings, shared audio) with
the given sampler, eval grid and caches (DDIM at 4 steps
by default; the fast profile is `--sampler unipc --steps 10`, turbo
`--steps 8`) on random inputs from a seed. The first run passes `timings`
(a synchronisation at every phase and step); the first clip carries the
warm-up and is left out of the medians. A second run without `timings`
gives the warm seconds a clip with the next clip's dispatch overlapping the
fetch. It prints the card's name and power limit, then one JSON line:
every denoiser step's seconds and kind, their median after the first clip,
every clip's VAE encode and decode seconds (the phases that launch K4) with
their medians after the first clip, K1's, K2's and K4's launches a clip,
the untimed run's seconds a clip and frames/s (over the batch), and its
peak memory. Times
on one card spread between runs (PERF.md): compare two versions of the code
only within one machine session, in turns.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from hallo_tpu_torch.ops import flash, temporal
from hallo_tpu_torch.pipelines.face_animate import FaceAnimatePipeline
from hallo_tpu_torch.utils.factory import build_models, dummy_clip_inputs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clips", type=int, default=3)
    ap.add_argument("--steps", type=int, default=4, help="sampler steps (evals) per clip")
    ap.add_argument("--batch", type=int, default=1, help="identities generated at once")
    ap.add_argument("--sampler", default="ddim", help="ddim, dpm++2m or unipc")
    ap.add_argument("--timestep-schedule", default="trailing", help="trailing or logsnr")
    ap.add_argument("--step-cache", default=None, help="off, uniform or dynamic")
    ap.add_argument("--step-cache-threshold", type=float, default=0.10)
    ap.add_argument("--cfg-cache-stride", type=int, default=1)
    ap.add_argument("--cfg-tail", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_clip: no CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    models = build_models("full", device=dev, dtype=torch.bfloat16, seed=0)
    clip = 16
    pipe = FaceAnimatePipeline(
        models, num_inference_steps=args.steps, clip_length=clip, n_motion_frames=2,
        sampler=args.sampler, timestep_schedule=args.timestep_schedule,
        step_cache=args.step_cache, step_cache_threshold=args.step_cache_threshold,
        cfg_cache_stride=args.cfg_cache_stride, cfg_tail=args.cfg_tail)
    inputs = dummy_clip_inputs(models, 512, 512, clip, batch=args.batch, seed=0)
    inputs["audio_windows"] = np.concatenate([inputs["audio_windows"]] * args.clips)
    timings: dict = {}
    for table in (flash.LAUNCHES, temporal.LAUNCHES):
        for key in table:
            table[key] = 0
    pipe(**inputs, seed=0, timings=timings)
    torch.cuda.synchronize()
    launches = dict(k1=flash.LAUNCHES["flash_fwd_packed"], k2=temporal.LAUNCHES["temporal_attn"],
                    k4=flash.LAUNCHES["flash_fwd"])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipe(**inputs, seed=1)
    torch.cuda.synchronize()
    untimed = (time.perf_counter() - t0) / args.clips
    steps = timings["denoise_step"]
    n = pipe.sampler.num_steps
    print(json.dumps(dict(
        batch=args.batch, sampler=pipe.sampler.name, steps=n,
        timestep_schedule=args.timestep_schedule,
        step_cache=pipe.step_cache, step_cache_threshold=args.step_cache_threshold,
        cfg_cache_stride=args.cfg_cache_stride, cfg_tail=args.cfg_tail,
        denoise_step_seconds=steps, step_kind=timings["step_kind"],
        median_after_first_clip=float(np.median(steps[n:])),
        vae_encode_seconds=timings["vae_encode"], vae_decode_seconds=timings["vae_decode"],
        vae_encode_median_after_first_clip=float(np.median(timings["vae_encode"][1:])),
        vae_decode_median_after_first_clip=float(np.median(timings["vae_decode"][1:])),
        **{f"{k}_launches_per_clip": v / args.clips for k, v in launches.items()},
        untimed_seconds_per_clip=untimed, untimed_frames_per_s=args.batch * clip / untimed,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30)), flush=True)


if __name__ == "__main__":
    main()
