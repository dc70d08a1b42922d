"""Seconds per denoiser step of the one-clip inference path on the card.

    python -m hallo_tpu_torch.pipelines.bench_clip [--clips 3] [--steps 4]

The full-width models (random weights from a seed, bf16) drive
`FaceAnimatePipeline` at 512^2 over `--clips` clips of 16 frames (2 motion
frames, CFG, DDIM at `--steps`) on random inputs from a seed. The first clip
carries the warm-up and is left out. It prints the card's name and power
limit, then one JSON line: every denoiser step's seconds, their median
after the first clip, every clip's VAE encode and decode seconds (the
phases that launch K4) with their medians after the first clip, and K1's
and K4's launches a clip. Times on one card spread between
runs (PERF.md): compare two versions of the code only within one machine
session, in turns.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from hallo_tpu_torch.ops import flash
from hallo_tpu_torch.pipelines.face_animate import FaceAnimatePipeline
from hallo_tpu_torch.utils.factory import build_models, dummy_clip_inputs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clips", type=int, default=3)
    ap.add_argument("--steps", type=int, default=4, help="DDIM steps per clip")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_clip: no CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    models = build_models("full", device=dev, dtype=torch.bfloat16, seed=0)
    clip = 16
    pipe = FaceAnimatePipeline(models, num_inference_steps=args.steps, clip_length=clip,
                               n_motion_frames=2)
    inputs = dummy_clip_inputs(models, 512, 512, clip, batch=1, seed=0)
    inputs["audio_windows"] = np.concatenate([inputs["audio_windows"]] * args.clips)
    timings: dict = {}
    flash.LAUNCHES["flash_fwd_packed"] = flash.LAUNCHES["flash_fwd"] = 0
    pipe(**inputs, seed=0, timings=timings)
    torch.cuda.synchronize()
    steps = timings["denoise_step"]
    print(json.dumps(dict(
        denoise_step_seconds=steps,
        median_after_first_clip=float(np.median(steps[args.steps:])),
        vae_encode_seconds=timings["vae_encode"], vae_decode_seconds=timings["vae_decode"],
        vae_encode_median_after_first_clip=float(np.median(timings["vae_encode"][1:])),
        vae_decode_median_after_first_clip=float(np.median(timings["vae_decode"][1:])),
        k1_launches_per_clip=flash.LAUNCHES["flash_fwd_packed"] / args.clips,
        k4_launches_per_clip=flash.LAUNCHES["flash_fwd"] / args.clips)), flush=True)


if __name__ == "__main__":
    main()
