"""Images per second of the static (stage-1) pipeline on the card: BASELINE
config 2, the counterpart of scripts/bench_static.py.

    python -m hallo_tpu_torch.pipelines.bench_static [--size 512] [--steps 40]

The full-width 2D models (ReferenceNet, face locator and the denoiser
without motion or audio modules or inflated GroupNorm; random weights from
a seed, bf16) render one 512^2 image with 40-step DDIM and CFG from a
random reference. One run warms up, three are timed (a synchronisation at
the end of each). It prints the card's name and power limit, then one JSON
line with scripts/bench_static.py's keys (`metric`
static_images_per_sec_{H}x{W}_{steps}step, `value`, `unit` images/sec/chip,
`detail`) and the card's name. A timing script, not a benchmark cell.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from hallo_tpu_torch.pipelines.static import StaticPipeline
from hallo_tpu_torch.utils.factory import build_models

STATIC_2D = dict(use_motion_module=False, use_audio_module=False,
                 use_inflated_groupnorm=False)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--steps", type=int, default=40)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_static: no CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    h = w = args.size
    models = build_models("full", device=dev, dtype=torch.bfloat16, seed=0,
                          unet_overrides=STATIC_2D)
    pipe = StaticPipeline(models, num_inference_steps=args.steps)
    rng = np.random.default_rng(0)
    ref = rng.uniform(-1, 1, (1, h, w, 3)).astype(np.float32)
    face_emb = rng.normal(size=(1, 512)).astype(np.float32)
    region = np.ones((1, h, w, 3), np.float32)

    def run() -> float:
        t0 = time.perf_counter()
        img = pipe(ref, face_emb, region, seed=42)
        torch.cuda.synchronize()
        assert img.shape == (1, h, w, 3) and np.isfinite(img).all()
        return time.perf_counter() - t0

    first = run()
    times = [run() for _ in range(3)]
    best = min(times)
    print(json.dumps({
        "metric": f"static_images_per_sec_{h}x{w}_{args.steps}step",
        "value": 1.0 / best,
        "unit": "images/sec/chip",
        "device": torch.cuda.get_device_name(0),
        "detail": {"seconds_per_image": best, "all": times, "first_s": first,
                   "peak_gib": torch.cuda.max_memory_allocated() / 2**30},
    }), flush=True)


if __name__ == "__main__":
    main()
