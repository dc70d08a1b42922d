"""LPIPS of the fast profile against exact on the reference's own samples
(counterpart of scripts/eval_lpips_samples.py).

    python -m hallo_tpu_torch.eval_lpips_samples [--config CONFIG]
        [--image IMG] [--audio WAV] [--steps-fast N] [--outdir DIR] [--device cuda]

With the weights in the reference's `pretrained_models/` layout and the
LPIPS file (`utils/lpips.py`), it renders the image and the audio twice
through the CLI's `inference_process`, with `--profile exact` and
`--profile fast`, and prints one JSON line: the frame-wise LPIPS and PSNR
between the two videos, and the settings each render actually ran, read back
from `resolve_settings` (`--steps-fast` overrides the fast profile's own
count, which it defaults to). Without the LPIPS file or any file the CLI
needs, it prints the skip JSON and exits 0. A render that fails with every
file present raises, where JAX turns the CLI's SystemExit into the skip
JSON (:76-82): the port's loaders raise on a file that fails.

A fault of the reference not copied (scripts/eval_lpips_samples.py:35,
:105-106): it renders the fast profile at 15 steps, which today means UniPC
at 15 evals, and labels it `{"sampler": "dpm++2m", "steps": 15,
"cfg_cache_stride": 3}`, the profile of an earlier round.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, Optional, Sequence

import numpy as np

from hallo_tpu_torch.utils.lpips import load_lpips, lpips_from_uint8

METRIC = "lpips_exact_vs_fast_samples"
# what `inference_process` needs beyond the two inputs (scripts/
# eval_lpips_samples.py:52-59): without one it would stop the render
REQUIRED = (
    "pretrained_models/hallo/net.pth",
    "pretrained_models/wav2vec/wav2vec2-base-960h",
    "pretrained_models/sd-vae-ft-mse",
    "pretrained_models/stable-diffusion-v1-5",
)
# the settings a render reports (keys of `inference.resolve_settings`)
REPORTED = ("profile", "sampler", "inference_steps", "step_cache", "cfg_cache_stride",
            "cfg_tail", "timestep_schedule")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="configs/inference/default.yaml")
    ap.add_argument("--image", default="examples/reference_images/1.jpg")
    ap.add_argument("--audio", default="examples/driving_audios/1.wav")
    ap.add_argument("--steps-fast", type=int, default=None,
                    help="evals of the fast render (default: the fast profile's own)")
    ap.add_argument("--outdir", default=".cache/lpips_samples")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for a host without a card)")
    return ap.parse_args(argv)


def skip_reasons(args: argparse.Namespace, lpips_params, lpips_status: str) -> list:
    reasons = [] if lpips_params is not None else [lpips_status]
    for path in REQUIRED + (args.image, args.audio):
        if not os.path.exists(path):
            reasons.append(f"missing {path}")
    return reasons


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    args = parse_args(argv)
    lpips_params, lpips_status = load_lpips()
    skip = skip_reasons(args, lpips_params, lpips_status)
    if skip:
        report = {"metric": METRIC, "skipped": "; ".join(skip)}
        print(json.dumps(report), flush=True)
        return report

    from hallo_tpu_torch.inference import build_parser, inference_process
    from hallo_tpu_torch.utils.video import read_frames

    os.makedirs(args.outdir, exist_ok=True)

    def render(profile: str, steps: Optional[int]):
        ns = build_parser().parse_args([])
        ns.config, ns.source_image, ns.driving_audio = args.config, args.image, args.audio
        ns.output = os.path.join(args.outdir, f"{profile}.mp4")
        ns.profile, ns.inference_steps, ns.device = profile, steps, args.device
        run = inference_process(ns)
        settings = {k: run.loaded.settings[k] for k in REPORTED}
        return np.stack(read_frames(run.output)), settings

    exact, exact_settings = render("exact", None)
    fast, fast_settings = render("fast", args.steps_fast)
    n = min(len(exact), len(fast))
    exact, fast = exact[:n], fast[:n]
    mse = np.mean((exact.astype(np.float64) - fast) ** 2)
    report = {
        "metric": METRIC,
        "frames": int(n),
        "lpips": round(lpips_from_uint8(lpips_params, fast, exact, device=args.device), 4),
        "psnr_db": round(float(10 * np.log10(255.0 ** 2 / mse)) if mse > 0 else 99.0, 2),
        "lpips_weights": lpips_status,
        "image": args.image,
        "audio": args.audio,
        "exact_profile": exact_settings,
        "fast_profile": fast_settings,
    }
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
