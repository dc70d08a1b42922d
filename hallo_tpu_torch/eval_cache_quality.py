"""Quality audit of the samplers and the step and CFG caches against the
exact path (counterpart of scripts/eval_cache_quality.py).

    python -m hallo_tpu_torch.eval_cache_quality [--device cuda]

The same clip inputs go through the exact pipeline (DDIM at
HALLO_EVAL_STEPS, 40 by default) and through every mode of the matrix;
each mode's decoded frames are compared with the exact frames: PSNR, SSIM,
LPIPS (when its weights file exists, `utils/lpips.py`) and the mean
absolute difference, with the clip's seconds and the speedup against exact.
Over several seeds (different random networks, the same dynamics) each
figure is reported as mean/min/max. The rows equal to the CLI's profiles
carry `cli_profile`: `r5_unipc10` is `--profile fast`, `r5_unipc8` is
`--profile turbo` (`inference.PROFILE_DEFAULTS`).

Caveat: the weights are random-init (no checkpoint ships), so absolute
quality means nothing; the caching and sampler error is measured through
the same dynamics as the real output (the trajectory of a fixed network),
so the ranking of the modes and the order of magnitude of the deviation
transfer. LPIPS is reported as skipped, with the reason, without its file.

Environment, as the JAX script's: HALLO_EVAL_SCALE=tiny|full (full: the
production widths in bf16, 16-frame clips, size 512; tiny: the test widths
in fp32, 4-frame clips, size 64), HALLO_EVAL_STEPS, HALLO_EVAL_THRESHOLDS
("0.10"), HALLO_EVAL_SEEDS ("0"), HALLO_EVAL_SIZES, HALLO_EVAL_MODES
(comma-separated substrings matched against each row's label, or its
sampler when it has none), HALLO_EVAL_UNIPC and HALLO_EVAL_R5 ("0" drops
those rows), HALLO_EVAL_CFG_STRIDE ("3").

Each seed builds its models on the device after the previous seed's are
freed, so one parameter set lives there at a time. Every mode of a seed
starts from the same initial latents, drawn once from a torch.Generator
seeded with 42 + seed (JAX draws them with jax.random: a named
divergence). Each mode runs twice; the second run is timed, ending in a
device synchronisation. Prints the card's name and power limit (on the
card), progress on stderr, then one JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from hallo_tpu_torch.config import SchedulerConfig
from hallo_tpu_torch.inference import PROFILE_DEFAULTS
from hallo_tpu_torch.pipelines.face_animate import FaceAnimatePipeline
from hallo_tpu_torch.utils import profiling
from hallo_tpu_torch.utils.factory import build_models, dummy_clip_inputs
from hallo_tpu_torch.utils.lpips import load_lpips, lpips_from_uint8

N_MOTION = 2
GUIDANCE = 3.5


def log(msg: str) -> None:
    print(f"# eval: {msg}", file=sys.stderr, flush=True)


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    """PSNR of two uint8 stacks in dB; 99.0 when they are identical."""
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    if mse == 0:
        return 99.0
    return float(10.0 * np.log10(255.0 ** 2 / mse))


def ssim(a: np.ndarray, b: np.ndarray, win: int = 8) -> float:
    """Mean SSIM over non-overlapping win x win patches of the luminance
    (the channel mean), with the standard constants, in the global form per
    patch (scripts/eval_cache_quality.py:52-71)."""
    a = a.astype(np.float64).mean(axis=-1)
    b = b.astype(np.float64).mean(axis=-1)
    a = a.reshape(-1, *a.shape[-2:])
    b = b.reshape(-1, *b.shape[-2:])
    h, w = a.shape[-2:]
    h, w = h - h % win, w - w % win
    pa = a[:, :h, :w].reshape(-1, h // win, win, w // win, win)
    pb = b[:, :h, :w].reshape(-1, h // win, win, w // win, win)
    ax = (2, 4)
    mu_a, mu_b = pa.mean(ax), pb.mean(ax)
    va, vb = pa.var(ax), pb.var(ax)
    cov = (pa * pb).mean(ax) - mu_a * mu_b
    c1, c2 = (0.01 * 255) ** 2, (0.03 * 255) ** 2
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a ** 2 + mu_b ** 2 + c1) * (va + vb + c2)
    )
    return float(s.mean())


@dataclasses.dataclass(frozen=True)
class Mode:
    """One row of the matrix: the pipeline's cache and sampler settings.
    `steps` None takes the exact path's count; `extra` holds further
    `FaceAnimatePipeline` arguments."""

    step_cache: Optional[str]
    threshold: float
    cfg_stride: int
    sampler: str
    steps: Optional[int] = None
    label: Optional[str] = None
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def name(self) -> str:
        if self.label:
            return self.label
        return (self.step_cache or "exact") + (
            f"+cfg{self.cfg_stride}" if self.cfg_stride > 1 else "")

    def pipeline_kwargs(self, steps: int) -> Dict[str, Any]:
        return dict(num_inference_steps=self.steps or steps, step_cache=self.step_cache,
                    step_cache_threshold=self.threshold, cfg_cache_stride=self.cfg_stride,
                    sampler=self.sampler, **self.extra)

    def cli_profile(self, steps: int) -> Optional[str]:
        """The CLI profile whose settings this row runs, if any."""
        for name, prof in PROFILE_DEFAULTS.items():
            if (prof and self.step_cache is None and self.cfg_stride == 1 and not self.extra
                    and self.sampler == prof.get("sampler", "ddim")
                    and (self.steps or steps) == prof.get("inference_steps", steps)):
                return name
        return None


def mode_table(thresholds: Sequence[float], cfg_stride: int = 3, unipc: bool = True,
               r5: bool = True, only: Optional[str] = None) -> List[Mode]:
    """The JAX script's rows in its order (scripts/eval_cache_quality.py:
    114-187): uniform; dynamic at each threshold; the CFG cache alone;
    dynamic + CFG; DPM-Solver++ at 15 (`fast_dpm15`, with the dynamic cache
    `turbo_dpm15`); the UniPC rows; the r5 rows. `only`: HALLO_EVAL_MODES."""
    last = thresholds[-1]
    modes = (
        [Mode("uniform", 0.0, 1, "ddim")]
        + [Mode("dynamic", t, 1, "ddim") for t in thresholds]
        + [Mode(None, 0.0, cfg_stride, "ddim")]
        + [Mode("dynamic", last, cfg_stride, "ddim")]
        + [Mode(None, 0.0, 3, "dpm++2m", 15, "fast_dpm15")]
        + [Mode("dynamic", last, 3, "dpm++2m", 15, "turbo_dpm15")]
    )
    if unipc:
        legacy = {"cfg_cache_warmup": 6, "cfg_cache_cooldown": 4}
        modes += [
            Mode(None, 0.0, 3, "unipc", 15, "fast_unipc15", legacy),
            Mode(None, 0.0, 3, "unipc", 12, "fast_unipc12_legacy", legacy),
            Mode("dynamic", last, 3, "unipc", 12, "turbo_unipc12"),
        ]
    if r5:
        mild = {"cfg_cache_warmup": 4, "cfg_cache_cooldown": 2}
        modes += [
            Mode(None, 0.0, 1, "unipc", 10, "r5_unipc10"),
            Mode(None, 0.0, 1, "unipc", 8, "r5_unipc8"),
            Mode(None, 0.0, 3, "unipc", 10, "r5_unipc10_c42", mild),
            Mode(None, 0.0, 3, "unipc", 8, "r5_unipc8_c42", mild),
            Mode(None, 0.0, 1, "unipc", 10, "r5_unipc10_t1", {"cfg_tail": 1}),
            Mode(None, 0.0, 1, "unipc", 20, "r5_unipc20"),
        ]
    if only:
        keys = [k.strip() for k in only.split(",") if k.strip()]
        modes = [mo for mo in modes if any(k in (mo.label or mo.sampler) for k in keys)]
    return modes


def agg(values: Sequence[Optional[float]]):
    """One value rounded to 4 places, or {mean, min, max} over several;
    None when there is none."""
    vals = [v for v in values if v is not None]
    if not vals:
        return None
    if len(vals) == 1:
        return round(vals[0], 4)
    return {"mean": round(float(np.mean(vals)), 4), "min": round(float(np.min(vals)), 4),
            "max": round(float(np.max(vals)), 4)}


def scale_settings(scale: str):
    """(default sizes, clip length, dtype) of a scale."""
    if scale == "tiny":
        return "64", 4, torch.float32
    if scale == "full":
        return "512", 16, torch.bfloat16
    raise ValueError(f"HALLO_EVAL_SCALE={scale!r}: expected tiny or full")


def clip_args(models, size: int, clip: int, seed: int, device: torch.device) -> tuple:
    """`FaceAnimatePipeline.clip`'s arguments for one seed: the first clip of
    `dummy_clip_inputs` (motion frames = the reference), with the initial
    latents from a torch.Generator seeded with 42 + seed."""
    inputs = dummy_clip_inputs(models, size, size, clip, batch=1, seed=seed)

    def put(x):
        return torch.tensor(np.asarray(x), dtype=torch.float32, device=device)

    ref = put(inputs["ref_image"])
    ref_pixels = torch.cat([ref[:, None], ref[:, None].expand(-1, N_MOTION, -1, -1, -1)], dim=1)
    latents = torch.randn((1, clip, size // 8, size // 8, 4),
                          generator=torch.Generator().manual_seed(42 + seed)).to(device)
    masks = tuple(tuple(put(x) for x in lvl) for lvl in inputs["masks"])
    return (ref_pixels, latents, put(inputs["audio_windows"])[None], put(inputs["face_emb"]),
            put(inputs["face_region"]), masks, torch.ones(3, device=device))


def run_matrix(scale: str, sizes: Sequence[int], seeds: Sequence[int], steps: int,
               modes: Sequence[Mode], device: torch.device, lpips_params=None,
               on_frames: Optional[Callable[[int, int, str, np.ndarray], None]] = None
               ) -> List[Dict[str, Any]]:
    """The matrix's sections, one per size (the JSON's `sections`).
    `on_frames(size, seed, mode name or "exact", frames)` sees every timed
    run's uint8 frames (B, F, H, W, 3)."""
    device = torch.device(device)
    _, clip, dtype = scale_settings(scale)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    def run(pipe, args):
        """(frames, seconds of the second run, seconds of the first)."""
        t0 = time.perf_counter()
        pipe.clip(*args)[0].cpu()
        first_s = time.perf_counter() - t0
        sync()
        t0 = time.perf_counter()
        frames = pipe.clip(*args)[0].cpu().numpy()
        sync()
        return frames, time.perf_counter() - t0, first_s

    sections = []
    for size in sizes:
        log(f"=== size {size} ===")
        exact_rows: List[Dict[str, float]] = []
        per_mode: List[List[Dict[str, Any]]] = [[] for _ in modes]
        for seed in seeds:
            log(f"size {size}: building the models, seed={seed}")
            models = build_models(scale, device=device, dtype=dtype, seed=seed)

            def make_pipe(**kw):
                return FaceAnimatePipeline(models, SchedulerConfig(), guidance_scale=GUIDANCE,
                                           clip_length=clip, n_motion_frames=N_MOTION, **kw)

            args = clip_args(models, size, clip, seed, device)
            exact, exact_s, c0 = run(make_pipe(num_inference_steps=steps), args)
            log(f"seed {seed} exact {exact_s:.2f}s/clip (first {c0:.1f}s)")
            exact_rows.append({"clip_seconds": exact_s})
            if on_frames is not None:
                on_frames(size, seed, "exact", exact)
            for i, mode in enumerate(modes):
                frames, run_s, _ = run(make_pipe(**mode.pipeline_kwargs(steps)), args)
                entry = {
                    "psnr": psnr(frames, exact),
                    "ssim": ssim(frames, exact),
                    "lpips": (lpips_from_uint8(lpips_params, frames, exact, device=device)
                              if lpips_params is not None else None),
                    "mad": float(np.mean(np.abs(frames.astype(np.float64) - exact))),
                    "clip_seconds": run_s,
                    "speedup": exact_s / run_s,
                }
                log(f"seed {seed} {mode.name}: psnr={entry['psnr']:.2f} "
                    f"ssim={entry['ssim']:.4f} {run_s:.2f}s")
                per_mode[i].append(entry)
                if on_frames is not None:
                    on_frames(size, seed, mode.name, frames)
            # free this seed's parameters before the next seed builds its own
            del models, args
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()

        mode_rows = []
        for mode, rows in zip(modes, per_mode):
            mode_rows.append({
                "mode": mode.name,
                "cli_profile": mode.cli_profile(steps),
                "sampler": mode.sampler,
                "steps": mode.steps or steps,
                "threshold": mode.threshold if mode.step_cache == "dynamic" else None,
                "cfg_cache_stride": mode.cfg_stride,
                "psnr_vs_exact_db": agg([r["psnr"] for r in rows]),
                "ssim_vs_exact": agg([r["ssim"] for r in rows]),
                "lpips_vs_exact": agg([r["lpips"] for r in rows]),
                "mean_abs_diff": agg([r["mad"] for r in rows]),
                "clip_seconds": agg([r["clip_seconds"] for r in rows]),
                "speedup_vs_exact": agg([r["speedup"] for r in rows]),
            })
        sections.append({
            "size": size,
            "seeds": list(seeds),
            "exact_clip_seconds": agg([r["clip_seconds"] for r in exact_rows]),
            "modes": mode_rows,
        })
    return sections


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for a host without a card)")
    device = torch.device(ap.parse_args(argv).device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("eval_cache_quality: no CUDA device; pass --device cpu for the CPU")
        print(profiling.card_line(), flush=True)
    env = os.environ
    scale = env.get("HALLO_EVAL_SCALE", "full")
    default_sizes, _, _ = scale_settings(scale)
    steps = int(env.get("HALLO_EVAL_STEPS", "40"))
    thresholds = [float(t) for t in env.get("HALLO_EVAL_THRESHOLDS", "0.10").split(",")]
    seeds = [int(x) for x in env.get("HALLO_EVAL_SEEDS", "0").split(",")]
    sizes = [int(x) for x in env.get("HALLO_EVAL_SIZES", default_sizes).split(",")]
    modes = mode_table(thresholds, int(env.get("HALLO_EVAL_CFG_STRIDE", "3")),
                       unipc=env.get("HALLO_EVAL_UNIPC", "1") != "0",
                       r5=env.get("HALLO_EVAL_R5", "1") != "0",
                       only=env.get("HALLO_EVAL_MODES"))

    lpips_params, lpips_status = load_lpips()
    log(f"lpips: {lpips_status}")
    sections = run_matrix(scale, sizes, seeds, steps, modes, device, lpips_params)
    report = {
        "metric": "step_cache_quality_audit",
        "scale": scale,
        "steps": steps,
        "weights": "random-init (relative numbers; see docstring)",
        "lpips": lpips_status,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else str(device),
        "sections": sections,
    }
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
