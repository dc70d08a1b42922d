"""Noise schedules in numpy (the port's copy of the parts of
hallo_tpu/diffusion/schedule.py that it uses).

Semantics follow diffusers' DDIMScheduler as the reference builds it
(configs/inference/default.yaml:79-90: linear betas 0.00085 -> 0.012,
zero-SNR rescale, v-prediction, trailing spacing).
"""

from __future__ import annotations

import numpy as np

from hallo_tpu_torch.config import SchedulerConfig


def make_betas(cfg: SchedulerConfig) -> np.ndarray:
    t = cfg.num_train_timesteps
    if cfg.beta_schedule == "linear":
        betas = np.linspace(cfg.beta_start, cfg.beta_end, t, dtype=np.float64)
    elif cfg.beta_schedule == "scaled_linear":
        betas = (
            np.linspace(cfg.beta_start**0.5, cfg.beta_end**0.5, t, dtype=np.float64)
            ** 2
        )
    elif cfg.beta_schedule == "squaredcos_cap_v2":
        def alpha_bar(s):
            return np.cos((s + 0.008) / 1.008 * np.pi / 2) ** 2

        steps = np.arange(t, dtype=np.float64)
        betas = np.minimum(1 - alpha_bar((steps + 1) / t) / alpha_bar(steps / t), 0.999)
    else:
        raise ValueError(f"unknown beta_schedule {cfg.beta_schedule}")
    return betas


def rescale_zero_terminal_snr(betas: np.ndarray) -> np.ndarray:
    """Shift and scale the schedule so that the final cumulative alpha is
    exactly 0 (Lin et al. 2023, diffusers `rescale_betas_zero_snr`)."""
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas)
    alphas_bar_sqrt = np.sqrt(alphas_cumprod)

    a0 = alphas_bar_sqrt[0].copy()
    aT = alphas_bar_sqrt[-1].copy()
    alphas_bar_sqrt = alphas_bar_sqrt - aT
    alphas_bar_sqrt = alphas_bar_sqrt * a0 / (a0 - aT)

    alphas_bar = alphas_bar_sqrt**2
    alphas = alphas_bar[1:] / alphas_bar[:-1]
    alphas = np.concatenate([alphas_bar[0:1], alphas])
    return 1.0 - alphas


def alphas_cumprod(cfg: SchedulerConfig) -> np.ndarray:
    betas = make_betas(cfg)
    if cfg.rescale_betas_zero_snr:
        betas = rescale_zero_terminal_snr(betas)
    return np.cumprod(1.0 - betas).astype(np.float32)


def inference_timesteps(cfg: SchedulerConfig, num_steps: int) -> np.ndarray:
    """Descending timestep sequence for sampling (diffusers set_timesteps)."""
    t = cfg.num_train_timesteps
    if cfg.timestep_spacing == "trailing":
        step = t / num_steps
        ts = np.round(np.arange(t, 0, -step)).astype(np.int64) - 1
    elif cfg.timestep_spacing == "leading":
        step = t // num_steps
        ts = (np.arange(0, num_steps) * step).round().astype(np.int64)[::-1].copy()
        ts += cfg.steps_offset
    elif cfg.timestep_spacing == "linspace":
        ts = (
            np.linspace(0, t - 1, num_steps).round().astype(np.int64)[::-1].copy()
        )
    else:
        raise ValueError(cfg.timestep_spacing)
    return ts


def logsnr_timesteps(
    cfg: SchedulerConfig,
    num_steps: int,
    rho: float = 1.0,
    t_min: int | None = None,
) -> np.ndarray:
    """Timesteps whose knots are spaced in log-SNR (lambda = log(alpha/sigma))
    between the trailing schedule's endpoints, instead of uniformly in t.

    At few evals the samplers' error is dominated by the first step, whose
    trailing interval is enormous in lambda under the zero-SNR rescale;
    even spacing in lambda (rho 1) shrinks it, rho > 1 concentrates the knots
    further at the high-noise end, rho < 1 toward the low-noise end. The
    first knot stays at the trailing start (`t0`) and the last at the
    trailing end (or `t_min`): rho only moves the interior knots. The
    trailing end is the trailing grid's `num_steps`-th knot: at 61, 103,
    121 and 122 steps that grid's float `arange` yields one knot more, at
    t = -1 (diffusers does the same), which the JAX package takes as its
    end and then asserts on.

    Nearest-neighbour inversion can make coarse knots collide. A downward
    pass pushes each collision one step lower (the JAX package's rule, which
    alone can move the last knot below `t_end`); an upward pass from the end
    then pins `ts[-1] == t_end` and lifts whatever sits at or below its
    successor. Where both passes leave the grid unchanged, as for every
    count from 2 to 60, the result equals the JAX package's. Raises
    ValueError where no strictly decreasing grid of `num_steps` knots fits
    between `t0` and `t_end`."""
    acp = alphas_cumprod(cfg).astype(np.float64)
    if cfg.rescale_betas_zero_snr:
        acp[-1] = max(acp[-1], 2.0**-24)  # keep lambda finite (diffusers)
    lam = 0.5 * np.log(acp / np.maximum(1.0 - acp, 1e-12))
    trail = inference_timesteps(cfg, num_steps)
    if num_steps < 2:
        return trail  # a single knot has no interior to respace
    t0 = int(trail[0])
    t_end = int(t_min) if t_min is not None else int(trail[num_steps - 1])
    if not 0 <= t_end <= t0 - (num_steps - 1):
        raise ValueError(
            f"no strictly decreasing grid of {num_steps} knots from t={t0} to t={t_end}")
    l0, l1 = lam[t0], lam[t_end]
    u = (np.arange(num_steps, dtype=np.float64) / (num_steps - 1)) ** float(rho)
    knots = l0 + (l1 - l0) * u
    # lam is strictly decreasing in t; invert by nearest neighbour.
    order = np.argsort(lam)  # ascending lam <-> descending t
    pos = np.searchsorted(lam[order], knots)
    pos = np.clip(pos, 1, len(lam) - 1)
    left, right = order[pos - 1], order[pos]
    ts = np.where(
        np.abs(lam[left] - knots) <= np.abs(lam[right] - knots), left, right
    ).astype(np.int64)
    ts[0], ts[-1] = t0, t_end
    for i in range(1, num_steps):
        if ts[i] >= ts[i - 1]:
            ts[i] = ts[i - 1] - 1
    ts[-1] = t_end
    for i in range(num_steps - 2, 0, -1):
        if ts[i] <= ts[i + 1]:
            ts[i] = ts[i + 1] + 1
    return ts
