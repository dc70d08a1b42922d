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
