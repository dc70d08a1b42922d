"""Deterministic DDIM step (counterpart of hallo_tpu/diffusion/ddim.py):
v-prediction, eta = 0, no clipping. The tables come from the numpy
`diffusion.schedule`."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from hallo_tpu_torch.config import SchedulerConfig
from hallo_tpu_torch.diffusion import schedule


class DDIMState(NamedTuple):
    timesteps: np.ndarray  # (S,) int, descending
    alphas_cumprod: np.ndarray  # (T,) float64 as computed by schedule
    final_alpha_cumprod: float
    prediction_type: str = "v_prediction"

    @property
    def num_steps(self) -> int:
        return int(self.timesteps.shape[0])


def make_state(cfg: SchedulerConfig, num_inference_steps: int) -> DDIMState:
    ac = schedule.alphas_cumprod(cfg).astype(np.float32)
    ts = schedule.inference_timesteps(cfg, num_inference_steps)
    return DDIMState(
        timesteps=np.asarray(ts, np.int64),
        alphas_cumprod=ac,
        final_alpha_cumprod=float(ac[0]),
        prediction_type=cfg.prediction_type,
    )


def predict_x0_eps(model_output, sample, alpha_prod_t, prediction_type: str):
    sqrt_a = alpha_prod_t ** 0.5
    sqrt_1ma = (1.0 - alpha_prod_t) ** 0.5
    if prediction_type == "v_prediction":
        return sqrt_a * sample - sqrt_1ma * model_output, sqrt_a * model_output + sqrt_1ma * sample
    if prediction_type == "epsilon":
        return (sample - sqrt_1ma * model_output) / sqrt_a, model_output
    if prediction_type == "sample":
        return model_output, (sample - sqrt_a * model_output) / sqrt_1ma
    raise ValueError(prediction_type)


def ddim_step(state: DDIMState, step_index: int, model_output: torch.Tensor,
              sample: torch.Tensor) -> torch.Tensor:
    """x_t -> x_{t - step_ratio}, eta = 0; computed in fp32, returned in
    sample's dtype."""
    t = int(state.timesteps[step_index])
    num_train = state.alphas_cumprod.shape[0]
    prev_t = t - num_train // state.num_steps
    alpha_t = torch.tensor(state.alphas_cumprod[t], dtype=torch.float32)
    alpha_prev = torch.tensor(
        state.alphas_cumprod[prev_t] if prev_t >= 0 else state.final_alpha_cumprod,
        dtype=torch.float32,
    )
    x0, eps = predict_x0_eps(model_output.float(), sample.float(), alpha_t,
                             state.prediction_type)
    prev = alpha_prev.sqrt() * x0 + (1.0 - alpha_prev).sqrt() * eps
    return prev.to(sample.dtype)
