"""Deterministic DDIM step (counterpart of hallo_tpu/diffusion/ddim.py):
v-prediction, eta = 0, no clipping; and the training helpers `add_noise`,
`get_velocity` and `compute_snr`. The tables come from the numpy
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


def make_state(cfg: SchedulerConfig, num_inference_steps: int,
               timesteps=None) -> DDIMState:
    """`timesteps` (descending) replaces the trailing grid, e.g. a log-SNR
    one; the step keeps its `num_train // num_steps` stride all the same, as
    the JAX package's does."""
    ac = schedule.alphas_cumprod(cfg).astype(np.float32)
    ts = (np.asarray(timesteps) if timesteps is not None
          else schedule.inference_timesteps(cfg, num_inference_steps))
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


def _at(alphas_cumprod: torch.Tensor, timesteps: torch.Tensor, ndim: int) -> torch.Tensor:
    """alphas_cumprod[t] in fp32, with trailing axes to broadcast over `ndim`."""
    a = torch.as_tensor(alphas_cumprod, device=timesteps.device)[timesteps].float()
    return a.reshape(a.shape + (1,) * (ndim - a.ndim))


def add_noise(alphas_cumprod, sample: torch.Tensor, noise: torch.Tensor,
              timesteps: torch.Tensor) -> torch.Tensor:
    """Forward diffusion q(x_t | x_0) (training), computed in fp32 and
    returned in sample's dtype. timesteps: (B,) ints; the schedule is
    broadcast over sample's trailing axes."""
    a = _at(alphas_cumprod, timesteps, sample.ndim)
    return (a.sqrt() * sample.float() + (1.0 - a).sqrt() * noise.float()).to(sample.dtype)


def get_velocity(alphas_cumprod, sample: torch.Tensor, noise: torch.Tensor,
                 timesteps: torch.Tensor) -> torch.Tensor:
    """The v-prediction training target (diffusers `get_velocity`)."""
    a = _at(alphas_cumprod, timesteps, sample.ndim)
    return (a.sqrt() * noise.float() - (1.0 - a).sqrt() * sample.float()).to(sample.dtype)


def compute_snr(alphas_cumprod, timesteps: torch.Tensor) -> torch.Tensor:
    """SNR(t) = alpha / (1 - alpha), for Min-SNR-gamma loss weights
    (reference util.py:822-851)."""
    a = _at(alphas_cumprod, timesteps, 1)
    return a / (1.0 - a)
