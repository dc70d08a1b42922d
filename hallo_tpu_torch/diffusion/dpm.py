"""DPM-Solver++ (2M) multistep sampler (counterpart of
hallo_tpu/diffusion/dpm.py).

Semantics follow diffusers' DPMSolverMultistepScheduler with
algorithm_type="dpmsolver++", solver_order=2, lower_order_final=True, for
the reference's scheduler (v-prediction, trailing spacing, zero-SNR
rescale); the final cumulative alpha is clamped to 2**-24 so that log-SNR
stays finite. Every step coefficient is computed on the host in float64
and stored in float32 tables, so a step is a few fp32 multiply-adds with a
single carry, the previous step's x0 estimate.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from hallo_tpu_torch.config import SchedulerConfig
from hallo_tpu_torch.diffusion import schedule


class DPMState(NamedTuple):
    """Per-step tables (float32). Step i evaluates the model at
    `timesteps[i]` and advances the sample to the next boundary; the last
    boundary is clean data (alpha 1, sigma 0), so the last update returns
    the x0 estimate."""

    timesteps: np.ndarray  # (S,) int, descending
    alpha_s: np.ndarray  # (S,) sqrt(alpha_cumprod) at the eval point
    sigma_s: np.ndarray  # (S,) sqrt(1 - alpha_cumprod) at the eval point
    coef_x: np.ndarray  # (S,) sigma_next / sigma_s (0 at the last step)
    coef_d: np.ndarray  # (S,) alpha_next * (1 - exp(-h)) (1 at the last step)
    c2: np.ndarray  # (S,) h_i / (2 h_{i-1}); 0 at i = 0 and i = S - 1
    prediction_type: str = "v_prediction"

    @property
    def num_steps(self) -> int:
        return int(self.timesteps.shape[0])


def clamped_alphas_cumprod(cfg: SchedulerConfig) -> np.ndarray:
    """alphas_cumprod in float64, its zero-SNR end clamped to 2**-24
    (diffusers), so that lambda = log(alpha / sigma) stays finite."""
    acp = schedule.alphas_cumprod(cfg).astype(np.float64)
    if cfg.rescale_betas_zero_snr:
        acp[-1] = max(acp[-1], 2.0**-24)
    return acp


def predictor_tables(acp: np.ndarray, ts: np.ndarray):
    """alpha, sigma and lambda at the eval points, and the 2M predictor's
    coef_x, coef_d and c2 (float64), shared with UniPC's predictor."""
    n = len(ts)
    alpha = np.sqrt(acp[ts])
    sigma = np.sqrt(1.0 - acp[ts])
    lam = np.log(alpha / sigma)
    # Step i advances from timesteps[i] to timesteps[i+1]; the final
    # boundary is clean data (alpha 1, sigma 0, lambda +inf).
    alpha_next = np.concatenate([alpha[1:], [1.0]])
    sigma_next = np.concatenate([sigma[1:], [0.0]])
    coef_x = np.zeros(n)
    coef_d = np.zeros(n)
    c2 = np.zeros(n)
    h = np.zeros(n)
    for i in range(n):
        if i == n - 1:
            h[i] = np.inf
            coef_x[i] = 0.0
            coef_d[i] = 1.0  # alpha_next 1, (1 - exp(-inf)) 1
        else:
            h[i] = np.log(alpha_next[i] / sigma_next[i]) - lam[i]
            coef_x[i] = sigma_next[i] / sigma[i]
            coef_d[i] = alpha_next[i] * -np.expm1(-h[i])
        if 0 < i < n - 1:  # the first step has no history; the last is first-order
            c2[i] = h[i] / (2.0 * h[i - 1])
    return alpha, sigma, lam, coef_x, coef_d, c2


def eval_timesteps(cfg: SchedulerConfig, num_inference_steps: int, timesteps) -> np.ndarray:
    return (np.asarray(timesteps) if timesteps is not None
            else schedule.inference_timesteps(cfg, num_inference_steps))


def make_state(cfg: SchedulerConfig, num_inference_steps: int,
               timesteps=None) -> DPMState:
    ts = eval_timesteps(cfg, num_inference_steps, timesteps)
    alpha, sigma, _, coef_x, coef_d, c2 = predictor_tables(clamped_alphas_cumprod(cfg), ts)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return DPMState(
        timesteps=np.asarray(ts, np.int64),
        alpha_s=f32(alpha), sigma_s=f32(sigma),
        coef_x=f32(coef_x), coef_d=f32(coef_d), c2=f32(c2),
        prediction_type=cfg.prediction_type,
    )


def to_x0(model_output, sample, alpha_s: float, sigma_s: float, prediction_type: str):
    """The raw model output at (sample, t) as a clean-data estimate."""
    if prediction_type == "v_prediction":
        return alpha_s * sample - sigma_s * model_output
    if prediction_type == "epsilon":
        return (sample - sigma_s * model_output) / alpha_s
    if prediction_type == "sample":
        return model_output
    raise ValueError(prediction_type)


def dpm_step(state: DPMState, step_index: int, model_output: torch.Tensor,
             sample: torch.Tensor, prev_x0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One 2M update x_i -> x_{i+1} in fp32. Returns (new sample in
    sample's dtype, fp32 x0 estimate); the estimate is the next call's
    `prev_x0` (zeros at i = 0, where its weight c2[0] is 0)."""
    i = step_index
    samplef = sample.float()
    x0 = to_x0(model_output.float(), samplef, float(state.alpha_s[i]),
               float(state.sigma_s[i]), state.prediction_type)
    d = x0 + float(state.c2[i]) * (x0 - prev_x0)
    prev = float(state.coef_x[i]) * samplef + float(state.coef_d[i]) * d
    return prev.to(sample.dtype), x0
