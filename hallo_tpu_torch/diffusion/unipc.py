"""UniPC (order 2, bh2) multistep predictor-corrector sampler (counterpart
of hallo_tpu/diffusion/unipc.py).

Semantics follow diffusers' UniPCMultistepScheduler with predict_x0=True,
solver_order=2, solver_type="bh2", lower_order_final=True,
final_sigmas_type="zero", for the reference's scheduler. The predictor is
DPM-Solver++ (2M)'s (dpm.predictor_tables); the corrector reuses each
step's model evaluation to correct the current point before advancing, at
no extra evaluation. As in dpm.py the coefficients are computed on the host
in float64 and stored in float32 tables; the carry is (prev_x0, prev2_x0,
last corrected sample), three fp32 latents-sized tensors.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from hallo_tpu_torch.config import SchedulerConfig
from hallo_tpu_torch.diffusion.dpm import (
    clamped_alphas_cumprod, eval_timesteps, predictor_tables, to_x0)


class UniPCState(NamedTuple):
    """Per-step tables (float32). Step i (1) corrects the current sample
    x_i (not at i = 0, where `gate` is 0) from the eval at x_i, the previous
    corrected sample and the x0 history, then (2) advances the corrected x_i
    to the next boundary with the 2M predictor. The x0 history holds the
    estimates from the uncorrected samples (diffusers)."""

    timesteps: np.ndarray  # (S,) int, descending
    alpha_s: np.ndarray  # (S,) sqrt(alpha_cumprod) at the eval point
    sigma_s: np.ndarray  # (S,) sqrt(1 - alpha_cumprod) at the eval point
    coef_x: np.ndarray  # (S,) predictor: sigma_next / sigma_s (0 at the last step)
    coef_d: np.ndarray  # (S,) alpha_next * (1 - exp(-h)) (1 at the last step)
    c2: np.ndarray  # (S,) h_i / (2 h_{i-1}); 0 at i = 0 and i = S - 1
    gate: np.ndarray  # (S,) corrector: 1.0 where it applies (i >= 1)
    c_x: np.ndarray  # (S,) sigma_i / sigma_{i-1}
    c_k: np.ndarray  # (S,) alpha_i * (1 - exp(-h_{i-1}))
    c_hist: np.ndarray  # (S,) weight on (x0_{i-2} - x0_{i-1}); 0 at order 1
    c_dt: np.ndarray  # (S,) weight on (x0_i - x0_{i-1})
    prediction_type: str = "v_prediction"

    @property
    def num_steps(self) -> int:
        return int(self.timesteps.shape[0])


def make_state(cfg: SchedulerConfig, num_inference_steps: int,
               timesteps=None) -> UniPCState:
    ts = eval_timesteps(cfg, num_inference_steps, timesteps)
    n = len(ts)
    alpha, sigma, lam, coef_x, coef_d, c2 = predictor_tables(clamped_alphas_cumprod(cfg), ts)

    gate = np.zeros(n)
    c_x = np.zeros(n)
    c_k = np.zeros(n)
    c_hist = np.zeros(n)
    c_dt = np.zeros(n)
    for i in range(1, n):
        # The corrector from x_{i-1} to x_i spans h_c = lam[i] - lam[i-1].
        h_c = lam[i] - lam[i - 1]
        hh = -h_c  # predict_x0 sign convention (diffusers uni_c: hh = -h)
        b_h = np.expm1(hh)  # bh2: B(h) = e^{hh} - 1
        gate[i] = 1.0
        c_x[i] = sigma[i] / sigma[i - 1]
        c_k[i] = alpha[i] * -np.expm1(hh)
        # The corrector's order at step i is the predictor's at step i-1:
        # 1 at i = 1, 2 from i = 2 on.
        if i == 1:
            c_dt[i] = 0.5  # diffusers' rhos_c = [0.5] at order 1
        else:
            # order 2: solve [[1, 1], [rk0, 1]] @ rhos = [b0, b1]
            rk0 = (lam[i - 2] - lam[i - 1]) / h_c
            h_phi_1 = np.expm1(hh)
            h_phi_k1 = h_phi_1 / hh - 1.0
            b0 = h_phi_k1 / b_h
            h_phi_k2 = h_phi_k1 / hh - 0.5
            b1 = 2.0 * h_phi_k2 / b_h
            rho0 = (b0 - b1) / (1.0 - rk0)
            rho1 = b0 - rho0
            # 1/rk0 of D1s[0] = (x0_{i-2} - x0_{i-1}) / rk0 folded in
            c_hist[i] = rho0 / rk0
            c_dt[i] = rho1

    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return UniPCState(
        timesteps=np.asarray(ts, np.int64),
        alpha_s=f32(alpha), sigma_s=f32(sigma),
        coef_x=f32(coef_x), coef_d=f32(coef_d), c2=f32(c2),
        gate=f32(gate), c_x=f32(c_x), c_k=f32(c_k), c_hist=f32(c_hist), c_dt=f32(c_dt),
        prediction_type=cfg.prediction_type,
    )


class UniPCCarry(NamedTuple):
    prev_x0: torch.Tensor  # x0 estimate at step i-1 (from the uncorrected x)
    prev2_x0: torch.Tensor  # x0 estimate at step i-2
    last_sample: torch.Tensor  # corrected sample at step i-1


def init_carry(latents: torch.Tensor) -> UniPCCarry:
    z = torch.zeros(latents.shape, dtype=torch.float32, device=latents.device)
    return UniPCCarry(z, z, z)


def unipc_step(state: UniPCState, step_index: int, model_output: torch.Tensor,
               sample: torch.Tensor, carry: UniPCCarry) -> Tuple[torch.Tensor, UniPCCarry]:
    """One UniC + UniP update x_i -> x_{i+1} in fp32. `sample` is the
    uncorrected x_i the model was evaluated at. Returns (new sample in
    sample's dtype, carry)."""
    i = step_index
    samplef = sample.float()
    x0 = to_x0(model_output.float(), samplef, float(state.alpha_s[i]),
               float(state.sigma_s[i]), state.prediction_type)
    if state.gate[i] > 0:  # UniC: correct x_i from x_{i-1} with the eval at x_i
        x_i = float(state.c_x[i]) * carry.last_sample + float(state.c_k[i]) * (
            carry.prev_x0
            + float(state.c_hist[i]) * (carry.prev2_x0 - carry.prev_x0)
            + float(state.c_dt[i]) * (x0 - carry.prev_x0)
        )
    else:
        x_i = samplef
    # UniP (DPM-Solver++ 2M) from the corrected x_i
    d = x0 + float(state.c2[i]) * (x0 - carry.prev_x0)
    new = float(state.coef_x[i]) * x_i + float(state.coef_d[i]) * d
    return new.to(sample.dtype), UniPCCarry(x0, carry.prev_x0, x_i)
