"""The reference's noise schedule and sampler updates (numpy tables, fp32
updates): diffusers' DDIMScheduler (eta 0) and UniPCMultistepScheduler
(order 2, bh2, predict_x0, lower_order_final, final sigma 0), with linear
or scaled-linear betas, the zero-terminal-SNR rescale, v-prediction and
trailing timesteps, as the configuration files state them.

Inside `bf16()` (the control's sampler) every update's inputs and result
are rounded through bfloat16.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional

import numpy as np
import torch

_LOWP = {"on": False}


@contextlib.contextmanager
def bf16():
    prev = _LOWP["on"]
    _LOWP["on"] = True
    try:
        yield
    finally:
        _LOWP["on"] = prev


def _r(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float() if _LOWP["on"] else t


def alphas_cumprod(s: dict) -> np.ndarray:
    n = s["num_train_timesteps"]
    if s["beta_schedule"] == "linear":
        betas = np.linspace(s["beta_start"], s["beta_end"], n, dtype=np.float64)
    elif s["beta_schedule"] == "scaled_linear":
        betas = np.linspace(s["beta_start"] ** 0.5, s["beta_end"] ** 0.5, n,
                            dtype=np.float64) ** 2
    else:
        raise ValueError(s["beta_schedule"])
    if s["rescale_betas_zero_snr"]:
        sq = np.sqrt(np.cumprod(1.0 - betas))
        a0, at = sq[0].copy(), sq[-1].copy()
        sq = (sq - at) * a0 / (a0 - at)
        bar = sq ** 2
        alphas = np.concatenate([bar[0:1], bar[1:] / bar[:-1]])
        betas = 1.0 - alphas
    return np.cumprod(1.0 - betas).astype(np.float32)


def trailing_timesteps(s: dict, steps: int) -> np.ndarray:
    n = s["num_train_timesteps"]
    return np.round(np.arange(n, 0, -n / steps)).astype(np.int64)[:steps] - 1


class DDIM:
    def __init__(self, s: dict, steps: int):
        self.acp = alphas_cumprod(s)
        self.timesteps = trailing_timesteps(s, steps)
        self.stride = s["num_train_timesteps"] // steps

    def init(self, lat):
        return None

    def step(self, i: int, v: torch.Tensor, x: torch.Tensor, carry):
        t = int(self.timesteps[i])
        a = torch.tensor(self.acp[t], dtype=torch.float32)
        prev = t - self.stride
        ap = torch.tensor(self.acp[prev] if prev >= 0 else self.acp[0], dtype=torch.float32)
        v, x = _r(v.float()), _r(x.float())
        x0 = a.sqrt() * x - (1 - a).sqrt() * v
        eps = a.sqrt() * v + (1 - a).sqrt() * x
        return _r(ap.sqrt() * x0 + (1 - ap).sqrt() * eps), carry


class UniPC:
    def __init__(self, s: dict, steps: int):
        acp = alphas_cumprod(s).astype(np.float64)
        if s["rescale_betas_zero_snr"]:
            acp[-1] = max(acp[-1], 2.0 ** -24)
        ts = trailing_timesteps(s, steps)
        self.timesteps = ts
        n = len(ts)
        alpha, sigma = np.sqrt(acp[ts]), np.sqrt(1.0 - acp[ts])
        lam = np.log(alpha / sigma)
        a_next = np.concatenate([alpha[1:], [1.0]])
        s_next = np.concatenate([sigma[1:], [0.0]])
        h = np.zeros(n)
        coef_x, coef_d, c2 = np.zeros(n), np.zeros(n), np.zeros(n)
        for i in range(n):
            if i == n - 1:
                coef_d[i] = 1.0
            else:
                h[i] = np.log(a_next[i] / s_next[i]) - lam[i]
                coef_x[i] = s_next[i] / sigma[i]
                coef_d[i] = a_next[i] * -np.expm1(-h[i])
            if 0 < i < n - 1:
                c2[i] = h[i] / (2.0 * h[i - 1])
        c_x, c_k, c_hist, c_dt = np.zeros(n), np.zeros(n), np.zeros(n), np.zeros(n)
        for i in range(1, n):
            hh = -(lam[i] - lam[i - 1])
            b_h = np.expm1(hh)
            c_x[i] = sigma[i] / sigma[i - 1]
            c_k[i] = alpha[i] * -np.expm1(hh)
            if i == 1:
                c_dt[i] = 0.5
            else:
                rk0 = (lam[i - 2] - lam[i - 1]) / (lam[i] - lam[i - 1])
                k1 = np.expm1(hh) / hh - 1.0
                b0 = k1 / b_h
                b1 = 2.0 * (k1 / hh - 0.5) / b_h
                rho0 = (b0 - b1) / (1.0 - rk0)
                c_hist[i] = rho0 / rk0
                c_dt[i] = b0 - rho0
        f = lambda a: [float(np.float32(x)) for x in a]  # noqa: E731
        self.alpha, self.sigma = f(alpha), f(sigma)
        self.coef_x, self.coef_d, self.c2 = f(coef_x), f(coef_d), f(c2)
        self.c_x, self.c_k, self.c_hist, self.c_dt = f(c_x), f(c_k), f(c_hist), f(c_dt)

    def init(self, lat):
        z = torch.zeros_like(lat, dtype=torch.float32)
        return (z, z, z)

    def step(self, i: int, v: torch.Tensor, x: torch.Tensor, carry):
        prev_x0, prev2_x0, last = carry
        v, x = _r(v.float()), _r(x.float())
        x0 = self.alpha[i] * x - self.sigma[i] * v
        if i > 0:
            xi = self.c_x[i] * last + self.c_k[i] * (
                prev_x0 + self.c_hist[i] * (prev2_x0 - prev_x0)
                + self.c_dt[i] * (x0 - prev_x0))
        else:
            xi = x
        d = x0 + self.c2[i] * (x0 - prev_x0)
        return _r(self.coef_x[i] * xi + self.coef_d[i] * d), (x0, prev_x0, xi)


SAMPLERS = {"ddim": DDIM, "unipc": UniPC}


def make_sampler(scheduler: dict, name: str, steps: int):
    return SAMPLERS[name](scheduler, steps)


def guided(out_u: torch.Tensor, out_c: torch.Tensor, scale: float,
           served: bool = True) -> torch.Tensor:
    """Classifier-free guidance (cond alone at scale <= 1), returned in
    fp32: computed in the dtype of the model's outputs (`served`, rounding
    as the model's output would), or in fp32 from them."""
    if not served:
        out_u, out_c = out_u.float(), out_c.float()
    g = out_u + scale * (out_c - out_u) if scale > 1.0 else out_c
    return _r(g.float())


def sample_trajectory(sampler, outputs: List[torch.Tensor], first: torch.Tensor,
                      scale: float, inputs: Optional[List[torch.Tensor]] = None,
                      served: bool = True):
    """Replays the sampler over the guided outputs (u, c) of each step
    (`served`: as `guided`). With `inputs` (the latents each step was
    evaluated at), step i starts from inputs[i] and its result is set beside
    inputs[i + 1]. Returns the list of per-step results (the last is the
    clip's final latents)."""
    carry = sampler.init(first)
    x = first
    res = []
    for i, (u, c) in enumerate(outputs):
        if inputs is not None:
            x = inputs[i]
        x, carry = sampler.step(i, guided(u, c, scale, served), x, carry)
        res.append(x)
    return res
