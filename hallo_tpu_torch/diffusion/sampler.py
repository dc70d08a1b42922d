"""Sampler handle over DDIM, DPM-Solver++ (2M) and UniPC (counterpart of
hallo_tpu/diffusion/sampler.py).

A sampler is (state, init_carry, step): `step(i, model_output, sample,
carry) -> (sample, carry)` is the update of loop step i. DDIM carries
nothing (None), DPM-Solver++ 2M the previous step's x0 estimate, UniPC
also the one before and its last corrected sample. The pipeline treats the
carry as opaque.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple, Union

import torch

from hallo_tpu_torch.config import SchedulerConfig
from hallo_tpu_torch.diffusion import ddim, dpm, unipc
from hallo_tpu_torch.diffusion import schedule as schedule_mod

SAMPLERS = ("ddim", "dpm++2m", "unipc")


class Sampler(NamedTuple):
    """The model is evaluated at `timesteps[i]` on loop step i."""

    name: str
    state: Union[ddim.DDIMState, dpm.DPMState, unipc.UniPCState]
    init_carry: Callable[[torch.Tensor], Any]  # latents -> carry
    step: Callable[[int, torch.Tensor, torch.Tensor, Any], Tuple[torch.Tensor, Any]]

    @property
    def timesteps(self):
        return self.state.timesteps

    @property
    def num_steps(self) -> int:
        return self.state.num_steps


def make_sampler(
    cfg: SchedulerConfig,
    name: str,
    num_inference_steps: int,
    timestep_schedule: str = "trailing",
    schedule_rho: float = 1.0,
) -> Sampler:
    """`timestep_schedule="logsnr"` replaces the trailing eval grid with
    knots spaced in log-SNR (schedule.logsnr_timesteps, curved by
    `schedule_rho`) between the same endpoints; "trailing" (also "default",
    "" or None) is the reference's grid."""
    name = (name or "ddim").lower()
    if timestep_schedule in (None, "", "trailing", "default"):
        ts = None
    elif timestep_schedule == "logsnr":
        ts = schedule_mod.logsnr_timesteps(cfg, num_inference_steps, rho=schedule_rho)
    else:
        raise ValueError(
            f"timestep_schedule={timestep_schedule!r}: 'trailing' or 'logsnr'")
    if name == "ddim":
        state = ddim.make_state(cfg, num_inference_steps, timesteps=ts)

        def step(i, model_output, sample, carry):
            return ddim.ddim_step(state, i, model_output, sample), carry

        return Sampler("ddim", state, lambda latents: None, step)

    if name in ("dpm++2m", "dpm", "dpmsolver++"):
        state = dpm.make_state(cfg, num_inference_steps, timesteps=ts)

        def init_carry(latents):
            # prev_x0; step 0's second-order weight is 0, so it is never read
            return torch.zeros(latents.shape, dtype=torch.float32, device=latents.device)

        def step(i, model_output, sample, carry):
            return dpm.dpm_step(state, i, model_output, sample, carry)

        return Sampler("dpm++2m", state, init_carry, step)

    if name == "unipc":
        state = unipc.make_state(cfg, num_inference_steps, timesteps=ts)

        def step(i, model_output, sample, carry):
            return unipc.unipc_step(state, i, model_output, sample, carry)

        return Sampler("unipc", state, unipc.init_carry, step)

    raise ValueError(f"sampler={name!r}: expected one of {SAMPLERS}")
