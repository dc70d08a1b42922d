"""Sampler handle (counterpart of hallo_tpu/diffusion/sampler.py). The port
has the DDIM branch; DPM-Solver++ and UniPC are still to be ported."""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from hallo_tpu_torch.config import SchedulerConfig
from hallo_tpu_torch.diffusion import ddim

SAMPLERS = ("ddim",)


class Sampler(NamedTuple):
    """`step(i, model_output, sample) -> new_sample`; the model is evaluated
    at `timesteps[i]` on loop step i."""

    name: str
    state: ddim.DDIMState
    step: Callable[[int, torch.Tensor, torch.Tensor], torch.Tensor]

    @property
    def timesteps(self):
        return self.state.timesteps

    @property
    def num_steps(self) -> int:
        return self.state.num_steps


def make_sampler(cfg: SchedulerConfig, name: str, num_inference_steps: int) -> Sampler:
    name = (name or "ddim").lower()
    if name != "ddim":
        raise ValueError(f"sampler={name!r}: the port has {SAMPLERS}")
    state = ddim.make_state(cfg, num_inference_steps)

    def step(i, model_output, sample):
        return ddim.ddim_step(state, i, model_output, sample)

    return Sampler("ddim", state, step)
