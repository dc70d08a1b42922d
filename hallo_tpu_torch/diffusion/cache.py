"""Denoiser step and CFG caching plans (the port's copy of
hallo_tpu/diffusion/cache.py; numpy only).

Caching reuses the model prediction across adjacent steps where the
denoising trajectory is smooth (PAPERS.md: caching-based parallel denoising
for talking heads; READ; the TeaCache/DeepCache lineage). Early steps set
the global structure and the last ones sharpen detail, so a warm-up prefix
and a cool-down suffix are always recomputed. Off by default: it trades
some fidelity for fewer denoiser forwards.
"""

from __future__ import annotations

import numpy as np


def make_skip_mask(
    num_steps: int,
    warmup: int = 6,
    cooldown: int = 4,
    stride: int = 2,
) -> np.ndarray:
    """Boolean (num_steps,): True = reuse the cached model output.

    Never skips step 0 (nothing cached yet), the first `warmup` steps, the
    last `cooldown` steps, or two skips in a row for stride=2."""
    skip = np.zeros(num_steps, dtype=bool)
    for i in range(num_steps):
        if i < max(1, warmup) or i >= num_steps - cooldown:
            continue
        if (i - warmup) % stride != 0:
            skip[i] = True
    return skip


def make_uncond_mask(
    num_steps: int,
    stride: int,
    warmup: int = 6,
    cooldown: int = 4,
) -> np.ndarray:
    """Boolean (num_steps,): True = recompute the CFG UNCOND half this step.

    Adaptive-guidance-style CFG caching: the unconditional prediction
    drifts slowly across the trajectory, so between warmup and cooldown it
    is recomputed only every `stride`-th step and reused otherwise (the
    conditional half always runs; the guidance combine uses the cached
    uncond). stride=1 disables caching (all True)."""
    mask = np.ones(num_steps, dtype=bool)
    if stride <= 1:
        return mask
    for i in range(num_steps):
        if i < max(1, warmup) or i >= num_steps - cooldown:
            continue
        if (i - warmup) % stride != 0:
            mask[i] = False
    return mask


def make_cfg_plan(
    num_steps: int,
    stride: int,
    guidance_scale: float,
    warmup: int | None = None,
    cooldown: int | None = None,
    tail: int = 0,
):
    """Per-step CFG execution plan: (uncond_mask, guidance_weights).

    - `uncond_mask[i]` True = evaluate the uncond half at step i (else the
      cached uncond is reused by the combine — make_uncond_mask semantics).
    - `guidance_weights[i]` = the CFG scale applied at step i. In the last
      `tail` steps it is 1.0 — guidance OFF entirely (pred = cond), which
      both saves the uncond evals there and avoids extrapolating against a
      stale cached uncond (guidance-interval truncation: at low noise the
      cond/uncond predictions have converged, so the extrapolation adds
      noise, not signal — see PAPERS.md guidance-interval lineage; VERDICT
      r5 item 3b).

    warmup/cooldown default to the legacy 6/4 when None, but SCALED DOWN
    to ~15%/10% of num_steps when that exceeds the step budget (the 6/4
    defaults were tuned for 40 steps; at 12 steps they left only 2 strides
    eligible — BASELINE.md r5)."""
    if warmup is None:
        warmup = 6 if num_steps >= 24 else max(2, round(0.15 * num_steps))
    if cooldown is None:
        cooldown = 4 if num_steps >= 24 else max(1, round(0.10 * num_steps))
    tail = int(max(0, min(tail, num_steps)))
    mask = make_uncond_mask(num_steps, stride, warmup=warmup, cooldown=cooldown)
    gw = np.full(num_steps, float(guidance_scale))
    if tail:
        mask[num_steps - tail:] = False
        gw[num_steps - tail:] = 1.0
    if tail < num_steps:
        mask[0] = True  # nothing cached yet
    return mask, gw


def make_allow_mask(
    num_steps: int, warmup: int = 6, cooldown: int = 4
) -> np.ndarray:
    """Boolean (num_steps,): True = this step MAY reuse the cache, for the
    DYNAMIC (TeaCache-style) criterion: the actual skip decision is made
    per step from the accumulated relative latent change since the last
    recompute. Warmup/cooldown are always recomputed (structure is set
    early, detail late)."""
    allow = np.zeros(num_steps, dtype=bool)
    allow[max(1, warmup) : max(1, num_steps - cooldown)] = True
    return allow
