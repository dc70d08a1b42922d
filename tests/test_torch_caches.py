"""The port's step caches against the live hallo_tpu pipeline, on the CPU in
fp32, as tests/test_torch_profiles.py holds the fast profile (the same
bridged, perturbed tiny weights, the same noise, 2 clips, 2/255 max and
1e-3 mean on the video).

One run of each of the JAX clip program's step-cache loop bodies, at 12
steps: DDIM with `step_cache="uniform"` (`body_c`); DPM-Solver++ with
`step_cache="dynamic"` alone (`body_d`); UniPC with "dynamic", the CFG cache
(`cfg_cache_stride=2`) and `cfg_tail=2` (`body_dg`). The dynamic runs'
threshold, 0.3, sits between the accumulated relative latent change of the
first allowed step (about 0.17 with these weights) and that of the second
after a reuse (about 0.53), so each clip reuses once and recomputes once on
its allowed steps. Each run asserts a margin above 1e-3 between every
recorded `accum + diff` and the threshold, so that fp32 summation order
(torch's mean against XLA's) cannot flip a decision between the two sides.
"""

import numpy as np

from hallo_tpu.diffusion.cache import make_allow_mask, make_cfg_plan, make_skip_mask

from tests.test_torch_profiles import CLIPS, few_threads, run_both  # noqa: F401 (a fixture)

THRESHOLD = 0.3


def check_dynamic(timings, n, plan=None):
    """Reuse only on allowed steps, at least one reuse and one recompute on
    them, every decision clear of the threshold, and every other step as
    the CFG plan (or the full CFG pair)."""
    allow = make_allow_mask(n)
    kinds = timings["step_kind"]
    assert len(kinds) == n * CLIPS
    scores = timings["step_cache_score"]
    assert len(scores) == allow.sum() * CLIPS
    assert min(abs(s - THRESHOLD) for s in scores) > 1e-3, scores
    allowed = [k for c in range(CLIPS) for k, a in zip(kinds[c * n:(c + 1) * n], allow) if a]
    assert "reuse" in allowed and any(k != "reuse" for k in allowed), kinds
    for c in range(CLIPS):
        for i, kind in enumerate(kinds[c * n:(c + 1) * n]):
            if kind == "reuse":
                assert allow[i], (i, kinds)
            elif plan is None:
                assert kind == "full", (i, kind)
            else:
                assert kind == ("full" if plan[i] else "cond"), (i, kind)
    # a decision is made on the host from the score: reuse exactly below it
    decided = [k == "reuse" for c in range(CLIPS)
               for k, a in zip(kinds[c * n:(c + 1) * n], allow) if a]
    assert decided == [s < THRESHOLD for s in scores]


def test_ddim_uniform_step_cache_matches_jax():
    _, pipe, timings = run_both(12, sampler="ddim", step_cache="uniform")
    skip = make_skip_mask(12)
    assert skip.any()
    assert timings["step_kind"] == ["reuse" if s else "full" for s in skip] * CLIPS
    assert "step_cache_score" not in timings


def test_dynamic_step_cache_matches_jax():
    _, pipe, timings = run_both(12, sampler="dpm++2m", step_cache="dynamic",
                                step_cache_threshold=THRESHOLD)
    check_dynamic(timings, 12)


def test_dynamic_step_cache_with_cfg_cache_matches_jax():
    _, pipe, timings = run_both(12, sampler="unipc", step_cache="dynamic",
                                step_cache_threshold=THRESHOLD, cfg_cache_stride=2,
                                cfg_tail=2)
    plan, weights = make_cfg_plan(12, 2, 3.5, tail=2)
    assert not plan[-2:].any() and (weights[-2:] == 1.0).all()
    check_dynamic(timings, 12, plan)
    assert "cond" in timings["step_kind"]
