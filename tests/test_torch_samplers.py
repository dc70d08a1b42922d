"""The port's samplers, eval grids and cache plans against hallo_tpu's, on
the CPU.

- DPM-Solver++ (2M) and UniPC tables equal JAX's bit for bit (the same
  float64 host arithmetic, then float32), on the trailing and log-SNR grids.
- `dpm_step` and `unipc_step` over 10 and 8 steps on seeded latents and
  model outputs match JAX's at atol 1e-6, carries included.
- `make_sampler`: names, aliases, grids and errors as JAX's.
- The cache plans equal JAX's over a grid of steps, strides, warm-up,
  cool-down and tail; the fast and turbo trailing grids nest in the exact
  40-step grid.
- `logsnr_timesteps` equals JAX's for every count from 2 to 60. Named
  divergence: where JAX's collision pass moves the last knot below the
  trailing end (118-120 steps at rho 0.5, 181 on at rho 1) or asserts (61,
  103, 121, 122: the trailing grid's float arange yields an extra knot at
  t = -1, which JAX takes as its end; 181 at rho 0.5), the port keeps
  `ts[-1]` at the trailing grid's `num_steps`-th knot with a strictly
  decreasing grid, and raises ValueError where no such grid fits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hallo_tpu.config import SchedulerConfig as JaxSchedulerConfig
from hallo_tpu.diffusion import cache as jax_cache
from hallo_tpu.diffusion import ddim as jax_ddim
from hallo_tpu.diffusion import dpm as jax_dpm
from hallo_tpu.diffusion import schedule as jax_schedule
from hallo_tpu.diffusion import unipc as jax_unipc
from hallo_tpu.diffusion.sampler import SAMPLERS as JAX_SAMPLERS
from hallo_tpu.diffusion.sampler import make_sampler as jax_make_sampler
from hallo_tpu_torch.config import SchedulerConfig
from hallo_tpu_torch.diffusion import cache, ddim, dpm, schedule, unipc
from hallo_tpu_torch.diffusion.sampler import SAMPLERS, make_sampler

CFG, JCFG = SchedulerConfig(), JaxSchedulerConfig()
RHOS = (0.5, 1.0, 1.5, 2.0, 3.0)
SHAPE = (1, 4, 8, 8, 4)


def _grid(kind, n, rho=1.0):
    return None if kind == "trailing" else schedule.logsnr_timesteps(CFG, n, rho)


@pytest.mark.parametrize("n", range(2, 61))
def test_logsnr_timesteps_equal_jax_from_2_to_60(n):
    for rho in RHOS:
        got = schedule.logsnr_timesteps(CFG, n, rho)
        want = jax_schedule.logsnr_timesteps(JCFG, n, rho)
        np.testing.assert_array_equal(got, want, err_msg=f"{n} steps, rho {rho}")
        assert got.dtype == want.dtype


@pytest.mark.parametrize("n, rho", [(61, 1.0), (103, 1.0), (121, 1.0), (122, 1.0),
                                    (181, 1.0), (118, 0.5), (120, 0.5), (181, 0.5)])
def test_logsnr_timesteps_keep_the_trailing_end_where_jax_does_not(n, rho):
    trail = schedule.inference_timesteps(CFG, n)
    t_end = int(trail[n - 1])
    got = schedule.logsnr_timesteps(CFG, n, rho)
    assert got.shape == (n,) and got[0] == trail[0] and got[-1] == t_end
    assert np.all(np.diff(got) < 0) and got[-1] >= 0
    try:
        want = jax_schedule.logsnr_timesteps(JCFG, n, rho)
    except AssertionError:
        return  # JAX asserts here: the divergence the port repairs
    assert want[-1] < t_end or not np.all(np.diff(want) < 0), (n, rho, want[-4:])


def test_logsnr_timesteps_raise_where_no_grid_fits():
    with pytest.raises(ValueError, match="strictly decreasing"):
        schedule.logsnr_timesteps(CFG, 10, t_min=995)
    with pytest.raises(ValueError, match="strictly decreasing"):
        schedule.logsnr_timesteps(CFG, 10, t_min=-1)
    np.testing.assert_array_equal(schedule.logsnr_timesteps(CFG, 1),
                                  jax_schedule.logsnr_timesteps(JCFG, 1))


def test_fast_profile_grids_nest_into_exact_grid():
    exact = set(schedule.inference_timesteps(CFG, 40).tolist())
    for s in (8, 10, 20):
        ts = schedule.inference_timesteps(CFG, s)
        assert set(ts.tolist()) <= exact, (s, sorted(set(ts) - exact))
        np.testing.assert_array_equal(ts, jax_schedule.inference_timesteps(JCFG, s))


@pytest.mark.parametrize("grid", ["trailing", "logsnr"])
@pytest.mark.parametrize("n", [8, 10, 12, 40])
def test_state_tables_equal_jax_bit_for_bit(n, grid):
    ts = _grid(grid, n)
    for mine, theirs in ((dpm.make_state(CFG, n, ts), jax_dpm.make_state(JCFG, n, ts)),
                         (unipc.make_state(CFG, n, ts), jax_unipc.make_state(JCFG, n, ts)),
                         (ddim.make_state(CFG, n, ts), jax_ddim.make_state(JCFG, n, ts))):
        assert mine._fields == theirs._fields
        for name in mine._fields:
            a, b = getattr(mine, name), getattr(theirs, name)
            if name == "prediction_type":
                assert a == b
                continue
            b = np.asarray(b)
            if isinstance(a, float):  # DDIM's final alpha: a host float of the f32 table
                assert a == float(b), name
                continue
            assert a.dtype == b.dtype or name == "timesteps", (name, a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b, err_msg=f"{type(mine).__name__}.{name}")


def _trajectory(name, n, grid, rho=1.0):
    """The same seeded latents and model outputs through both samplers'
    steps; every returned sample and carry leaf side by side."""
    rng = np.random.default_rng(n)
    x0 = rng.normal(size=SHAPE).astype(np.float32)
    outs = rng.normal(size=(n,) + SHAPE).astype(np.float32)
    ts = schedule.logsnr_timesteps(CFG, n, rho) if grid == "logsnr" else None
    mine = make_sampler(CFG, name, n, timestep_schedule=grid, schedule_rho=rho)
    theirs = jax_make_sampler(JCFG, name, n, timestep_schedule=grid, schedule_rho=rho)
    np.testing.assert_array_equal(mine.timesteps, np.asarray(theirs.timesteps))
    if ts is not None:
        np.testing.assert_array_equal(mine.timesteps, ts)
    x, c = torch.from_numpy(x0), mine.init_carry(torch.from_numpy(x0))
    jx, jc = jnp.asarray(x0), theirs.init_carry(jnp.asarray(x0))
    pairs = []
    for i in range(n):
        # the model output depends on the sample, so the carry matters
        out = outs[i] + 0.3 * np.asarray(jx)
        x, c = mine.step(i, torch.from_numpy(out), x, c)
        jx, jc = theirs.step(jnp.int32(i), jnp.asarray(out), jx, jc)
        pairs.append((x, jx))
        if name != "ddim":
            leaves = c if isinstance(c, tuple) else (c,)
            jleaves = jc if isinstance(jc, tuple) else (jc,)
            pairs.extend(zip(leaves, jleaves))
    return pairs


@pytest.mark.parametrize("name, n", [("dpm++2m", 10), ("dpm++2m", 8), ("unipc", 10),
                                     ("unipc", 8), ("ddim", 10)])
@pytest.mark.parametrize("grid", ["trailing", "logsnr"])
def test_steps_match_jax(name, n, grid):
    for got, want in _trajectory(name, n, grid):
        assert got.dtype == torch.float32 and got.shape == SHAPE
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_steps_keep_the_sample_dtype_and_carry_fp32():
    x = torch.randn(SHAPE, dtype=torch.bfloat16)
    for name in ("dpm++2m", "unipc"):
        s = make_sampler(CFG, name, 4)
        c = s.init_carry(x)
        new, c = s.step(1, torch.randn(SHAPE, dtype=torch.bfloat16), x, c)
        assert new.dtype == torch.bfloat16
        for leaf in (c if isinstance(c, tuple) else (c,)):
            assert leaf.dtype == torch.float32 and leaf.shape == SHAPE


def test_make_sampler_names_aliases_and_errors_match_jax():
    assert SAMPLERS == JAX_SAMPLERS
    for alias, name in (("ddim", "ddim"), ("DDIM", "ddim"), (None, "ddim"), ("", "ddim"),
                        ("dpm++2m", "dpm++2m"), ("dpm", "dpm++2m"),
                        ("dpmsolver++", "dpm++2m"), ("unipc", "unipc"), ("UniPC", "unipc")):
        for grid in ("trailing", "default", "", None, "logsnr"):
            s = make_sampler(CFG, alias, 12, timestep_schedule=grid, schedule_rho=1.5)
            j = jax_make_sampler(JCFG, alias, 12, timestep_schedule=grid, schedule_rho=1.5)
            assert s.name == j.name == name and s.num_steps == j.num_steps == 12
            np.testing.assert_array_equal(s.timesteps, np.asarray(j.timesteps))
    assert make_sampler(CFG, "ddim", 4).init_carry(torch.zeros(2)) is None
    assert isinstance(make_sampler(CFG, "unipc", 4).init_carry(torch.zeros(2)),
                      unipc.UniPCCarry)
    for kw in (dict(name="euler"), dict(name="ddim", timestep_schedule="karras")):
        args = (kw.pop("name"), 10)
        with pytest.raises(ValueError) as mine:
            make_sampler(CFG, *args, **kw)
        with pytest.raises(ValueError) as theirs:
            jax_make_sampler(JCFG, *args, **kw)
        assert str(mine.value) == str(theirs.value)


@pytest.mark.parametrize("n", [4, 8, 10, 12, 20, 40])
def test_cache_plans_equal_jax(n):
    for warmup in (0, 1, 2, 6):
        for cooldown in (0, 1, 4):
            np.testing.assert_array_equal(cache.make_allow_mask(n, warmup, cooldown),
                                          jax_cache.make_allow_mask(n, warmup, cooldown))
            for stride in (1, 2, 3):
                np.testing.assert_array_equal(
                    cache.make_skip_mask(n, warmup, cooldown, stride),
                    jax_cache.make_skip_mask(n, warmup, cooldown, stride))
                np.testing.assert_array_equal(
                    cache.make_uncond_mask(n, stride, warmup, cooldown),
                    jax_cache.make_uncond_mask(n, stride, warmup, cooldown))
    for stride in (1, 2, 3):
        for warmup in (None, 0, 2, 6):
            for cooldown in (None, 0, 1, 4):
                for tail in (0, 1, 2, n):
                    got = cache.make_cfg_plan(n, stride, 3.5, warmup, cooldown, tail)
                    want = jax_cache.make_cfg_plan(n, stride, 3.5, warmup, cooldown, tail)
                    for a, b in zip(got, want):
                        np.testing.assert_array_equal(a, b)
                        assert a.dtype == b.dtype
