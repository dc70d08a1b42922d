"""The frozen reference against the measured program at the test widths on
the CPU, on the same seeded weights (every bias and zero-initialised head
drawn non-zero): one clip stage by stage, and one stage-2 train step; and
what the reference imports."""

from __future__ import annotations

import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import inputs, weights
from benchmark.drivers import common, infer, train
from benchmark.reference import models as ref_models
from benchmark.reference import sampling as ref_sampling

from conftest import ROOT, load


@pytest.fixture(scope="module")
def tiny():
    return load("tiny.json")


def _program(cfg, seed):
    from hallo_tpu_torch.utils.factory import build_models

    models = build_models("tiny", device="cpu", dtype=torch.float32)
    weights.load(models.modules(), weights.make(cfg, seed, "cpu", torch.float32))
    return models


@pytest.mark.parametrize("sampler,steps", [("ddim", 3), ("unipc", 3)])
def test_reference_follows_the_port_through_two_clips(tiny, sampler, steps):
    seed = 2 ** 31 + 17
    models = _program(tiny, seed)
    traffic = {"sampler": sampler, "steps": steps}
    pipe = infer._pipeline(models, tiny, traffic, steps)
    f, h = tiny["clip_length"], tiny["height"]
    cap = infer.Capture(models, 1, 2, steps, 1, (1, f, 4, h // 8, h // 8))
    req = inputs.clip_request(seed, 0, tiny, 1, 2)
    frames = []
    cap.active = True
    cap.begin(0)
    infer._call(pipe, req, lambda a: frames.append(np.array(a)), 0)
    caps = [cap.steps_of(0, c) for c in range(2)]
    num = infer.judge(tiny, traffic, {"steps_per_clip": steps}, seed, req,
                      [la for la, _ in caps], [ou for _, ou in caps], frames, "cpu")
    assert num["start_rel"] == 0.0
    assert num["sampler_rel"] < 1e-6
    assert num["denoiser_rel"] < 1e-5
    assert num["frames_mad"] < 0.01


def test_reference_modules_match_the_port_one_by_one(tiny):
    seed = 99
    models = _program(tiny, seed)
    ref = common.build_reference(tiny, seed, "cpu")
    x = torch.randn(2, 3, 64, 64)
    torch.testing.assert_close(ref["vae"].encode_mean(x), models.vae.encode_mean(x),
                               rtol=1e-5, atol=1e-5)
    z = torch.randn(2, 4, 8, 8)
    torch.testing.assert_close(ref["vae"].decode(z), models.vae.decode(z), rtol=1e-5,
                               atol=1e-5)
    e = torch.randn(2, tiny["image_proj"]["clip_embeddings_dim"])
    torch.testing.assert_close(ref["image_proj"](e), models.image_proj(e), rtol=1e-5,
                               atol=1e-5)


def test_reference_train_step_matches_the_port():
    cfg = load("tiny_train.json")
    seed = 12345
    batches = [inputs.train_batch(seed, i, cfg, 2) for i in range(2)]
    models, state, step = train._program(cfg, seed, "cpu")
    state, prog = train.setup_steps(cfg, seed, models, state, step, batches, 2, "cpu")
    ref = train.reference_readings(cfg, seed, batches, 2, "cpu")
    num = train.compare(prog, ref)
    assert num["loss_rel"] < 1e-5
    assert num["grad_rel"] < 1e-4
    assert num["update_rel"] < 1e-3


def test_sampler_tables_match_the_port():
    import dataclasses

    from hallo_tpu_torch.config import SchedulerConfig
    from hallo_tpu_torch.diffusion import ddim, schedule, unipc

    cfg = SchedulerConfig()
    s = dataclasses.asdict(cfg)
    assert np.array_equal(ref_sampling.alphas_cumprod(s), schedule.alphas_cumprod(cfg))
    for n in (8, 10, 40):
        assert np.array_equal(ref_sampling.trailing_timesteps(s, n),
                              ddim.make_state(cfg, n).timesteps)
        u, st = ref_sampling.UniPC(s, n), unipc.make_state(cfg, n)
        for k in ("coef_x", "coef_d", "c2", "c_x", "c_k", "c_hist", "c_dt"):
            assert np.array_equal(np.float32(getattr(u, k)), getattr(st, k)), k


def test_reference_imports_nothing_of_the_port_or_jax():
    code = ("import sys, benchmark.reference.models, benchmark.reference.clip, "
            "benchmark.reference.sampling, benchmark.reference.train;"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True).stdout
    tops = set(eval(out.strip().splitlines()[-1]))  # noqa: S307
    assert not tops & {"jax", "jaxlib", "flax", "hallo_tpu", "hallo_tpu_torch"}


def test_reference_parameter_names_are_the_ports(tiny):
    from hallo_tpu_torch.utils.factory import build_models

    models = build_models("tiny", device="meta")
    ref = ref_models.build(tiny, "meta")
    for top, mod in models.modules().items():
        assert {k: tuple(v.shape) for k, v in mod.state_dict().items()} == \
            {k: tuple(v.shape) for k, v in ref[top].state_dict().items()}, top
