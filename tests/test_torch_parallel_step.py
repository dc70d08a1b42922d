"""The port's stage-2 step over a (data, seq) mesh of gloo ranks, with
ZeRO-2, against hallo_tpu's step and against the port's step on one
process (tests/test_torch_parallel.py's case (d); the ranks come from
tests/torch_parallel_ranks.py)."""

import jax
import numpy as np
import pytest
import torch

from hallo_tpu.train import state as jax_state
from hallo_tpu.train import step as jax_step_mod
from hallo_tpu.utils.factory import build_models as jax_build_models
from hallo_tpu_torch.convert.from_jax import load_jax_params
from hallo_tpu_torch.train import state as tstate
from hallo_tpu_torch.train import step as tstep
from hallo_tpu_torch.utils.factory import build_models

from tests.test_torch_parallel import np_tree, rel_l2
from tests.test_torch_train import (
    EPS, LR, NO_DROPOUT, CapturingAdamW, at_path, capture_grads, jax_path, perturb_all,
    to_jax_layout)
from tests.torch_parallel_ranks import spawn

STEP_HW, STEP_F, STEP_M, STEP_B = 128, 4, 2, 2
OPT_KW = dict(learning_rate=LR, eps=EPS, lr_warmup_steps=1)


def step_batch(seed=0):
    """A global stage-2 batch at 128x128 (the deepest level's 4 sites split
    over the seq ranks), B 2, 4 + 2 frames, with noise and timesteps."""
    rng = np.random.default_rng(seed)
    h, f, m, b = STEP_HW, STEP_F, STEP_M, STEP_B
    hl = h // 8
    return dict(
        pixel_values=rng.uniform(-1, 1, (b, f, h, h, 3)).astype(np.float32),
        ref_pixels=rng.uniform(-1, 1, (b, h, h, 3)).astype(np.float32),
        motion_pixels=rng.uniform(-1, 1, (b, m, h, h, 3)).astype(np.float32),
        audio_windows=rng.normal(size=(b, f, 3, 2, 4)).astype(np.float32),
        face_emb=rng.normal(size=(b, 16)).astype(np.float32),
        face_region=rng.uniform(0, 1, (b, h, h, 3)).astype(np.float32),
        masks=tuple(tuple((rng.uniform(size=(b, (hl >> d) ** 2)) > 0.3).astype(np.float32)
                          for _ in range(3)) for d in range(4)),
        noise=rng.normal(size=(b, f, hl, hl, 4)).astype(np.float32),
        timesteps=np.array([999, 321], np.int32),
    )


@pytest.fixture(scope="module")
def step_ref():
    """JAX's step (overrides) on the global batch, and the port's one-process
    steps on it with and without the overrides, from the same perturbed tiny
    weights."""
    jm = jax_build_models("tiny", init_key=jax.random.PRNGKey(0), height=STEP_HW,
                          width=STEP_HW, clip_length=STEP_F, n_motion_frames=STEP_M)
    params = {k: perturb_all(v, seed=i) for i, (k, v) in enumerate(sorted(jm.params.items()))}
    labels = jax_state.label_params(params, jax_state.stage2_trainable)
    tx = capture_grads(jax_state.make_optimizer(jax_state.OptimizerConfig(**OPT_KW), labels))
    step = jax.jit(jax_step_mod.make_train_step(
        jm, tx, jax_step_mod.TrainConfig(stage=2, **NO_DROPOUT)))
    batch = step_batch()
    s1, m1 = step(jax_state.TrainState.create(params, tx), batch, jax.random.PRNGKey(0))
    pm = build_models("tiny", device="cpu")
    load_jax_params(pm, np_tree(params))
    states = {k: {n: v.numpy() for n, v in mod.state_dict().items()}
              for k, mod in pm.modules().items()}
    port = {}
    for override in (True, False):
        pm = build_models("tiny", device="cpu")
        load_jax_params(pm, np_tree(params))
        trainable = tstate.unfreeze(pm.modules(), tstate.stage2_trainable)
        opt = CapturingAdamW(tstate.OptimizerConfig(**OPT_KW))
        state = tstate.TrainState.create(trainable, opt)
        fn = tstep.make_train_step(pm, trainable, opt, tstep.TrainConfig(**NO_DROPOUT))
        b = batch if override else {k: v for k, v in batch.items()
                                    if k not in ("noise", "timesteps")}
        runs = []
        for i in range(2):
            state, metrics = fn(state, b, tstep.step_generator(0, i, "cpu"))
            runs.append(dict(metrics, grads=opt.grads))
        port[override] = dict(steps=runs, params=state.params)
    return dict(jax_loss=float(m1["loss"]), jax_grads=np_tree(s1.opt_state[0]),
                states=states, batch=batch, port=port)


@pytest.mark.parametrize("n_data,n_seq", [(2, 1), (1, 2), (2, 2)])
def test_train_step_data_and_clip_parallel(tmp_path, step_ref, n_data, n_seq):
    """The stage-2 step over a (data, seq) mesh of gloo ranks (ZeRO-2 AdamW):
    - with the noise/timesteps overrides, against JAX's step on the global
      batch at test_torch_train.py's tolerances (loss 1e-5, each trainable
      gradient relative L2 1e-4);
    - with the draws from the step generator, two steps against the port's
      one-process steps on the same global batch: loss 1e-6, the whole
      trainable gradient relative L2 1e-5 and each trainable gradient 1e-4
      (a leaf of small norm sums large opposite terms: the port and JAX
      differ by up to 2.2e-5 on one leaf of this batch at one process, and
      the sharded sums by up to 3e-5), the masters after two AdamW steps
      1e-4 (Adam divides by sqrt(v): rounding of near-zero gradients is
      amplified);
    - the metrics are the same on every rank."""
    world = n_data * n_seq
    ranks = spawn("train_step", world, str(tmp_path / "run"), states=step_ref["states"],
                  batch=step_ref["batch"], n_data=n_data, n_seq=n_seq, opt_kw=OPT_KW,
                  train_kw=NO_DROPOUT, runs=[(True, 1), (False, 2)])
    first = ranks[0][0]["steps"][0]
    np.testing.assert_allclose(first["loss"], step_ref["jax_loss"], rtol=1e-5)
    for name, g in first["grads"].items():
        path, transform = jax_path(name)
        want = at_path(step_ref["jax_grads"], path)
        if np.linalg.norm(want) > 0:
            assert rel_l2(to_jax_layout(g, transform), want) < 1e-4, name

    ref = step_ref["port"][False]
    for i in range(2):
        got, want = ranks[0][1]["steps"][i], ref["steps"][i]
        assert all(r[1]["steps"][i]["loss"] == got["loss"] and
                   r[1]["steps"][i]["grad_norm"] == got["grad_norm"] for r in ranks)
        assert got["skipped"] == 0.0
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-5)
        names = [n for n, g in want["grads"].items() if g.norm() > 0]
        assert rel_l2(torch.cat([got["grads"][n].flatten() for n in names]),
                      torch.cat([want["grads"][n].flatten() for n in names])) < 1e-5
        for name in names:
            assert rel_l2(got["grads"][name], want["grads"][name]) < 1e-4, (i, name)
    for name, p in ref["params"].items():
        assert rel_l2(ranks[0][1]["state"]["params"][name], p) < 1e-4, name
