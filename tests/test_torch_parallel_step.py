"""The port's stage-2 step over a (data, seq) mesh of gloo ranks, with
ZeRO-2, against hallo_tpu's step and against the port's step on one
process (tests/test_torch_parallel.py's case (d); the ranks come from
tests/torch_parallel_ranks.py); and tensor parallelism (parallel/tp.py) on
the same references: each sharded layer kind against its unsharded module,
the stage-2 step over (data, seq, model) meshes, the stage-1 step's clip
and its 8-bit AdamW (tests/test_torch_tp.py holds the plan and the
trainer)."""

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
    s2, _ = step(s1, batch, jax.random.PRNGKey(1))  # the warm-up's first update moved nothing
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
                jax_params2=np_tree(s2.params), states=states, batch=batch, port=port)


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


# --- tensor parallelism ------------------------------------------------------------

# (n_data, n_seq, n_model, min_dim, planted fault) of the stage-2 steps, by
# world; min_dim 32 is JAX's test's (the feed-forwards, the time embedding,
# the projections), 16 shards the attention denses too
TP_MESHES = {2: [(1, 1, 2, 16, True)], 4: [(2, 1, 2, 32, False), (1, 2, 2, 32, False)]}
TP_STEPS = [(2, 0), (4, 0), (4, 1)]
# the stage-1 step at model 4: AdamW with the clip biting (eps 1e-2 makes
# the update near-linear in the clipped gradient, so a wrong clip scale
# moves the masters), and the 8-bit AdamW
STAGE1_VARIANTS = [dict(learning_rate=1.0, eps=1e-2, max_grad_norm=1e-3),
                   dict(learning_rate=1e-3, eps=EPS, use_8bit_adam=True)]


@pytest.fixture(scope="module")
def tp_runs(step_ref, tmp_path_factory):
    """world -> every tensor-parallel case at that world size, run in one
    spawn the first time a test asks for it."""
    runs = {}

    def at(world):
        if world not in runs:
            root = str(tmp_path_factory.mktemp(f"tp{world}") / "run")
            runs[world] = spawn("tensor_parallel", world, root, timeout=180,
                                states=step_ref["states"], batch=step_ref["batch"],
                                meshes=TP_MESHES[world], opt_kw=OPT_KW, train_kw=NO_DROPOUT,
                                stage1_variants=STAGE1_VARIANTS if world == 4 else [])
        return runs[world]

    return at


@pytest.mark.parametrize("world", [2, 4])
def test_tp_layer_kinds(tp_runs, world):
    """Each sharded layer kind over model = world (tiny widths, min_dim 16,
    every parameter perturbed) against its unsharded module: the output,
    every input's gradient and every parameter's gradient (a sharded one
    against its piece of the plain gradient) at relative L2 1e-5. The
    attentions run on their local heads where the shard holds whole heads
    (4 heads at world 2 and 4, 2 heads at world 2) and gather the
    projections where it splits one (2 heads at world 4)."""
    for got in (r["layers"] for r in tp_runs(world)):
        for name, res in got.items():
            assert res["sharded"] > 0 and res["err"] < 1e-5, (name, res)
        assert got["attention_4"]["heads"] == got["temporal"]["heads"] == 4 // world
        assert got["attention_2"]["heads"] == (1 if world == 2 else 2)


def whole_gradient(grads: dict, names) -> torch.Tensor:
    return torch.cat([grads[n].flatten() for n in names])


@pytest.mark.parametrize("world,index", TP_STEPS,
                         ids=["data1-model2", "data2-model2", "seq2-model2"])
def test_tp_train_step(tp_runs, step_ref, world, index):
    """The stage-2 step with the tiny models sharded over the mesh's model
    axis (ZeRO-2 AdamW over its data axis), two steps on the global batch:
    - against JAX's unsharded step (tests/test_tensor_parallel.py's
      tolerances): the loss at rel 1e-5, the masters after the two steps
      (the first, under the warm-up, moves nothing) at rtol 5e-4 / atol 1e-6;
    - against the port's one-process steps: the loss at 1e-6, the grad norm
      at 1e-5, the whole trainable gradient at relative L2 1e-5;
    - the metrics are the same on every rank;
    - at world 2, the planted fault (`all_reduce_sum`, whose backward sums
      the cotangents, in place of g) must miss the gradient's limit."""
    runs = [r["steps"][index] for r in tp_runs(world)]
    got = runs[0]["tp"]
    assert got["sharded"] > 0
    np.testing.assert_allclose(got["steps"][0]["loss"], step_ref["jax_loss"], rtol=1e-5)
    for name, p in got["params"].items():
        path, transform = jax_path(name)
        np.testing.assert_allclose(to_jax_layout(p, transform),
                                   at_path(step_ref["jax_params2"], path), rtol=5e-4,
                                   atol=1e-6, err_msg=name)
    ref = step_ref["port"][True]
    names = [n for n, g in ref["steps"][0]["grads"].items() if g.norm() > 0]
    for i in range(2):
        step, want = got["steps"][i], ref["steps"][i]
        assert all(r["tp"]["steps"][i]["loss"] == step["loss"] and
                   r["tp"]["steps"][i]["grad_norm"] == step["grad_norm"] for r in runs)
        assert step["skipped"] == 0.0
        np.testing.assert_allclose(step["loss"], want["loss"], rtol=1e-6)
        np.testing.assert_allclose(step["grad_norm"], want["grad_norm"], rtol=1e-5)
        assert rel_l2(whole_gradient(step["grads"], names),
                      whole_gradient(want["grads"], names)) < 1e-5, i
    if "fault" in runs[0]:
        fault = runs[0]["fault"]["steps"][0]
        assert rel_l2(whole_gradient(fault["grads"], names),
                      whole_gradient(ref["steps"][0]["grads"], names)) > 1e-5


def test_tp_stage1_clip_bites(tp_runs):
    """The stage-1 step at model 4 (tiny 2D models, min_dim 16: split heads
    included) with the gradient-norm clip biting (max_grad_norm 1e-3 against
    a norm near 1.4) against the same steps on one process: the loss at
    1e-6, the grad norm at 1e-5, the masters after two steps at rtol 5e-4 /
    atol 1e-6 (eps 1e-2 keeps the update near-linear in the clipped
    gradient). The norm that counts each replicated leaf once a rank (4
    times) must miss the norm's limit."""
    run = tp_runs(4)[0]["stage1"][0]
    one, tp = run["one"], run["tp"]
    for i in range(2):
        assert one["steps"][i]["grad_norm"] > 100 * STAGE1_VARIANTS[0]["max_grad_norm"]
        np.testing.assert_allclose(tp["steps"][i]["loss"], one["steps"][i]["loss"], rtol=1e-6)
        np.testing.assert_allclose(tp["steps"][i]["grad_norm"], one["steps"][i]["grad_norm"],
                                   rtol=1e-5)
        faulty = tp["faulty_norms"][2 * i]
        assert abs(faulty - one["steps"][i]["grad_norm"]) > 1e-5 * one["steps"][i]["grad_norm"]
    for name, p in one["state"]["params"].items():
        np.testing.assert_allclose(tp["state"]["params"][name], p, rtol=5e-4, atol=1e-6,
                                   err_msg=name)


def test_tp_stage1_8bit_adamw(tp_runs):
    """The stage-1 step at model 4 with the 8-bit AdamW (stage 1's default),
    which steps each sharded leaf whole (its blocks are the whole leaf's),
    against the same two steps on one process: the loss at 1e-6, the grad
    norm at 1e-5; the int8 moments' codes at most 1e-3 of them apart, each
    by two steps at most (a gradient that differs in its last bits can round
    a code the other way, and the first step's code carries into the
    second's); the masters at rtol 5e-4 / atol 1e-6 but
    for at most 1e-3 of the elements (where a moment's code went the other
    way), every element within the two steps' largest move (each Adam
    update moves an element by about the learning rate at most)."""
    run = tp_runs(4)[0]["stage1"][1]
    one, tp = run["one"], run["tp"]
    for i in range(2):
        np.testing.assert_allclose(tp["steps"][i]["loss"], one["steps"][i]["loss"], rtol=1e-6)
        np.testing.assert_allclose(tp["steps"][i]["grad_norm"], one["steps"][i]["grad_norm"],
                                   rtol=1e-5)
    got = torch.cat([tp["state"]["params"][k].flatten() for k in one["state"]["params"]])
    want = torch.cat([p.flatten() for p in one["state"]["params"].values()])
    diff = (got - want).abs()
    assert float(diff.max()) <= 2 * STAGE1_VARIANTS[1]["learning_rate"]
    assert float((diff > 1e-6 + 5e-4 * want.abs()).float().mean()) <= 1e-3
    q_one, q_tp = one["state"]["opt_state"]["q8"], tp["state"]["opt_state"]["q8"]
    assert q_one["rows"] == q_tp["rows"]
    for store in ("mu_q", "nu_q"):
        diff = (q_tp[store].int() - q_one[store].int()).abs()
        assert int(diff.max()) <= 2 and float((diff > 0).float().mean()) <= 1e-3, store
