"""The port's stage-2 training against hallo_tpu's, on the CPU in fp32.

The step runs at the tiny widths (`TINY_UNET_KW`), 64x64, 4 frames + 2
motion frames, batch 2. The JAX trees come from `build_models("tiny")` with
EVERY leaf perturbed (zero-initialised layers, the motion modules' proj_out
and the audio zero_convs, would otherwise zero the gradient of everything
before them) and are bridged with `convert.from_jax`. The JAX step is
compiled once per module (`jax_step`); it reads its gradients through an
optax wrapper that keeps them in the optimizer state.

The trainer (`hallo_tpu_torch.train.stage2`) runs on the port alone, on a
synthetic .npz dataset in `data/datasets.py`'s format.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hallo_tpu import config as jax_config
from hallo_tpu.data import datasets as jax_datasets
from hallo_tpu.diffusion import ddim as jax_ddim
from hallo_tpu.train import state as jax_state
from hallo_tpu.train import step as jax_step_mod
from hallo_tpu.utils.factory import build_models as jax_build_models
from hallo_tpu_torch import config as tconfig
from hallo_tpu_torch.convert.from_jax import MAPPERS, load_jax_params
from hallo_tpu_torch.data import datasets as tdatasets
from hallo_tpu_torch.diffusion import ddim as tddim
from hallo_tpu_torch.diffusion import schedule
from hallo_tpu_torch.train import state as tstate
from hallo_tpu_torch.train import step as tstep
from hallo_tpu_torch.train.stage2 import train_stage2_process
from hallo_tpu_torch.utils.factory import build_models

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H = W = 64
F, M, B = 4, 2, 2
LR = 1e-3  # large enough that an update is far above the fp32 rounding of p + u
# Adam's eps for the parity run, on both sides. At the default 1e-8, an
# element whose gradient is ~1e-9 (at the rounding floor of its leaf) gets
# u = g / (|g| + eps), so a 4e-10 difference between the two packages'
# gradients moved one update element by 15% (relative L2 2.4e-3 of its
# leaf, against 1e-3). At 1e-6 such elements barely move; every other
# element still takes Adam's full arithmetic.
EPS = 1e-6
NO_DROPOUT = dict(uncond_img_ratio=0.0, uncond_audio_ratio=0.0, uncond_ia_ratio=0.0,
                  start_ratio=0.0)


def perturb_all(tree, seed=0):
    """Every bias -> N(0, 0.5); every norm scale -> 1 + N(0, 0.2); every
    other leaf + N(0, 0.02), so that no layer is zero."""
    rng = np.random.default_rng(seed)

    def f(path, leaf):
        name = getattr(path[-1], "key", "")
        if name == "bias":
            return jnp.asarray(rng.normal(0, 0.5, leaf.shape).astype(np.float32))
        if name == "scale":
            return jnp.asarray(1 + rng.normal(0, 0.2, leaf.shape).astype(np.float32))
        return leaf + jnp.asarray(rng.normal(0, 0.02, leaf.shape).astype(np.float32))

    return jax.tree_util.tree_map_with_path(f, tree)


def make_batch(seed=0):
    rng = np.random.default_rng(seed)
    hl = H // 8
    return dict(
        pixel_values=rng.uniform(-1, 1, (B, F, H, W, 3)).astype(np.float32),
        ref_pixels=rng.uniform(-1, 1, (B, H, W, 3)).astype(np.float32),
        motion_pixels=rng.uniform(-1, 1, (B, M, H, W, 3)).astype(np.float32),
        audio_windows=rng.normal(size=(B, F, 3, 2, 4)).astype(np.float32),
        face_emb=rng.normal(size=(B, 16)).astype(np.float32),
        face_region=rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32),
        masks=tuple(
            tuple((rng.uniform(size=(B, (hl >> d) ** 2)) > 0.3).astype(np.float32)
                  for _ in range(3))
            for d in range(4)
        ),
        noise=rng.normal(size=(B, F, hl, hl, 4)).astype(np.float32),
        # t = 999 is the zero-SNR end of the schedule: the Min-SNR weight
        # must stay finite there
        timesteps=np.array([999, 321], np.int32),
    )


def capture_grads(inner):
    """An optax transformation that runs `inner` and keeps the gradients it
    was given in its state."""
    def init(params):
        return (jax.tree.map(jnp.zeros_like, params), inner.init(params))

    def update(grads, state, params=None):
        updates, inner_state = inner.update(grads, state[1], params)
        return updates, (grads, inner_state)

    return optax.GradientTransformation(init, update)


@pytest.fixture(scope="module")
def jax_run():
    """Two JAX steps (one compile) from the perturbed tiny params."""
    jm = jax_build_models("tiny", init_key=jax.random.PRNGKey(0), height=H, width=W,
                          clip_length=F, n_motion_frames=M)
    params = {k: perturb_all(v, seed=i) for i, (k, v) in enumerate(sorted(jm.params.items()))}
    labels = jax_state.label_params(params, jax_state.stage2_trainable)
    tx = capture_grads(jax_state.make_optimizer(
        jax_state.OptimizerConfig(learning_rate=LR, eps=EPS, lr_warmup_steps=1), labels))
    step = jax.jit(jax_step_mod.make_train_step(
        jm, tx, jax_step_mod.TrainConfig(stage=2, **NO_DROPOUT)))
    batch = make_batch()
    s0 = jax_state.TrainState.create(params, tx)
    s1, m1 = step(s0, batch, jax.random.PRNGKey(0))
    s2, m2 = step(s1, batch, jax.random.PRNGKey(1))
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return dict(params=to_np(params), labels=labels, grads=to_np(s1.opt_state[0]),
                params2=to_np(s2.params), m1={k: float(v) for k, v in m1.items()},
                m2={k: float(v) for k, v in m2.items()}, batch=batch)


class CapturingAdamW(tstate.AdamW):
    """The port's optimizer, keeping a copy of the last gradients it got."""

    def update(self, grads, state, params):
        self.grads = {k: g.detach().clone() for k, g in grads.items()}
        super().update(grads, state, params)


def port_setup(params, remat=False, opt_cls=CapturingAdamW, **train_kw):
    pm = build_models("tiny", device="cpu", remat=remat)
    load_jax_params(pm, params)
    trainable = tstate.unfreeze(pm.modules(), tstate.stage2_trainable)
    opt = opt_cls(tstate.OptimizerConfig(learning_rate=LR, eps=EPS, lr_warmup_steps=1))
    state = tstate.TrainState.create(trainable, opt)
    step = tstep.make_train_step(pm, trainable, opt, tstep.TrainConfig(**train_kw))
    return pm, trainable, opt, state, step


def jax_path(name: str):
    """A port parameter "module.key" -> (JAX tree path, layout transform)."""
    top, key = name.split(".", 1)
    path, transform = MAPPERS[top](key)
    return (top, "params") + tuple(path), transform


def at_path(tree, path):
    for part in path:
        tree = tree[part]
    return tree


def to_jax_layout(x: torch.Tensor, transform) -> np.ndarray:
    a = x.detach().numpy()
    return a if transform is None else transform(a)


def rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def one_token_self_attention(name: str) -> bool:
    """The mid block's audio-module self-attention runs over one token at
    64x64 (a 1x1 latent): softmax over one key is 1 whatever q and k are, so
    the gradients of to_q and to_k are zero on both sides by construction."""
    return "mid_block.audio_modules" in name and name.endswith(
        ("attn1.to_q.weight", "attn1.to_k.weight"))


def test_stage2_step_matches_jax(jax_run):
    """Loss (rel 1e-5), every trainable gradient (relative L2 1e-4, fp32
    summation order; each non-zero on both sides but the two that are zero
    by construction, `one_token_self_attention`), the trainable grad norm,
    the updates after two AdamW steps with a one-step warm-up (relative L2
    1e-3 per leaf: Adam divides by sqrt(v), so elements with near-zero
    gradients amplify rounding), and every frozen leaf bitwise unchanged."""
    pm, trainable, opt, state, step = port_setup(jax_run["params"], **NO_DROPOUT)
    frozen = {f"{top}.{k}": v.detach().clone() for top, mod in pm.modules().items()
              for k, v in mod.named_parameters() if not v.requires_grad}
    masters0 = {k: v.clone() for k, v in state.params.items()}

    gen = tstep.step_generator(0, 0, "cpu")
    state, m1 = step(state, jax_run["batch"], gen)
    grads1 = opt.grads
    assert m1["skipped"] == 0.0
    np.testing.assert_allclose(m1["loss"], jax_run["m1"]["loss"], rtol=1e-5)

    # the trainable sets are the same leaves
    labels = jax.tree_util.tree_flatten_with_path(jax_run["labels"])[0]
    jax_trainable = {tuple(getattr(k, "key", str(k)) for k in path)
                     for path, label in labels if label == "train"}
    assert {jax_path(n)[0] for n in trainable} == jax_trainable

    sq = 0.0
    for name, g in grads1.items():
        path, transform = jax_path(name)
        want = at_path(jax_run["grads"], path)
        got = to_jax_layout(g, transform)
        sq += float(np.sum(np.square(want.astype(np.float64))))
        if one_token_self_attention(name):
            assert np.abs(got).max() <= 1e-6 and np.abs(want).max() <= 1e-6, name
            continue
        assert np.linalg.norm(got) > 0 and np.linalg.norm(want) > 0, name
        assert rel_l2(got, want) <= 1e-4, (name, rel_l2(got, want))
    # grad_norm: the trainable gradients' norm (JAX's metric also counts the
    # frozen denoiser weights' gradients, which the port never computes)
    np.testing.assert_allclose(m1["grad_norm"], np.sqrt(sq), rtol=1e-5)
    assert m1["grad_norm"] < jax_run["m1"]["grad_norm"]

    # warm-up from 0: the first update moves no weight
    for name, p in state.params.items():
        assert torch.equal(p, masters0[name]), name
    state, m2 = step(state, jax_run["batch"], tstep.step_generator(0, 1, "cpu"))
    np.testing.assert_allclose(m2["loss"], jax_run["m2"]["loss"], rtol=1e-5)
    assert state.step == 2 and state.opt_state["count"] == 2
    for name, p in state.params.items():
        path, transform = jax_path(name)
        got = to_jax_layout(p - masters0[name], transform)
        want = at_path(jax_run["params2"], path) - at_path(jax_run["params"], path)
        assert rel_l2(got, want) <= 1e-3, (name, rel_l2(got, want))
        # the model holds the masters after the step
        assert torch.equal(trainable[name].detach(), p), name
    for top, mod in pm.modules().items():
        for k, v in mod.named_parameters():
            if not v.requires_grad:
                assert torch.equal(v, frozen[f"{top}.{k}"]), (top, k)


def test_nan_guard_keeps_state_bitwise(jax_run):
    """A planted inf in the batch: the masters, the moments, the step count
    of the optimizer and the model's parameters stay bitwise as they were;
    `skipped` is 1 and the train step still counts."""
    pm, trainable, opt, state, step = port_setup(jax_run["params"], **NO_DROPOUT)
    state, _ = step(state, jax_run["batch"], tstep.step_generator(0, 0, "cpu"))
    state, _ = step(state, jax_run["batch"], tstep.step_generator(0, 1, "cpu"))
    before = dict(
        params={k: v.clone() for k, v in state.params.items()},
        mu={k: v.clone() for k, v in state.opt_state["mu"].items()},
        nu={k: v.clone() for k, v in state.opt_state["nu"].items()},
        model={k: v.detach().clone() for k, v in trainable.items()},
    )
    poisoned = dict(jax_run["batch"])
    poisoned["pixel_values"] = poisoned["pixel_values"].copy()
    poisoned["pixel_values"][0, 0, 0, 0, 0] = np.inf
    state, m = step(state, poisoned, tstep.step_generator(0, 2, "cpu"))
    assert m["skipped"] == 1.0 and not np.isfinite(m["loss"])
    assert state.step == 3 and state.opt_state["count"] == 2
    for key, table in (("params", state.params), ("mu", state.opt_state["mu"]),
                       ("nu", state.opt_state["nu"]),
                       ("model", {k: v.detach() for k, v in trainable.items()})):
        for name, v in table.items():
            assert torch.equal(v, before[key][name]), (key, name)


def test_remat_gives_the_same_gradients(jax_run):
    """Per-block checkpointing (`remat`) recomputes each denoiser block in
    the backward: the gradients equal the plain backward's to 1e-6."""
    grads = []
    for remat in (False, True):
        pm, trainable, opt, state, step = port_setup(jax_run["params"], remat=remat,
                                                     **NO_DROPOUT)
        assert pm.denoising_net.config.remat is remat
        step(state, jax_run["batch"], tstep.step_generator(0, 0, "cpu"))
        grads.append(opt.grads)
    for name, g in grads[0].items():
        torch.testing.assert_close(grads[1][name], g, atol=1e-6, rtol=1e-6)


def test_dropout_decisions_match_jax():
    """One uniform draw decides the image, audio and joint dropouts and
    another the zero-motion start (hallo_tpu/train/step.py:147-153): the
    port's decisions against the JAX step's expressions on the same u,
    including the ratio boundaries, at stage2.yaml's ratios and others."""
    for ratios in ((0.05, 0.05, 0.05, 0.05), (0.1, 0.2, 0.3, 0.5)):
        p_i, p_a, p_ia, p_s = ratios
        cfg = tstep.TrainConfig(uncond_img_ratio=p_i, uncond_audio_ratio=p_a,
                                uncond_ia_ratio=p_ia, start_ratio=p_s)
        edges = [p_i, p_i + p_a, 1.0 - p_ia, p_s]
        us = np.concatenate([np.linspace(0, 0.9999, 97),
                             np.nextafter(np.float32(edges), np.float32(0)),
                             np.float32(edges)]).astype(np.float32)
        for u in us:
            uj = jnp.float32(u)
            drop_img = jnp.logical_or(uj < p_i, uj >= 1.0 - p_ia)
            drop_audio = jnp.logical_or(jnp.logical_and(uj >= p_i, uj < p_i + p_a),
                                        uj >= 1.0 - p_ia)
            want = (bool(drop_img), bool(drop_audio), bool(uj < p_s))
            ut = torch.tensor(u, dtype=torch.float32)
            got = tuple(bool(x) for x in tstep.dropout_decisions(ut, ut, cfg))
            assert got == want, (ratios, u)


def test_diffusion_train_helpers_match_jax():
    """add_noise, get_velocity, compute_snr and the Min-SNR weights on the
    train schedule (scaled_linear, zero-SNR), t up to the zero-SNR 999."""
    sched = tstep.TrainConfig().scheduler
    alphas = schedule.alphas_cumprod(sched)
    rng = np.random.default_rng(0)
    x, n = rng.normal(size=(2, 3, 4, 5, 5)).astype(np.float32), rng.normal(
        size=(2, 3, 4, 5, 5)).astype(np.float32)
    t = np.array([999, 17])
    ja = jnp.asarray(alphas)
    tt = torch.from_numpy(t)
    for ours, theirs in ((tddim.add_noise, jax_ddim.add_noise),
                         (tddim.get_velocity, jax_ddim.get_velocity)):
        got = ours(alphas, torch.from_numpy(x), torch.from_numpy(n), tt)
        want = theirs(ja, jnp.asarray(x), jnp.asarray(n), jnp.asarray(t)[:, None, None, None, None])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_allclose(tddim.compute_snr(alphas, tt).numpy(),
                               np.asarray(jax_ddim.compute_snr(ja, jnp.asarray(t))), rtol=1e-6)
    got = tstep._min_snr_weights(alphas, tt, 5.0, "v_prediction")
    want = jax_step_mod._min_snr_weights(ja, jnp.asarray(t), 5.0, "v_prediction")
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_adamw_matches_optax_with_clip_and_accumulation():
    """`AdamW` against optax's MultiSteps(chain(clip_by_global_norm, adamw))
    with a 2-step warm-up and k = 2 accumulation, on gradients large enough
    to clip: 6 calls, 3 updates. fp32 both sides: rtol 1e-5."""
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 2)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (3.0 * rng.normal(size=s)).astype(np.float32) for k, s in shapes.items()}
             for _ in range(6)]
    cfg = dict(learning_rate=0.05, lr_warmup_steps=2, gradient_accumulation_steps=2)
    tx = jax_state.make_optimizer(jax_state.OptimizerConfig(**cfg),
                                  {k: "train" for k in shapes})
    jp, js = {k: jnp.asarray(v) for k, v in params.items()}, None
    js = tx.init(jp)
    opt = tstate.AdamW(tstate.OptimizerConfig(**cfg))
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = opt.init(tp)
    for g in grads:
        upd, js = tx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, upd)
        opt.update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp)
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-5, atol=1e-7)
    assert ts["count"] == 3 and ts["gradient_step"] == 3


def _write_dataset(root, n_clips=2, t=16, h=64):
    """The port's copy of tests/test_trainer_e2e.py's synthetic clips."""
    rng = np.random.default_rng(0)
    meta = []
    for i in range(n_clips):
        data = dict(
            frames=rng.uniform(0, 255, (t, h, h, 3)).astype(np.uint8),
            audio_emb=rng.normal(size=(t, 2, 4)).astype(np.float32),
            face_emb=rng.normal(size=(16,)).astype(np.float32),
            face_region=np.ones((h, h, 3), np.float32),
        )
        for level, div in enumerate((1, 2, 4, 8)):
            size = h // 8 // div
            for kind in ("full", "face", "lip"):
                data[f"{kind}_mask_{level}"] = (
                    rng.uniform(size=(1, size * size)) > 0.3).astype(np.float32)
        path = os.path.join(root, f"clip{i}.npz")
        np.savez(path, **data)
        meta.append({"clip_path": path})
    meta_path = os.path.join(root, "meta.json")
    with open(meta_path, "w") as fh:
        json.dump(meta, fh)
    return meta_path


def _trainer_cfg(root, meta, exp_name, max_steps):
    return tconfig.DotDict.wrap(dict(
        exp_name=exp_name, output_dir=os.path.join(root, "exp"), seed=0, aux_scale="tiny",
        log_every=1,
        data=dict(train_bs=2, train_width=64, train_height=64, n_sample_frames=F,
                  n_motion_frames=M, audio_margin=1, meta_paths=[meta]),
        solver=dict(learning_rate=LR, max_train_steps=max_steps, max_grad_norm=1.0,
                    gradient_checkpointing=True, mixed_precision="no", lr_warmup_steps=1),
        val=dict(validation_steps=0),
        uncond_img_ratio=0.05, uncond_audio_ratio=0.05, uncond_ia_ratio=0.05,
        start_ratio=0.05, noise_offset=0.05, snr_gamma=5.0,
        unet_additional_kwargs=dict(
            use_inflated_groupnorm=True, use_motion_module=True, use_audio_module=True,
            motion_module_mid_block=True, block_out_channels=[8, 16, 16, 16],
            layers_per_block=1, num_attention_heads=2, cross_attention_dim=12,
            norm_num_groups=4, audio_attention_dim=6,
            motion_module_kwargs=dict(num_attention_heads=2, num_transformer_block=1,
                                      temporal_position_encoding_max_len=8,
                                      norm_num_groups=4)),
        base_model_path=os.path.join(root, "nonexistent"),
        vae_model_path=os.path.join(root, "nonexistent"),
        checkpointing_steps=2, resume_from_checkpoint="latest",
    ))


def test_trainer_two_steps_then_resume_is_bitwise_four_steps(tmp_path):
    """`train_stage2_process` on the CPU: 2 steps write checkpoint-2,
    metrics.jsonl (finite losses, with ts) and final_net; resuming from
    "latest" for 2 more steps gives bitwise the trainable weights of 4
    straight steps."""
    root = str(tmp_path)
    meta = _write_dataset(root)
    train_stage2_process(_trainer_cfg(root, meta, "resumed", 2), device="cpu")
    exp = os.path.join(root, "exp", "resumed")
    assert os.path.isdir(os.path.join(exp, "checkpoint-2"))
    assert os.path.isfile(os.path.join(exp, "final_net", "denoising_net.pt"))
    lines = [json.loads(line) for line in open(os.path.join(exp, "metrics.jsonl"))]
    assert [r["step"] for r in lines] == [0, 1]
    assert all(np.isfinite(r["loss"]) and "ts" in r for r in lines)

    resumed = train_stage2_process(_trainer_cfg(root, meta, "resumed", 4), device="cpu")
    straight = train_stage2_process(_trainer_cfg(root, meta, "straight", 4), device="cpu")
    lines = [json.loads(line) for line in open(os.path.join(exp, "metrics.jsonl"))]
    assert [r["step"] for r in lines] == [0, 1, 2, 3]
    assert resumed.step == straight.step == 4
    assert resumed.params.keys() == straight.params.keys()
    for name, p in straight.params.items():
        assert torch.equal(resumed.params[name], p), name
    assert os.path.isdir(os.path.join(exp, "checkpoint-4"))


@pytest.mark.parametrize("case", ["pretrained", "stage1_ckpt_dir", "use_8bit_adam",
                                  "validation"])
def test_trainer_takes_what_stage2_yaml_can_ask_for(tmp_path, case):
    """One step of `train_stage2_process` with each of what it once refused:
    pretrained files that exist (SD-1.5, the VAE, AnimateDiff in the
    reference layout, tests/test_torch_load_pretrained.py's tiny files),
    a stage-1 export directory, the 8-bit AdamW, a validation render. The
    frozen weights in final_net/ are the files' bit for bit (the step's
    one-step warm-up moves no trainable weight either)."""
    from hallo_tpu_torch.utils.checkpoint import save_params
    from hallo_tpu_torch.utils.video import read_frames

    from tests.test_torch_load_pretrained import write_layout

    root = str(tmp_path)
    meta = _write_dataset(root, n_clips=1)
    cfg = _trainer_cfg(root, meta, "x", 1)
    exp = os.path.join(root, "exp", "x")
    want = {}
    if case == "pretrained":
        paths, written = write_layout(os.path.join(root, "pm"), build_models("tiny", device="cpu"))
        cfg.update(base_model_path=paths["base"], vae_model_path=paths["vae"],
                   mm_path=paths["motion"])
        want = {"reference_net": written["sd15"],
                "denoising_net": {k: written["sd15"][k] for k in ("conv_in.weight",
                                                                  "conv_out.bias")}}
        want["denoising_net"].update(written["mm"])
        for k in [k for k in want["denoising_net"] if k.endswith("pos_encoder.pe")]:
            del want["denoising_net"][k]  # a buffer the port recomputes
    elif case == "stage1_ckpt_dir":
        stage1 = build_models("tiny", device="cpu", seed=5, unet_overrides=dict(
            use_motion_module=False, use_audio_module=False))
        for name in ("reference_net", "denoising_net", "face_locator", "image_proj"):
            module = getattr(stage1, name)
            save_params(os.path.join(root, "s1", f"final_{name}"), {name: module})
            want[name] = module.state_dict()
        cfg["stage1_ckpt_dir"] = os.path.join(root, "s1")
    elif case == "use_8bit_adam":
        cfg.solver.use_8bit_adam = True
    else:
        cfg.val.update(validation_steps=1, num_inference_steps=1)
    state = train_stage2_process(cfg, device="cpu")
    assert state.step == 1
    line = json.loads(open(os.path.join(exp, "metrics.jsonl")).readline())
    assert np.isfinite(line["loss"]) and np.isfinite(line["grad_norm"])
    for name, tensors in want.items():
        got = torch.load(os.path.join(exp, "final_net", f"{name}.pt"))
        assert tensors and all(torch.equal(got[k], v) for k, v in tensors.items()), name
    if case == "use_8bit_adam":
        q8 = state.opt_state["q8"]
        assert q8["mu_q"].dtype == torch.int8 and q8["mu_q"].any()
        assert state.opt_state["count"] == 1 and len(q8["rows"]) > 100
    if case == "validation":
        frames = read_frames(os.path.join(exp, "validation", "step1.mp4"))
        assert len(frames) == F and frames[0].shape == (64, 64, 3)


def test_trainer_defaults_to_the_card(tmp_path):
    """The default device is the card: without one the call raises instead
    of running on the CPU."""
    meta = _write_dataset(str(tmp_path), n_clips=1)
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            train_stage2_process(_trainer_cfg(str(tmp_path), meta, "x", 1))


def test_dataset_copy_matches_jax(tmp_path):
    """The port's TalkingVideoDataset and batch_iterator give the JAX
    package's batches (synchronous reads there too) for the same seed."""
    meta = _write_dataset(str(tmp_path), n_clips=3, t=12)
    ours = tdatasets.batch_iterator(
        tdatasets.TalkingVideoDataset([meta], n_sample_frames=F, n_motion_frames=M,
                                      audio_margin=1, seed=3), 2, seed=5)
    theirs = jax_datasets.batch_iterator(
        jax_datasets.TalkingVideoDataset([meta], n_sample_frames=F, n_motion_frames=M,
                                         audio_margin=1, seed=3), 2, seed=5, prefetch=False)
    for _ in range(4):
        a, b = next(ours), next(theirs)
        assert a.keys() == b.keys()
        for key in a:
            if key == "masks":
                for lvl_a, lvl_b in zip(a[key], b[key]):
                    for x, y in zip(lvl_a, lvl_b):
                        np.testing.assert_array_equal(x, y)
            else:
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_config_copies_match_jax_on_stage2_yaml():
    """`load_config` and `unet_config_from_yaml_kwargs` give the JAX
    package's on configs/train/stage2.yaml, field by field (less the UNet
    fields the port does not implement)."""
    import dataclasses

    path = os.path.join(REPO, "configs", "train", "stage2.yaml")
    ours, theirs = tconfig.load_config(path), jax_config.load_config(path)
    assert tconfig.to_container(ours) == jax_config.to_container(theirs)
    assert ours.solver.gradient_checkpointing is True and ours.data.n_sample_frames == 14
    kw = tconfig.to_container(ours.unet_additional_kwargs)
    for extra in ({}, {"remat": True}, {"remat": True, "remat_inner": True}):
        got = dataclasses.asdict(tconfig.unet_config_from_yaml_kwargs(kw, **extra))
        want = dataclasses.asdict(jax_config.unet_config_from_yaml_kwargs(
            jax_config.to_container(theirs.unet_additional_kwargs), **extra))
        for field in ("use_linear_projection", "upcast_attention"):
            assert want.pop(field) is False
        assert got == want
