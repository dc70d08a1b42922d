"""The port's stage 1 against hallo_tpu's, on the CPU in fp32: the
`FaceMaskDataset` copy, `stage1_trainable`, the stage-1 loss, gradients and
one AdamW update, the 8-bit AdamW (`train/adam8bit.py`) against
hallo_tpu/train/adam8bit.py, and the stage-1 trainer with its resume,
validation still and exports, read back by stage 2.

The step runs at the tiny widths in 2D (`use_motion_module=False,
use_audio_module=False`), 64x64, batch 2, with EVERY leaf perturbed
(tests/test_torch_train.py's `perturb_all`: the zero-initialised face
locator conv_out, and image_proj's bias) and the batch's "noise" and
"timesteps" given, the dropout forced off (`uncond_ratio` 0). The JAX step
is compiled once per module. The ReferenceNet's layers after its last
harvested feature reach no output of the loss: their gradients are zero on
both sides (`jax.grad`'s zeros; the port fills them in).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hallo_tpu.data import datasets as jax_datasets
from hallo_tpu.train import adam8bit as jax_adam8bit
from hallo_tpu.train import state as jax_state
from hallo_tpu.train import step as jax_step_mod
from hallo_tpu.utils.factory import build_models as jax_build_models
from hallo_tpu_torch import config as tconfig
from hallo_tpu_torch.convert.from_jax import load_jax_params
from hallo_tpu_torch.data import datasets as tdatasets
from hallo_tpu_torch.train import adam8bit
from hallo_tpu_torch.train import state as tstate
from hallo_tpu_torch.train import step as tstep
from hallo_tpu_torch.train.stage1 import train_stage1_process
from hallo_tpu_torch.train.stage2 import train_stage2_process
from hallo_tpu_torch.utils.factory import build_models

from tests.test_torch_train import (
    CapturingAdamW, _trainer_cfg, _write_dataset, at_path, capture_grads, jax_path,
    perturb_all, rel_l2, to_jax_layout)

H = W = 64
B = 2
LR = 1e-3
EPS = 1e-6  # tests/test_torch_train.py's EPS, for the same reason
STAGE1_2D = dict(use_motion_module=False, use_audio_module=False)
NO_DROPOUT = dict(uncond_img_ratio=0.0, uncond_audio_ratio=0.0, uncond_ia_ratio=0.0,
                  start_ratio=0.0)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for the port's CPU runs (the suite runs beside
    other workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def make_batch(seed=0):
    rng = np.random.default_rng(seed)
    hl = H // 8
    return dict(
        pixel_values=rng.uniform(-1, 1, (B, 1, H, W, 3)).astype(np.float32),
        ref_pixels=rng.uniform(-1, 1, (B, H, W, 3)).astype(np.float32),
        face_emb=rng.normal(size=(B, 16)).astype(np.float32),
        face_region=rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32),
        noise=rng.normal(size=(B, 1, hl, hl, 4)).astype(np.float32),
        timesteps=np.array([999, 321], np.int32),
    )


@pytest.fixture(scope="module")
def jax_run():
    """One JAX stage-1 step (one compile) from the perturbed tiny 2D params,
    without warm-up, so that it updates."""
    jm = jax_build_models("tiny", init_key=jax.random.PRNGKey(0), height=H, width=W,
                          clip_length=1, n_motion_frames=0, unet_overrides=STAGE1_2D)
    params = {k: perturb_all(v, seed=i) for i, (k, v) in enumerate(sorted(jm.params.items()))}
    labels = jax_state.label_params(params, jax_state.stage1_trainable)
    tx = capture_grads(jax_state.make_optimizer(
        jax_state.OptimizerConfig(learning_rate=LR, eps=EPS), labels))
    step = jax.jit(jax_step_mod.make_train_step(
        jm, tx, jax_step_mod.TrainConfig(stage=1, **NO_DROPOUT)))
    batch = make_batch()
    s0 = jax_state.TrainState.create(params, tx)
    s1, m1 = step(s0, batch, jax.random.PRNGKey(0))
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return dict(params=to_np(params), labels=labels, grads=to_np(s1.opt_state[0]),
                params1=to_np(s1.params), m1={k: float(v) for k, v in m1.items()},
                batch=batch)


def port_setup(params):
    pm = build_models("tiny", device="cpu", unet_overrides=STAGE1_2D)
    load_jax_params(pm, params)
    trainable = tstate.unfreeze(pm.modules(), tstate.stage1_trainable)
    opt = CapturingAdamW(tstate.OptimizerConfig(learning_rate=LR, eps=EPS))
    state = tstate.TrainState.create(trainable, opt)
    step = tstep.make_train_step(pm, trainable, opt, tstep.TrainConfig(stage=1, **NO_DROPOUT))
    return pm, trainable, opt, state, step


def test_stage1_trainable_matches_jax_labels(jax_run):
    """The same leaves train: the ReferenceNet, the 2D denoiser, the face
    locator and the image projection; the VAE and audio projection not."""
    pm, trainable, *_ = port_setup(jax_run["params"])
    labels = jax.tree_util.tree_flatten_with_path(jax_run["labels"])[0]
    want = {tuple(getattr(k, "key", str(k)) for k in path)
            for path, label in labels if label == "train"}
    assert {jax_path(n)[0] for n in trainable} == want
    assert {n.split(".", 1)[0] for n in trainable} == {
        "reference_net", "denoising_net", "face_locator", "image_proj"}
    for name, module in pm.modules().items():
        frozen = name in ("vae", "audio_proj")
        assert all(p.requires_grad != frozen for p in module.parameters()), name


def test_stage1_step_matches_jax(jax_run):
    """Loss (rel 1e-5), every trainable gradient (relative L2 1e-4; the
    ones zero on the JAX side exactly zero on the port's, the others
    non-zero on both: the ReferenceNet's features get their gradient through
    the denoiser's K/V concat), and one AdamW update (relative L2 1e-3 per
    leaf, tests/test_torch_train.py's limit and reason); the frozen leaves
    stay bitwise as they were."""
    pm, trainable, opt, state, step = port_setup(jax_run["params"])
    frozen = {f"{top}.{k}": v.detach().clone() for top, mod in pm.modules().items()
              for k, v in mod.named_parameters() if not v.requires_grad}
    masters0 = {k: v.clone() for k, v in state.params.items()}
    state, m1 = step(state, jax_run["batch"], tstep.step_generator(0, 0, "cpu"))
    assert m1["skipped"] == 0.0
    np.testing.assert_allclose(m1["loss"], jax_run["m1"]["loss"], rtol=1e-5)
    zero = 0
    for name, g in opt.grads.items():
        path, transform = jax_path(name)
        want = at_path(jax_run["grads"], path)
        got = to_jax_layout(g, transform)
        if not np.any(want):
            zero += 1
            assert name.startswith("reference_net.") and not np.any(got), name
            continue
        assert np.linalg.norm(got) > 0, name
        assert rel_l2(got, want) <= 1e-4, (name, rel_l2(got, want))
    # the unused tail is a small part; the ReferenceNet's attention layers
    # that produce features do get gradients
    assert 0 < zero < 30
    assert any(name.startswith("reference_net.down_blocks.0.attentions") and
               opt.grads[name].abs().max() > 0 for name in opt.grads)
    for name, p in state.params.items():
        path, transform = jax_path(name)
        got = to_jax_layout(p - masters0[name], transform)
        want = at_path(jax_run["params1"], path) - at_path(jax_run["params"], path)
        assert rel_l2(got, want) <= 1e-3, (name, rel_l2(got, want))
        assert torch.equal(trainable[name].detach(), p), name
    for top, mod in pm.modules().items():
        for k, v in mod.named_parameters():
            if not v.requires_grad:
                assert torch.equal(v, frozen[f"{top}.{k}"]), (top, k)


def test_face_mask_dataset_matches_jax_item_for_item(tmp_path):
    """The same target and reference frames, item for item and batch for
    batch (the same `random.Random` draws in the same order), including a
    clip shorter than the margin."""
    meta = _write_dataset(str(tmp_path), n_clips=3, t=12)
    for margin in (4, 30):
        ours = tdatasets.FaceMaskDataset([meta], sample_margin=margin, seed=3)
        theirs = jax_datasets.FaceMaskDataset([meta], img_size=H, sample_margin=margin, seed=3)
        for i in (0, 1, 2, 2, 0):
            a, b = ours[i], theirs[i]
            assert a.keys() == b.keys()
            for key in a:
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        it_a = tdatasets.batch_iterator(ours, 2, seed=5)
        it_b = jax_datasets.batch_iterator(theirs, 2, seed=5, prefetch=False)
        for _ in range(3):
            a, b = next(it_a), next(it_b)
            for key in a:
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        assert a["pixel_values"].shape == (2, 1, H, W, 3)


def _moments(shapes, seed):
    rng = np.random.default_rng(seed)
    out = {k: (rng.normal(size=s) * 10.0 ** rng.uniform(-6, 0, size=s)).astype(np.float32)
           for k, s in shapes.items()}
    out["d"][256:512] = 0  # an all-zero block: log max -inf, codes 0
    return out


def test_8bit_quantisers_match_jax():
    """`quantize` / `quantize_log` and their dequantisers against JAX's on
    leaves with ragged last blocks, an all-zero block and a small (fp32)
    leaf: the codes equal, the scales within 1e-6 (relative; exactly equal
    here)."""
    x = _moments({"a": (33, 40), "b": (7,), "c": (3, 300), "d": (1000,)}, 0)
    for name, value in x.items():
        for ours, theirs, deq, jdeq, v in (
                (adam8bit.quantize, jax_adam8bit._quantize, adam8bit.dequantize,
                 jax_adam8bit._dequantize, value),
                (adam8bit.quantize_log, jax_adam8bit._quantize_log, adam8bit.dequantize_log,
                 jax_adam8bit._dequantize_log, np.abs(value))):
            got, want = ours(torch.from_numpy(v)), theirs(jnp.asarray(v), 256)
            if name == "b":
                assert got.q.dtype == torch.float32
                np.testing.assert_array_equal(got.q.numpy(), v)
                continue
            assert got.q.dtype == torch.int8 and got.q.shape == v.shape
            np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
            np.testing.assert_allclose(got.scales.numpy(), np.asarray(want.scales), rtol=1e-6)
            np.testing.assert_allclose(deq(got).numpy(),
                                       np.asarray(jdeq(want, v.shape, 256)), rtol=1e-6)


def test_8bit_adamw_updates_match_jax():
    """`AdamW8bit` against `adamw_8bit` (inside make_optimizer's clip) over
    three updates: each leaf's int8 codes equal JAX's and its scales within
    1e-6 relative; the parameters within 2e-5 relative L2 of the update
    (the fp32 small leaf takes the fp32 path: XLA's sqrt and the division by
    the bias correction round differently)."""
    shapes = {"a": (33, 40), "b": (7,), "c": (3, 300), "d": (1000,)}
    params = _moments(shapes, 1)
    cfg = dict(learning_rate=1e-2, weight_decay=1e-2, max_grad_norm=1e9, use_8bit_adam=True)
    tx = jax_state.make_optimizer(jax_state.OptimizerConfig(**cfg), {k: "train" for k in shapes})
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = tx.init(jp)
    opt = tstate.make_optimizer(tstate.OptimizerConfig(**cfg))
    assert isinstance(opt, adam8bit.AdamW8bit)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = opt.init(tp)
    for it in range(3):
        g = _moments(shapes, 10 + it)
        upd, js = tx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, upd)
        opt.update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp)
        inner = js.inner_states["train"].inner_state[1][0]  # clip, then the 8-bit chain
        for name in shapes:
            moved = np.asarray(jp[name]) - params[name]
            assert rel_l2(tp[name].numpy() - params[name], moved) <= 2e-5, (it, name)
            if name == "b":
                continue
            mu, nu = opt.leaf_moments(ts, name)
            for got, want in ((mu, inner.mu[name]), (nu, inner.nu[name])):
                np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
                np.testing.assert_allclose(got.scales.numpy(), np.asarray(want.scales),
                                           rtol=1e-6)
    assert ts["count"] == 3 and ts["q8"]["mu_q"].dtype == torch.int8


def test_8bit_trajectory_tracks_fp32_adamw():
    """tests/test_adam8bit.py's quadratic on the port: the 8-bit run tracks
    the fp32 AdamW while descending and reaches the same optimum."""
    rng = np.random.default_rng(1)
    target = torch.from_numpy(rng.normal(size=(512,)).astype(np.float32))

    def loss(p):
        return ((p["w"] - target) ** 2).sum() + (p["b"] ** 2).sum()

    def run(use_8bit, steps=60):
        opt = tstate.make_optimizer(tstate.OptimizerConfig(
            learning_rate=0.05, weight_decay=1e-3, max_grad_norm=1e9, use_8bit_adam=use_8bit))
        p = {"w": torch.zeros(512), "b": torch.zeros(4)}
        s, mid = opt.init(p), None
        for i in range(steps):
            q = {k: v.clone().requires_grad_() for k, v in p.items()}
            g = dict(zip(q, torch.autograd.grad(loss(q), list(q.values()))))
            opt.update(g, s, p)
            if i == 9:
                mid = {k: v.clone() for k, v in p.items()}
        return p, mid

    p_ref, mid_ref = run(False)
    p_8, mid_8 = run(True)
    err = (mid_8["w"] - mid_ref["w"]).abs()
    assert err.mean() < 0.02 and err.max() < 0.12, (err.mean(), err.max())
    p0 = {"w": torch.zeros(512), "b": torch.zeros(4)}
    assert loss(p_8) < 0.01 * loss(p0)
    assert loss(p_8) < 2.0 * loss(p_ref) + 1e-3


def _stage1_cfg(root, meta, exp_name, max_steps, use_8bit=True):
    return tconfig.DotDict.wrap(dict(
        exp_name=exp_name, output_dir=os.path.join(root, "exp"), seed=0, aux_scale="tiny",
        log_every=1,
        data=dict(train_bs=2, train_width=H, train_height=H, meta_paths=[meta],
                  sample_margin=3),
        solver=dict(learning_rate=LR, max_train_steps=max_steps, max_grad_norm=1.0,
                    gradient_checkpointing=False, mixed_precision="no", lr_warmup_steps=1,
                    use_8bit_adam=use_8bit),
        val=dict(validation_steps=2, num_inference_steps=2),
        uncond_ratio=0.1, noise_offset=0.05, snr_gamma=5.0,
        unet_additional_kwargs=dict(
            block_out_channels=[8, 16, 16, 16], layers_per_block=1, num_attention_heads=2,
            cross_attention_dim=12, norm_num_groups=4, audio_attention_dim=6),
        base_model_path=os.path.join(root, "nonexistent"),
        vae_model_path=os.path.join(root, "nonexistent"),
        checkpointing_steps=2, resume_from_checkpoint="latest",
    ))


def test_stage1_trainer_resumes_bitwise_and_hands_off_to_stage2(tmp_path):
    """`train_stage1_process` on the CPU with the 8-bit AdamW: 2 steps write
    checkpoint-2 (int8 moments), a validation still and the four exports;
    resuming for 2 more gives bitwise the masters of 4 straight steps. The
    exports hold the masters; `train_stage2_process` with `stage1_ckpt_dir`
    loads them (its frozen spatial weights in final_net/ equal the export
    bit for bit; the denoiser's motion and audio modules keep their
    initialisation) and takes a finite step."""
    import cv2

    root = str(tmp_path)
    meta = _write_dataset(root, n_clips=2, t=8)
    exp = os.path.join(root, "exp", "resumed")
    train_stage1_process(_stage1_cfg(root, meta, "resumed", 2), device="cpu")
    sd = torch.load(os.path.join(exp, "checkpoint-2", "train_state.pt"), weights_only=False)
    assert sd["opt_state"]["q8"]["mu_q"].dtype == torch.int8
    png = os.path.join(exp, "validation", "step2_sample0.png")
    img = cv2.imread(png)
    assert img.shape == (H, W, 3) and img.std() > 0
    resumed = train_stage1_process(_stage1_cfg(root, meta, "resumed", 4), device="cpu")
    straight = train_stage1_process(_stage1_cfg(root, meta, "straight", 4), device="cpu")
    lines = [json.loads(line) for line in open(os.path.join(exp, "metrics.jsonl"))]
    assert [r["step"] for r in lines] == [0, 1, 2, 3]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in lines)
    assert resumed.step == straight.step == 4
    assert resumed.params.keys() == straight.params.keys()
    for name, p in straight.params.items():
        assert torch.equal(resumed.params[name], p), name
    assert sorted(os.listdir(os.path.join(exp, "validation"))) == [
        f"step{s}_sample{i}.png" for s in (2, 4) for i in (0, 1)]
    exports = {}
    for name in ("reference_net", "denoising_net", "face_locator", "image_proj"):
        exports[name] = torch.load(os.path.join(exp, f"final_{name}", f"{name}.pt"))
        for key, value in exports[name].items():
            if f"{name}.{key}" in resumed.params:
                assert torch.equal(value, resumed.params[f"{name}.{key}"]), (name, key)

    cfg2 = _trainer_cfg(root, meta, "stage2", 1)  # the clips hold stage 2's keys too
    cfg2["stage1_ckpt_dir"] = exp
    assert train_stage2_process(cfg2, device="cpu").step == 1
    line = json.loads(open(os.path.join(root, "exp", "stage2", "metrics.jsonl")).readline())
    assert np.isfinite(line["loss"]) and np.isfinite(line["grad_norm"])
    final = os.path.join(root, "exp", "stage2", "final_net")
    for name, export in exports.items():
        got = torch.load(os.path.join(final, f"{name}.pt"))
        for key, value in export.items():
            assert torch.equal(got[key], value), (name, key)
        if name == "denoising_net":
            assert any("motion_modules" in k for k in set(got) - set(export))
