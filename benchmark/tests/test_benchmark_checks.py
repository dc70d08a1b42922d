"""The check that decides `correct`, shown to fail: each fault that a cell
can have, planted in the measured program underneath a whole run of the
harness (which skips its look for a card), and the control, the reference
in the next precision down (fp8 products, a bfloat16 sampler) in the
program's place, against each cell's limits. At the test widths on the CPU.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import inputs
from benchmark.drivers import common, infer, train

from conftest import load, load_work, tiny_cell

INFER = ["infer-exact", "infer-turbo-req4"]
SETUP_STEPS = load_work("train-stage2-b4")["check"]["steps"]


def _fault(monkeypatch, name: str, sampler: str = "ddim"):
    from hallo_tpu_torch.diffusion import ddim, unipc
    from hallo_tpu_torch.models.unet_denoise import DenoisingUNet
    from hallo_tpu_torch.models.vae import AutoencoderKL
    from hallo_tpu_torch.train import state as train_state
    from hallo_tpu_torch.train import step as train_step

    if name == "state_unchanged" and sampler == "ddim":
        monkeypatch.setattr(ddim, "ddim_step", lambda st, i, out, sample: sample)
    elif name == "state_unchanged" and sampler == "unipc":
        monkeypatch.setattr(unipc, "unipc_step", lambda st, i, out, sample, carry: (sample, carry))
    elif name == "half_batch":
        orig = DenoisingUNet.forward

        def forward(self, *a, **k):  # the uncond half left out, the cond half in its place
            out = orig(self, *a, **k)
            half = out.shape[0] // 2
            return torch.cat([out[half:], out[half:]])

        monkeypatch.setattr(DenoisingUNet, "forward", forward)
    elif name == "answer_altered":
        orig_decode = AutoencoderKL.decode

        def decode(self, z):  # one frame of the clip altered where it is made
            out = orig_decode(self, z).clone()
            out[0] = -out[0]
            return out

        monkeypatch.setattr(AutoencoderKL, "decode", decode)
    elif name == "step_unchanged":
        monkeypatch.setattr(train_state.AdamW, "update", lambda self, *a, **k: None)
    elif name == "window_step_unchanged":  # updates skipped once the set-up steps are done
        orig_update = train_state.AdamW.update

        def update(self, grads, state, *a, **k):
            if state["count"] < SETUP_STEPS:
                orig_update(self, grads, state, *a, **k)
            else:
                state["count"] += 1

        monkeypatch.setattr(train_state.AdamW, "update", update)
    elif name == "window_half_batch":  # the batch cut once the set-up steps are done
        orig_loss = train_step.make_loss_fn
        calls = {"n": 0}

        def make_loss_fn(models, cfg=train_step.TrainConfig(), mesh=None):
            fn = orig_loss(models, cfg, mesh)

            def loss(batch, gen):
                calls["n"] += 1
                if calls["n"] <= SETUP_STEPS:
                    return fn(batch, gen)
                b = np.asarray(batch["pixel_values"]).shape[0] // 2
                cut = {k: (tuple(tuple(x[:b] for x in lvl) for lvl in v) if k == "masks"
                           else v[:b]) for k, v in batch.items()}
                return fn(cut, gen)

            return loss

        monkeypatch.setattr(train_step, "make_loss_fn", make_loss_fn)
    elif name == "train_half_batch":
        orig_loss = train_step.make_loss_fn

        def make_loss_fn(models, cfg=train_step.TrainConfig(), mesh=None):
            fn = orig_loss(models, cfg, mesh)

            def loss(batch, gen):
                b = np.asarray(batch["pixel_values"]).shape[0] // 2
                cut = {k: (tuple(tuple(x[:b] for x in lvl) for lvl in v) if k == "masks"
                           else v[:b]) for k, v in batch.items()}
                return fn(cut, gen)

            return loss

        monkeypatch.setattr(train_step, "make_loss_fn", make_loss_fn)
    elif name == "loss_altered":
        orig_loss = train_step.make_loss_fn

        def make_loss_fn(models, cfg=train_step.TrainConfig(), mesh=None):
            fn = orig_loss(models, cfg, mesh)
            return lambda batch, gen: 1.25 * fn(batch, gen)

        monkeypatch.setattr(train_step, "make_loss_fn", make_loss_fn)
    else:
        raise ValueError(name)


@pytest.mark.parametrize("workload", INFER)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered"])
def test_infer_fault_is_not_correct(monkeypatch, cell_runner, workload, fault):
    ov = tiny_cell(workload)
    _fault(monkeypatch, fault, ov["traffic"]["sampler"])
    assert cell_runner(workload, overrides=ov)["correct"] is False


@pytest.mark.parametrize("fault", ["step_unchanged", "train_half_batch", "loss_altered",
                                   "window_step_unchanged", "window_half_batch"])
def test_train_fault_is_not_correct(monkeypatch, cell_runner, fault):
    _fault(monkeypatch, fault)
    assert cell_runner("train-stage2-b4")["correct"] is False


@pytest.mark.parametrize("workload", INFER)
def test_infer_control_is_not_correct(workload):
    ov = tiny_cell(workload)
    cfg, traffic, check = ov["cfg"], ov["traffic"], ov["work"]["check"]
    seed = 4000000007
    models = common.build_program(cfg, seed, "cpu")
    pipe = infer._pipeline(models, cfg, traffic, traffic["steps"])
    f, h = cfg["clip_length"], cfg["height"]
    cap = infer.Capture(models, 1, 2, traffic["steps"], 1, (1, f, 4, h // 8, h // 8))
    req = inputs.clip_request(seed, 0, cfg, 1, 2)
    frames = []
    cap.active = True
    cap.begin(0)
    infer._call(pipe, req, lambda a: frames.append(np.array(a)), 0)
    caps = [cap.steps_of(0, c) for c in range(2)]
    args = (cfg, traffic, check, seed, req, [la for la, _ in caps], [ou for _, ou in caps],
            frames, "cpu")
    assert common.judged(infer.judge(*args), check["limits"])[0] is True
    assert common.judged(infer.judge(*args, control=True), check["limits"])[0] is False


def test_train_control_is_not_correct():
    ov = tiny_cell("train-stage2-b4")
    cfg, check = ov["cfg"], ov["work"]["check"]
    seed, n = 4000000009, check["steps"]
    batches = [inputs.train_batch(seed, i, cfg, 2) for i in range(n + 1)]
    models, state, step = train._program(cfg, seed, "cpu")
    state, prog = train.setup_steps(cfg, seed, models, state, step, batches, n, "cpu")
    snap = train.Snapshot(state)
    snap.take(state, n)
    state, met = step(state, batches[n], train.generator(seed, n, "cpu"))
    win = train.window_readings(state, snap, met["loss"], cfg["optimizer"]["beta1"])
    window = (snap, batches[n])
    ref = train.reference_readings(cfg, seed, batches, n, "cpu", window=window)
    ctl = train.reference_readings(cfg, seed, batches, n, "cpu", control=True, window=window)
    limits = check["limits"]
    setup_limits = {k: v for k, v in limits.items() if not k.startswith("window_")}
    window_limits = {k: v for k, v in limits.items() if k.startswith("window_")}
    assert common.judged(train.window_numbers(win, ref["window"]), window_limits)[0] is True
    assert common.judged(train.compare(ctl, ref), setup_limits)[0] is False
    assert common.judged(train.window_numbers(ctl["window"], ref["window"]),
                         window_limits)[0] is False


@pytest.mark.parametrize("sampler", ["ddim", "unipc"])
def test_sampler_rel_allows_the_guidance_in_fp32_or_the_served_dtype(sampler):
    from benchmark.reference import sampling as ref_sampling

    limit = load_work("infer-exact")["check"]["limits"]["sampler_rel"]
    cfg = load("tiny.json")
    samp = ref_sampling.make_sampler(cfg["scheduler"], sampler, 6)
    gen = torch.Generator().manual_seed(17)
    lats = [torch.randn(1, 4, 4, 8, 8, generator=gen) for _ in range(6)]
    outs = [tuple(torch.randn(1, 4, 4, 8, 8, generator=gen).to(torch.bfloat16) for _ in "uc")
            for _ in range(6)]

    def worst(traj):
        return min(infer.sampler_gaps(samp, outs, lats, traj[:-1], 3.5).values())

    for served in (True, False):  # a program combining in either precision
        traj = ref_sampling.sample_trajectory(samp, outs, lats[0], 3.5, inputs=lats,
                                              served=served)
        assert worst(traj) <= limit
    with ref_sampling.bf16():  # the control: a bfloat16 sampler
        traj = ref_sampling.sample_trajectory(samp, outs, lats[0], 3.5, inputs=lats)
    assert worst(traj) > limit
