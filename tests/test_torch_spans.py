"""The port's spans and counters (`hallo_tpu_torch/utils/profiling.py`) on
the CPU: off, a span is one shared no-op context; under torch.profiler a
two-clip run of the tiny pipeline (dynamic step cache and CFG cache on) and
a tiny stage-2 train step record their ranges, nested; the counters equal
a hand count of the denoiser's evaluations by kind and of the host's waits
by site; `timings` keeps its keys, and without it a clip never
synchronises.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hallo_tpu_torch.config import SchedulerConfig
from hallo_tpu_torch.diffusion.cache import make_allow_mask, make_cfg_plan
from hallo_tpu_torch.pipelines import face_animate
from hallo_tpu_torch.pipelines.face_animate import FaceAnimatePipeline
from hallo_tpu_torch.train import state as tstate
from hallo_tpu_torch.train import step as tstep
from hallo_tpu_torch.utils import profiling
from hallo_tpu_torch.utils.factory import build_models

H, F, M, CLIPS, STEPS = 64, 4, 2, 2, 12
INPUT_ARRAYS = 16  # the request's copies: reference, embedding, region, 12 masks, scale


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads, as the other port tests beside five workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def clip_inputs(clips):
    rng = np.random.default_rng(7)
    hl = H // 8
    return dict(
        ref_image=rng.uniform(-1, 1, size=(1, H, H, 3)).astype(np.float32),
        audio_windows=rng.normal(size=(F * clips, 3, 2, 4)).astype(np.float32),
        face_emb=rng.normal(size=(1, 16)).astype(np.float32),
        face_region=np.ones((1, H, H, 3), np.float32),
        masks=tuple(tuple(np.ones((1, (hl // 2**d) ** 2), np.float32) for _ in range(3))
                    for d in range(4)),
        latents=[rng.normal(size=(1, F, hl, hl, 4)).astype(np.float32) for _ in range(clips)],
    )


def ranges(prof, prefix="hallo."):
    """The profiler's host ranges named `prefix`*: (name, start, end), each
    an operation's range (no device-side copy)."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(prefix):
            assert e.activity_type() == "cpu_op", (e.name(), e.activity_type())
            out.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
    return sorted(out, key=lambda r: (r[1], -r[2]))


def parent(rs, r):
    """The innermost range around `r` (None at the top)."""
    around = [p for p in rs if p is not r and p[1] <= r[1] and r[2] <= p[2]]
    return min(around, key=lambda p: p[2] - p[1], default=None)


def named(rs, name):
    return [r for r in rs if r[0] == name]


def test_spans_are_a_shared_no_op_with_the_profiler_off():
    assert not torch.autograd.profiler._is_profiler_enabled
    before = profiling.counters()
    assert profiling.span("hallo.x") is profiling.span("hallo.y")
    with profiling.wait("site"), profiling.span("hallo.x"):
        pass
    after = profiling.counters()
    assert after - before == {"wait.site": 1}  # counted all the same
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pass
    assert ranges(prof) == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("hallo.x"):
            with profiling.wait("site"):
                pass
    (outer, inner) = ranges(prof)
    assert outer[0] == "hallo.x"
    assert inner[0] == "hallo.wait.site" and parent([outer, inner], inner) is outer


def test_counters_hold_the_ops_launch_tables():
    from hallo_tpu_torch.ops import flash
    from hallo_tpu_torch.parallel import collectives

    got = profiling.counters()
    assert got["launch.flash_fwd_packed"] == flash.LAUNCHES["flash_fwd_packed"]
    assert got["launch.all_reduce"] == collectives.LAUNCHES["all_reduce"]


@pytest.fixture(scope="module")
def models():
    return build_models("tiny", device="cpu")


def pipeline(models, steps):
    """The dynamic step cache at a threshold no score reaches (every
    allowed step reuses), the CFG cache at stride 2 with a 2-step tail."""
    return FaceAnimatePipeline(
        models, SchedulerConfig(), num_inference_steps=steps, guidance_scale=3.5,
        clip_length=F, n_motion_frames=M, sampler="unipc", step_cache="dynamic",
        step_cache_threshold=1e9, cfg_cache_stride=2, cfg_tail=2)


@pytest.fixture(scope="module")
def clip_run(models):
    """One profiled two-clip request of 12 UniPC steps a clip, with
    `timings`."""
    timings, got = {}, []
    before = profiling.counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pipeline(models, STEPS)(**clip_inputs(CLIPS), seed=0, on_clip=got.append,
                                return_video=False, timings=timings)
    return dict(counts=profiling.counters() - before, ranges=ranges(prof), timings=timings,
                delivered=got)


def plan(steps=STEPS):
    """The hand count of one clip's steps: reuse where the cache may reuse,
    else the CFG pair where the plan evaluates the uncond half, else the
    cond half alone."""
    allow = make_allow_mask(steps)
    un_mask, _ = make_cfg_plan(steps, 2, 3.5, tail=2)
    return ["reuse" if a else ("full" if u else "cond") for a, u in zip(allow, un_mask)]


def test_counters_are_the_hand_count(clip_run):
    kinds = plan()
    assert "cond" in kinds and "full" in kinds and "reuse" in kinds
    want = {
        "request": 1, "clip": CLIPS,
        "denoiser.eval.full": CLIPS * kinds.count("full"),
        "denoiser.eval.cond": CLIPS * kinds.count("cond"),
        "denoiser.step.reuse": CLIPS * kinds.count("reuse"),
        "wait.timestep": CLIPS * STEPS,
        "wait.cache_score": CLIPS * int(make_allow_mask(STEPS).sum()),
        "wait.inputs": INPUT_ARRAYS + 2 * CLIPS,  # each clip's noise and audio
        "wait.frames": CLIPS,
    }
    assert clip_run["counts"] == want  # and no kernel launched on the CPU
    assert clip_run["timings"]["step_kind"] == kinds * CLIPS


def test_clip_spans_nest(clip_run):
    rs = clip_run["ranges"]
    kinds = plan()
    clips = named(rs, "hallo.clip")
    assert len(clips) == CLIPS
    for c, clip in enumerate(clips):
        assert parent(rs, clip) is None
        for name in ("hallo.clip.encode", "hallo.clip.condition", "hallo.clip.decode"):
            assert [parent(rs, r) for r in named(rs, name)].count(clip) == 1, name
        steps = [s for s in named(rs, "hallo.step") if parent(rs, s) is clip]
        assert len(steps) == STEPS
        for i, (step, kind) in enumerate(zip(steps, kinds)):
            inside = sorted(r[0] for r in rs if parent(rs, r) is step)
            want = ["hallo.step.sampler", "hallo.wait.timestep"]
            want += ["hallo.wait.cache_score"] if kind == "reuse" else ["hallo.step.denoise"]
            assert inside == sorted(want), (c, i, inside)
    assert len(named(rs, "hallo.step")) == CLIPS * STEPS
    for name, n in (("hallo.wait.inputs", INPUT_ARRAYS + 2 * CLIPS),
                    ("hallo.wait.frames", CLIPS), ("hallo.emit", CLIPS)):
        got = named(rs, name)
        assert len(got) == n and all(parent(rs, r) is None for r in got), name
    # each clip's frames are fetched and emitted after the next clip is dispatched
    emits = named(rs, "hallo.emit")
    assert clips[0][2] < clips[1][1] < emits[0][1] and clips[1][2] < emits[1][1]
    assert len(clip_run["delivered"]) == CLIPS


def test_timings_keep_their_keys(clip_run):
    t = clip_run["timings"]
    assert set(t) == {"vae_encode", "conditioning", "denoise_step", "vae_decode",
                      "step_kind", "step_cache_score"}
    for key in ("vae_encode", "conditioning", "vae_decode"):
        assert len(t[key]) == CLIPS and min(t[key]) >= 0
    assert len(t["denoise_step"]) == len(t["step_kind"]) == CLIPS * STEPS
    assert len(t["step_cache_score"]) == CLIPS * int(make_allow_mask(STEPS).sum())


def train_batch(b=2):
    rng = np.random.default_rng(3)
    hl = H // 8
    return dict(
        pixel_values=rng.uniform(-1, 1, (b, F, H, H, 3)).astype(np.float32),
        ref_pixels=rng.uniform(-1, 1, (b, H, H, 3)).astype(np.float32),
        motion_pixels=rng.uniform(-1, 1, (b, M, H, H, 3)).astype(np.float32),
        audio_windows=rng.normal(size=(b, F, 3, 2, 4)).astype(np.float32),
        face_emb=rng.normal(size=(b, 16)).astype(np.float32),
        face_region=rng.uniform(0, 1, (b, H, H, 3)).astype(np.float32),
        masks=tuple(tuple(np.ones((b, (hl >> d) ** 2), np.float32) for _ in range(3))
                    for d in range(4)),
    )


def test_train_step_spans_and_waits():
    models = build_models("tiny", device="cpu")
    trainable = tstate.unfreeze(models.modules(), tstate.stage2_trainable)
    opt = tstate.AdamW(tstate.OptimizerConfig())
    state = tstate.TrainState.create(trainable, opt)
    state.step = 5
    step = tstep.make_train_step(models, trainable, opt, tstep.TrainConfig())
    before = profiling.counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state, met = step(state, train_batch(), torch.Generator().manual_seed(0))
    assert np.isfinite(met["loss"]) and met["skipped"] == 0.0
    # 6 arrays and 12 masks copied; the loss read; the norm read twice
    assert profiling.counters() - before == {
        "train.step": 1, "wait.batch": 18, "wait.loss": 1, "wait.grad_norm": 2}
    rs = ranges(prof)
    (top,) = named(rs, "hallo.train.step")
    assert parent(rs, top) is None
    children = [r[0] for r in rs if parent(rs, r) is top]
    assert children == ["hallo.train.forward", "hallo.train.backward", "hallo.train.optimizer"]
    (fwd,) = named(rs, "hallo.train.forward")
    (opt_span,) = named(rs, "hallo.train.optimizer")
    assert [parent(rs, r) for r in named(rs, "hallo.train.encode")] == [fwd, fwd]
    assert all(parent(rs, r) is fwd for r in named(rs, "hallo.wait.batch"))
    assert len(named(rs, "hallo.wait.batch")) == 18
    waits = [r for r in rs if r[0] in ("hallo.wait.loss", "hallo.wait.grad_norm")]
    assert [r[0] for r in waits] == ["hallo.wait.loss"] + ["hallo.wait.grad_norm"] * 2
    assert [parent(rs, r) for r in waits[:2]] == [opt_span] * 2


def test_a_clip_without_timings_never_synchronises(models, monkeypatch):
    """Only a `timings` caller synchronises for tracing: without one, a
    clip reaches neither the marks' clock nor `torch.cuda.synchronize`."""
    def refuse(*args):
        raise AssertionError("synchronised without timings")

    monkeypatch.setattr(face_animate, "_synced_clock", refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    got, steps = [], 6
    kinds = plan(steps)
    before = profiling.counters()
    pipeline(models, steps)(**clip_inputs(1), seed=0, on_clip=got.append,
                            return_video=False)
    assert len(got) == 1
    assert "reuse" not in kinds  # the cache may reuse no step of so short a plan
    want = {"request": 1, "clip": 1, "wait.timestep": steps, "wait.inputs": INPUT_ARRAYS + 2,
            "wait.frames": 1}
    want.update({face_animate.STEP_COUNTERS[k]: kinds.count(k) for k in set(kinds)})
    assert profiling.counters() - before == want
