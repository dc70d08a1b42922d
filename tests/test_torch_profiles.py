"""The port's fast-profile pipeline against the live hallo_tpu pipeline, on
the CPU in fp32 (the tiny models, 64x64, clips of 4 + 2 motion frames).

Both pipelines take the same bridged weights (every bias and norm scale
perturbed) and the same noise (the port is given the JAX pipeline's
per-clip draws), over 2 clips so that the uint8 motion-frame carry feeds
clip 2. A uint8 value may round the other way on one side (fp32 summation
order), moving a pixel by 1/255 and, through the motion frames, clip 2
slightly more: the tolerance is tests/test_torch_slice.py's, 2/255 per pixel
at most and 1e-3 on the mean absolute difference.

The zero-initialised weights (motion modules' proj_out, audio zero convs)
are drawn too, so that the motion-frame features reach the output.

Here: UniPC at 10 evals (the JAX clip program's plain `body`) with
`legacy_context_tiling=False`; DPM-Solver++ on the log-SNR grid with the
CFG cache (`cfg_cache_stride=2`, `cfg_tail=1`: `body_g`, whose cond-only
steps run the denoiser on the cond half alone); the streaming `__call__`
(`on_clip`, `return_video=False`, `audio_length` cutting clip 2) against
JAX's hook; the constructor's errors. The step caches are in
tests/test_torch_caches.py: each JAX pipeline is a compile of its own.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from hallo_tpu.config import SchedulerConfig as JaxSchedulerConfig
from hallo_tpu.diffusion.cache import make_cfg_plan
from hallo_tpu.pipelines.face_animate import FaceAnimatePipeline as JaxPipeline
from hallo_tpu.utils.factory import build_models as jax_build_models
from hallo_tpu_torch.config import SchedulerConfig
from hallo_tpu_torch.convert.from_jax import load_jax_params
from hallo_tpu_torch.pipelines.face_animate import FaceAnimatePipeline
from hallo_tpu_torch.utils.factory import build_models

from tests.test_torch_modules import perturb
from tests.test_torch_slice import F, H, M, inputs, jax_noise

CLIPS = 2


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for the port's CPU runs here: the suite runs
    these files beside five other workers, where torch's default of one
    thread a core oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def wake(tree, seed):
    """Every zero-initialised weight (the motion modules' proj_out, the audio
    zero convs) -> N(0, 0.1): with them at zero the motion-frame features,
    and with them the identity tokens' tiling over the ReferenceNet batch,
    would not reach the output."""
    rng = np.random.default_rng(seed)

    def f(leaf):
        a = np.asarray(leaf)
        if a.ndim > 1 and not a.any():
            return jax.numpy.asarray(rng.normal(0, 0.1, a.shape).astype(a.dtype))
        return leaf

    return jax.tree.map(f, tree)


@functools.lru_cache(maxsize=None)
def weights():
    """The tiny JAX models with perturbed parameters, and the port's models
    with the same weights bridged in."""
    jm = jax_build_models("tiny", init_key=jax.random.PRNGKey(0), height=H, width=H,
                          clip_length=F, n_motion_frames=M)
    jm.params = {k: wake(perturb(v, seed=i), seed=i)
                 for i, (k, v) in enumerate(sorted(jm.params.items()))}
    pm = build_models("tiny", device="cpu")
    load_jax_params(pm, jax.tree.map(np.asarray, jm.params))
    return jm, pm


def pipelines(steps, **kw):
    jm, pm = weights()
    common = dict(num_inference_steps=steps, guidance_scale=3.5, clip_length=F,
                  n_motion_frames=M, **kw)
    return JaxPipeline(jm, JaxSchedulerConfig(), **common), FaceAnimatePipeline(
        pm, SchedulerConfig(), **common)


def assert_video_close(got, want):
    assert got.shape == want.shape, (got.shape, want.shape)
    diff = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))
    assert diff.max() <= 2 / 255 + 1e-6, diff.max()
    assert diff.mean() <= 1e-3, diff.mean()


def run_both(steps, seed=5, **kw):
    """Both pipelines over CLIPS clips; the port's step kinds beside."""
    jpipe, pipe = pipelines(steps, **kw)
    want = jpipe(**inputs(CLIPS), seed=seed)
    timings: dict = {}
    got = pipe(**inputs(CLIPS), latents=jax_noise(seed, CLIPS), timings=timings)
    assert got.shape == (1, CLIPS * F, H, H, 3)
    assert_video_close(got, want)
    return jpipe, pipe, timings


@functools.lru_cache(maxsize=None)
def unipc_fast():
    return run_both(10, sampler="unipc", legacy_context_tiling=False)


def test_unipc_fast_profile_matches_jax():
    _, pipe, timings = unipc_fast()
    assert pipe.sampler.name == "unipc" and pipe.sampler.num_steps == 10
    assert timings["step_kind"] == ["full"] * 10 * CLIPS
    assert len(timings["denoise_step"]) == 10 * CLIPS


def test_context_tiling_reaches_the_latents():
    """At these widths the two tilings of the identity tokens move the video
    by at most 1/255, inside the parity tolerance, so the JAX comparison
    above cannot tell them apart: the flag's effect is read from the
    latents handed to the VAE decoder."""
    _, pm = weights()
    decode, seen = pm.vae.decode, []

    def recording(z):
        seen.append(z.clone())
        return decode(z)

    pm.vae.decode = recording
    try:
        for legacy in (True, False):
            FaceAnimatePipeline(pm, SchedulerConfig(), num_inference_steps=2, clip_length=F,
                                n_motion_frames=M, legacy_context_tiling=legacy)(
                **inputs(1), latents=jax_noise(5, 1))
    finally:
        del pm.vae.decode
    assert (seen[0] - seen[1]).abs().max() > 1e-5


def test_dpm_logsnr_with_cfg_cache_matches_jax():
    _, pipe, timings = run_both(10, sampler="dpm++2m", timestep_schedule="logsnr",
                                cfg_cache_stride=2, cfg_tail=1)
    un_mask, weights_ = make_cfg_plan(10, 2, 3.5, tail=1)
    assert weights_[-1] == 1.0 and not un_mask.all()
    want = ["full" if u else "cond" for u in un_mask] * CLIPS
    assert timings["step_kind"] == want


def test_streaming_hook_matches_jax_and_keeps_no_video():
    """on_clip over 2 clips with audio_length cutting the second, and
    return_video=False, against JAX's hook output (the UniPC pipelines of
    the first test). Clip 2 is dispatched before clip 1's frames reach the
    hook."""
    jpipe, pipe, _ = unipc_fast()
    length = F + 1
    want, got, dispatched = [], [], []
    assert jpipe(**inputs(CLIPS), seed=6, audio_length=length, on_clip=want.append,
                 return_video=False) is None
    clip = pipe.clip

    def counting_clip(*a, **kw):
        dispatched.append(1)
        return clip(*a, **kw)

    pipe.clip = counting_clip

    def hook(frames):
        got.append((len(dispatched), frames.copy()))

    try:
        assert pipe(**inputs(CLIPS), latents=jax_noise(6, CLIPS), audio_length=length,
                    on_clip=hook, return_video=False) is None
    finally:
        del pipe.clip
    assert [n for n, _ in got] == [2, 2]
    assert [w.shape for w in want] == [(1, F, H, H, 3), (1, 1, H, H, 3)]
    for (_, g), w in zip(got, want):
        assert g.dtype == np.uint8
        assert_video_close(g.astype(np.float32) / 255, np.asarray(w, np.float32) / 255)


def test_hook_frames_equal_the_returned_video():
    pipe = unipc_fast()[1]
    frames = []
    video = pipe(**inputs(CLIPS), seed=2, audio_length=F + 3, on_clip=frames.append)
    assert video.shape == (1, F + 3, H, H, 3)
    np.testing.assert_array_equal(
        np.concatenate(frames, axis=1).astype(np.float32) / 255.0, video)


@pytest.mark.parametrize("kw", [
    dict(step_cache="sometimes"),
    dict(cfg_cache_stride=0),
    dict(step_cache="uniform", cfg_cache_stride=2),
    dict(step_cache="uniform", cfg_tail=1),
    dict(sampler="euler"),
    dict(timestep_schedule="karras"),
])
def test_constructor_errors_match_jax(kw):
    jm, pm = weights()
    with pytest.raises(ValueError) as theirs:
        JaxPipeline(jm, JaxSchedulerConfig(), num_inference_steps=4, **kw)
    with pytest.raises(ValueError) as mine:
        FaceAnimatePipeline(pm, SchedulerConfig(), num_inference_steps=4, **kw)
    assert str(mine.value) == str(theirs.value)


@pytest.mark.parametrize("off", [None, "", "off", "none", "exact"])
def test_step_cache_off_spellings(off):
    pipe = FaceAnimatePipeline(weights()[1], SchedulerConfig(), num_inference_steps=4,
                               step_cache=off)
    assert pipe.step_cache is None and pipe.skip is None and pipe.allow is None
