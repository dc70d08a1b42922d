"""The port's whole one-clip slice against hallo_tpu, on the CPU in fp32.

(a) The golden: `build_models("tiny", PRNGKey(0))`'s trees bridged into the
port, the initial noise drawn with the same `jax.random` key splits as
hallo_tpu's `FaceAnimatePipeline.__call__` at seed 11, and the port's video
held against tests/golden/e2e_tiny.npz at test_e2e_golden.py's tolerances.
No JAX pipeline is compiled.

(b) Live, two clips (so the uint8 motion-frame carry feeds clip 2): the JAX
pipeline and the port on the same bridged weights (biases perturbed) and
the same noise. A uint8 value may round the other way on one side (fp32
summation order), which can move a pixel by 1/255 and, through the motion
frames, clip 2 slightly more: the tolerance is 2/255 per pixel at most and
1e-3 on the mean absolute difference.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np

from hallo_tpu.config import SchedulerConfig
from hallo_tpu.pipelines.face_animate import FaceAnimatePipeline as JaxPipeline
from hallo_tpu.pipelines.face_animate import window_audio_embeddings as jax_windows
from hallo_tpu.utils.factory import build_models as jax_build_models
from hallo_tpu_torch.convert.from_jax import load_jax_params
from hallo_tpu_torch.pipelines.face_animate import FaceAnimatePipeline, window_audio_embeddings
from hallo_tpu_torch.utils.factory import build_models

from tests.test_torch_modules import perturb

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "e2e_tiny.npz")
H, F, M = 64, 4, 2


def jax_noise(seed, clips, b=1):
    """hallo_tpu FaceAnimatePipeline.__call__'s per-clip noise."""
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(clips):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, (b, F, H // 8, H // 8, 4), jnp.float32)))
    return out


def inputs(clips):
    rng = np.random.default_rng(7)
    hl = H // 8
    return dict(
        ref_image=rng.uniform(-1, 1, size=(1, H, H, 3)).astype(np.float32),
        audio_windows=rng.normal(size=(F * clips, 3, 2, 4)).astype(np.float32),
        face_emb=rng.normal(size=(1, 16)).astype(np.float32),
        face_region=np.ones((1, H, H, 3), np.float32),
        masks=tuple(tuple(np.ones((1, (hl // 2**d) ** 2), np.float32) for _ in range(3))
                    for d in range(4)),
    )


def port_pipeline(params, steps=2):
    pm = build_models("tiny", device="cpu")
    load_jax_params(pm, jax.tree.map(np.asarray, params))
    return FaceAnimatePipeline(pm, SchedulerConfig(), num_inference_steps=steps,
                               guidance_scale=3.5, clip_length=F, n_motion_frames=M)


def test_slice_matches_golden():
    jm = jax_build_models("tiny", init_key=jax.random.PRNGKey(0), height=H, width=H,
                          clip_length=F, n_motion_frames=M)
    video = port_pipeline(jm.params)(**inputs(1), latents=jax_noise(11, 1))
    assert video.shape == (1, F, H, H, 3)
    pooled = video[0, 0].reshape(8, H // 8, 8, H // 8, 3).mean(axis=(1, 3))
    stats = np.array([video.mean(), video.std(), video.min(), video.max()], np.float64)
    golden = np.load(GOLDEN)
    np.testing.assert_allclose(stats, golden["stats"], atol=2e-3, rtol=0)
    np.testing.assert_allclose(pooled, golden["pooled"], atol=5e-3, rtol=0)


def test_slice_draws_its_own_noise():
    """Without given latents, __call__ draws them from a seeded generator:
    the same seed gives the same video, another seed another."""
    jm = jax_build_models("tiny", init_key=jax.random.PRNGKey(0), height=H, width=H,
                          clip_length=F, n_motion_frames=M)
    pipe = port_pipeline(jm.params, steps=1)
    a = pipe(**inputs(1), seed=3)
    b = pipe(**inputs(1), seed=3)
    c = pipe(**inputs(1), seed=4)
    np.testing.assert_array_equal(a, b)
    assert np.abs(a - c).max() > 0


def test_slice_live_two_clips_matches_jax():
    jm = jax_build_models("tiny", init_key=jax.random.PRNGKey(0), height=H, width=H,
                          clip_length=F, n_motion_frames=M)
    params = {k: perturb(v, seed=i) for i, (k, v) in enumerate(sorted(jm.params.items()))}
    jm.params = params
    jpipe = JaxPipeline(jm, SchedulerConfig(), num_inference_steps=2, guidance_scale=3.5,
                        clip_length=F, n_motion_frames=M)
    want = jpipe(**inputs(2), seed=5)
    got = port_pipeline(params)(**inputs(2), latents=jax_noise(5, 2))
    assert got.shape == want.shape == (1, 2 * F, H, H, 3)
    diff = np.abs(got - want)
    assert diff.max() <= 2 / 255 + 1e-6, diff.max()
    assert diff.mean() <= 1e-3, diff.mean()


def test_slice_two_identities_match_jax():
    """Long-form with several identities (BASELINE.json config 4): batch 2
    with distinct reference images, face embeddings, regions and masks and
    shared audio, over 2 clips, against the JAX pipeline at the same noise
    (every bias perturbed, every zero-initialised weight drawn, so that the
    motion-frame carry reaches clip 2). The tolerance is the live test's."""
    from tests.test_torch_profiles import wake

    jm = jax_build_models("tiny", init_key=jax.random.PRNGKey(0), height=H, width=H,
                          clip_length=F, n_motion_frames=M)
    params = {k: wake(perturb(v, seed=i), seed=i)
              for i, (k, v) in enumerate(sorted(jm.params.items()))}
    jm.params = params
    rng = np.random.default_rng(8)
    hl = H // 8
    call = dict(
        inputs(2), ref_image=rng.uniform(-1, 1, size=(2, H, H, 3)).astype(np.float32),
        face_emb=rng.normal(size=(2, 16)).astype(np.float32),
        face_region=(rng.uniform(size=(2, H, H, 3)) > 0.4).astype(np.float32),
        masks=tuple(tuple((rng.uniform(size=(2, (hl // 2**d) ** 2)) > 0.3).astype(np.float32)
                          for _ in range(3)) for d in range(4)))
    jpipe = JaxPipeline(jm, SchedulerConfig(), num_inference_steps=2, guidance_scale=3.5,
                        clip_length=F, n_motion_frames=M)
    want = jpipe(**call, seed=5)
    got = port_pipeline(params)(**call, latents=jax_noise(5, 2, b=2))
    assert got.shape == want.shape == (2, 2 * F, H, H, 3)
    diff = np.abs(got - want)
    assert diff.max() <= 2 / 255 + 1e-6, diff.max()
    assert diff.mean() <= 1e-3, diff.mean()
    assert np.abs(got[0] - got[1]).mean() > 1e-2  # two identities, two videos


def test_window_audio_embeddings_matches_jax():
    emb = np.random.default_rng(3).normal(size=(7, 2, 4)).astype(np.float32)
    for margin in (0, 2):
        got = window_audio_embeddings(emb, margin)
        assert got.shape == (7, 2 * margin + 1, 2, 4)
        np.testing.assert_array_equal(got, jax_windows(emb, margin))
