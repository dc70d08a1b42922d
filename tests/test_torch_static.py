"""The port's static pipeline (`pipelines/static.py`, the stage-1
validation path) against hallo_tpu's `StaticPipeline`, on the CPU in fp32.

The tiny 2D models (`use_motion_module=False, use_audio_module=False`, as
the stage-1 trainer builds them) at 64x64, B 2, with every bias and norm
scale perturbed and every zero-initialised weight drawn (the face locator's
conv_out would otherwise zero the face conditioning, and image_proj's bias
makes the uncond tokens image_proj(0) non-zero). Both sides take the same
initial noise: the JAX program is called with it directly, the port
through `latents=` (the port draws its own noise from a torch.Generator).
The images are compared in fp32 (no uint8 rounding between): 1e-4 per
pixel at most, fp32 summation order through the UNets and the sampler.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hallo_tpu.config import SchedulerConfig as JaxSchedulerConfig
from hallo_tpu.pipelines.static import StaticPipeline as JaxStaticPipeline
from hallo_tpu.utils.factory import build_models as jax_build_models
from hallo_tpu_torch.config import SchedulerConfig
from hallo_tpu_torch.convert.from_jax import load_jax_params
from hallo_tpu_torch.pipelines.static import StaticPipeline
from hallo_tpu_torch.utils.factory import build_models

from tests.test_torch_modules import perturb
from tests.test_torch_profiles import wake

H, B = 64, 2
STATIC_2D = dict(use_motion_module=False, use_audio_module=False)
ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for the port's CPU runs (the suite runs beside
    other workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def weights():
    jm = jax_build_models("tiny", init_key=jax.random.PRNGKey(0), height=H, width=H,
                          clip_length=1, n_motion_frames=0, unet_overrides=STATIC_2D)
    jm.params = {k: wake(perturb(v, seed=i), seed=i)
                 for i, (k, v) in enumerate(sorted(jm.params.items()))}
    pm = build_models("tiny", device="cpu", unet_overrides=STATIC_2D)
    load_jax_params(pm, jax.tree.map(np.asarray, jm.params))
    return jm, pm


def inputs(seed=0):
    """Distinct references, embeddings and regions per sample, and the
    initial noise."""
    rng = np.random.default_rng(seed)
    return dict(
        ref_image=rng.uniform(-1, 1, (B, H, H, 3)).astype(np.float32),
        face_emb=rng.normal(size=(B, 16)).astype(np.float32),
        face_region=(rng.uniform(size=(B, H, H, 3)) > 0.5).astype(np.float32),
    ), rng.normal(size=(B, 1, H // 8, H // 8, 4)).astype(np.float32)


@pytest.mark.parametrize("sampler,steps", [("ddim", 2), ("unipc", 3)])
def test_static_pipeline_matches_jax(sampler, steps):
    jm, pm = weights()
    call, latents = inputs()
    jpipe = JaxStaticPipeline(jm, JaxSchedulerConfig(), num_inference_steps=steps,
                              sampler=sampler)
    want = np.asarray(jpipe._run(jm.params, jnp.asarray(call["ref_image"]),
                                 jnp.asarray(latents), jnp.asarray(call["face_emb"]),
                                 jnp.asarray(call["face_region"])))
    got = StaticPipeline(pm, SchedulerConfig(), num_inference_steps=steps,
                         sampler=sampler)(**call, latents=latents)
    assert got.shape == want.shape == (B, H, H, 3) and got.dtype == np.float32
    assert 0.0 <= got.min() and got.max() <= 1.0 and got.std() > 0.01
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    # the two samples differ (distinct identities in one batch)
    assert np.abs(got[0] - got[1]).mean() > 1e-3


def test_static_pipeline_draws_its_own_noise():
    """Without `latents` the noise comes from a generator seeded with
    `seed`: the same seed gives the same images, another seed others."""
    _, pm = weights()
    call, _ = inputs(1)
    pipe = StaticPipeline(pm, num_inference_steps=1)
    a, b, c = pipe(**call, seed=3), pipe(**call, seed=3), pipe(**call, seed=4)
    np.testing.assert_array_equal(a, b)
    assert np.abs(a - c).max() > 0


def test_static_denoiser_runs_one_frame_with_every_branch_off():
    """The 2D denoiser of `build_models(unet_overrides=...)` has no motion or
    audio modules (the JAX factory's configs, field by field), and runs F 1
    without audio, masks, motion frames or motion scale."""
    import dataclasses

    from hallo_tpu.config import denoising_unet_config, reference_unet_config
    from hallo_tpu.utils.factory import TINY_UNET_KW

    for overrides in (STATIC_2D, dict(STATIC_2D, use_inflated_groupnorm=False)):
        pm = build_models("tiny", device="cpu", unet_overrides=overrides)
        for ours, theirs in ((pm.denoising_net.config, denoising_unet_config),
                             (pm.reference_net.config, reference_unet_config)):
            want = dataclasses.asdict(theirs(**TINY_UNET_KW, **overrides))
            for field in ("use_linear_projection", "upcast_attention"):
                want.pop(field)
            assert dataclasses.asdict(ours) == want
        names = [n for n, _ in pm.denoising_net.named_parameters()]
        assert not any("motion_modules" in n or "audio_modules" in n for n in names)
        den = pm.denoising_net
        x = torch.randn(1, 1, 4, 8, 8)
        with torch.no_grad():
            out = den(x, torch.tensor(10), torch.randn(1, 4, 12))
        assert out.shape == x.shape and torch.isfinite(out).all()
