"""The port's denoising UNet, ReferenceNet and VAE against hallo_tpu's, at
the tiny widths (`TINY_UNET_KW`, the config of
tests/test_convert_denoiser_oracle.py), in fp32 on the CPU.

The JAX trees come from `build_models("tiny", PRNGKey(0))` with every bias
and norm scale perturbed, and are bridged with `convert.from_jax`. The
denoiser runs both CFG formulations: `cfg_split` (plain self-attention and
the zero-audio `zero_conv(mask x bo)` term for the uncond half) and the
bias-masked path. Tolerances are the oracle test's (atol 5e-4, rtol 1e-3):
fp32 on both sides through ~100 layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hallo_tpu.utils.factory import build_models as jax_build_models
from hallo_tpu_torch.convert.from_jax import load_jax_params
from hallo_tpu_torch.utils.factory import build_models

from tests.test_torch_modules import perturb

TOL = dict(atol=5e-4, rtol=1e-3)


@pytest.fixture(scope="module")
def pair():
    jm = jax_build_models("tiny", init_key=jax.random.PRNGKey(0), height=64, width=64,
                          clip_length=4, n_motion_frames=2)
    params = {k: perturb(v, seed=i) for i, (k, v) in enumerate(sorted(jm.params.items()))}
    pm = build_models("tiny", device="cpu")
    load_jax_params(pm, jax.tree.map(np.asarray, params))
    return jm, params, pm


def t(x):
    return torch.from_numpy(np.asarray(x))


def to_nchw(x):  # (..., H, W, C) -> (..., C, H, W)
    return t(x).movedim(-1, -3)


def test_reference_net(pair):
    jm, params, pm = pair
    rng = np.random.default_rng(0)
    x = rng.normal(size=(6, 8, 8, 4)).astype(np.float32)
    ctx = rng.normal(size=(6, 4, 12)).astype(np.float32)
    out_j, feats_j = jax.jit(jm.reference_net.apply)(
        params["reference_net"], jnp.asarray(x), jnp.zeros(()), jnp.asarray(ctx))
    with torch.no_grad():
        out_t, feats_t = pm.reference_net(to_nchw(x), torch.zeros(()), t(ctx))
    np.testing.assert_allclose(out_t.movedim(1, -1).numpy(), np.asarray(out_j), **TOL)
    assert sorted(feats_t) == sorted(feats_j)
    for key in feats_j:
        for a, b in zip(feats_t[key], feats_j[key]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL, err_msg=key)


def _denoiser_inputs(seed):
    rng = np.random.default_rng(seed)
    b, f, hw, m = 2, 2, 16, 1

    def r(*shape):
        return rng.normal(size=shape).astype(np.float32)

    audio = r(b, f, 3, 6)
    audio[: b // 2] = 0.0  # CFG-uncond audio is zero (both formulations agree)
    masks = tuple(
        tuple((rng.uniform(size=(b * f, n)) > 0.3).astype(np.float32) for _ in range(3))
        for n in (256, 64, 16, 4)
    )
    dims = {"down_0": [(256, 8)], "down_1": [(64, 16)], "down_2": [(16, 16)],
            "mid": [(4, 16)], "up_1": [(16, 16)] * 2, "up_2": [(64, 16)] * 2,
            "up_3": [(256, 8)] * 2}
    return dict(
        x=r(b, f, hw, hw, 4), t=np.array([3.0, 11.0], np.float32), ctx=r(b, 4, 12),
        audio=audio, face=r(b, f, hw, hw, 8), masks=masks,
        scale=np.array([1.3, 0.7, 0.4], np.float32),
        ref={k: [r(b, n, c) for n, c in v] for k, v in dims.items()},
        mot={k: [r(b, m, n, c) for n, c in v] for k, v in dims.items()},
    )


@pytest.mark.parametrize("cfg_split", [True, False])
def test_denoising_unet(pair, cfg_split):
    jm, params, pm = pair
    d = _denoiser_inputs(1)
    uncond = None if cfg_split else np.array([1.0, 0.0], np.float32)

    def run_jax(p):
        return jm.denoising_net.apply(
            p, jnp.asarray(d["x"]), jnp.asarray(d["t"]), jnp.asarray(d["ctx"]),
            jax.tree.map(jnp.asarray, d["ref"]), jax.tree.map(jnp.asarray, d["mot"]),
            jnp.asarray(d["audio"]), jnp.asarray(d["face"]),
            jax.tree.map(jnp.asarray, d["masks"]), jnp.asarray(d["scale"]),
            None if uncond is None else jnp.asarray(uncond), cfg_split=cfg_split,
        )

    want = np.asarray(jax.jit(run_jax)(params["denoising_net"]))
    with torch.no_grad():
        got = pm.denoising_net(
            to_nchw(d["x"]), t(d["t"]), t(d["ctx"]),
            {k: [t(a) for a in v] for k, v in d["ref"].items()},
            {k: [t(a) for a in v] for k, v in d["mot"].items()},
            t(d["audio"]), to_nchw(d["face"]),
            tuple(tuple(t(a) for a in lvl) for lvl in d["masks"]), t(d["scale"]),
            None if uncond is None else t(uncond), cfg_split=cfg_split,
        )
    np.testing.assert_allclose(got.movedim(2, -1).numpy(), want, **TOL)


def test_vae_encode_decode(pair):
    jm, params, pm = pair
    rng = np.random.default_rng(2)
    px = rng.uniform(-1, 1, size=(2, 32, 32, 3)).astype(np.float32)
    z = rng.normal(size=(3, 4, 4, 4)).astype(np.float32)
    vae = jm.vae
    enc = jax.jit(lambda p, x: vae.apply(p, x, method=vae.encode_mean))(params["vae"], px)
    dec = jax.jit(lambda p, z: vae.apply(p, z, method=vae.decode))(params["vae"], z)
    with torch.no_grad():
        got_enc = pm.vae.encode_mean(to_nchw(px)).movedim(1, -1)
        got_dec = pm.vae.decode(to_nchw(z)).movedim(1, -1)
    np.testing.assert_allclose(got_enc.numpy(), np.asarray(enc), **TOL)
    np.testing.assert_allclose(got_dec.numpy(), np.asarray(dec), **TOL)


def test_heads_and_face_locator(pair):
    jm, params, pm = pair
    rng = np.random.default_rng(3)
    emb = rng.normal(size=(2, 16)).astype(np.float32)
    aw = rng.normal(size=(1, 4, 3, 2, 4)).astype(np.float32)
    region = rng.uniform(size=(1, 2, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        np.testing.assert_allclose(
            pm.image_proj(t(emb)).numpy(),
            np.asarray(jm.image_proj.apply(params["image_proj"], emb)), **TOL)
        np.testing.assert_allclose(
            pm.audio_proj(t(aw)).numpy(),
            np.asarray(jm.audio_proj.apply(params["audio_proj"], aw)), **TOL)
        got = pm.face_locator(to_nchw(region[0])).movedim(1, -1)
    want = jm.face_locator.apply(params["face_locator"], region)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
