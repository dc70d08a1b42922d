"""hallo_tpu_torch modules that hold a kernel, and the norms, against the
hallo_tpu modules in fp32 on the CPU.

Each JAX module is initialised, every bias and norm scale is perturbed away
from its init (zero biases hid the cfg_split `zero_conv(mask x bo)` term
before), the tree is bridged into the port's state_dict with
`convert.from_jax`, and both run on the same numpy inputs. fp32 on both
sides: the tolerance is summation order (atol 2e-5 on O(1) outputs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hallo_tpu.convert import torch_to_jax as tj
from hallo_tpu.models import layers as jl
from hallo_tpu.models.attention_blocks import AudioTransformerBlock as JAudioBlock
from hallo_tpu.models.vae import VAEAttention as JVAEAttention
from hallo_tpu_torch.convert.from_jax import state_dict_from_jax
from hallo_tpu_torch.models import layers as tl
from hallo_tpu_torch.models.attention_blocks import AudioTransformerBlock
from hallo_tpu_torch.models.vae import VAEAttention

ATOL = 2e-5


def perturb(tree, seed=0):
    """Every bias -> N(0, 0.5); every norm scale -> 1 + N(0, 0.2)."""
    rng = np.random.default_rng(seed)

    def f(path, leaf):
        name = getattr(path[-1], "key", "")
        if name == "bias":
            return jnp.asarray(rng.normal(0, 0.5, leaf.shape).astype(np.float32))
        if name == "scale":
            return jnp.asarray(1 + rng.normal(0, 0.2, leaf.shape).astype(np.float32))
        return leaf

    return jax.tree_util.tree_map_with_path(f, tree)


def attn_keys(key):
    return tj._map_attention(key, ())


def bridge(module, tree, mapper):
    module.load_state_dict(state_dict_from_jax(module, tree, mapper), strict=True)
    return module


def t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("with_extra,with_bias", [(False, False), (True, True)])
def test_cross_attention(with_extra, with_bias):
    rng = np.random.default_rng(1)
    b, lq, lc, lx, c, cc, heads, d = 2, 40, 7, 24, 16, 12, 2, 8
    x = rng.normal(size=(b, lq, c)).astype(np.float32)
    ctx = rng.normal(size=(b, lc, cc)).astype(np.float32)
    extra = bias = None
    if with_extra:
        extra = tuple(rng.normal(size=(b, lx, heads * d)).astype(np.float32) for _ in range(2))
    if with_bias:
        bias = np.zeros((b, lc + (lx if with_extra else 0)), np.float32)
        bias[0, lc:] = -1e9
        bias[1] = rng.normal(size=bias.shape[1])
    jm = jl.CrossAttention(heads, d)
    jb = None if bias is None else jnp.asarray(bias)[:, None, None, :]
    je = None if extra is None else tuple(map(jnp.asarray, extra))
    params = perturb(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(ctx)))
    want = jm.apply(params, jnp.asarray(x), jnp.asarray(ctx), bias=jb, extra_kv=je)

    pm = bridge(tl.CrossAttention(c, heads, d, context_dim=cc), params, attn_keys)
    got = pm(t(x), t(ctx), bias=None if bias is None else t(bias),
             extra_kv=None if extra is None else tuple(map(t, extra)))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL)


def test_temporal_self_attention():
    rng = np.random.default_rng(2)
    b, f, l, c, heads = 2, 6, 20, 16, 2
    x = rng.normal(size=(b, f, l, c)).astype(np.float32)
    jm = jl.TemporalSelfAttention(heads, c // heads)
    params = perturb(jm.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    want = jm.apply(params, jnp.asarray(x))
    pm = bridge(tl.TemporalSelfAttention(c, heads, c // heads), params, attn_keys)
    np.testing.assert_allclose(pm(t(x)).detach().numpy(), np.asarray(want), atol=ATOL)


def test_vae_attention():
    rng = np.random.default_rng(3)
    b, h, w, c = 2, 6, 5, 16
    x = rng.normal(size=(b, h, w, c)).astype(np.float32)
    jm = JVAEAttention(groups=4)
    params = perturb(jm.init(jax.random.PRNGKey(2), jnp.asarray(x)))
    want = jm.apply(params, jnp.asarray(x))

    def keys(key):
        path, tf = tj.map_vae_key("encoder.mid_block.attentions.0." + key)
        return path[2:], tf  # drop ("encoder", "mid_attn")

    pm = bridge(VAEAttention(c, groups=4), params, keys)
    got = pm(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("hierarchical", [True, False])
@pytest.mark.parametrize("cfg_split", [True, False])
def test_audio_block(hierarchical, cfg_split):
    """Masked 3-branch audio cross-attention (or the single branch). With
    cfg_split the uncond half is the zero_conv(mask x bo) term, which the
    perturbed to_out and zero_conv biases make visible."""
    rng = np.random.default_rng(6)
    bf, l, c, t_a, da, heads = 4, 12, 16, 3, 6, 2
    x = rng.normal(size=(bf, l, c)).astype(np.float32)
    audio = rng.normal(size=(bf, t_a, da)).astype(np.float32)
    masks = [(rng.uniform(size=(bf, l)) > 0.4).astype(np.float32) for _ in range(3)]
    scale = np.array([1.3, 0.7, 0.4], np.float32)
    jm = JAudioBlock(heads, c // heads, hierarchical=hierarchical, cfg_split=cfg_split)
    args = [jnp.asarray(a) for a in (x, audio, *masks, scale)]
    params = perturb(jm.init(jax.random.PRNGKey(4), *args))
    want = jm.apply(params, *args)
    pm = bridge(AudioTransformerBlock(c, heads, c // heads, da, hierarchical), params,
                lambda k: tj._map_transformer_block(k, ()))
    got = pm(t(x), t(audio), *map(t, masks), t(scale), cfg_split=cfg_split)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("inflated", [False, True])
def test_group_norm(inflated):
    rng = np.random.default_rng(4)
    x = (2.0 + rng.normal(size=(2, 3, 5, 4, 8))).astype(np.float32)  # (B, F, H, W, C)
    scale = (1 + 0.3 * rng.normal(size=8)).astype(np.float32)
    bias = rng.normal(size=8).astype(np.float32)
    xj = jnp.asarray(x if inflated else x.reshape(6, 5, 4, 8))
    want = np.asarray(jl.group_norm(xj, jnp.asarray(scale), jnp.asarray(bias), 4, 1e-6))
    if inflated:
        got = tl.group_norm(t(x).permute(0, 1, 4, 2, 3), t(scale), t(bias), 4, 1e-6,
                            channel_dim=2).permute(0, 1, 3, 4, 2)
    else:
        got = tl.group_norm(t(x).reshape(6, 5, 4, 8).permute(0, 3, 1, 2), t(scale), t(bias),
                            4, 1e-6).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want.reshape(got.shape), atol=ATOL)


def test_layer_norm_one_pass():
    """|mean| >> std: the one-pass variance E[x^2] - E[x]^2 cancels, which
    multiplies fp32 rounding by E[x^2] / var = 65 here -- both sides do it,
    in another summation order, so the tolerance is 65x wider than ATOL's
    basis (6e-8 relative per sum): 1e-4."""
    rng = np.random.default_rng(5)
    x = (4.0 + 0.5 * rng.normal(size=(3, 7, 24))).astype(np.float32)
    jm = jl.LayerNorm()
    params = perturb(jm.init(jax.random.PRNGKey(3), jnp.asarray(x)))
    want = jm.apply(params, jnp.asarray(x))
    pm = bridge(tl.LayerNorm(24), params, lambda k: tj._map_norm(k, ()))
    np.testing.assert_allclose(pm(t(x)).detach().numpy(), np.asarray(want), atol=1e-4)
    # ... and at zero mean it is the same estimator to fp32 summation order
    z = x - 4.0
    np.testing.assert_allclose(pm(t(z)).detach().numpy(),
                               np.asarray(jm.apply(params, jnp.asarray(z))), atol=ATOL)


def test_embeddings_match():
    ts = np.array([0.0, 3.0, 999.0], np.float32)
    want = jl.timestep_embedding(jnp.asarray(ts), 32)
    got = tl.timestep_embedding(t(ts), 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(
        tl.sinusoidal_positions(32, 16).numpy(),
        np.asarray(jl.sinusoidal_positions(32, 16)), atol=1e-6,
    )
