"""Nested per-layer checkpointing (`UNetConfig.remat_inner`) and the chunked
feed-forward (`FeedForward.chunks`) of the port, on the CPU in fp32.

Checkpointing changes what is kept for the backward pass, not the math: the
stage-2 step at the tiny widths (64x64, 2 + 2 frames, B 1) with per-block
and per-layer checkpointing gives the plain step's loss (relative 1e-6) and
every trainable gradient (relative L2 1e-5). `FeedForward(chunks=4)` equals
the unchunked one and JAX's `FeedForward(chunks=4)` on the same weights
(1e-6). The recomputation is counted: under `remat_inner` each checkpointed
sub-layer runs once more than under the per-block checkpoint alone. The JAX side runs
as tests/test_remat_inner.py runs it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hallo_tpu.models.layers import FeedForward as JaxFeedForward
from hallo_tpu_torch.config import DotDict
from hallo_tpu_torch.convert import keymaps as km
from hallo_tpu_torch.convert.from_jax import state_dict_from_jax
from hallo_tpu_torch.models.layers import FeedForward
from hallo_tpu_torch.train import state as tstate
from hallo_tpu_torch.train import step as tstep
from hallo_tpu_torch.train.loop import checkpointing
from hallo_tpu_torch.utils.factory import build_models

H = W = 64
F, M, B = 2, 2, 1
LOSS_RTOL = 1e-6
GRAD_RTOL = 1e-5
FF_ATOL = 1e-6
NO_DROPOUT = dict(uncond_img_ratio=0.0, uncond_audio_ratio=0.0, uncond_ia_ratio=0.0,
                  start_ratio=0.0)


def perturbed_models(**unet_overrides):
    """The tiny models with every bias N(0, 0.5) and every other parameter
    moved by N(0, 0.02) (zero-initialised layers would zero the gradient of
    everything before them), the same for every call."""
    models = build_models("tiny", device="cpu", seed=0, unet_overrides=unet_overrides)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for module in models.modules().values():
            for name, p in module.named_parameters():
                noise = torch.randn(p.shape, generator=gen)
                if name.endswith("bias"):
                    p.copy_(0.5 * noise)
                else:
                    p.add_(0.02 * noise)
    return models


def batch():
    rng = np.random.default_rng(3)
    hl = H // 8
    return dict(
        pixel_values=rng.uniform(-1, 1, (B, F, H, W, 3)).astype(np.float32),
        ref_pixels=rng.uniform(-1, 1, (B, H, W, 3)).astype(np.float32),
        motion_pixels=rng.uniform(-1, 1, (B, M, H, W, 3)).astype(np.float32),
        audio_windows=rng.normal(size=(B, F, 3, 2, 4)).astype(np.float32),
        face_emb=rng.normal(size=(B, 16)).astype(np.float32),
        face_region=rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32),
        masks=tuple(tuple((rng.uniform(size=(B, (hl >> d) ** 2)) > 0.3).astype(np.float32)
                          for _ in range(3)) for d in range(4)),
        timesteps=np.full((B,), 321, np.int32),
    )


def loss_and_grads(models):
    trainable = tstate.unfreeze(models.modules(), tstate.stage2_trainable)
    loss = tstep.make_loss_fn(models, tstep.TrainConfig(**NO_DROPOUT))(
        batch(), tstep.step_generator(0, 0, "cpu"))
    names = list(trainable)
    grads = torch.autograd.grad(loss, [trainable[n] for n in names])
    return loss.item(), dict(zip(names, grads))


def test_stage2_step_with_remat_inner_matches_plain():
    """The loss and every trainable gradient with both checkpoints equal the
    plain step's."""
    loss0, g0 = loss_and_grads(perturbed_models(remat=False, remat_inner=False))
    nested = perturbed_models(remat=True, remat_inner=True)
    assert nested.denoising_net.config.remat_inner
    loss1, g1 = loss_and_grads(nested)
    assert np.isfinite(loss0)
    np.testing.assert_allclose(loss1, loss0, rtol=LOSS_RTOL)
    assert g0.keys() == g1.keys()
    nonzero = 0
    for name, g in g0.items():
        if not g.any():  # the one-token attentions of the mid block, by construction
            assert not g1[name].any(), name
            continue
        nonzero += 1
        err = float((g1[name] - g).norm() / g.norm())
        assert err <= GRAD_RTOL, (name, err)
    assert nonzero > 0.9 * len(g0)


def _count_calls(models):
    """Run one loss and backward, counting the calls of sub-layers of the
    denoiser's last up block (a block that the backward passes through):
    its first resnet and motion module (sub-layers of the block), and that
    motion module's first temporal attention and feed-forward (sub-layers
    of the motion module), and the feed-forward's GEGLU."""
    block = models.denoising_net.up_blocks[-1]
    motion = block.motion_modules[0]
    temporal = motion.temporal_transformer.transformer_blocks[0]
    picked = dict(resnet=block.resnets[0], motion=motion,
                  attention=temporal.attention_blocks[0], ff=temporal.ff,
                  geglu=temporal.ff.net[0])
    counts = dict.fromkeys(picked, 0)
    for name, module in picked.items():
        module.register_forward_pre_hook(
            lambda *_, name=name: counts.__setitem__(name, counts[name] + 1))
    loss_and_grads(models)
    return counts


def test_remat_inner_runs_each_sub_layer_once_more():
    """Per-block checkpointing runs each sub-layer twice in a step: the
    forward and the block's replay. `remat_inner` adds one replay of each
    checkpointed sub-layer: the resnet, the temporal attention and the
    feed-forward run 3 times, the motion module (no checkpoint of its own)
    still 2. The motion feed-forward's 4 chunks run in each of its 3 calls,
    but the last chunk not in the feed-forward's own replay (the replay
    stops once the last chunk's input is recomputed: the checkpoints' early
    stop), and once more each in their own replays."""
    assert _count_calls(perturbed_models(remat=True)) == dict(
        resnet=2, motion=2, attention=2, ff=2, geglu=2)
    assert _count_calls(perturbed_models(remat=True, remat_inner=True)) == dict(
        resnet=3, motion=2, attention=3, ff=3, geglu=3 * 4 - 1 + 4)


def test_remat_inner_chunks_the_motion_feed_forward():
    models = perturbed_models(remat=True, remat_inner=True)
    plain = perturbed_models(remat=True)
    for blocks, n in ((models, 4), (plain, 1)):
        ffs = [m.ff for m in blocks.denoising_net.modules()
               if type(m).__name__ == "_TemporalBlock"]
        assert ffs and all(ff.chunks == n for ff in ffs)
    # the spatial transformers' feed-forwards are not chunked
    assert all(m.chunks == 1 for m in models.denoising_net.modules()
               if isinstance(m, FeedForward) and m not in
               {b.ff for b in models.denoising_net.modules()
                if type(b).__name__ == "_TemporalBlock"})


def _jax_ff_and_port(dim=16, seed=0):
    x = np.random.default_rng(seed).normal(size=(2, 3, 8, dim)).astype(np.float32)
    params = JaxFeedForward(dim, dtype=jnp.float32).init(jax.random.PRNGKey(seed),
                                                         jnp.asarray(x))
    # every bias moved, so that a bias lost in the chunked path shows
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: a + 0.3 * jax.random.normal(jax.random.PRNGKey(len(path)), a.shape)
        if getattr(path[-1], "key", "") == "bias" else a, params)
    ports = []
    for chunks in (1, 4):
        ff = FeedForward(dim, chunks=chunks)
        ff.load_state_dict(state_dict_from_jax(ff, params, lambda k: km._map_ff(k, ())))
        ports.append(ff)
    return x, params, ports


def test_feedforward_chunks_match_unchunked_and_jax():
    """chunks=4 against chunks=1 (output and every parameter gradient) and
    against JAX's FeedForward(chunks=4) on the same weights."""
    x, params, (plain, chunked) = _jax_ff_and_port()
    want = np.asarray(JaxFeedForward(16, dtype=jnp.float32, chunks=4).apply(
        params, jnp.asarray(x)))
    xt = torch.from_numpy(x)
    y_plain, y_chunked = plain(xt), chunked(xt)
    np.testing.assert_allclose(y_chunked.detach().numpy(), y_plain.detach().numpy(),
                               atol=FF_ATOL)
    np.testing.assert_allclose(y_chunked.detach().numpy(), want, atol=FF_ATOL)
    (y_plain ** 2).sum().backward()
    (y_chunked ** 2).sum().backward()
    for (name, a), (_, b) in zip(plain.named_parameters(), chunked.named_parameters()):
        torch.testing.assert_close(b.grad, a.grad, atol=1e-5, rtol=1e-5, msg=name)


def test_feedforward_runs_unchunked_where_it_cannot_split(monkeypatch):
    """An axis that does not divide by 4, or an input of one axis: the
    unchunked path, bit for bit, with no checkpoint."""
    from hallo_tpu_torch.models import layers

    x, params, (plain, chunked) = _jax_ff_and_port()
    calls = []
    monkeypatch.setattr(layers, "checkpoint",
                        lambda *a, **kw: calls.append(1) or a[0](*a[1:]))
    for z in (x[:, :, :7], x[0, 0, 0]):
        zt = torch.from_numpy(np.ascontiguousarray(z))
        assert torch.equal(chunked(zt), plain(zt))
    assert calls == []
    chunked(torch.from_numpy(x))
    assert len(calls) == 4


@pytest.mark.parametrize("solver,want", [
    (dict(gradient_checkpointing=True), dict(remat=True, remat_inner=True)),
    (dict(gradient_checkpointing=True, gradient_checkpointing_inner=False),
     dict(remat=True, remat_inner=False)),
    (dict(gradient_checkpointing=False, gradient_checkpointing_inner=True),
     dict(remat=False, remat_inner=False)),
    (dict(), dict(remat=False, remat_inner=False)),
])
def test_trainers_read_the_solver_keys_as_jax(solver, want):
    """`gradient_checkpointing_inner` defaults to true under
    `gradient_checkpointing` (scripts/train_stage2.py:64-77)."""
    assert checkpointing(DotDict.wrap(solver)) == want
