"""The port's nearest-2x + 3x3 up-conv (`models/layers.py`: the fused
low-resolution form `fused_up2x_conv3x3` by default, HALLO_FUSED_UPSAMPLE=0
the interpolate-then-conv form) against JAX's `Up2xConv` in both its forms,
on the CPU, at tests/test_fused_upsample.py's shapes, with a perturbed bias:

- outputs in fp32 within rtol/atol 2e-5 (the tap sums reassociate);
- gradients of sum(sin(y)) for the weight, the bias and the input within
  rtol/atol 5e-5 (test_fused_upsample.py's gradient tolerance);
- one bf16 case, fused against JAX's fused in bf16: both sum the taps in
  bf16 and round the output to bf16, so they agree within 2 bf16 ulps of the
  output's largest value (atol 2**-7 x max |y|);
- HALLO_FUSED_UPSAMPLE is read at call time, "1" by default; the parameters
  stay `conv.weight` / `conv.bias`;
- a tiny denoiser with per-block checkpointing takes its gradient through
  the fused form, matching the plain form's.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hallo_tpu.models.layers import Up2xConv
from hallo_tpu_torch.models import layers
from hallo_tpu_torch.models.layers import Upsample2x

SHAPES = [((2, 5, 7, 6), 4), ((1, 8, 8, 3), 3)]
ATOL = RTOL = 2e-5
GRAD_TOL = 5e-5


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for the port's CPU runs here: the suite runs
    these files beside five other workers, where torch's default of one
    thread a core oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def set_form(monkeypatch, fused: bool) -> None:
    monkeypatch.setenv("HALLO_FUSED_UPSAMPLE", "1" if fused else "0")


def jax_params(x_nhwc: np.ndarray, features: int, seed: int = 0):
    """Up2xConv's initial parameters with a random (not zero) bias."""
    params = Up2xConv(features, dtype=jnp.float32).init(jax.random.PRNGKey(seed),
                                                         jnp.asarray(x_nhwc))
    bias = np.random.default_rng(seed + 7).normal(size=(features,)).astype(np.float32)
    return {"params": {"Conv_0": {"kernel": params["params"]["Conv_0"]["kernel"],
                                  "bias": jnp.asarray(bias)}}}


def jax_apply(params, x_nhwc, features: int, fused: bool, dtype=jnp.float32):
    saved = os.environ.get("HALLO_FUSED_UPSAMPLE")
    os.environ["HALLO_FUSED_UPSAMPLE"] = "1" if fused else "0"
    try:
        return Up2xConv(features, dtype=dtype).apply(params, x_nhwc)
    finally:
        if saved is None:
            os.environ.pop("HALLO_FUSED_UPSAMPLE", None)
        else:
            os.environ["HALLO_FUSED_UPSAMPLE"] = saved


def port_module(params, c: int, features: int, dtype=torch.float32) -> Upsample2x:
    up = Upsample2x(c)
    up.conv = torch.nn.Conv2d(c, features, 3, padding=1)
    kernel = np.asarray(params["params"]["Conv_0"]["kernel"])  # (3, 3, C, F)
    with torch.no_grad():
        up.conv.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()))
        up.conv.bias.copy_(torch.from_numpy(np.array(params["params"]["Conv_0"]["bias"])))
    return up.to(dtype)


def nchw(x_nhwc: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x_nhwc.transpose(0, 3, 1, 2).copy())


@pytest.mark.parametrize("jax_fused", [True, False], ids=["jax_fused", "jax_plain"])
@pytest.mark.parametrize("port_fused", [True, False], ids=["port_fused", "port_plain"])
@pytest.mark.parametrize("shape,features", SHAPES)
def test_upconv_matches_jax(monkeypatch, shape, features, port_fused, jax_fused):
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    params = jax_params(x, features)
    want = np.asarray(jax_apply(params, jnp.asarray(x), features, jax_fused))
    set_form(monkeypatch, port_fused)
    got = port_module(params, shape[-1], features)(nchw(x)).detach().numpy()
    assert got.shape == (shape[0], features, 2 * shape[1], 2 * shape[2])
    np.testing.assert_allclose(got.transpose(0, 2, 3, 1), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "plain"])
def test_upconv_gradients_match_jax(monkeypatch, fused):
    x = np.random.default_rng(2).normal(size=(1, 4, 6, 3)).astype(np.float32)
    params = jax_params(x, 4, seed=3)

    def loss(p, xx):
        return jnp.sum(jnp.sin(jax_apply(p, xx, 4, fused)))

    g_params, g_x = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    set_form(monkeypatch, fused)
    up = port_module(params, 3, 4)
    xt = nchw(x).requires_grad_(True)
    torch.sin(up(xt)).sum().backward()
    kernel_grad = np.asarray(g_params["params"]["Conv_0"]["kernel"]).transpose(3, 2, 0, 1)
    np.testing.assert_allclose(up.conv.weight.grad.numpy(), kernel_grad,
                               rtol=GRAD_TOL, atol=GRAD_TOL)
    np.testing.assert_allclose(up.conv.bias.grad.numpy(),
                               np.asarray(g_params["params"]["Conv_0"]["bias"]),
                               rtol=GRAD_TOL, atol=GRAD_TOL)
    np.testing.assert_allclose(xt.grad.numpy().transpose(0, 2, 3, 1), np.asarray(g_x),
                               rtol=GRAD_TOL, atol=GRAD_TOL)


def test_upconv_bf16_matches_jax_fused(monkeypatch):
    x = np.random.default_rng(4).normal(size=(2, 8, 8, 16)).astype(np.float32)
    params = jax_params(x, 16, seed=5)
    want = np.asarray(jax_apply(params, jnp.asarray(x), 16, True, dtype=jnp.bfloat16)
                      .astype(jnp.float32))
    set_form(monkeypatch, True)
    up = port_module(params, 16, 16, dtype=torch.bfloat16)
    got = up(nchw(x).to(torch.bfloat16)).float().detach().numpy().transpose(0, 2, 3, 1)
    atol = 2.0 ** -7 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def test_form_is_read_at_call_time(monkeypatch):
    calls = []
    fused = layers.fused_up2x_conv3x3
    monkeypatch.setattr(layers, "fused_up2x_conv3x3",
                        lambda *a: calls.append(1) or fused(*a))
    up = Upsample2x(3)
    x = torch.randn(1, 3, 4, 4)
    monkeypatch.delenv("HALLO_FUSED_UPSAMPLE", raising=False)
    a = up(x)
    assert len(calls) == 1
    set_form(monkeypatch, False)
    b = up(x)
    assert len(calls) == 1
    torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
    assert set(up.state_dict()) == {"conv.weight", "conv.bias"}


def test_remat_denoiser_gradient_through_fused_form(monkeypatch):
    """A tiny denoiser with per-block checkpointing: the gradients of the
    fused and the plain form agree (fp32), so training, its replays and the
    parameter tree are the same with either."""
    from hallo_tpu_torch.utils.factory import build_models

    models = build_models("tiny", device="cpu", remat=True, seed=1)
    den = models.denoising_net.requires_grad_(True)
    assert any(name.endswith("upsamplers.0.conv.weight") for name, _ in den.named_parameters())
    gen = torch.Generator().manual_seed(0)
    f, hw = 4, 8
    sample = torch.randn((1, f, 4, hw, hw), generator=gen)
    ctx = torch.randn((1, 4, 12), generator=gen)

    def grads(fused: bool):
        set_form(monkeypatch, fused)
        den.zero_grad()
        out = den(sample, torch.tensor(300), ctx, train=True)
        (out.float() ** 2).mean().backward()
        return {n: p.grad.clone() for n, p in den.named_parameters() if p.grad is not None}

    g_fused, g_plain = grads(True), grads(False)
    assert g_fused.keys() == g_plain.keys() and len(g_fused) > 10
    for name in g_fused:
        torch.testing.assert_close(g_fused[name], g_plain[name], rtol=1e-4, atol=1e-6,
                                   msg=name)
