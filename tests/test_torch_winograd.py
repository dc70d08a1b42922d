"""hallo_tpu_torch's Winograd conv (K8) and layout anchor (K9) against the JAX
package's, on the CPU.

The port's plain versions take the same numpy inputs as the JAX functions:
`winograd_conv3x3` in Pallas interpret mode, `_wino_bwd` (XLA
convolutions), and `layout_anchor` with its `pl.pallas_call` run in
interpret mode (the `pl` name the JAX module looks up is replaced inside
the test only). fp32 throughout: relative L2 1e-5 for the conv (the
threshold of tests/test_winograd.py; only the summation order differs),
atol 2e-3 / rtol 1e-3 for the gradients (tests/test_winograd.py's), bit
for bit for the copy.

The CUDA kernels against their plain versions are in test_torch_kernels.py.
"""

import functools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from hallo_tpu.ops import layout as jax_layout
from hallo_tpu.ops import pallas_winograd as pw
from hallo_tpu_torch.ops import _build, layout, winograd


def _inputs(shape, cout, seed):
    """x ~ N(0, 1), a kernel ~ N(0, 1) / 30, a non-zero bias, as numpy."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    k = (rng.normal(size=(3, 3, shape[-1], cout)) / 30).astype(np.float32)
    bias = rng.normal(size=(cout,)).astype(np.float32)
    return x, k, bias


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def test_winograd_weights_match_jax():
    _, k, _ = _inputs((1, 2, 2, 24), 40, seed=0)
    got = winograd.winograd_weights(torch.from_numpy(k)).numpy()
    want = np.asarray(pw.winograd_weights(jnp.asarray(k)))
    assert got.shape == want.shape == (16, 24, 40)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize(
    "shape,cout",
    [((1, 16, 32, 64), 64), ((2, 32, 32, 24), 40), ((1, 16, 64, 40), 40)],
    ids=["square", "batch2", "non_square"],
)
def test_plain_matches_pallas_interpret(shape, cout):
    x, k, bias = _inputs(shape, cout, seed=sum(shape))
    assert pw.winograd_eligible(shape, k.shape, (1, 1), 1)
    want = pw.winograd_conv3x3(jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias),
                               interpret=True)
    got = winograd.winograd_conv3x3(*(torch.from_numpy(a) for a in (x, k, bias)))
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _rel(got.numpy(), want) < 1e-5


@pytest.mark.parametrize(
    "shape,cout",
    [((2, 4, 6, 5), 7), ((1, 2, 2, 3), 4), ((2, 8, 10, 33), 70)],
    ids=["H_ne_W", "one_tile", "odd_channels"],
)
def test_plain_matches_direct_conv(shape, cout):
    """The port's own eligibility at shapes JAX rejects: H and W only one or
    a few tiles wide (every tile touches the pad-1 border), non-square,
    channel counts that are not multiples of 8; a non-zero bias."""
    x, k, bias = (torch.from_numpy(a) for a in _inputs(shape, cout, seed=1))
    got = winograd.winograd_conv3x3(x, k, bias)
    want = winograd.conv3x3_direct(x, k, bias)
    assert got.shape == (*shape[:3], cout)
    assert _rel(got.numpy(), want.numpy()) < 1e-5
    assert not torch.equal(got, winograd.winograd_conv3x3(x, k))  # the bias counts


def test_plain_rounds_u_to_x_dtype(monkeypatch):
    """bf16 x: U is rounded to bf16 as in JAX (`winograd_weights(k).astype(x.dtype)`),
    then the plain version computes in fp32 and returns bf16: the same as
    the fp32 computation from the bf16 values of x and of U."""
    x, k, bias = (torch.from_numpy(a) for a in _inputs((2, 4, 6, 8), 8, seed=2))
    xb = x.to(torch.bfloat16)
    got = winograd.winograd_reference(xb, k, bias)
    assert got.dtype == torch.bfloat16
    unrounded = winograd.winograd_reference(xb.float(), k, bias).to(torch.bfloat16)
    exact = winograd.winograd_weights
    monkeypatch.setattr(winograd, "winograd_weights",
                        lambda kernel: exact(kernel).to(torch.bfloat16).float())
    rounded = winograd.winograd_reference(xb.float(), k, bias).to(torch.bfloat16)
    assert torch.equal(got, rounded) and not torch.equal(got, unrounded)


def test_vjp_matches_jax_backward():
    """`winograd_conv3x3_vjp`'s dx, dk, db against JAX's `_wino_bwd` on the
    same cotangent; its forward is the plain version here."""
    x, k, bias = _inputs((2, 8, 12, 16), 24, seed=3)
    g = np.random.default_rng(4).normal(size=(2, 8, 12, 24)).astype(np.float32)
    want = pw._wino_bwd((jnp.asarray(x), jnp.asarray(k)), jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, k, bias)]
    out = winograd.winograd_conv3x3_vjp(*leaves)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    for name, a, w in zip(("dx", "dk", "db"), got, want):
        assert a.shape == w.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=2e-3, rtol=1e-3, err_msg=name)
    assert winograd.winograd_conv3x3_vjp(leaves[0], leaves[1]).requires_grad  # no bias


def test_eligibility_keeps_jax_rejections():
    k = (3, 3, 320, 320)
    assert not winograd.winograd_eligible((2, 16, 15, 320), k, (1, 1), 1)  # odd W
    assert not winograd.winograd_eligible((2, 15, 16, 320), k, (1, 1), 1)  # odd H
    assert not winograd.winograd_eligible((2, 16, 64, 320), k, (2, 2), 1)  # strided
    assert not winograd.winograd_eligible((2, 16, 64, 320), k, (1, 1), 0)  # pad 0
    assert not winograd.winograd_eligible((2, 16, 64, 320), (1, 1, 320, 320), (1, 1), 1)
    assert not winograd.winograd_eligible((2, 16, 64, 320), (3, 3, 64, 320), (1, 1), 1)
    with pytest.raises(ValueError):
        winograd.winograd_conv3x3(torch.zeros(1, 4, 5, 8), torch.zeros(3, 3, 8, 8))


@pytest.mark.parametrize(
    "shape,kshape,rule",
    [((2, 18, 64, 320), (3, 3, 320, 320), "H % 2TR"),
     ((2, 64, 64, 960), (3, 3, 960, 320), "VMEM budget for U"),
     ((32, 64, 64, 640), (3, 3, 640, 320), "VMEM budget for U"),  # the denoiser's level-0 up
     ((2, 16, 14, 320), (3, 3, 320, 320), "128 % (W/2)"),  # JAX's test calls it odd W
     ((2, 16, 24, 40), (3, 3, 40, 48), "128 % (W/2), W >= 16")],
    ids=["h_multiple", "vmem_budget", "vmem_budget_l0_up", "half_width_7", "half_width_12"],
)
def test_eligibility_drops_tpu_only_rules(shape, kshape, rule):
    """Named divergence (ROADMAP Queue 3): JAX's Mosaic limits do not apply
    on the card; the port accepts these shapes, JAX does not."""
    assert not pw.winograd_eligible(shape, kshape, (1, 1), 1), rule
    assert winograd.winograd_eligible(shape, kshape, (1, 1), 1), rule


def test_eligibility_accepts_every_shape_jax_accepts():
    """Every shape tests/test_winograd.py and this file run through JAX's
    kernel, and the three of the denoiser's five 3x3 shapes that JAX takes
    (its budget for U rejects level 0's C 640 and 960 -> 320)."""
    for shape, cout in [((2, 16, 64, 320), 320), ((2, 64, 64, 320), 320),
                        ((1, 32, 32, 640), 640), ((1, 16, 64, 64), 64), ((1, 16, 32, 64), 64),
                        ((2, 32, 32, 24), 40), ((1, 16, 64, 40), 40),
                        ((32, 64, 64, 320), 320), ((32, 32, 32, 640), 640),
                        ((32, 32, 32, 1280), 640)]:
        kshape = (3, 3, shape[-1], cout)
        assert pw.winograd_eligible(shape, kshape, (1, 1), 1), shape
        assert winograd.winograd_eligible(shape, kshape, (1, 1), 1), shape


def _jax_layout_anchor(x, monkeypatch):
    interpret = types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True), BlockSpec=pl.BlockSpec)
    monkeypatch.setattr(jax_layout, "pl", interpret)
    return np.asarray(jax_layout.layout_anchor(jnp.asarray(x)))


@pytest.mark.parametrize(
    "shape,dtype",
    [((7,), np.float32), ((64, 24), np.float32), ((4, 96, 20), np.float32),
     ((1500, 8), np.float32), ((33, 16), jnp.bfloat16)],
    ids=["ndim1", "ndim2", "ndim3", "ragged_rows", "bf16"],
)
def test_layout_anchor_matches_pallas_interpret(shape, dtype, monkeypatch):
    """Bit for bit. 1500 rows are no multiple of the 1024-row block: JAX's
    kernel takes 750-row blocks, the port's copy needs no divisor."""
    x = np.random.default_rng(5).normal(size=shape).astype(dtype)
    want = _jax_layout_anchor(x, monkeypatch)
    tx = torch.from_numpy(x.astype(np.float32))
    if dtype != np.float32:
        tx = tx.to(torch.bfloat16)
    got = layout.layout_anchor(tx)
    assert got.shape == tx.shape and got.dtype == tx.dtype and got.is_contiguous()
    np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32))
    assert (got is tx) == (len(shape) < 2)


def test_layout_anchor_plain_is_a_fresh_contiguous_copy():
    x = torch.randn(6, 10).t()
    got = layout.layout_anchor(x)
    assert torch.equal(got, x) and got.is_contiguous() and got.data_ptr() != x.data_ptr()
    y = torch.randn(4, 5, requires_grad=True)
    layout.layout_anchor(y).sum().backward()  # the plain copy carries the gradient
    assert torch.equal(y.grad, torch.ones(4, 5))


def test_cpu_wrappers_do_not_launch():
    before = {**winograd.LAUNCHES, **layout.LAUNCHES}
    x, k, bias = (torch.from_numpy(a) for a in _inputs((1, 4, 4, 8), 8, seed=6))
    winograd.winograd_conv3x3(x, k, bias)
    winograd.winograd_conv3x3_vjp(x.requires_grad_(), k, bias).sum().backward()
    layout.layout_anchor(torch.randn(5, 3))
    assert {**winograd.LAUNCHES, **layout.LAUNCHES} == before


@pytest.mark.parametrize("call", [
    lambda x, k: winograd.winograd_conv3x3(x, k),
    lambda x, k: winograd.winograd_conv3x3(x, k, torch.zeros(8, device="meta")),
    lambda x, k: layout.layout_anchor(x),
], ids=["winograd_conv3x3", "winograd_conv3x3_bias", "layout_anchor"])
def test_kernel_wrappers_have_no_cpu_fallback(call):
    """A tensor that is not on the CPU never takes the plain version (meta
    tensors stand in for the card's: the checks come before any launch).
    With a gradient to take, the forward-only kernels raise first; under
    no_grad the device check raises."""
    x = torch.empty(2, 4, 6, 8, device="meta", requires_grad=True)
    k = torch.empty(3, 3, 8, 8, device="meta")
    with pytest.raises(RuntimeError, match="no backward"):
        call(x, k)
    with torch.no_grad(), pytest.raises(ValueError):
        call(x, k)


def test_vjp_has_no_cpu_fallback():
    """The differentiable entry launches the kernel off the CPU, whatever
    needs a gradient: on a meta tensor it raises at the device check."""
    x = torch.empty(2, 4, 6, 8, device="meta", requires_grad=True)
    k = torch.empty(3, 3, 8, 8, device="meta", requires_grad=True)
    with pytest.raises(ValueError):
        winograd.winograd_conv3x3_vjp(x, k, torch.zeros(8, device="meta"))


def test_use_winograd_reads_the_switch(monkeypatch):
    monkeypatch.delenv("HALLO_WINOGRAD", raising=False)
    assert not winograd.use_winograd() and not pw.use_winograd()
    monkeypatch.setenv("HALLO_WINOGRAD", "1")
    assert winograd.use_winograd() and pw.use_winograd()


def test_new_kernels_are_built_sources():
    """`python3 chip_smoke.py` alone builds them: both sources are in
    `_build.SOURCES`, and each entry point's source exists under csrc/."""
    assert {"winograd", "layout_copy"} <= set(_build.SOURCES)
    for src, _, _ in _build.ENTRY_POINTS.values():
        assert _build._target(src)[0].endswith(f"csrc/{src}.cu")
