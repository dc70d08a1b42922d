"""hallo_tpu_torch attention ops against hallo_tpu's Pallas kernels.

The port's CPU path (the plain PyTorch version of each kernel) is held
against the JAX kernels run in Pallas interpret mode, in fp32, on the same
numpy inputs: K1 (`flash_attention_packed`), K4 (`flash_attention`, the
straight d % 128 == 0 path), K3 (`flash_attention` at d % 128 != 0, the
transposed path) and K2 (`temporal_attention`, after the (B, F, C, L) <->
(B, F, L, C) transpose). fp32 throughout, so the tolerance is summation
order: atol 2e-5. K6's plain version is held against its Pallas kernel in
test_torch_audio.py.

The CUDA kernels against their plain versions are in test_torch_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from hallo_tpu.ops import pallas_flash, pallas_temporal
from hallo_tpu_torch.ops import attention, flash, temporal

ATOL = 2e-5


def _normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize(
    "b,lq,lk,heads,d,masked",
    [
        (2, 100, 150, 2, 40, False),   # SD head dim 40, ragged Lq and Lk
        (1, 130, 260, 2, 80, False),   # d 80, ref-concat Lk = 2 Lq
        (2, 256, 32, 2, 40, False),    # audio cross-attention, 32 tokens
        (2, 256, 4, 2, 40, False),     # identity cross-attention, 4 tokens
        (2, 100, 150, 2, 40, True),    # per-key bias masking the ref tokens
    ],
)
def test_plain_flash_packed_matches_pallas(b, lq, lk, heads, d, masked):
    rng = np.random.default_rng(lq + lk + d)
    c = heads * d
    q, k, v = _normal(rng, b, lq, c), _normal(rng, b, lk, c), _normal(rng, b, lk, c)
    bias = None
    if masked:
        bias = np.zeros((b, lk), np.float32)
        bias[0, lk // 2:] = -1e9
        bias[1] = rng.normal(size=lk)  # a non-zero bias on every key
    with pltpu.force_tpu_interpret_mode():
        want = pallas_flash.flash_attention_packed(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads=heads,
            bias=None if bias is None else jnp.asarray(bias),
        )
    got = flash.flash_attention_packed(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), heads=heads,
        bias=None if bias is None else torch.from_numpy(bias),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("lq,lk", [(128, 128), (100, 72)])
def test_plain_flash_heads_major_d512_matches_pallas(lq, lk):
    """K4: one head of d = 512 (the VAE mid-block attention)."""
    rng = np.random.default_rng(lq)
    q, k, v = _normal(rng, 2, 1, lq, 512), _normal(rng, 2, 1, lk, 512), _normal(rng, 2, 1, lk, 512)
    with pltpu.force_tpu_interpret_mode():
        want = pallas_flash.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = flash.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    # the dispatch takes the same plain math on the CPU
    via = attention.dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v)
    )
    np.testing.assert_allclose(via.numpy(), got.numpy(), atol=0)


@pytest.mark.parametrize("lq,lk,masked", [(304, 304, False), (300, 260, True)])
def test_plain_flash_heads_major_d64_matches_pallas_transposed(lq, lk, masked):
    """K3: 12 heads of d = 64 (the wav2vec2 self-attention), which JAX sends
    to the transposed kernel; ragged lengths and a per-key bias."""
    rng = np.random.default_rng(lq + lk)
    q, k, v = _normal(rng, 1, 12, lq, 64), _normal(rng, 1, 12, lk, 64), _normal(rng, 1, 12, lk, 64)
    bias = None
    if masked:
        bias = rng.normal(size=(1, lk)).astype(np.float32)
        bias[:, lk // 2:] = -1e9
    with pltpu.force_tpu_interpret_mode():
        want = pallas_flash.flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            bias=None if bias is None else jnp.asarray(bias))
    got = flash.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                bias=None if bias is None else torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("b,f,heads,d,l", [(1, 6, 2, 8, 256), (2, 18, 2, 16, 200)])
def test_plain_temporal_matches_pallas(b, f, heads, d, l):
    rng = np.random.default_rng(f + d + l)
    c = heads * d
    q, k, v = (_normal(rng, b, f, l, c) for _ in range(3))

    def site_major(x):  # (B, F, L, C) -> (B, F, C, L)
        return jnp.asarray(np.ascontiguousarray(np.swapaxes(x, 2, 3)))

    with pltpu.force_tpu_interpret_mode():
        want = pallas_temporal.temporal_attention(
            site_major(q), site_major(k), site_major(v), heads=heads, block_l=128
        )
    got = temporal.temporal_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), heads=heads
    )
    np.testing.assert_allclose(got.numpy(), np.swapaxes(np.asarray(want), 2, 3), atol=3e-5)


def test_cpu_wrappers_do_not_launch():
    """On the CPU the wrappers take the plain version and count nothing."""
    before = {**flash.LAUNCHES, **temporal.LAUNCHES}
    x = torch.randn(1, 300, 16)
    flash.flash_attention_packed(x, x, x, heads=2)
    flash.flash_attention(x[:, None], x[:, None], x[:, None])
    t = torch.randn(1, 4, 9, 16)
    temporal.temporal_attention(t, t, t, heads=2)
    assert {**flash.LAUNCHES, **temporal.LAUNCHES} == before


def test_kernel_wrappers_reject_non_cuda_devices():
    """A tensor that is not on the CPU never takes the plain version: the
    wrapper checks it for the kernel and raises."""
    x = torch.empty(1, 300, 80, device="meta")
    with pytest.raises(ValueError):
        flash.flash_attention_packed(x, x, x, heads=2)
    t = torch.empty(1, 4, 9, 16, device="meta")
    with pytest.raises(ValueError):
        temporal.temporal_attention(t, t, t, heads=2)
    h = torch.empty(1, 2, 300, 64, device="meta")
    with pytest.raises(ValueError):
        flash.flash_attention(h, h, h)
    with pytest.raises(ValueError):
        flash.flash_attention_int8(h, h, h)


def _int8_quantized(h):
    q8, k8, qs, ks = flash.quantize_int8(h.detach(), h.detach(), 0.125)
    return flash.flash_int8_quantized(q8, k8, qs, ks, h)


@pytest.mark.parametrize("call,on_cpu", [
    (lambda h: flash.flash_attention(h, h, h), True),
    (lambda h: flash.flash_attention_int8(h, h, h), True),
    (_int8_quantized, False),
    (lambda h: flash.flash_forward_packed(h[:, 0], h[:, 0], h[:, 0], heads=2), False),
], ids=["flash_attention", "flash_attention_int8", "flash_int8_quantized",
        "flash_forward_packed"])
def test_forward_only_kernels_raise_on_a_tensor_that_needs_a_gradient(call, on_cpu):
    """K3/K4, K6 and K1's bare forward have no backward kernel: off the CPU,
    an input that needs a gradient raises instead of returning an output
    autograd does not track (meta tensors stand in for the card's: the
    check comes before any launch). Under no_grad the same call goes on to
    the device checks. On the CPU, the wrappers that have a plain version
    carry the gradient through it."""
    h = torch.empty(1, 2, 300, 64, device="meta", requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        call(h)
    with torch.no_grad(), pytest.raises(ValueError):
        call(h)
    if on_cpu:
        x = torch.randn(1, 2, 30, 64, requires_grad=True)
        call(x).sum().backward()
        assert x.grad is not None and torch.isfinite(x.grad).all()


def test_build_target_covers_shared_headers(tmp_path, monkeypatch):
    """A kernel's build target changes when its source or a shared header
    under csrc/ changes, so that an edited header is rebuilt."""
    from hallo_tpu_torch.ops import _build

    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "_CSRC", str(tmp_path))
    first = _build._target("k")[1]
    assert _build._target("k")[1] == first
    (tmp_path / "common.cuh").write_text("// v2\n")
    second = _build._target("k")[1]
    assert second != first
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n// edited\n')
    assert _build._target("k")[1] not in (first, second)


# K1's LSE output and K5 (the two-pass backward): the port's plain versions
# against the JAX package's own functions in Pallas interpret mode, called
# directly (`_flash_forward_packed(with_lse=True)`, `_flash_backward_packed`)
# and not through jax.grad: no grad transpose runs beside interpret mode's
# callbacks (ROADMAP Queue 3). fp32 throughout. The LSE is a log2 of sums of
# O(1) terms: atol 2e-5 (summation order). The gradients are sums over up to
# 150 keys or 100 queries of O(1) products: atol 1e-4, rtol 1e-4.
K5_CASES = [
    (2, 100, 150, 2, 40, "mask"),    # d 40, ragged Lq and Lk, a bias masking the ref half
    (1, 130, 260, 2, 80, None),      # d 80, ref-concat Lk = 2 Lq, no bias
    (2, 100, 32, 2, 40, None),       # audio cross-attention, ragged Lk 32
    (2, 100, 4, 2, 80, "random"),    # identity cross-attention Lk 4, a bias on every key
]


def _k5_inputs(b, lq, lk, heads, d, bias_kind):
    rng = np.random.default_rng(lq + lk + d)
    c = heads * d
    q, k, v, g = (_normal(rng, b, n, c) for n in (lq, lk, lk, lq))
    bias = None
    if bias_kind == "mask":
        bias = np.zeros((b, lk), np.float32)
        bias[:, lk // 2:] = -1e9
        bias[0, : lk // 2] = rng.normal(size=lk // 2)
    elif bias_kind == "random":
        bias = rng.normal(size=(b, lk)).astype(np.float32)
    return q, k, v, g, bias


def _jax_k5(q, k, v, g, bias, heads, scale):
    jb = None if bias is None else jnp.asarray(bias)
    with pltpu.force_tpu_interpret_mode():
        out, lse = pallas_flash._flash_forward_packed(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jb, heads, scale, 128, 128,
            with_lse=True)
        grads = pallas_flash._flash_backward_packed(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jb, out, lse, jnp.asarray(g),
            heads, scale, 128, 128)
    return np.array(out), np.array(lse[:, :, 0, :]), [np.array(x) for x in grads]


@pytest.mark.parametrize("b,lq,lk,heads,d,bias_kind", K5_CASES)
def test_plain_lse_and_backward_match_pallas(b, lq, lk, heads, d, bias_kind):
    q, k, v, g, bias = _k5_inputs(b, lq, lk, heads, d, bias_kind)
    scale = d ** -0.5
    out, lse, want = _jax_k5(q, k, v, g, bias, heads, scale)
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    tb = None if bias is None else torch.from_numpy(bias)
    got_lse = flash.flash_lse_reference(tq, tk, heads, tb, scale)
    np.testing.assert_allclose(got_lse.numpy(), lse, atol=ATOL)
    got = flash.flash_backward_reference(
        tq, tk, tv, tb, torch.from_numpy(out), torch.from_numpy(lse), tg, heads, scale)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), w, atol=1e-4, rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("b,lq,lk,heads,d,bias_kind", K5_CASES)
def test_flash_packed_autograd_matches_plain_autograd(b, lq, lk, heads, d, bias_kind):
    """`flash_attention_packed` with a gradient to take goes through
    `FlashPackedFn` (the LSE forward and the plain K5 on the CPU); autograd
    through `packed_reference` is the yardstick. The bias gets no gradient."""
    q, k, v, g, bias = _k5_inputs(b, lq, lk, heads, d, bias_kind)
    tb = None if bias is None else torch.from_numpy(bias).requires_grad_()
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = flash.flash_attention_packed(*leaves, heads=heads, bias=tb)
    got = torch.autograd.grad(out, leaves + ([] if tb is None else [tb]), torch.from_numpy(g),
                              allow_unused=True)
    if tb is not None:
        assert got[3] is None
    ref = flash.packed_reference(*leaves, heads, None if tb is None else tb.detach())
    want = torch.autograd.grad(ref, leaves, torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(), atol=ATOL)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), w.numpy(), atol=1e-4, rtol=1e-4)


def test_lse_of_a_row_with_every_key_masked_is_huge_not_minus_inf():
    """An empty row's LSE must keep the backward's exp2(s - lse) at 0."""
    q, k = torch.randn(1, 3, 16), torch.randn(1, 5, 16)
    bias = torch.full((1, 5), flash.MASK_VALUE)
    lse = flash.flash_lse_reference(q, k, 2, bias)
    assert torch.all(lse == -flash.MASK_VALUE)


def test_temporal_autograd_matches_plain_autograd():
    """`TemporalAttentionFn`'s backward (the plain recompute, JAX's
    `_temporal_bwd`) against autograd through `temporal_reference`."""
    x = [torch.randn(2, 6, 9, 16, generator=torch.Generator().manual_seed(i)).requires_grad_()
         for i in range(3)]
    g = torch.randn(2, 6, 9, 16)
    got = torch.autograd.grad(temporal.temporal_attention(*x, heads=2), x, g)
    want = torch.autograd.grad(temporal.temporal_reference(*x, 2), x, g)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, atol=1e-6, rtol=1e-6)
