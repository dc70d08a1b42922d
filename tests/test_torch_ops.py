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
