"""hallo_tpu_torch's CUDA kernels against their plain PyTorch versions.

These need a card (`gpu` marker) and skip without one. The file imports
torch and the port only, so it also runs where jax is not installed:

    python -m pytest tests/test_torch_kernels.py -m gpu -q --noconftest

(`--noconftest` skips tests/conftest.py, which sets jax up for the CPU
tests.) Inputs are unit-normal bf16; the plain version runs in fp32 from the
same bf16 inputs. The kernel rounds the probabilities and the output to
bf16 (8 bits of mantissa), hence atol 2e-2.
"""

import pytest
import torch

from hallo_tpu_torch.ops import attention, flash, temporal

ATOL = 2e-2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU or interpret mode")
    return torch.device("cuda", 0)


def _bf16(gen, dev, *shape):
    return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "b,lq,lk,c,masked",
    [(2, 4096, 8192, 320, False), (2, 256, 512, 1280, False), (2, 4096, 32, 320, False),
     (2, 4096, 4, 320, False), (1, 1, 1, 320, False), (2, 1000, 3000, 640, True)],
)
def test_flash_kernel_matches_plain(cuda_device, b, lq, lk, c, masked):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (_bf16(gen, cuda_device, b, n, c) for n in (lq, lk, lk))
    bias = None
    if masked:
        bias = torch.zeros(b, lk, device=cuda_device)
        bias[:, lk // 2:] = flash.MASK_VALUE
    got = flash.flash_attention_packed(q, k, v, heads=8, bias=bias)
    want = flash.packed_reference(q.float(), k.float(), v.float(), 8, bias)
    assert (got.float() - want).abs().max().item() <= ATOL


@pytest.mark.gpu
def test_flash_kernel_d512_matches_plain(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    q, k, v = (_bf16(gen, cuda_device, 3, 1, 4096, 512) for _ in range(3))
    got = flash.flash_attention(q, k, v)
    want = attention.attention_reference(q.float(), k.float(), v.float())
    assert (got.float() - want).abs().max().item() <= ATOL


@pytest.mark.gpu
@pytest.mark.parametrize(
    "f,l,c", [(18, 4096, 320), (16, 4096, 320), (18, 256, 1280), (17, 77, 640)]
)
def test_temporal_kernel_matches_plain(cuda_device, f, l, c):
    """F 16 and 18 take the kernel's compile-time frame counts, 17 the
    general one."""
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    q, k, v = (_bf16(gen, cuda_device, 2, f, l, c) for _ in range(3))
    got = temporal.temporal_attention(q, k, v, heads=8)
    want = temporal.temporal_reference(q.float(), k.float(), v.float(), 8)
    assert (got.float() - want).abs().max().item() <= ATOL
