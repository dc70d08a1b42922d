"""The Python side of K4's Hopper kernel (`csrc/flash_fwd_d512_sm90.cu`):
`flash.d512_plan`, the tensor maps, tiles, grid and cluster that the wrapper
computes for heads-major (B, H, L, d) q, k, v. The kernel itself needs a
card (tests/test_torch_kernels.py); these run on the CPU.

A map lists its axes innermost first with the byte strides of axes 1-4 and
its box: (64 columns, L, d / 64 column blocks, H, B), so that one box brings
a whole tile; Q's box is 64 rows x all blocks, K's and V's 32 keys x the
blocks one CTA of a cluster of two loads and multicasts.
"""

import pytest
import torch

from hallo_tpu_torch.ops import flash
from hallo_tpu_torch.ops.attention import attention_reference

BF16 = torch.bfloat16


def _heads_major(b, h, lq, lk, d, dtype=BF16):
    return (torch.empty(b, h, lq, d, dtype=dtype), torch.empty(b, h, lk, d, dtype=dtype),
            torch.empty(b, h, lk, d, dtype=dtype))


@pytest.mark.parametrize("lk", [1, 33, 4096])
@pytest.mark.parametrize("d", [128, 256, 384, 512])
def test_plan_of_contiguous_heads_major(d, lk):
    """Every head dim the kernel takes: per-head 5-d maps with the tensors'
    own strides, 64 query rows a block, 32 keys a tile, each CTA loading
    half of a tile's column blocks, the ring as deep as shared memory
    allows (at most 4), the grid's query tiles rounded up to the cluster."""
    b, h, lq = 2, 3, 300
    q, k, v = _heads_major(b, h, lq, lk, d)
    plan = flash.d512_plan(q, k, v)
    blocks = d // 64
    assert (plan.d, plan.boxes, plan.block_q, plan.block_k, plan.cluster) == (d, blocks, 64, 32, 2)
    assert plan.stages == {128: 4, 256: 4, 384: 3, 512: 2}[d]
    assert plan.q == flash.TmaMap((64, lq, blocks, h, b), (2 * d, 128, 2 * lq * d, 2 * h * lq * d),
                                  (64, 64, blocks, 1, 1))
    for m in (plan.k, plan.v):
        assert m == flash.TmaMap((64, lk, blocks, h, b), (2 * d, 128, 2 * lk * d, 2 * h * lk * d),
                                 (64, 32, blocks // 2, 1, 1))
    assert plan.grid == (6, h, b)  # 5 query tiles of 64, rounded up to the cluster of 2


@pytest.mark.parametrize("b,lq", [(3, 4096), (16, 4096), (1, 1), (1, 65)])
def test_plan_of_the_vae_mid_block(b, lq):
    """The main path: one head of d 512 (the encode at B 3, the decode at
    B 16), and ragged query lengths; a head of extent 1 is never stepped."""
    q, k, v = (torch.empty(b, lq, 512, dtype=BF16)[:, None] for _ in range(3))
    plan = flash.d512_plan(q, k, v)
    tiles = -(-lq // 64)
    assert plan.grid == (tiles + tiles % 2, 1, b)
    assert plan.q.dims == (64, lq, 8, 1, b) and plan.q.strides[:2] == (1024, 128)
    assert plan.stages == 2 and plan.k.box == (64, 32, 4, 1, 1)


def test_plan_of_views_with_their_own_strides():
    """A (B, L, H, d) tensor read heads-major through a transposed view:
    no copy, the token stride is H d, the head stride d."""
    x = torch.empty(2, 100, 2, 256, dtype=BF16)
    q = x.transpose(1, 2)
    plan = flash.d512_plan(q, q, q)
    assert plan.q.dims == (64, 100, 4, 2, 2)
    assert plan.q.strides == (2 * 2 * 256, 128, 2 * 256, 2 * 100 * 2 * 256)


@pytest.mark.parametrize("case,error", [
    ("fp16", TypeError), ("fp32", TypeError), ("d64", ValueError), ("d192", ValueError),
    ("d640", ValueError), ("inner_stride", ValueError), ("misaligned", ValueError),
    ("mismatched", ValueError), ("empty", ValueError), ("odd_row_stride", ValueError),
])
def test_plan_rejects_what_the_kernel_does_not_take(case, error):
    """No fallback: a type, head dim, stride, address or shape the kernel
    cannot take raises (the wrapper rounds fp32 inputs to bf16 before it
    plans)."""
    q, k, v = _heads_major(1, 1, 64, 64, 128)
    if case in ("fp16", "fp32"):
        q = q.to(torch.float16 if case == "fp16" else torch.float32)
    elif case in ("d64", "d192", "d640"):
        q, k, v = _heads_major(1, 1, 64, 64, int(case[1:]))
    elif case == "inner_stride":
        q = torch.empty(1, 1, 64, 256, dtype=BF16)[..., ::2]
    elif case == "misaligned":
        q = torch.empty(64 * 128 + 4, dtype=BF16)[4:].view(1, 1, 64, 128)
    elif case == "mismatched":
        v = _heads_major(1, 1, 64, 65, 128)[2]
    elif case == "empty":
        q, k, v = _heads_major(1, 1, 64, 0, 128)
    else:
        q = torch.empty(1, 1, 64, 132, dtype=BF16)[..., :128]  # 264-byte rows
    with pytest.raises(error):
        flash.d512_plan(q, k, v)


def test_stages_fill_shared_memory():
    """The ring's depth mirrors the kernel's: Q, the exchange of S's halves
    and the stages of K, V and their bias fit the 227 KB of a block, and one
    more stage would not (or the ring is at its 4)."""
    def smem(d, st):  # csrc/flash_fwd_d512_sm90.cu: Tiles<D>::kSmem
        q = d // 64 * 64 * 128
        kv = d // 64 * 32 * 128
        return q + st * (2 * kv + 128) + 2 * 4 * 128 * 16 + 8 * (1 + 4 * st) + 1024

    assert sorted(flash.D512_STAGES) == [128, 256, 384, 512]
    for d, st in flash.D512_STAGES.items():
        assert smem(d, st) <= 232448
        assert st == 4 or smem(d, st + 1) > 232448


def test_dispatch_by_head_dim():
    """On the CPU `flash_attention` is the plain version for every d and
    launches nothing; off the CPU d = 128 n goes to K4's checks and any
    other d to K3's (meta tensors stand in for the card's), and a d neither
    takes raises."""
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 1, n, 128, generator=gen) for n in (70, 33, 33))
    before = dict(flash.LAUNCHES)
    got = flash.flash_attention(q, k, v)
    assert flash.LAUNCHES == before
    torch.testing.assert_close(got, attention_reference(q, k, v))
    for d in (128, 512, 64):
        m = torch.empty(1, 1, 8, d, device="meta", dtype=BF16)
        with pytest.raises(ValueError, match="is on meta"):
            flash.flash_attention(m, m, m)
    with pytest.raises(ValueError, match="head dim 168"):
        flash._heads_major_args((1, 1, 8, 168), (1344, 1344, 168, 1), (1, 1, 8, 168),
                                (1344, 1344, 168, 1), (1, 1, 8, 168), (1344, 1344, 168, 1),
                                BF16)
