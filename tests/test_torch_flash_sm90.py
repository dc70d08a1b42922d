"""The Python side of K1's Hopper kernel (`csrc/flash_fwd_sm90.cu`):
`flash.sm90_plan`, the tensor maps, tiles and grid that the wrapper computes
for the (B, L, H, d) views it launches the kernel on. The kernel itself
needs a card (tests/test_torch_kernels.py); these run on the CPU.

A map lists its axes innermost first with the byte strides of axes 1-3 and
a box of 64 columns x rows: a head's own map is (d, L, H, B); the wide map,
taken when a token's heads are adjacent in q, k and v, is (H d, L, 1, B).
The contraction of S = QK^T is d rounded up to 16, the width of O = PV is
d.
"""

import pytest
import torch

from hallo_tpu_torch.ops import flash

BF16 = torch.bfloat16


def _heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    return t.unflatten(2, (heads, t.shape[2] // heads))


def _natural(b, lq, lk, heads, d):
    q = torch.empty(b, lq, heads * d, dtype=BF16)
    k = torch.empty(b, lk, heads * d, dtype=BF16)
    v = torch.empty(b, lk, heads * d, dtype=BF16)
    return _heads(q, heads), _heads(k, heads), _heads(v, heads)


@pytest.mark.parametrize("lk", [1, 33, 8192])
@pytest.mark.parametrize("d", list(range(8, 161, 8)))
def test_plan_of_natural_views(d, lk):
    """Contiguous (B, L, C = 8 d) tensors at every head dim the kernel takes:
    the maps have the views' own strides (no copy), one box per 64 columns,
    192 query rows a block while d fits one box, else 128, and 128 keys a
    tile (64 keys above two boxes, for shared memory); wide maps over the C
    columns, K's and V's with a box of half a tile (each
    CTA of a cluster of two loads half and multicasts it); the grid's query
    tiles rounded up to the cluster."""
    b, lq, heads = 2, 300, 8
    q, k, v = _natural(b, lq, lk, heads, d)
    plan = flash.sm90_plan(q, k, v)
    c = heads * d
    d_qk = -(-d // 16) * 16
    boxes = -(-d_qk // 64)
    block_k = 128 if d <= 128 else 64
    assert (plan.d_qk, plan.d_v, plan.boxes) == (d_qk, d, boxes)
    assert plan.d_qk % 16 == 0 and plan.d_qk - d in (0, 8)
    assert (plan.block_k, plan.stages) == (block_k, flash.SM90_STAGES)
    block_q = 192 if d <= 64 else 128
    assert plan.block_q == block_q
    assert plan.q == flash.TmaMap((c, lq, 1, b), (2 * c, 2 * d, 2 * lq * c),
                                  (64, block_q, 1, 1))
    assert plan.wide
    for m in (plan.k, plan.v):
        assert m == flash.TmaMap((c, lk, 1, b), (2 * c, 2 * d, 2 * lk * c),
                                 (64, block_k // 2, 1, 1))  # half a tile: the cluster's share
    # 2 or 3 query tiles, rounded up to the cluster of 2
    assert plan.grid == (2 if d <= 64 else 4, heads, b)


@pytest.mark.parametrize("d,d_qk,boxes", [(40, 48, 1), (80, 80, 2), (160, 160, 3)])
def test_plan_of_the_main_path_widths(d, d_qk, boxes):
    """Level 0 (d 40: the contraction padded to 48, 20% of QK^T, Q's
    columns past d read as 0), level 1 (d 80, two boxes) and level 2 / the
    mid block (d 160, three boxes, 64-key tiles), at the 512^2 shapes."""
    lq = {40: 4096, 80: 1024, 160: 256}[d]
    q, k, v = _natural(2, lq, 2 * lq, 8, d)
    plan = flash.sm90_plan(q, k, v)
    assert (plan.d_qk, plan.d_v, plan.boxes) == (d_qk, d, boxes)
    # level 0: 4096 rows in 22 blocks of 192 (21.3, rounded up to the cluster)
    assert plan.grid == ({40: 22, 80: 8, 160: 2}[d], 8, 2)


@pytest.mark.parametrize("case", ["kv_halves", "token_slice", "batch_slice", "heads_major"])
def test_plan_of_sliced_views(case):
    """Views that are not contiguous tensors: k and v as the two halves of
    one (B, L, 2C) projection, q a slice of the tokens or of the batch, and
    a transposed heads-major (B, H, L, d) tensor. The maps carry each view's
    strides; nothing is copied."""
    b, l, heads, d = 3, 200, 8, 40
    c = heads * d
    if case == "kv_halves":
        kv = torch.empty(b, l, 2 * c, dtype=BF16)
        q = _heads(torch.empty(b, l, c, dtype=BF16), heads)
        k, v = _heads(kv[..., :c], heads), _heads(kv[..., c:], heads)
        want = (2 * 2 * c, 2 * d, 2 * l * 2 * c)
        plan = flash.sm90_plan(q, k, v)
        assert plan.wide and plan.k.strides == plan.v.strides == want
        assert plan.k.dims == (c, l, 1, b)
    elif case == "token_slice":
        x = torch.empty(b, l + 8, c, dtype=BF16)
        q = _heads(x[:, 8:], heads)
        k = v = _heads(torch.empty(b, 16, c, dtype=BF16), heads)
        plan = flash.sm90_plan(q, k, v)
        assert plan.q.dims == (c, l, 1, b)
        assert plan.q.strides == (2 * c, 2 * d, 2 * (l + 8) * c)
    elif case == "batch_slice":
        x = torch.empty(b, l, c, dtype=BF16)
        q = k = v = _heads(x[1:], heads)
        plan = flash.sm90_plan(q, k, v)
        assert plan.q.dims == (c, l, 1, b - 1)
        assert plan.q.strides == (2 * c, 2 * d, 2 * l * c)
        assert plan.grid == (2, heads, b - 1)  # 200 rows: 2 blocks of 192
        assert flash.sm90_plan(*(_heads(x[:, :1], heads),) * 3).grid == (2, heads, b)
    else:
        x = torch.empty(b, heads, l, d, dtype=BF16)
        q = k = v = x.transpose(1, 2)
        plan = flash.sm90_plan(q, k, v)
        assert not plan.wide  # heads not adjacent: per-head maps
        for m in (plan.q, plan.k, plan.v):
            assert m.dims == (d, l, heads, b)
            assert m.strides == (2 * d, 2 * l * d, 2 * heads * l * d)


def test_plan_of_an_axis_of_extent_one():
    """One head and one batch element: strides that are never stepped are
    given a value TMA accepts (16 bytes) when the view's own is not one, as
    for an expanded batch axis."""
    x = torch.empty(1, 77, 40, dtype=BF16).expand(1, 77, 40)
    q = x.unflatten(2, (1, 40))
    base = torch.empty(77, 40, dtype=BF16)
    k = base[None].expand(1, 77, 40).unflatten(2, (1, 40))
    k = k.as_strided(k.shape, (0, 40, 40, 1))  # a zero batch stride
    plan = flash.sm90_plan(q, k, k)
    assert not plan.wide  # one head: nothing to span
    assert plan.q.strides == (80, 80, 77 * 80)
    assert plan.k.strides == (80, 80, 16)
    assert plan.k.dims == (40, 77, 1, 1)


@pytest.mark.parametrize("case,error", [
    ("fp16", TypeError), ("fp32", TypeError), ("d12", ValueError), ("d168", ValueError),
    ("d512", ValueError), ("inner_stride", ValueError), ("odd_row_stride", ValueError),
    ("misaligned", ValueError), ("mismatched", ValueError), ("zero_stride", ValueError),
])
def test_plan_rejects_what_the_kernel_does_not_take(case, error):
    """No fallback: a type, head dim, stride or address the kernel cannot
    read raises (the wrapper rounds fp32 inputs to bf16 before it plans)."""
    q, k, v = _natural(2, 64, 64, 2, 40)
    if case in ("fp16", "fp32"):
        dt = torch.float16 if case == "fp16" else torch.float32
        q = q.to(dt)
    elif case in ("d12", "d168", "d512"):
        d = int(case[1:])
        q, k, v = _natural(1, 64, 64, 1, d)
    elif case == "inner_stride":
        q = torch.empty(2, 64, 2, 80, dtype=BF16)[..., ::2]
    elif case == "odd_row_stride":
        q = _heads(torch.empty(2, 64, 84, dtype=BF16)[..., :80], 2)  # 168-byte rows
    elif case == "misaligned":
        q = _heads(torch.empty(2 * 64 * 80 + 4, dtype=BF16)[4:].view(2, 64, 80), 2)
    elif case == "mismatched":
        v = _natural(2, 64, 65, 2, 40)[2]
    else:
        q = _heads(torch.empty(1, 1, 80, dtype=BF16).expand(2, 64, 80), 2)
    with pytest.raises(error):
        flash.sm90_plan(q, k, v)


def test_cpu_tensors_take_the_plain_version_and_cards_the_kernel():
    """On the CPU `flash_attention_packed` is `packed_reference` and launches
    nothing; off the CPU it goes to the kernel's checks and raises for a
    tensor it cannot take (meta tensors stand in for the card's)."""
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, n, 80, generator=gen) for n in (70, 130, 130))
    before = dict(flash.LAUNCHES)
    got = flash.flash_attention_packed(q, k, v, heads=2)
    assert flash.LAUNCHES == before
    torch.testing.assert_close(got, flash.packed_reference(q, k, v, 2, None, 40 ** -0.5))
    m = torch.empty(2, 70, 80, device="meta", dtype=BF16)
    with pytest.raises(ValueError):
        flash.flash_forward_packed(m, m, m, heads=2)


@pytest.mark.parametrize("case", ["contiguous", "kv_half", "token_slice"])
def test_wrapper_plans_the_views_it_does_not_make(case):
    """`flash_forward_packed` plans from (B, L, C) tensors without making
    their (B, L, H, d) views: the plan equals `sm90_plan` of the views, and
    channels that do not split into the heads raise."""
    x = torch.empty(2, 40, 2 * 320, dtype=BF16)
    t = {"contiguous": x[..., :320].contiguous(), "kv_half": x[..., 320:],
         "token_slice": x[:, 8:, :320]}[case]
    views = (_heads(t, 8),) * 3
    assert flash._plan(*flash._heads_view(t, 8) * 3) == flash.sm90_plan(*views)
    with pytest.raises(ValueError, match="heads"):
        flash._heads_view(torch.empty(1, 4, 81, dtype=BF16), 2)


def test_tile_bias_is_scaled_and_padded_to_whole_tiles():
    """The kernel reads the per-key bias a key tile at a time: times log2(e),
    -inf past Lk up to a whole tile, MASK_VALUE at -inf (its product with
    log2 e overflows, as in the plain versions), broadcast over the batch."""
    bias = torch.tensor([[0.0, -1e9, flash.MASK_VALUE, 1.5]])
    got = flash._tile_bias(bias, 2, 4, 64)
    assert got.shape == (2, 64) and got.dtype == torch.float32
    want = torch.tensor([0.0, -1e9 * flash._LOG2E, -float("inf"), 1.5 * flash._LOG2E])
    for row in got:
        torch.testing.assert_close(row[:4], want)
        assert torch.isneginf(row[4:]).all()
    assert flash._tile_bias(None, 2, 4, 64) is None
    assert flash._tile_bias(torch.zeros(3, 130), 3, 130, 128).shape == (3, 256)
    half = torch.randn(1, 128).to(BF16)  # a bf16 bias is scaled in fp32
    assert torch.equal(flash._tile_bias(half, 2, 128, 128), half.float().expand(2, 128) * flash._LOG2E)
