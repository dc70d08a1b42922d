"""The Python side of K5's Hopper kernels (`csrc/flash_bwd_sm90.cu`):
`flash.bwd_plan`, the tensor maps, tiles, splits and grids that the wrapper
computes for the (B, L, H, d) views of q, k, v and dO it launches the two
passes on. The kernels themselves need a card (tests/test_torch_kernels.py);
these run on the CPU.

The maps are K1's (tests/test_torch_flash_sm90.py): a head's own map is
(d, L, H, B), the wide map, taken when a token's heads are adjacent in all
four operands, (H d, L, 1, B), with boxes of 64 columns x rows. The
contraction of S and dP is d rounded up to 16; under a wide map its pad
columns are the next head's, and the kernels zero them in shared memory
(the plans' `zeroed`).
"""

import ctypes

import pytest
import torch

from hallo_tpu_torch.ops import flash

BF16 = torch.bfloat16


def _heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    return t.unflatten(2, (heads, t.shape[2] // heads))


def _natural(b, lq, lk, heads, d):
    """(B, L, H, d) views of contiguous (B, L, H d) q, k, v, dO."""
    q, g = (_heads(torch.empty(b, lq, heads * d, dtype=BF16), heads) for _ in range(2))
    k, v = (_heads(torch.empty(b, lk, heads * d, dtype=BF16), heads) for _ in range(2))
    return q, k, v, g


def _cdiv(a, b):
    return -(-a // b)


def _stage_owners(stages: int, tiles: int) -> dict:
    """Which consumers read each stage of the dK/dV ring when the two take
    alternate query tiles (tile i in stage i % stages, consumer i % 2)."""
    owners = {}
    for i in range(tiles):
        owners.setdefault(i % stages, set()).add(i % 2)
    return owners


@pytest.mark.parametrize("lk", [1, 4, 32, 33, 64])
@pytest.mark.parametrize("d", [8, 40, 64, 96, 128, 160])
def test_dkv_ring_under_alternate_tiles_gives_each_stage_one_reader(d, lk):
    """At Lk <= 64 the dK/dV pass's two consumers take alternate query
    tiles. A consumer waits on a stage by the parity of its phase, which
    is only sound if it has waited on every earlier phase of that stage:
    each stage must be read by one consumer alone. A ring of 3 (the first
    design) shares every stage, and a wait on tile i could pass while tile
    i - 3, the other consumer's, was still landing (non-finite dK and dV,
    now and then, in training's audio attention)."""
    b, lq, heads = 14, 1024, 8
    plan = flash.bwd_plan(*_natural(b, lq, lk, heads, d))
    assert plan.dkv.wg_split
    tiles = plan.dkv.tiles
    assert tiles >= 2 * plan.dkv.stages  # every stage is reused
    assert all(len(r) == 1 for r in _stage_owners(plan.dkv.stages, tiles).values())
    assert any(len(r) == 2 for r in _stage_owners(3, tiles).values())


@pytest.mark.parametrize("lk", [1, 33, 8192])
@pytest.mark.parametrize("d", list(range(8, 161, 8)))
def test_bwd_plan_of_natural_views(d, lk):
    """Contiguous (B, L, C = 8 d) tensors at every head dim the kernels take:
    wide maps with the views' own strides; the dK/dV pass takes 128 keys a
    CTA, 64 queries a tile (32 above d 96) in a ring of 4, Q and dO boxes a
    tile high, K and V boxes the CTA's keys; the dQ pass takes 128 queries a
    CTA and 128 keys a tile (64 above d 96, 32 up to d 64 at Lk <= 32), K
    and V boxes half a tile (the cluster's multicast), 3 stages and two Q
    buffers while d fits one box, else 2 and one; LSE and Delta padded to 64
    rows, the bias to 128 keys."""
    b, lq, heads = 2, 300, 8
    plan = flash.bwd_plan(*_natural(b, lq, lk, heads, d))
    c = heads * d
    d_qk = _cdiv(d, 16) * 16
    boxes = _cdiv(d_qk, 64)
    assert (plan.wide, plan.d_qk, plan.d_v, plan.boxes) == (True, d_qk, d, boxes)
    assert (plan.lq_pad, plan.lk_pad) == (320, _cdiv(lk, 128) * 128)
    dkv, dq = plan.dkv, plan.dq
    block_q = 64 if d <= 96 else 32
    assert (dkv.block_q, dkv.block_k, dkv.stages) == (block_q, 128, 4)
    q_map = flash.TmaMap((c, lq, 1, b), (2 * c, 2 * d, 2 * lq * c), (64, block_q, 1, 1))
    kv_map = flash.TmaMap((c, lk, 1, b), (2 * c, 2 * d, 2 * lk * c), (64, 128, 1, 1))
    assert (dkv.q, dkv.g, dkv.k, dkv.v) == (q_map, q_map, kv_map, kv_map)
    assert dkv.wg_split == (lk <= 64)
    assert dkv.grid == (_cdiv(lk, 128) * dkv.splits, heads, b)
    block_k = 32 if lk <= 32 and d <= 64 else 128 if d <= 96 else 64
    assert (dq.block_q, dq.block_k) == (128, block_k)
    assert (dq.stages, dq.q_buffers) == ((3, 2) if boxes == 1 else (2, 1))
    assert dq.q == dq.g == q_map._replace(box=(64, 128, 1, 1))
    assert dq.k == dq.v == kv_map._replace(box=(64, block_k // 2, 1, 1))
    assert dq.grid[0] % 2 == 0 and dq.grid[1:] == (heads, b)
    assert dq.grid[0] * dq.tiles * 128 >= lq  # every query row has a CTA


@pytest.mark.parametrize("name,b,lq,lk,c,want", [
    # (dK/dV grid, splits, tiles, wg_split), (dQ grid, tiles)
    ("level0", 14, 4096, 8192, 320, ((64, 8, 14), 1, 64, False, (32, 8, 14), 1)),
    ("level1", 14, 1024, 2048, 640, ((16, 8, 14), 1, 16, False, (8, 8, 14), 1)),
    ("level2", 14, 256, 512, 1280, ((4, 8, 14), 1, 8, False, (2, 8, 14), 1)),
    ("audio", 14, 4096, 32, 320, ((1, 8, 14), 1, 64, True, (4, 8, 14), 8)),
    ("identity", 14, 4096, 4, 320, ((1, 8, 14), 1, 64, True, (4, 8, 14), 8)),
    ("audio_b1", 1, 4096, 32, 320, ((16, 8, 1), 16, 4, True, (32, 8, 1), 1)),
])
def test_bwd_plan_of_the_training_shapes(name, b, lq, lk, c, want):
    """The stage-2 step's five attentions (14 frames at 512^2, 8 heads) and
    the audio one at batch 1. Audio and identity (Lk 32, 4): both consumers
    of a dK/dV CTA take the same 64 keys and alternate query tiles, and a
    dQ CTA walks 8 query tiles against its one key tile (448 CTAs). At
    batch 1 the 8 dK/dV CTAs would leave 124 SMs idle: the query range is
    split 16 ways into fp32 partials."""
    plan = flash.bwd_plan(*_natural(b, lq, lk, 8, c // 8))
    dkv, dq = plan.dkv, plan.dq
    assert (dkv.grid, dkv.splits, dkv.tiles, dkv.wg_split, dq.grid, dq.tiles) == want


@pytest.mark.parametrize("b,h,lq,lk,sms", [
    (1, 8, 4096, 32, 132), (2, 8, 4096, 512, 132), (1, 1, 1000, 8192, 132),
    (3, 2, 65, 129, 132), (1, 8, 4096, 32, 16), (14, 8, 4096, 32, 132), (1, 2, 64, 64, 132),
])
def test_dkv_split_of_the_query_range(b, h, lq, lk, sms):
    """Where the key tiles leave SMs idle, the dK/dV pass splits the query
    range: every split has at least one tile and together they cover every
    tile once; no split where the CTAs already fill the card; the plan
    follows the card's SM count."""
    q, k, v, g = _natural(b, lq, lk, h, 40)
    dkv = flash.bwd_plan(q, k, v, g, sms=sms).dkv
    nq = _cdiv(lq, 64)
    key_tiles = _cdiv(lk, 128)
    assert dkv.splits >= 1 and dkv.tiles >= 1
    assert (dkv.splits - 1) * dkv.tiles < nq <= dkv.splits * dkv.tiles
    assert dkv.grid == (key_tiles * dkv.splits, h, b)
    if key_tiles * h * b >= sms:
        assert dkv.splits == 1
    # the split finishes its waves no later than the unsplit pass would
    per_wg = (lambda t: _cdiv(t, 2)) if dkv.wg_split else (lambda t: t)
    base = key_tiles * h * b
    assert (_cdiv(dkv.splits * base, sms) * (per_wg(dkv.tiles) + 2)
            <= _cdiv(base, sms) * (per_wg(nq) + 2))


@pytest.mark.parametrize("lq,lk,b,d", [
    (4096, 32, 14, 40), (4096, 4, 14, 40), (4096, 256, 14, 40), (4096, 257, 14, 40),
    (4096, 128, 14, 160), (1000, 32, 3, 40), (128, 4, 1, 40),
])
def test_dq_query_tiles_per_cta(lq, lk, b, d):
    """A dQ CTA walks several query tiles only where it has at most two key
    tiles: then the grid (a multiple of the cluster of two) still gives two
    CTAs an SM, and at most an eighth of the CTAs' tiles lie past Lq."""
    dq = flash.bwd_plan(*_natural(b, lq, lk, 8, d)).dq
    q_tiles = _cdiv(lq, 128)
    ctas = dq.grid[0]
    assert ctas % 2 == 0 and ctas * dq.tiles >= q_tiles
    if _cdiv(lk, dq.block_k) > 2:
        assert dq.tiles == 1
    elif dq.tiles > 1:
        assert ctas * 8 * b >= 2 * flash.H100_SMS
        assert (ctas * dq.tiles - q_tiles) * 8 <= q_tiles


@pytest.mark.parametrize("layout,d,want_k1,want_k5", [
    ("natural", 40, ("q", "k"), ("q", "k", "dO", "v")),
    ("natural", 72, ("q", "k"), ("q", "k", "dO", "v")),
    ("natural", 8, ("q", "k"), ("q", "k", "dO", "v")),
    ("natural", 80, (), ()),
    ("natural", 160, (), ()),
    ("heads_major", 40, (), ()),
    ("one_head", 40, (), ()),
])
def test_plans_zero_the_pad_of_every_contraction_operand(layout, d, want_k1, want_k5):
    """Under a wide map a box reads the next head's first columns as the
    contraction's pad (d .. d rounded to 16): K1 zeroes Q's and K's (the
    operands of S = QK^T), K5 those of S and dP = dO V^T: Q, K, dO and V.
    Where d is a multiple of 16 there is no pad; per-head maps (heads-major
    tensors, or one head) read it as 0 from TMA's fill."""
    heads = 1 if layout == "one_head" else 4
    if layout == "heads_major":
        q, k, v, g = (torch.empty(2, heads, n, d, dtype=BF16).transpose(1, 2)
                      for n in (64, 96, 96, 64))
    else:
        q, k, v, g = _natural(2, 64, 96, heads, d)
    assert flash.sm90_plan(q, k, v).zeroed == want_k1
    plan = flash.bwd_plan(q, k, v, g)
    assert plan.zeroed == want_k5
    assert plan.wide == (layout == "natural")


@pytest.mark.parametrize("case,error", [
    ("fp16", TypeError), ("fp32", TypeError), ("d12", ValueError), ("d168", ValueError),
    ("d512", ValueError), ("inner_stride", ValueError), ("misaligned", ValueError),
    ("mismatched_dO", ValueError), ("mismatched_v", ValueError), ("empty", ValueError),
])
def test_bwd_plan_rejects_what_the_kernels_do_not_take(case, error):
    """No fallback: a type, head dim, stride, address or shape the kernels
    cannot take raises (the wrapper rounds fp32 inputs to bf16 before it
    plans)."""
    q, k, v, g = _natural(2, 64, 64, 2, 40)
    if case in ("fp16", "fp32"):
        g = g.to(torch.float16 if case == "fp16" else torch.float32)
    elif case in ("d12", "d168", "d512"):
        q, k, v, g = _natural(1, 64, 64, 1, int(case[1:]))
    elif case == "inner_stride":
        g = torch.empty(2, 64, 2, 80, dtype=BF16)[..., ::2]
    elif case == "misaligned":
        g = _heads(torch.empty(2 * 64 * 80 + 4, dtype=BF16)[4:].view(2, 64, 80), 2)
    elif case == "mismatched_dO":
        g = _natural(2, 65, 64, 2, 40)[3]
    elif case == "mismatched_v":
        v = _natural(2, 64, 65, 2, 40)[2]
    else:
        q, k, v, g = _natural(2, 0, 64, 2, 40)
    with pytest.raises(error):
        flash.bwd_plan(q, k, v, g)


def test_bwd_launch_arrays_follow_the_kernels_layout():
    """The arrays a launch passes: 7 values per map (q, k, v, dO: 4 extents,
    3 byte strides) and the kernels' `enum Cfg` (B, H, Lq, Lk, d, the padded
    LSE rows, the tiled bias's row, the split partials' stride, wide,
    block_q, block_k, stages, tiles, grid x, then Q buffers for the dQ pass
    or the shared-keys flag for the dK/dV pass); cached by plan."""
    b, lq, lk, heads, d = 2, 300, 32, 8, 40
    plan = flash.bwd_plan(*_natural(b, lq, lk, heads, d))
    for dq_pass, p, extra in ((False, plan.dkv, 1), (True, plan.dq, 2)):
        maps, cfg = flash._bwd_args(plan, dq_pass, b, lq, lk, heads)
        assert isinstance(maps, ctypes.Array) and len(maps) == 28
        assert list(maps[:7]) == [*p.q.dims, *p.q.strides]
        assert list(maps[21:]) == [*p.g.dims, *p.g.strides]
        assert list(cfg) == [b, heads, lq, lk, d, 320, 128, b * lk * heads * d, 1, p.block_q,
                             p.block_k, p.stages, p.tiles, p.grid[0], extra]
        assert flash._bwd_args(plan, dq_pass, b, lq, lk, heads) is not None
        assert flash._bwd_args(plan, dq_pass, b, lq, lk, heads)[1] is cfg


def test_padded_lse_and_delta_rows():
    """LSE and Delta reach the kernels a tile at a time: padded to 64 rows,
    LSE +inf (P = 0) and Delta 0 past Lq; unpadded where Lq already is."""
    lse = torch.randn(2, 3, 65)
    got = flash._padded_rows(lse, 128, float("inf"))
    assert got.shape == (2, 3, 128) and got.is_contiguous()
    assert torch.equal(got[..., :65], lse) and torch.isposinf(got[..., 65:]).all()
    assert torch.equal(flash._padded_rows(lse, 128, 0.0)[..., 65:], torch.zeros(2, 3, 63))
    full = torch.randn(2, 3, 64)
    assert flash._padded_rows(full, 64, 0.0).data_ptr() == full.data_ptr()


def test_backward_on_a_card_tensor_goes_to_the_kernels_checks():
    """No CPU fallback: `flash_backward` on tensors off the CPU checks them
    for the kernels and raises for what they cannot take (meta tensors stand
    in for the card's), where the plain version would have run."""
    m = torch.empty(2, 70, 24, device="meta", dtype=BF16)
    lse = torch.empty(2, 2, 70, device="meta")
    with pytest.raises(ValueError):
        flash.flash_backward(m, m, m, None, m, lse, m, heads=2)
