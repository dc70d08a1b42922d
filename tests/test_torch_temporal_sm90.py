"""The Python side of K2's Hopper kernel (`csrc/temporal_attn_sm90.cu`):
`temporal.temporal_plan`, the tensor map, units, ring and grid that the
wrapper computes for contiguous (B, F, L, C = H d) bf16 q, k, v; and K9's
split of a copy into head, bulk body and tail (`layout.copy_plan`). The
kernels themselves need a card (tests/test_torch_kernels.py); these run on
the CPU.

K2's map lists (C, F, L, B) innermost first with the byte strides of F, L
and B and a box of 64 columns x F frames x `sites` sites. A unit is (batch,
`sites` sites, `heads_per_unit` heads) over whole 64-column boxes; a task is
one (site, head), taken by one of the CTA's consumer warps. Frames past F
are read from a zero row.
"""

import math

import pytest
import torch

from hallo_tpu_torch.ops import layout, temporal

BF16 = torch.bfloat16
H100_SMS = 132


def _qkv(b, f, l, c, dtype=BF16):
    return tuple(torch.empty(b, f, l, c, dtype=dtype) for _ in range(3))


def _units_cover_every_column(plan, c):
    """Every unit's boxes hold all its heads' columns, and the heads of all
    units are each head exactly once."""
    d, nh = plan.d, plan.heads_per_unit
    seen = []
    for g in range(plan.groups):
        heads = range(g * nh, min(plan.heads, (g + 1) * nh))
        col0 = g * nh * d // 64 * 64  # the kernel's window start
        for h in heads:
            assert col0 <= h * d and (h + 1) * d <= col0 + 64 * plan.boxes
        seen += heads
    assert seen == list(range(plan.heads)) and plan.heads * d == c


@pytest.mark.parametrize("f", [1, 5, 16, 17, 18, 32])
@pytest.mark.parametrize("d", [8, 16, 40, 72, 80, 160])
def test_plan_at_every_width_and_frame_count(d, f):
    """At each width and frame count, over L 64, 77, 200, 256, 1024 and
    4096: the map is the tensor's own (no copy), a box is 64 columns x F
    frames x the unit's sites; the box buffers are whole swizzle atoms (8
    rows) that hold the sites' frames; the ring of `stages` units fits the
    shared memory a block may take; the grid is persistent; the key tiles,
    query tiles and zero rows follow F, the m16n8k8 tail d % 16."""
    heads = 8
    c = heads * d
    for l in (64, 77, 200, 256, 1024, 4096):
        plan = temporal.temporal_plan(*_qkv(2, f, l, c), heads)
        assert plan.map.dims == (c, f, l, 2)
        assert plan.map.strides == (2 * l * c, 2 * c, 2 * f * l * c)
        assert plan.map.box == (64, f, plan.sites, 1)
        assert 1 <= plan.sites <= min(256, l)
        assert plan.box_rows % 8 == 0 and plan.sites * f <= plan.box_rows < plan.sites * f + 8
        stage = 3 * plan.boxes * plan.box_rows * 128
        assert 1 <= plan.stages <= temporal.MAX_STAGES
        assert plan.smem == plan.stages * (stage + 16) + 32 + 1024 <= temporal.SMEM_LIMIT
        assert plan.units == 2 * -(-l // plan.sites) * plan.groups
        assert plan.grid == min(plan.units, H100_SMS)
        assert plan.warps == (8 if f > 24 else 12)
        assert plan.k_tiles == -(-f // 8) and plan.m_tiles == (2 if f > 16 else 1)
        assert plan.k8_tail == (d % 16 == 8)
        q_rows, s_keys, pv_keys = plan.zero_rows
        assert (q_rows + f) % 16 == 0 and (s_keys + f) == 8 * plan.k_tiles
        assert (pv_keys + f) % 16 == 0 and 0 <= pv_keys < 16
        _units_cover_every_column(plan, c)
        # a second site would push the stage past its target (or no sites are left)
        if plan.sites < min(256, l):
            rows = -(-(plan.sites + 1) * f // 8) * 8
            assert 3 * plan.boxes * rows * 128 > temporal.STAGE_TARGET


@pytest.mark.parametrize("name,shape,nh,units", [
    ("level 0", (2, 18, 4096, 320), 8, 8192), ("level 1", (2, 18, 1024, 640), 4, 4096),
    ("level 2", (2, 18, 256, 1280), 2, 2048), ("level 3", (2, 18, 64, 1280), 2, 512),
    ("training level 0", (1, 16, 4096, 320), 8, 4096),
])
def test_plan_of_the_main_path(name, shape, nh, units):
    """The 512^2 denoiser's four levels at B 2 (the CFG batch), F 18 (16 clip
    + 2 motion frames), and training's level 0 at B 1, F 16 (14 + 2): every
    unit is one site and 320 columns (5 boxes, read once: 8 heads of d 40, 4
    of 80, 2 of 160), a ring of 4 stages; 132 CTAs walk the units."""
    q, k, v = _qkv(*shape)
    plan = temporal.temporal_plan(q, k, v, 8)
    f = shape[1]
    assert plan.d == shape[3] // 8 and plan.heads_per_unit == nh
    assert (plan.boxes, plan.sites, plan.stages) == (5, 1, 4)
    assert plan.box_rows == (24 if f == 18 else 16)
    assert plan.units == units and plan.grid == 132
    assert plan.heads_per_unit * plan.d == 320 == 64 * plan.boxes
    assert plan.zero_rows == ((14, 6, 14) if f == 18 else (0, 0, 0))
    assert plan.k8_tail == (plan.d == 40)


@pytest.mark.parametrize("case", ["d152", "d1000", "heads10"])
def test_plan_of_heads_that_do_not_tile_64_columns(case):
    """Where lcm(d, 64) columns are too many for two stages (d 152 at F 32)
    a unit takes fewer heads and reads a box shared with its neighbour unit;
    a head wider than that fits one stage alone (d 1000); a last group of
    fewer heads (10 heads of 40: 8, then 2)."""
    if case == "d152":
        plan = temporal.temporal_plan(*_qkv(1, 32, 64, 8 * 152), 8)
        assert plan.heads_per_unit < math.lcm(152, 64) // 152 and plan.stages >= 2
        _units_cover_every_column(plan, 8 * 152)
    elif case == "d1000":
        plan = temporal.temporal_plan(*_qkv(1, 18, 64, 8 * 1000), 8)
        assert plan.heads_per_unit == 1 and plan.boxes == 17 and plan.stages == 1
        _units_cover_every_column(plan, 8000)
    else:
        plan = temporal.temporal_plan(*_qkv(2, 18, 100, 400), 10)
        assert (plan.heads_per_unit, plan.groups, plan.boxes) == (8, 2, 5)
        _units_cover_every_column(plan, 400)


@pytest.mark.parametrize("case,error", [
    ("f33", ValueError), ("d12", ValueError), ("fp16", TypeError), ("fp32", TypeError),
    ("transposed", ValueError), ("sliced", ValueError), ("misaligned", ValueError),
    ("mismatched", ValueError), ("heads", ValueError), ("d_too_wide", ValueError),
])
def test_plan_rejects_what_the_kernel_does_not_take(case, error):
    """No fallback: 33 frames, d not a multiple of 8, a type other than
    bf16, a view that is not contiguous or not 16-byte aligned, shapes that
    differ, channels that do not split into the heads, a head too wide for
    one stage of shared memory."""
    q, k, v = _qkv(2, 18, 64, 320)
    heads = 8
    if case == "f33":
        q, k, v = _qkv(2, 33, 64, 320)
    elif case == "d12":
        q, k, v = _qkv(2, 18, 64, 96)
    elif case in ("fp16", "fp32"):
        k = k.to(torch.float16 if case == "fp16" else torch.float32)
    elif case == "transposed":
        q = torch.empty(2, 64, 18, 320, dtype=BF16).transpose(1, 2)
    elif case == "sliced":
        v = torch.empty(2, 18, 64, 640, dtype=BF16)[..., :320]
    elif case == "misaligned":
        q = torch.empty(2 * 18 * 64 * 320 + 4, dtype=BF16)[4:].view(2, 18, 64, 320)
    elif case == "mismatched":
        v = torch.empty(2, 18, 65, 320, dtype=BF16)
    elif case == "heads":
        heads = 7
    else:
        q, k, v = _qkv(1, 32, 8, 8 * 2048)
    with pytest.raises(error):
        temporal.temporal_plan(q, k, v, heads)


def test_plan_is_cached_and_packs_the_launch():
    """The plan is a pure function of the shape (cached, one per card's SM
    count); the launch's `args` array (cached with it) is the map's 4
    extents and 3 byte strides, the unit geometry, and o's element strides
    of a contiguous (B, F, L, C) tensor."""
    q, k, v = _qkv(2, 18, 256, 1280)
    plan = temporal.temporal_plan(q, k, v, 8)
    assert temporal.temporal_plan(q, k, v, 8) is plan
    assert temporal.temporal_plan(q, k, v, 8, sms=78).grid == 78
    args = temporal._launch_args(plan)
    assert temporal._launch_args(plan) is args
    assert list(args) == [*plan.map.dims, *plan.map.strides, 8, 160, 2, 1, 5, 24, 4, 132, 12,
                          18 * 256 * 1280, 256 * 1280, 1280]


def test_no_cpu_fallback_for_a_tensor_off_the_cpu():
    """On the CPU the wrapper is the plain version and launches nothing; a
    tensor elsewhere (meta tensors stand in for the card's) goes to the
    kernel's checks and raises there."""
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 6, 9, 32, generator=gen) for _ in range(3))
    before = dict(temporal.LAUNCHES)
    got = temporal.temporal_attention(q, k, v, heads=2)
    assert temporal.LAUNCHES == before
    torch.testing.assert_close(got, temporal.temporal_reference(q, k, v, 2))
    m = torch.empty(1, 6, 9, 32, device="meta", dtype=BF16)
    with pytest.raises(ValueError, match="meta"):
        temporal.temporal_attention(m, m, m, heads=2)


@pytest.mark.parametrize("src,dst,nbytes,split", [
    (0, 0, 131072 * 320 * 2, (0, 131072 * 640, 0)),  # the level-0 activation: all bulk
    (0, 0, 4099 * 37 * 2, (0, 303312, 14)),  # ragged: a 14-byte tail
    (4, 0, 40 * 25 * 4, (0, 0, 4000)),  # an fp32 view 4 bytes into its storage
    (4, 4, 4000, (12, 3984, 4)),  # the same offset in both: head, body, tail
    (6, 6, 9, (9, 0, 0)),  # shorter than the head
    (0, 0, 16384 * 12 - 16, (0, 16384 * 12 - 16, 0)),  # just short of the ring
    (0, 0, 16384 * 12 + 16, (0, 16384 * 12 + 16, 0)),  # just past it
])
def test_copy_plan_splits_head_body_and_tail(src, dst, nbytes, split):
    """K9: bulk copies take 16-byte-aligned addresses and sizes, so the body
    runs between the first and the last 16-byte boundary where source and
    destination agree modulo 16; the rest goes a byte a thread. The body's
    chunks are the ring's stages; the grid is persistent (one CTA an SM)."""
    plan = layout.copy_plan(src, dst, nbytes)
    assert (plan.head, plan.body, plan.tail) == split
    assert plan.head + plan.body + plan.tail == nbytes and plan.body % 16 == 0
    if plan.body:
        assert (src + plan.head) % 16 == 0 and (dst + plan.head) % 16 == 0
    assert plan.chunks == -(-plan.body // layout.COPY_CHUNK)
    rest = -(-(plan.head + plan.tail) // layout.COPY_THREADS)
    assert plan.grid == min(H100_SMS, max(1, plan.chunks, rest))
    with pytest.raises(ValueError):
        layout.copy_plan(src, dst, 0)
