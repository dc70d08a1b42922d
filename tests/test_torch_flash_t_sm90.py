"""The Python side of K3's and K6's Hopper kernels (`csrc/flash_fwd_t_sm90.cu`
and `csrc/flash_int8_sm90.cu`): `flash.heads_major_plan` and
`flash.int8_plan`, the tensor maps, tiles, rings, grids, buffers and launch
arrays the wrappers compute for heads-major (B, H, L, d) q, k, v. The
kernels themselves need a card (tests/test_torch_kernels.py); these run on
the CPU.

K3 reads K and V in their own type through maps over the (B, L, H, d) view
(innermost first, byte strides of axes 1-3, boxes of 128-byte rows x
block_k keys): (H d, L, 1, B) when a token's heads are adjacent, as in the
wav2vec2 view, else (d, L, H, B). K6's prelude writes int8 q8/k8 rows of d
rounded up to 32 bytes and bf16 v16 rows of whole 64-column boxes, zeros in
the pad, and the attention kernel reads them through 4-d maps (a row's
bytes in blocks, L, the blocks, B H) one box a tile.
"""

import ctypes

import pytest
import torch

from hallo_tpu_torch.ops import flash

F32, BF16 = torch.float32, torch.bfloat16
DS = [8, 40, 64, 72, 160]
LKS = [1, 33, 304, 1050, 1056, 4096]


def _wav2vec(b, lq, lk, h, d, dtype=F32):
    """The model's view: (B, T, H, d) projections -> (B, H, T, d)."""
    return tuple(torch.empty(b, n, h, d, dtype=dtype).transpose(1, 2) for n in (lq, lk, lk))


def _contiguous(b, lq, lk, h, d, dtype=F32):
    return tuple(torch.empty(b, h, n, d, dtype=dtype) for n in (lq, lk, lk))


def _block_q(d_p, lq, pairs, sms=132):
    """64 rows a consumer warpgroup: 3 up to d 64 where 2 would take more
    waves of one CTA an SM, else 2."""
    def waves(rows):
        return -(-(-(-lq // rows) * pairs) // sms)
    return 192 if d_p <= 64 and waves(128) > waves(192) else 128


def _k3_tiles(d, lq=300, pairs=12):
    d_p = -(-d // 32) * 32
    return d_p, _block_q(d_p, lq, pairs), (128 if d_p <= 64 else 64)


@pytest.mark.parametrize("view", ["wav2vec2", "contiguous"])
@pytest.mark.parametrize("lk", LKS)
@pytest.mark.parametrize("d", DS)
def test_heads_major_plan(d, lk, view):
    """K3 at every width and key length of the audio path and beyond: the
    maps carry the views' own strides (no copy), boxes of 32 fp32 columns x
    block_k keys, a ring of 2-4 slots that fits shared memory beside Q, the
    two bf16 K and V stages, and the grid of query blocks (two consumer
    warpgroups at L 300: their grid takes one wave, as three's does)."""
    b, h, lq = 1, 12, 300
    q, k, v = (_wav2vec if view == "wav2vec2" else _contiguous)(b, lq, lk, h, d)
    plan = flash.heads_major_plan(q, k, v)
    d_p, block_q, block_k = _k3_tiles(d)
    assert (plan.d, plan.d_p, plan.block_q, plan.block_k) == (d, d_p, block_q, block_k)
    assert plan.boxes == -(-d_p // 64) and plan.box_cols == 32
    assert plan.src_boxes == -(-d_p // 32)
    assert plan.grid == (-(-lq // block_q), h, b)
    assert 2 <= plan.slots <= 4 and plan.smem <= flash.SMEM_LIMIT
    if plan.slots < 4:  # one more slot would not fit
        assert plan.smem + plan.src_boxes * block_k * 128 + 16 > flash.SMEM_LIMIT
    c = h * d
    if view == "wav2vec2":
        assert plan.wide
        for m in (plan.k, plan.v):
            assert m == flash.TmaMap((c, lk, 1, b), (4 * c, 4 * d, 4 * lk * c), (32, block_k, 1, 1))
    elif lk > 1:
        assert not plan.wide
        for m in (plan.k, plan.v):
            assert m == flash.TmaMap((d, lk, h, b), (4 * d, 4 * lk * d, 4 * h * lk * d),
                                     (32, block_k, 1, 1))
    else:  # one key a head: the contiguous heads are adjacent too
        assert plan.wide and plan.k.dims == (c, 1, 1, b)


@pytest.mark.parametrize("d", DS)
def test_heads_major_plan_in_bf16(d):
    """bf16 I/O: boxes of 64 columns (128-byte rows), fewer landed boxes
    a tile, the same tiles and grid."""
    q, k, v = _wav2vec(2, 1056, 1056, 12, d, BF16)
    plan = flash.heads_major_plan(q, k, v)
    d_p, block_q, block_k = _k3_tiles(d, 1056, 24)
    assert plan.box_cols == 64 and plan.src_boxes == -(-d_p // 64)
    assert plan.k.box == (64, block_k, 1, 1) and plan.k.strides[0] == 2 * 12 * d
    assert plan.grid == (-(-1056 // block_q), 12, 2)


@pytest.mark.parametrize("lq,block_q,ctas", [(304, 128, 36), (1056, 128, 108),
                                             (4096, 192, 264)])
def test_heads_major_plan_of_the_audio_path(lq, block_q, ctas):
    """12 s (L 304), 42 s (L 1056) and about 2.7 min (L 4096) of audio: 128
    query rows a CTA (two consumer warpgroups) while that fits one wave of
    132 CTAs, 192 (three) at L 4096, where 128 would take three waves
    against two; 128 keys a tile, four landed slots of 32 KB (two boxes of
    32 fp32 columns)."""
    plan = flash.heads_major_plan(*_wav2vec(1, lq, lq, 12, 64))
    assert plan.wide and plan.slots == 4 and plan.src_boxes == 2
    assert plan.block_q == block_q
    assert plan.grid[0] * plan.grid[1] * plan.grid[2] == ctas


@pytest.mark.parametrize("d,lq,sms,consumers", [
    (64, 304, 132, 2), (64, 1056, 132, 2), (64, 4096, 132, 3), (64, 2048, 132, 3),
    (64, 1500, 132, 3), (40, 1056, 132, 2), (8, 4096, 132, 3), (72, 4096, 132, 2),
    (160, 4096, 132, 2), (64, 4096, 264, 3), (64, 4096, 400, 2),
])
def test_consumer_warpgroups_follow_the_waves(d, lq, sms, consumers):
    """K3 and K6 take two consumer warpgroups (more CTAs of fewer rows)
    unless that takes more waves of one CTA an SM than three, which only d
    up to 64 can have: at 12 heads, L 2048 is 132 CTAs of 192 rows (one
    wave) or 192 of 128 (two); L 1500 96 or 144."""
    q, k, v = _wav2vec(1, lq, lq, 12, d)
    for plan in (flash.heads_major_plan(q, k, v, sms=sms), flash.int8_plan(q, k, v, sms=sms)):
        assert plan.block_q == 64 * consumers
        assert plan.grid[0] == -(-lq // plan.block_q)


def test_heads_major_launch_array_is_cached_and_complete():
    """Every launch integer in one array, built once per shape: the same
    ctypes object for every call of a shape, holding B, H, Lq, Lk, d, d_p,
    the dtype code, the wide flag, q's and the output's (batch, token, head)
    strides, the bias's batch stride, the two maps, the tiles and slots."""
    q, k, v = _wav2vec(1, 304, 304, 12, 64)
    plan, args = flash._heads_major_args(tuple(q.shape), q.stride(), tuple(k.shape), k.stride(),
                                         tuple(v.shape), v.stride(), F32)
    again = flash._heads_major_args(tuple(q.shape), q.stride(), tuple(k.shape), k.stride(),
                                    tuple(v.shape), v.stride(), F32)
    assert again[1] is args
    vals = list(args)
    assert isinstance(args, ctypes.Array) and len(vals) == 32
    assert vals[:8] == [1, 12, 304, 304, 64, 64, 1, 1]
    assert vals[8:11] == [304 * 768, 768, 64]  # q: batch, token, head
    assert vals[11:14] == [12 * 304 * 64, 64, 304 * 64]  # the output, contiguous
    assert vals[14] == 0
    assert vals[15:29] == [*plan.k.dims, *plan.k.strides, *plan.v.dims, *plan.v.strides]
    assert vals[29:] == [plan.block_q, plan.block_k, plan.slots]
    with_bias = flash._heads_major_args(tuple(q.shape), q.stride(), tuple(k.shape), k.stride(),
                                        tuple(v.shape), v.stride(), F32, 304)[1]
    assert with_bias is not args and list(with_bias)[14] == 304


def test_key_rows_reads_a_bias_in_place():
    """A (B, Lk) or (1, Lk) fp32 bias with contiguous keys reaches the
    kernels as it is (batch stride 0 for one row); others are copied."""
    bias = torch.zeros(2, 300)
    assert flash._key_rows(bias, 2, 300) == (bias, 300)
    one = torch.zeros(1, 300)
    assert flash._key_rows(one, 2, 300) == (one, 0)
    rows, sb = flash._key_rows(torch.zeros(2, 1, 1, 300, dtype=BF16), 2, 300)
    assert rows.shape == (2, 300) and rows.dtype == F32 and sb == 300
    assert flash._key_rows(None, 2, 300) == (None, 0)


@pytest.mark.parametrize("lk", LKS)
@pytest.mark.parametrize("d", DS)
def test_int8_plan(d, lk):
    """K6: q8/k8 rows of d rounded up to 32 bytes and v16 rows of whole
    64-column boxes (TMA strides of 16-byte multiples, int8 wgmma's 32-deep
    steps, no box past the innermost extent); meta's keys padded to whole
    key tiles; the five buffers 1024-byte aligned in one workspace; maps
    whose boxes bring a tile at once; the prelude's clusters of 8 CTAs over
    each (b, h) of K, Q and V."""
    b, h, lq = 1, 12, 1056
    q, k, v = _wav2vec(b, lq, lk, h, d)
    plan = flash.int8_plan(q, k, v)
    d_p = -(-d // 32) * 32
    d_vp = -(-d_p // 64) * 64
    block_q = _block_q(d_p, lq, b * h)
    block_k = 128 if d_vp <= 128 else 64
    assert (plan.d, plan.d_p, plan.d_vp) == (d, d_p, d_vp)
    assert (plan.block_q, plan.block_k, plan.stages) == (block_q, block_k, flash.INT8_STAGES)
    assert plan.lk_pad % block_k == 0 and lk <= plan.lk_pad < lk + block_k
    bh = b * h
    assert plan.q8 == flash.TmaMap((32, lq, d_p // 32, bh), (d_p, 32, lq * d_p),
                                   (32, block_q, d_p // 32, 1))
    assert plan.k8 == flash.TmaMap((32, lk, d_p // 32, bh), (d_p, 32, lk * d_p),
                                   (32, block_k, d_p // 32, 1))
    assert plan.v16 == flash.TmaMap((64, lk, d_vp // 64, bh), (2 * d_vp, 128, 2 * lk * d_vp),
                                    (64, block_k, d_vp // 64, 1))
    sizes = (bh * lq * d_p, bh * lk * d_p, 4 * bh * lq, 8 * bh * plan.lk_pad,
             2 * bh * lk * d_vp)
    ends = [o + n for o, n in zip(plan.offsets, sizes)]
    assert all(o % 1024 == 0 for o in plan.offsets)
    assert all(e <= o for e, o in zip(ends, plan.offsets[1:])) and ends[-1] <= plan.workspace
    assert plan.grid == (-(-lq // block_q), h, b)
    assert plan.prelude_grid == (flash.INT8_PRELUDE_CLUSTER, bh, 3)


@pytest.mark.parametrize("lq,block_q,ctas", [(1056, 128, 108), (4096, 192, 264)])
def test_int8_plan_of_the_audio_path(lq, block_q, ctas):
    """42 s of audio (L 1056) and about 2.7 min (L 4096) at d 64: q8/k8
    rows of 64 bytes (two 32-byte blocks), v16 rows of 64 columns, 128-key
    tiles; at L 1056 128 query rows a CTA, 108 CTAs in one wave; at L 4096
    192, 264 CTAs, two waves of one CTA an SM."""
    plan = flash.int8_plan(*_wav2vec(1, lq, lq, 12, 64))
    assert (plan.d_p, plan.d_vp, plan.block_k, plan.block_q) == (64, 64, 128, block_q)
    assert plan.grid[0] * plan.grid[1] * plan.grid[2] == ctas


def test_int8_launch_array_is_cached_and_complete():
    """The prelude and the attention kernel share one launch array, built
    once per shape (csrc/flash_int8_sm90.cu's enum Arg)."""
    q, k, v = _wav2vec(1, 1056, 1050, 12, 64)
    key = (tuple(q.shape), q.stride(), tuple(k.shape), k.stride(), tuple(v.shape), v.stride(),
           F32, 1050)
    plan, args = flash._int8_args(*key)
    assert flash._int8_args(*key)[1] is args
    vals = list(args)
    assert vals[:9] == [1, 12, 1056, 1050, 64, 64, 64, plan.lk_pad, 1]
    assert vals[9:18] == [1056 * 768, 768, 64, 1050 * 768, 768, 64, 1050 * 768, 768, 64]
    assert vals[18:] == [1050, plan.block_q, plan.block_k, plan.stages]


@pytest.mark.parametrize("case,error", [
    ("d 168", ValueError), ("d 12", ValueError), ("shapes", ValueError),
    ("q strides", ValueError), ("k strides", ValueError), ("d strided", ValueError),
])
def test_plans_reject_what_the_kernels_do_not_take(case, error):
    """d not a multiple of 8 in 8..160, mismatched shapes, strides that are
    not 16-byte steps, a head dim that is not contiguous."""
    d = {"d 168": 168, "d 12": 12}.get(case, 64)
    q, k, v = _contiguous(1, 300, 300, 2, d)
    if case == "shapes":
        k = torch.empty(1, 2, 300, 32)
    elif case == "q strides":
        q = torch.empty(1, 2, 300, 66)[..., :64]
    elif case == "k strides":
        k = torch.empty(1, 2, 300, 66)[..., :64]
        v = k
    elif case == "d strided":
        k = torch.empty(1, 2, 64, 300).transpose(2, 3)
        v = k
    for plan in (flash.heads_major_plan, flash.int8_plan):
        with pytest.raises(error):
            plan(q, k, v)


@pytest.mark.parametrize("plan", ["heads_major_plan", "int8_plan"])
@pytest.mark.parametrize("dtypes", [(torch.float16,) * 3, (F32, BF16, F32), (BF16, BF16, F32)])
def test_plans_reject_other_dtypes(plan, dtypes):
    """bf16 or fp32, one type for q, k and v."""
    q, k, v = (torch.empty(1, 2, 300, 64, dtype=t) for t in dtypes)
    with pytest.raises(TypeError):
        getattr(flash, plan)(q, k, v)


@pytest.mark.parametrize("call", ["flash_attention", "flash_attention_int8", "int8_prelude"])
def test_no_cpu_fallback_off_the_cpu(call):
    """No fallback on a tensor that is not on the CPU (meta tensors stand in
    for the card's): an input that needs a gradient raises before any
    launch, and under no_grad the device check raises."""
    fn = getattr(flash, call)
    h = torch.empty(1, 12, 300, 64, device="meta")
    g = h.clone().requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        fn(g, g, g)
    with pytest.raises(ValueError, match="is on meta"):
        fn(h, h, h)


@pytest.mark.parametrize("call", ["flash_attention", "flash_attention_int8"])
def test_cpu_tensors_take_the_plain_versions(call):
    """A CPU tensor takes `attention_reference` or `int8_reference` and
    launches nothing."""
    gen = torch.Generator().manual_seed(9)
    q, k, v = (torch.randn(1, 2, n, 40, generator=gen) for n in (70, 33, 33))
    before = dict(flash.LAUNCHES)
    got = getattr(flash, call)(q, k, v)
    assert flash.LAUNCHES == before
    want = (flash.int8_reference(q, k, v) if call == "flash_attention_int8"
            else flash.attention_reference(q, k, v))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_int8_prelude_counts_apart_from_the_attention():
    """The prelude has a launch count of its own beside the attention
    kernel's, which counts one per attention call."""
    assert "int8_prelude" in flash.LAUNCHES and "flash_int8" in flash.LAUNCHES
    assert "flash_fwd_t" in flash.LAUNCHES
