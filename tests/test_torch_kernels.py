"""hallo_tpu_torch's CUDA kernels against their plain PyTorch versions.

These need a card (`gpu` marker) and skip without one. The file imports
torch and the port only, so it also runs where jax is not installed:

    python -m pytest tests/test_torch_kernels.py -m gpu -q --noconftest

(`--noconftest` skips tests/conftest.py, which sets jax up for the CPU
tests.) Inputs are unit-normal; the plain version runs in fp32 from the same
inputs. The kernels round q, k, v (fp32 I/O: on the way into shared
memory), the probabilities and a bf16 output to bf16 (8 bits of mantissa),
about 0.4% of each value. Each case holds two limits: max abs error 2e-2
(an error local to a few rows, where |o| ~ 1 at short key lengths), and
relative L2 error 1e-2 of the case's own output (at long key lengths a
typical |o| is ~sqrt(e / Lk), as small as 2e-2 at Lk 8192, and only the
relative limit sees a dropped key tile or a slightly wrong scale there).
On an H100 the relative errors read 1.7e-3 to 3.3e-3, and dropping the
first 64 of 8192 keys reads 9.0e-2 (chip_smoke.py's kernel phase). K1 runs
`csrc/flash_fwd_sm90.cu`, K2 `csrc/temporal_attn_sm90.cu`, K3
`csrc/flash_fwd_t_sm90.cu`, K4 `csrc/flash_fwd_d512_sm90.cu`, K6
`csrc/flash_int8_sm90.cu` (its quantisation prelude and the attention),
K8 `csrc/winograd.cu` and K9 `csrc/layout_copy.cu` (Hopper kernels). K1's LSE and K5's
gradients, K8 (the Winograd conv) and K9 (the layout copy) have
limits of their own (see their tests).
"""

import pytest
import torch

from hallo_tpu_torch.ops import attention, flash, layout, temporal, winograd

ATOL = 2e-2
RTOL = 1e-2


def _close(got, want):
    err = (got.float() - want).float()
    return (err.abs().max().item() <= ATOL
            and (err.norm() / want.float().norm()).item() <= RTOL)


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
    assert _close(got, want)


def _k1_with_lse(q, k, v, heads, bias=None):
    """K1 (`flash_fwd_sm90.cu`) with its LSE, counting that it launched once."""
    before = flash.LAUNCHES["flash_fwd_packed"]
    out, lse = flash.flash_forward_packed(q, k, v, heads, bias, with_lse=True)
    assert flash.LAUNCHES["flash_fwd_packed"] == before + 1
    return out, lse


@pytest.mark.gpu
@pytest.mark.parametrize("lk", [1, 4, 32, 33, 127, 129, 8192])
@pytest.mark.parametrize("d", [8, 40, 64, 72, 80, 128, 160])
def test_sm90_flash_kernel_matches_plain(cuda_device, d, lk):
    """K1's Hopper kernel over its head-dim classes (one, two and three
    64-column boxes; d a multiple of 16 or not, so the contraction is padded
    by TMA's zero fill) and key lengths of one key, a partial tile, one key
    past a 32- or 128-key boundary, and many tiles, at a ragged Lq of 65:
    the output against `packed_reference`, the LSE (log2 units, max abs
    1e-3) against `flash_lse_reference`."""
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    heads = 2
    q, k, v = (_bf16(gen, cuda_device, 2, n, heads * d) for n in (65, lk, lk))
    out, lse = _k1_with_lse(q, k, v, heads)
    qf, kf, vf = q.float(), k.float(), v.float()
    assert _close(out, flash.packed_reference(qf, kf, vf, heads))
    assert (lse - flash.flash_lse_reference(qf, kf, heads)).abs().max().item() <= 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("lq", [1, 65, 4095])
def test_sm90_flash_kernel_ragged_queries(cuda_device, lq):
    """Level 0's width (8 heads of d 40) and reference-concat key length
    (8192) at query lengths that leave one row, a part of the second
    warpgroup, and all but one row of the last block: the inference entry
    (`flash_attention_packed` without a gradient) and the LSE."""
    gen = torch.Generator(device=cuda_device).manual_seed(12)
    q, k, v = (_bf16(gen, cuda_device, 1, n, 320) for n in (lq, 8192, 8192))
    with torch.no_grad():
        got = flash.flash_attention_packed(q, k, v, heads=8)
    want = flash.packed_reference(q.float(), k.float(), v.float(), 8)
    assert _close(got, want)
    _, lse = _k1_with_lse(q, k, v, 8)
    assert (lse - flash.flash_lse_reference(q.float(), k.float(), 8)).abs().max().item() <= 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("d", [40, 80, 160])
def test_sm90_flash_kernel_masked_keys_and_empty_rows(cuda_device, d):
    """The main path's widths with MASK_VALUE on the second half of the keys
    (batch 0), on every key (batch 1) and on none (batch 2). A row whose keys
    are all masked gets output 0 and LSE -MASK_VALUE (kLseEmpty), which K5
    reads; the others hold the plain versions' limits."""
    gen = torch.Generator(device=cuda_device).manual_seed(13)
    heads, lq, lk = 8, 300, 1000
    q, k, v = (_bf16(gen, cuda_device, 3, n, heads * d) for n in (lq, lk, lk))
    bias = torch.zeros(3, lk, device=cuda_device)
    bias[0, lk // 2:] = flash.MASK_VALUE
    bias[1] = flash.MASK_VALUE
    out, lse = _k1_with_lse(q, k, v, heads, bias)
    assert torch.equal(out[1], torch.zeros_like(out[1]))
    torch.testing.assert_close(lse[1], torch.full_like(lse[1], -flash.MASK_VALUE), rtol=1e-6,
                               atol=0)
    for i in (0, 2):
        qf, kf, vf = (t[i:i + 1].float() for t in (q, k, v))
        assert _close(out[i:i + 1], flash.packed_reference(qf, kf, vf, heads, bias[i:i + 1]))
        want_lse = flash.flash_lse_reference(qf, kf, heads, bias[i:i + 1])
        assert (lse[i:i + 1] - want_lse).abs().max().item() <= 1e-3


@pytest.mark.gpu
def test_flash_kernel_d512_matches_plain(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    q, k, v = (_bf16(gen, cuda_device, 3, 1, 4096, 512) for _ in range(3))
    got = flash.flash_attention(q, k, v)
    want = attention.attention_reference(q.float(), k.float(), v.float())
    assert _close(got, want)


def _k4(q, k, v, bias=None):
    """K4 (`flash_fwd_d512_sm90.cu`), counting that it launched once."""
    before = flash.LAUNCHES["flash_fwd"]
    out = flash.flash_attention(q, k, v, bias=bias)
    assert flash.LAUNCHES["flash_fwd"] == before + 1
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("lk", [1, 33, 4096])
@pytest.mark.parametrize("d", [128, 256, 384, 512])
def test_sm90_d512_kernel_matches_plain(cuda_device, d, lk):
    """K4's Hopper kernel at every head dim it takes (2, 4, 6 and 8
    64-column blocks; 2 to 4 ring stages) and key lengths of one key, one
    past a 32-key tile and many tiles, at a ragged Lq of 65 and 2 heads."""
    gen = torch.Generator(device=cuda_device).manual_seed(21)
    q, k, v = (_bf16(gen, cuda_device, 2, 2, n, d) for n in (65, lk, lk))
    got = _k4(q, k, v)
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    assert _close(got, attention.attention_reference(q.float(), k.float(), v.float()))


@pytest.mark.gpu
@pytest.mark.parametrize("b,lq", [(3, 4096), (16, 4096), (1, 4095)])
def test_sm90_d512_kernel_at_the_vae_mid_block(cuda_device, b, lq):
    """The main path's shapes, one head of d 512: the encode (B 3), the
    decode (B 16), and all but one row of the last query tile; the plain
    version runs one sample at a time."""
    gen = torch.Generator(device=cuda_device).manual_seed(22)
    q, k, v = (_bf16(gen, cuda_device, b, 1, n, 512) for n in (lq, 4096, 4096))
    got = _k4(q, k, v)
    for i in range(b):
        want = attention.attention_reference(q[i:i + 1].float(), k[i:i + 1].float(),
                                             v[i:i + 1].float())
        assert _close(got[i:i + 1], want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_sm90_d512_kernel_masked_keys_and_empty_rows(cuda_device, dtype):
    """MASK_VALUE on the second half of the keys (batch 0), on every key
    (batch 1: output 0) and on none (batch 2), with a ragged Lk of 300 (the
    tiled bias's -inf past Lk); fp32 q, k, v are rounded to bf16 and the
    output is fp32."""
    gen = torch.Generator(device=cuda_device).manual_seed(23)
    q, k, v = (torch.randn(3, 2, n, 512, generator=gen, device=cuda_device).to(dtype)
               for n in (200, 300, 300))
    bias = torch.zeros(3, 300, device=cuda_device)
    bias[0, 150:] = flash.MASK_VALUE
    bias[1] = flash.MASK_VALUE
    got = _k4(q, k, v, bias)
    assert got.dtype == dtype
    assert torch.equal(got[1], torch.zeros_like(got[1]))
    for i in (0, 2):
        want = attention.attention_reference(
            q[i:i + 1].float(), k[i:i + 1].float(), v[i:i + 1].float(),
            bias[i:i + 1, None, None, :])
        assert _close(got[i:i + 1], want)


@pytest.mark.gpu
def test_sm90_d512_and_winograd_kernels_are_bitwise_repeatable(cuda_device):
    """K4 (its two consumers sum S's halves through shared memory behind
    named barriers) and K8 (persistent CTAs, the two warpgroups' halves of Y
    summed through shared memory) have no atomics, and their rings' parity
    waits must hold: 300 launches at the decode's and level 0's shapes give
    the first launch's bits."""
    gen = torch.Generator(device=cuda_device).manual_seed(24)
    q, k, v = (_bf16(gen, cuda_device, 16, 1, 4096, 512) for _ in range(3))
    x, kk, bias = _winograd_inputs(cuda_device, (32, 64, 64, 320), 320, torch.bfloat16, seed=11)
    u = winograd.kernel_weights(kk, torch.bfloat16)
    first = (flash.flash_attention(q, k, v), winograd.winograd_launch(x, u, 320, bias))
    bad = 0
    for _ in range(300):
        again = (flash.flash_attention(q, k, v), winograd.winograd_launch(x, u, 320, bias))
        bad += not all(torch.equal(a, b) for a, b in zip(first, again))
    assert bad == 0


@pytest.mark.gpu
@pytest.mark.parametrize("lse", [False, True])
@pytest.mark.parametrize("b,lq,lk,c", [(2, 4096, 32, 320), (2, 4096, 4, 320),
                                       (2, 4096, 8192, 320), (8, 4096, 4096, 320)])
def test_sm90_flash_kernel_repeats_bit_for_bit_over_300_launches(cuda_device, b, lq, lk, c,
                                                                 lse):
    """K1's ring (TMA loads behind mbarrier parity waits, a producer warp
    ahead of the consumers): 300 launches at the audio attention's Lk 32,
    the identity attention's Lk 4, level 0's self-attention over the
    reference concat (Lk 8192) and the stage-1 ReferenceNet's self-attention
    at its batch of 8 (Lq = Lk), with and without the LSE output, give the
    first launch's output (and LSE) bit for bit."""
    gen = torch.Generator(device=cuda_device).manual_seed(40 + lk)
    q, k, v = (_bf16(gen, cuda_device, b, n, c) for n in (lq, lk, lk))

    def run():
        if lse:
            return flash.flash_forward_packed(q, k, v, 8, None, with_lse=True)
        return (flash.flash_attention_packed(q, k, v, heads=8),)

    before = flash.LAUNCHES["flash_fwd_packed"]
    first = run()
    assert all(torch.isfinite(t).all() for t in first)
    bad = sum(not all(torch.equal(a, b) for a, b in zip(run(), first)) for _ in range(300))
    assert bad == 0
    assert flash.LAUNCHES["flash_fwd_packed"] == before + 301


def _sampler_trajectory(name, grid, dev, n=10, fault=None):
    """Seeded latents and model outputs through a sampler's steps on `dev`
    (the model output depends on the sample, so the carry matters); every
    sample and carry leaf, on the host. `fault` replaces the UniPC state."""
    from hallo_tpu_torch.config import SchedulerConfig
    from hallo_tpu_torch.diffusion import unipc
    from hallo_tpu_torch.diffusion.sampler import make_sampler

    sampler = make_sampler(SchedulerConfig(), name, n, timestep_schedule=grid)
    step = sampler.step
    if fault is not None:
        state = fault(sampler.state)
        step = lambda i, out, x, c: unipc.unipc_step(state, i, out, x, c)  # noqa: E731
    gen = torch.Generator().manual_seed(n)
    x = torch.randn(1, 4, 8, 8, 4, generator=gen).to(dev)
    outs = torch.randn(n, 1, 4, 8, 8, 4, generator=gen).to(dev)
    c, seen = sampler.init_carry(x), []
    for i in range(n):
        x, c = step(i, outs[i] + 0.3 * x, x, c)
        leaves = () if c is None else (c if isinstance(c, tuple) else (c,))
        seen += [t.cpu() for t in (x,) + tuple(leaves)]
    return seen


@pytest.mark.gpu
@pytest.mark.parametrize("grid", ["trailing", "logsnr"])
@pytest.mark.parametrize("name", ["ddim", "dpm++2m", "unipc"])
def test_sampler_steps_on_the_card_match_the_cpu(cuda_device, name, grid):
    """DDIM, DPM-Solver++ (2M) and UniPC alone over 10 steps, carries
    included, on CUDA tensors against the CPU: 1e-6 (fp32 elementwise
    updates; the card may fuse a multiply-add the CPU rounds twice)."""
    got = _sampler_trajectory(name, grid, cuda_device)
    want = _sampler_trajectory(name, grid, torch.device("cpu"))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-6, rtol=1e-6)


@pytest.mark.gpu
def test_sampler_card_check_sees_a_zeroed_corrector(cuda_device):
    """The check above must see UniPC's corrector go: the CPU run with
    `c_dt` zeroed (UniC without its data term) against the card's."""
    import numpy as np

    got = _sampler_trajectory("unipc", "trailing", cuda_device)
    want = _sampler_trajectory("unipc", "trailing", torch.device("cpu"),
                               fault=lambda s: s._replace(c_dt=np.zeros_like(s.c_dt)))
    worst = max((g - w).abs().max().item() for g, w in zip(got, want))
    assert worst > 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("d", [192, 640])
def test_sm90_d512_kernel_raises_for_other_wide_heads(cuda_device, d):
    """No fallback: a head dim neither K3 (multiples of 8 up to 160) nor K4
    (128 n up to 512) takes raises on the card."""
    q = torch.zeros(1, 1, 64, d, dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        flash.flash_attention(q, q, q)


@pytest.mark.gpu
@pytest.mark.parametrize("lq", [304, 1056])
def test_flash_kernel_fp32_heads_major_matches_plain(cuda_device, lq):
    """K3: the wav2vec2 self-attention, fp32 I/O, 12 heads of d = 64, taken
    through the same transposed (B, T, H, d) -> (B, H, T, d) view as the
    model's."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    q, k, v = (torch.randn(1, lq, 12, 64, generator=gen, device=cuda_device).transpose(1, 2)
               for _ in range(3))
    before = flash.LAUNCHES["flash_fwd_t"]
    got = flash.flash_attention(q, k, v)
    assert got.dtype == torch.float32 and flash.LAUNCHES["flash_fwd_t"] == before + 1
    want = attention.attention_reference(q, k, v)
    assert _close(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["plain", "half_masked", "ragged_lk"])
def test_int8_kernel_matches_plain(cuda_device, case):
    """K6 at the audio path's shape (12 heads, d = 64, L 1056, fp32 V)."""
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    lk = 1050 if case == "ragged_lk" else 1056
    q = torch.randn(1, 12, 1056, 64, generator=gen, device=cuda_device)
    k, v = (torch.randn(1, 12, lk, 64, generator=gen, device=cuda_device) for _ in range(2))
    bias = None
    if case == "half_masked":
        bias = torch.zeros(1, lk, device=cuda_device)
        bias[:, lk // 2:] = flash.MASK_VALUE
    got = flash.flash_attention_int8(q, k, v, bias=bias)
    want = flash.int8_reference(q, k, v, bias)
    assert got.dtype == torch.float32
    assert _close(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "f,l,c", [(18, 4096, 320), (16, 4096, 320), (18, 256, 1280), (17, 77, 640)]
)
def test_temporal_kernel_matches_plain(cuda_device, f, l, c):
    """F 16 and 18 (the main path's) and 17 (another) run the same kernel."""
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    q, k, v = (_bf16(gen, cuda_device, 2, f, l, c) for _ in range(3))
    got = temporal.temporal_attention(q, k, v, heads=8)
    want = temporal.temporal_reference(q.float(), k.float(), v.float(), 8)
    assert _close(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("b,f,heads,d,l", [(1, 6, 2, 8, 256), (2, 5, 2, 16, 200)])
def test_temporal_kernel_at_packed_cases_matches_plain(cuda_device, b, f, heads, d, l):
    """K7 (`_temporal_kernel_packed`): K2's kernel at K7's own test cases
    (tests/test_pallas_temporal.py), which take the run-time frame count."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    q, k, v = (_bf16(gen, cuda_device, b, f, l, heads * d) for _ in range(3))
    got = temporal.temporal_attention(q, k, v, heads=heads)
    want = temporal.temporal_reference(q.float(), k.float(), v.float(), heads)
    assert _close(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("b,f,l,c", [(2, 18, 4096, 320), (2, 18, 1024, 640), (2, 18, 256, 1280),
                                     (2, 18, 64, 1280), (1, 16, 4096, 320)],
                         ids=["level0", "level1", "level2", "level3", "training_level0"])
def test_temporal_sm90_kernel_at_the_main_path(cuda_device, b, f, l, c):
    """K2 (`temporal_attn_sm90.cu`) at the 512^2 denoiser's four levels (B
    2, F 18 = 16 clip + 2 motion frames, 8 heads of d 40, 80, 160, 160) and
    training's level 0 (B 1, F 16 = 14 + 2), one launch each."""
    gen = torch.Generator(device=cuda_device).manual_seed(31)
    q, k, v = (_bf16(gen, cuda_device, b, f, l, c) for _ in range(3))
    before = temporal.LAUNCHES["temporal_attn"]
    got = temporal.temporal_attention(q, k, v, heads=8)
    assert temporal.LAUNCHES["temporal_attn"] == before + 1
    assert _close(got, temporal.temporal_reference(q.float(), k.float(), v.float(), 8))


@pytest.mark.gpu
@pytest.mark.parametrize("b,f,l,heads,d", [
    (2, 1, 77, 8, 40), (2, 17, 1024, 8, 80), (2, 32, 256, 8, 40), (1, 32, 64, 8, 160),
    (2, 5, 203, 2, 16), (1, 6, 250, 2, 8), (2, 18, 77, 8, 72), (1, 32, 64, 8, 152),
    (2, 18, 100, 10, 40), (1, 9, 33, 3, 24),
], ids=["f1_ragged_sites", "f17", "f32", "f32_d160", "k7_d16_ragged_sites", "k7_d8",
        "d72_ragged", "d152_shared_boxes", "partial_head_group", "f9_d24"])
def test_temporal_sm90_kernel_frame_counts_and_ragged_sites(cuda_device, b, f, l, heads, d):
    """Any F up to 32 runs the same kernel: F 1, 17 and 32, K7's head dims 8
    and 16, L not a multiple of the unit's sites (F 1 takes 24 sites a unit,
    F 5 25), d 72 (9 boxes), d 152 (units of fewer heads that share a box
    with their neighbours), a last group of 2 of 10 heads, d 24."""
    gen = torch.Generator(device=cuda_device).manual_seed(32)
    q, k, v = (_bf16(gen, cuda_device, b, f, l, heads * d) for _ in range(3))
    got = temporal.temporal_attention(q, k, v, heads=heads)
    assert _close(got, temporal.temporal_reference(q.float(), k.float(), v.float(), heads))


@pytest.mark.gpu
@pytest.mark.parametrize("d", [40, 72])
def test_temporal_sm90_keeps_a_neighbour_heads_inf_out(cuda_device, d):
    """inf planted in head h + 1's first columns of q, k and v (which a box
    holding head h's columns also holds) does not reach head h: the kernel
    reads exactly each head's d columns. Head h equals the plain version on
    head h alone; head h + 1 is non-finite, as the plain version's is."""
    gen = torch.Generator(device=cuda_device).manual_seed(33)
    heads, h = 4, 1
    q, k, v = (_bf16(gen, cuda_device, 2, 18, 300, heads * d) for _ in range(3))
    nxt = slice((h + 1) * d, (h + 1) * d + 8)
    for t in (q, k, v):
        t[..., nxt] = float("inf")
    got = temporal.temporal_attention(q, k, v, heads=heads)
    cols = slice(h * d, (h + 1) * d)
    want = temporal.temporal_reference(*(t[..., cols].float() for t in (q, k, v)), 1)
    assert torch.isfinite(got[..., cols]).all()
    assert _close(got[..., cols], want)
    assert not torch.isfinite(got[..., (h + 1) * d:(h + 2) * d]).all()


@pytest.mark.gpu
def test_temporal_sm90_and_layout_copy_repeat_over_many_launches(cuda_device):
    """The rings' parity waits: 300 launches each of K2 (levels 1 and 3 at F
    18, and training's F 16, where each CTA walks many units through its
    ring) and of K9 (the level-0 activation, 39 or 40 stages a CTA) give the
    first launch's output bit for bit."""
    gen = torch.Generator(device=cuda_device).manual_seed(34)
    for b, f, l, c in ((2, 18, 1024, 640), (2, 18, 64, 1280), (1, 16, 4096, 320)):
        q, k, v = (_bf16(gen, cuda_device, b, f, l, c) for _ in range(3))
        first = temporal.temporal_attention(q, k, v, heads=8)
        assert torch.isfinite(first).all()
        bad = sum(not torch.equal(temporal.temporal_attention(q, k, v, heads=8).view(torch.int16),
                                  first.view(torch.int16)) for _ in range(300))
        assert bad == 0
    x = _bf16(gen, cuda_device, 131072, 320)
    bad = sum(not torch.equal(layout.layout_anchor(x).view(torch.int16), x.view(torch.int16))
              for _ in range(300))
    assert bad == 0


@pytest.mark.gpu
@pytest.mark.parametrize("nbytes,offset", [
    (16384 - 16, 0), (16384 + 16, 0), (16384 * 12 - 2, 0), (16384 * 12 + 2, 0),
    (16384 * 132 + 30, 0), (16384 * 12 + 7, 16), (16384 * 12 + 7, 6), (16384 * 12 + 7, 3),
], ids=["below_a_stage", "above_a_stage", "below_the_ring", "above_the_ring",
        "a_stage_past_the_grid", "view_16_bytes_in", "view_6_bytes_in", "view_3_bytes_in"])
def test_layout_copy_around_ring_stages(cuda_device, nbytes, offset):
    """K9 at sizes just below and above a ring stage (16 KB), the ring (12
    stages) and one stage a CTA of the whole grid (132 CTAs), with ragged
    tails; a source 16 bytes into its storage (aligned as the fresh output
    is: a body and a tail), and sources 6 and 3 bytes in (the offsets differ
    modulo 16: a byte a thread). Bit for bit."""
    gen = torch.Generator(device=cuda_device).manual_seed(35)
    raw = torch.randint(0, 256, (nbytes + offset,), generator=gen, device=cuda_device,
                        dtype=torch.uint8)
    x = raw[offset:].view(1, nbytes)
    got = layout.layout_anchor(x)
    plan = layout.copy_plan(x.data_ptr(), got.data_ptr(), nbytes)
    assert (plan.body > 0) == (offset % 16 == 0)
    assert torch.equal(got, x)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "b,lq,lk,c,with_bias,dtype",
    [(14, 4096, 8192, 320, True, torch.bfloat16), (14, 1024, 2048, 640, True, torch.bfloat16),
     (14, 256, 512, 1280, True, torch.bfloat16), (14, 4096, 32, 320, False, torch.bfloat16),
     (14, 4096, 4, 320, False, torch.bfloat16), (2, 100, 150, 320, True, torch.bfloat16),
     (2, 100, 150, 320, True, torch.float32)],
)
def test_flash_lse_and_backward_kernels_match_plain(cuda_device, b, lq, lk, c, with_bias, dtype):
    """K1's LSE and K5's dQ, dK, dV at the stage-2 training shapes (14
    frames at 512^2: levels 0-2 with the CFG-uncond bias on the ref half of
    half the batch, audio Lk 32, identity Lk 4) and a ragged small case in
    bf16 and fp32 I/O (fp32 tiles are rounded to bf16 on their way into
    shared memory, as in the forward).
    The LSE is in log2 units: max abs 1e-3 (P off by 0.07%). The gradients
    grow with the length they sum over, so their max abs error is held
    against 2e-2 of the plain gradient's max |value|, beside the relative
    L2 limit. The plain versions run one sample at a time (their (H, Lq, Lk)
    fp32 temporaries)."""
    heads = 8
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    q, k, v, g = (_bf16(gen, cuda_device, b, n, c).to(dtype) for n in (lq, lk, lk, lq))
    bias = None
    if with_bias:
        bias = torch.zeros(b, lk, device=cuda_device)
        bias[: b // 2, lk // 2:] = -1e9
    before = {n: flash.LAUNCHES[n] for n in ("flash_bwd_dkv", "flash_bwd_dq")}
    out, lse = flash.flash_forward_packed(q, k, v, heads, bias, with_lse=True)
    grads = flash.flash_backward(q, k, v, bias, out, lse, g, heads)
    assert all(flash.LAUNCHES[n] == before[n] + 1 for n in before)
    for i in range(b):
        # the plain versions on the operands the kernels multiply (bf16)
        qf, kf, vf, gf = (t[i:i + 1].to(torch.bfloat16).float() for t in (q, k, v, g))
        bi = None if bias is None else bias[i:i + 1]
        want_lse = flash.flash_lse_reference(qf, kf, heads, bi)
        assert (lse[i:i + 1] - want_lse).abs().max().item() <= 1e-3
        want = flash.flash_backward_reference(qf, kf, vf, bi, out[i:i + 1], lse[i:i + 1], gf,
                                              heads)
        for got, w in zip(grads, want):
            err = (got[i:i + 1].float() - w.float())
            assert err.abs().max().item() <= ATOL * w.abs().max().item()
            assert (err.norm() / w.float().norm()).item() <= RTOL


@pytest.mark.gpu
def test_flash_packed_autograd_takes_the_kernels(cuda_device):
    """With a gradient to take, `flash_attention_packed` runs K1 with its LSE
    and both K5 passes, and no plain version."""
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    q, k, v = (_bf16(gen, cuda_device, 2, n, 320).requires_grad_() for n in (300, 600, 600))
    before = dict(flash.LAUNCHES)
    out = flash.flash_attention_packed(q, k, v, heads=8)
    out.float().square().sum().backward()
    launched = {n: flash.LAUNCHES[n] - before[n] for n in before}
    assert launched == {**{n: 0 for n in before}, "flash_fwd_packed": 1, "flash_bwd_dkv": 1,
                        "flash_bwd_dq": 1}
    assert all(torch.isfinite(t.grad).all() for t in (q, k, v))


def _winograd_inputs(dev, shape, cout, dtype, seed):
    """x ~ N(0, 1), an HWIO kernel ~ N(0, 1) / 30 and a non-zero fp32 bias."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(*shape, generator=gen, device=dev).to(dtype)
    k = (torch.randn(3, 3, shape[-1], cout, generator=gen, device=dev) / 30).to(dtype)
    return x, k, torch.randn(cout, generator=gen, device=dev)


def _scaled_close(got, want):
    """K8's limits: the outputs reach |y| ~ 15 at C 960, where a bf16 output's
    own rounding exceeds 2e-2, so the max abs error is held against 2e-2 of
    max |plain|, beside the relative L2 limit 1e-2."""
    err = got.float() - want.float()
    return (err.abs().max().item() <= ATOL * want.float().abs().max().item()
            and (err.norm() / want.float().norm()).item() <= RTOL)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "shape,cout,dtype",
    [((4, 64, 64, 320), 320, torch.bfloat16), ((4, 32, 32, 1280), 640, torch.bfloat16),
     ((4, 32, 32, 640), 640, torch.float32), ((2, 16, 24, 40), 48, torch.bfloat16),
     ((2, 6, 10, 33), 70, torch.bfloat16), ((1, 2, 2, 3), 5, torch.float32)],
    ids=["level0_res", "level1_up", "level1_res_fp32", "non_square", "odd_channels", "one_tile"],
)
def test_winograd_kernel_matches_plain(cuda_device, shape, cout, dtype):
    """K8 against `winograd_reference` (the same transforms and products in
    fp32, U rounded to x's dtype): the denoiser's level-0 and level-1
    widths at batch 4, fp32 I/O (tiles rounded to bf16 in the kernel), a
    non-square one and channel counts that are not multiples of 8 (the
    kernel's element-wise patch loads and stores)."""
    x, k, bias = _winograd_inputs(cuda_device, shape, cout, dtype, seed=8)
    before = winograd.LAUNCHES["winograd_conv3x3"]
    got = winograd.winograd_conv3x3(x, k, bias)
    assert winograd.LAUNCHES["winograd_conv3x3"] == before + 1
    assert got.shape == (*shape[:3], cout) and got.dtype == dtype
    assert _scaled_close(got, winograd.winograd_reference(x, k, bias))


@pytest.mark.gpu
@pytest.mark.parametrize(
    "shape,cout,dtype",
    [((4, 64, 64, 640), 320, torch.bfloat16), ((4, 64, 64, 960), 320, torch.bfloat16),
     ((4, 32, 32, 640), 640, torch.bfloat16), ((3, 34, 18, 16), 64, torch.bfloat16),
     ((1, 18, 30, 40), 24, torch.bfloat16), ((2, 6, 10, 33), 70, torch.float32),
     ((5, 16, 16, 32), 64, torch.float32)],
    ids=["level0_up", "level0_concat", "level1_res", "ragged_patches", "ragged_both",
         "odd_channels_fp32", "odd_units_fp32"],
)
def test_winograd_sm90_kernel_matches_plain(cuda_device, shape, cout, dtype):
    """K8's Hopper kernel against `winograd_reference` at the rest of the
    denoiser's widths (batch 4), patches that H / 2 or W / 2 does not fill
    (read as 0, not written), C and Co padded by the wrapper, and a patch
    count the cluster of two does not divide (the last CTA's patch lies past
    the batch); bf16 and fp32 I/O."""
    x, k, bias = _winograd_inputs(cuda_device, shape, cout, dtype, seed=10)
    before = winograd.LAUNCHES["winograd_conv3x3"]
    got = winograd.winograd_conv3x3(x, k, bias)
    assert winograd.LAUNCHES["winograd_conv3x3"] == before + 1
    assert got.shape == (*shape[:3], cout) and got.dtype == dtype and got.is_contiguous()
    assert _scaled_close(got, winograd.winograd_reference(x, k, bias))


@pytest.mark.gpu
def test_winograd_autograd_matches_cudnn(cuda_device):
    """`winograd_conv3x3_vjp` (K8 forward, cuDNN backward) against autograd
    of `conv3x3_direct`, in fp32 with TF32 off: the gradients are the same
    convolutions in another order of sums (relative L2 1e-4); the forward
    holds K8's limits. The plain entry raises under a gradient."""
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        x, k, bias = _winograd_inputs(cuda_device, (4, 32, 32, 64), 96, torch.float32, seed=9)
        g = torch.randn(4, 32, 32, 96, device=cuda_device)
        leaves = [t.requires_grad_() for t in (x, k, bias)]
        before = winograd.LAUNCHES["winograd_conv3x3"]
        out = winograd.winograd_conv3x3_vjp(*leaves)
        got = torch.autograd.grad(out, leaves, g)
        assert winograd.LAUNCHES["winograd_conv3x3"] == before + 1
        ref = winograd.conv3x3_direct(*leaves)
        want = torch.autograd.grad(ref, leaves, g)
        assert _scaled_close(out.detach(), ref.detach())
        for a, w in zip(got, want):
            assert a.shape == w.shape
            assert ((a - w).norm() / w.norm()).item() <= 1e-4
        with pytest.raises(RuntimeError, match="no backward"):
            winograd.winograd_conv3x3(*leaves)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


@pytest.mark.gpu
@pytest.mark.parametrize(
    "shape,dtype,offset",
    [((131072, 320), torch.bfloat16, 0), ((4099, 37), torch.bfloat16, 0),
     ((3, 5, 7), torch.float32, 0), ((40, 25), torch.float32, 1)],
    ids=["level0_activation", "ragged_bytes", "ndim3", "unaligned"],
)
def test_layout_copy_is_bitwise(cuda_device, shape, dtype, offset):
    """K9: the level-0 activation of the 512^2 denoiser (84 MB), a size with
    a byte tail past the last 16-byte vector, a 3-d tensor, and a view 4
    bytes into its storage (the kernel's unaligned path): equal bit for bit,
    in a new buffer. A transposed view and a tensor that needs a gradient
    raise."""
    n = 1
    for d in shape:
        n *= d
    gen = torch.Generator(device=cuda_device).manual_seed(10)
    x = torch.randn(n + offset, generator=gen, device=cuda_device).to(dtype)[offset:].view(shape)
    before = layout.LAUNCHES["layout_copy"]
    got = layout.layout_anchor(x)
    assert layout.LAUNCHES["layout_copy"] == before + 1
    assert got.data_ptr() != x.data_ptr() and got.is_contiguous()
    assert torch.equal(got.view(torch.uint8 if dtype == torch.bfloat16 else torch.int32),
                       x.view(torch.uint8 if dtype == torch.bfloat16 else torch.int32))
    with pytest.raises(ValueError, match="not contiguous"):
        layout.layout_anchor(x.transpose(0, 1))
    with pytest.raises(RuntimeError, match="no backward"):
        layout.layout_anchor(x.clone().requires_grad_())


def _k5_close(got, want, vanishes=False):
    """K5's limits: the gradients grow with the length they sum over, so the
    max abs error is held against 2e-2 of the plain gradient's max |value|,
    beside the relative L2 limit 1e-2. With one key (`vanishes`, for dQ
    and dK), P is 1 and dS = dP - Delta is 0 up to rounding: both versions'
    residues are differences of two fp32 sums of the same bf16 products,
    held within 1e-3."""
    err = got.float() - want.float()
    if vanishes:
        return err.abs().max().item() <= 1e-3 and want.abs().max().item() <= 1e-3
    return (err.abs().max().item() <= ATOL * want.float().abs().max().item()
            and (err.norm() / want.float().norm()).item() <= RTOL)


def _k5(q, k, v, heads, bias=None, seed=0):
    """K1 with its LSE, then K5 (`flash_bwd_sm90.cu`) on a seeded dO,
    counting one launch of each pass. Returns (g, out, lse, (dq, dk, dv))."""
    gen = torch.Generator(device=q.device).manual_seed(seed)
    g = torch.randn(q.shape, generator=gen, device=q.device).to(q.dtype)
    out, lse = flash.flash_forward_packed(q, k, v, heads, bias, with_lse=True)
    before = {n: flash.LAUNCHES[n] for n in ("flash_bwd_dkv", "flash_bwd_dq")}
    grads = flash.flash_backward(q, k, v, bias, out, lse, g, heads)
    assert all(flash.LAUNCHES[n] == before[n] + 1 for n in before)
    assert all(a.dtype == t.dtype and a.shape == t.shape for a, t in zip(grads, (q, k, v)))
    return g, out, lse, grads


def _k5_plain(q, k, v, bias, out, lse, g, heads, i):
    """The plain version for batch element i, on the operands the kernels
    multiply (bf16)."""
    qf, kf, vf, gf = (t[i:i + 1].to(torch.bfloat16).float() for t in (q, k, v, g))
    bi = None if bias is None else bias[i:i + 1]
    return flash.flash_backward_reference(qf, kf, vf, bi, out[i:i + 1], lse[i:i + 1], gf, heads)


@pytest.mark.gpu
@pytest.mark.parametrize("lk", [1, 4, 32, 33, 127, 129, 8192])
@pytest.mark.parametrize("d", [8, 40, 64, 80, 128, 160])
def test_sm90_backward_kernels_match_plain(cuda_device, d, lk):
    """K5's Hopper kernels over their head-dim classes (one, two and three
    64-column boxes; d a multiple of 16 or not, 32-query dK/dV tiles and
    64-key dQ tiles above d 96) and key lengths of one key, the audio and
    identity lengths (both consumers on the same 64 keys in the dK/dV pass,
    several query tiles a dQ CTA), one key past a boundary, and many tiles,
    at a ragged Lq of 65: dQ, dK and dV against `flash_backward_reference`."""
    gen = torch.Generator(device=cuda_device).manual_seed(21)
    heads = 2
    q, k, v = (_bf16(gen, cuda_device, 2, n, heads * d) for n in (65, lk, lk))
    g, out, lse, grads = _k5(q, k, v, heads, seed=22)
    for i in range(2):
        want = _k5_plain(q, k, v, None, out, lse, g, heads, i)
        for j, (got, w) in enumerate(zip(grads, want)):
            assert _k5_close(got[i:i + 1], w, vanishes=lk == 1 and j < 2)


@pytest.mark.gpu
@pytest.mark.parametrize("lq", [1, 65, 4095])
def test_sm90_backward_kernels_ragged_queries(cuda_device, lq):
    """Level 0's width (8 heads of d 40) and reference-concat key length
    (8192) at query lengths that leave one row, part of a tile, and all but
    one row of the last tile (LSE and Delta padded past Lq)."""
    gen = torch.Generator(device=cuda_device).manual_seed(23)
    q, k, v = (_bf16(gen, cuda_device, 1, n, 320) for n in (lq, 8192, 8192))
    g, out, lse, grads = _k5(q, k, v, 8, seed=24)
    for got, w in zip(grads, _k5_plain(q, k, v, None, out, lse, g, 8, 0)):
        assert _k5_close(got, w)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [40, 80, 160])
def test_sm90_backward_kernels_masked_keys(cuda_device, d):
    """The main path's widths with MASK_VALUE on the second half of the keys
    (batch 0), on every key (batch 1: K1's LSE is -MASK_VALUE there, P is 0
    and every gradient exactly 0) and on none (batch 2), and in fp32 I/O
    (rounded to bf16 by the wrapper; fp32 gradients)."""
    gen = torch.Generator(device=cuda_device).manual_seed(25)
    heads, lq, lk = 8, 300, 1000
    q, k, v = (_bf16(gen, cuda_device, 3, n, heads * d) for n in (lq, lk, lk))
    bias = torch.zeros(3, lk, device=cuda_device)
    bias[0, lk // 2:] = flash.MASK_VALUE
    bias[1] = flash.MASK_VALUE
    for dtype in (torch.bfloat16, torch.float32):
        qd, kd, vd = (t.to(dtype) for t in (q, k, v))
        g, out, lse, grads = _k5(qd, kd, vd, heads, bias, seed=26)
        for got in grads:
            assert torch.equal(got[1], torch.zeros_like(got[1]))
        for i in (0, 2):
            for got, w in zip(grads, _k5_plain(qd, kd, vd, bias, out, lse, g, heads, i)):
                assert _k5_close(got[i:i + 1], w)


@pytest.mark.gpu
@pytest.mark.parametrize("b,lq,lk,c", [(14, 4096, 8192, 320), (1, 4096, 32, 320),
                                       (14, 4096, 4, 320), (2, 256, 512, 1280)],
                         ids=["level0", "audio_split", "identity", "level2"])
def test_sm90_backward_kernels_are_bitwise_repeatable(cuda_device, b, lq, lk, c):
    """Two launches on the same inputs give bit-identical dQ, dK and dV: no
    atomics, every sum in a fixed order (the query range split over CTAs at
    B 1, Lk 32, summed by the wrapper in split order)."""
    gen = torch.Generator(device=cuda_device).manual_seed(27)
    q, k, v, g = (_bf16(gen, cuda_device, b, n, c) for n in (lq, lk, lk, lq))
    out, lse = flash.flash_forward_packed(q, k, v, 8, None, with_lse=True)
    first = flash.flash_backward(q, k, v, None, out, lse, g, 8)
    second = flash.flash_backward(q, k, v, None, out, lse, g, 8)
    for a, b2 in zip(first, second):
        assert torch.equal(a.view(torch.int16), b2.view(torch.int16))


@pytest.mark.gpu
@pytest.mark.parametrize("b,lq,lk,c", [(14, 256, 32, 1280), (14, 4096, 32, 320)],
                         ids=["level2_audio", "level0_audio"])
def test_sm90_dkv_alternate_tiles_repeat_over_many_launches(cuda_device, b, lq, lk, c):
    """At Lk <= 64 the dK/dV pass's two consumers take alternate query
    tiles through one ring: 300 launches at the training step's audio
    shapes all give the first one's dK and dV bit for bit (a ring of 3
    let a consumer read a stage still being filled: a non-finite dK and dV
    now and then, placed in the trainer's level-2 audio attention)."""
    gen = torch.Generator(device=cuda_device).manual_seed(30)
    q, k, v, g = (_bf16(gen, cuda_device, b, n, c) for n in (lq, lk, lk, lq))
    out, lse = flash.flash_forward_packed(q, k, v, 8, None, with_lse=True)
    a = flash.backward_args(q, k, v, None, out, lse, g, 8)
    assert a.plan.dkv.wg_split
    first = flash.flash_bwd_dkv(a)
    assert all(bool(torch.isfinite(t).all()) for t in first)
    runs = [flash.flash_bwd_dkv(a) for _ in range(300)]
    bad = sum(not (torch.equal(dk.view(torch.int16), first[0].view(torch.int16))
                   and torch.equal(dv.view(torch.int16), first[1].view(torch.int16)))
              for dk, dv in runs)
    assert bad == 0


@pytest.mark.gpu
@pytest.mark.parametrize("d", [40, 72])
def test_wide_maps_keep_a_neighbour_heads_inf_out(cuda_device, d):
    """Under the wide maps a box reads head h + 1's first columns as head
    h's contraction pad (d up to d rounded to 16): with inf planted there in
    K (for K1) and in K and V (for K5), head h's K1 output and LSE and its
    K5 dQ, dK and dV still equal the plain version's on head h alone, since
    the kernels zero the pad in shared memory. Head h + 1's own results are
    non-finite, as the plain version's are."""
    gen = torch.Generator(device=cuda_device).manual_seed(28)
    heads, h, lq, lk = 4, 1, 200, 300
    q, k, v, g = (_bf16(gen, cuda_device, 2, n, heads * d) for n in (lq, lk, lk, lq))
    nxt = slice((h + 1) * d, (h + 1) * d + 8)
    k[:, :, nxt] = float("inf")
    v[:, :, nxt] = float("inf")
    out, lse = flash.flash_forward_packed(q, k, v, heads, None, with_lse=True)
    grads = flash.flash_backward(q, k, v, None, out, lse, g, heads)
    cols = slice(h * d, (h + 1) * d)
    qh, kh, vh, gh = (t[:, :, cols].float() for t in (q, k, v, g))
    assert _close(out[:, :, cols], flash.packed_reference(qh, kh, vh, 1))
    assert (lse[:, h] - flash.flash_lse_reference(qh, kh, 1)[:, 0]).abs().max().item() <= 1e-3
    want = flash.flash_backward_reference(qh, kh, vh, None, out[:, :, cols], lse[:, h:h + 1],
                                          gh, 1)
    for got, w in zip(grads, want):
        assert torch.isfinite(got[:, :, cols]).all()
        assert _k5_close(got[:, :, cols], w)


# K3 (csrc/flash_fwd_t_sm90.cu) and K6 (csrc/flash_int8_sm90.cu), the Hopper
# redesigns of the audio path's attention.

def _heads_major(gen, dev, b, n, h, d, dtype=torch.float32):
    """The wav2vec2 view: (B, T, H, d) -> (B, H, T, d)."""
    return torch.randn(b, n, h, d, generator=gen, device=dev).to(dtype).transpose(1, 2)


def _masked(dev, lk, start):
    bias = torch.zeros(1, lk, device=dev)
    bias[:, start:] = flash.MASK_VALUE
    return bias


# The K mean's summation order differs between the prelude kernel and
# torch's reduction, so a centred K value can cross a rounding boundary of
# round(x / ks) and move k8 by one. On an H100 that moved 0 of 811008
# elements at L 1056 and 1 of 3145728 (3.2e-7) at L 4096; the bound leaves
# room for other data (chip_smoke.py's prelude case prints the share it
# sees).
K8_OFF_BY_ONE_SHARE = 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("d,lq,lk", [(64, 1056, 1056), (64, 1056, 1050), (64, 1024, 4096),
                                     (40, 300, 1024), (160, 100, 1030), (8, 64, 1024)])
def test_int8_prelude_kernel_matches_quantize_int8(cuda_device, d, lq, lk):
    """K6's prelude kernel against `quantize_int8` on the card: q8 and qs
    (times scale log2 e) bit for bit; k8 within one step on at most
    K8_OFF_BY_ONE_SHARE of its elements, ks to fp32 rounding; v16 is V
    rounded to bf16 bit for bit; zeros in every pad, (0, -inf) in meta past
    Lk."""
    gen = torch.Generator(device=cuda_device).manual_seed(40)
    q, k, v = (_heads_major(gen, cuda_device, 1, n, 12, d) for n in (lq, lk, lk))
    before = dict(flash.LAUNCHES)
    ops = flash.int8_prelude(q, k, v)
    assert flash.LAUNCHES["int8_prelude"] == before["int8_prelude"] + 1
    q8, k8, qs, ks = flash.quantize_int8(q, k, d ** -0.5)
    p = ops.plan
    assert torch.equal(ops.q8[:, :, :d].reshape(q8.shape), q8)
    assert torch.equal(ops.qs.reshape(qs.shape), qs)
    off = ops.k8[:, :, :d].reshape(k8.shape).int() - k8.int()
    assert off.abs().max().item() <= 1
    assert (off != 0).float().mean().item() <= K8_OFF_BY_ONE_SHARE
    torch.testing.assert_close(ops.meta[:, :lk, 0].reshape(ks.shape), ks, rtol=2e-6, atol=0)
    assert torch.equal(ops.v16[:, :, :d].reshape(1, 12, lk, d), v.to(torch.bfloat16))
    for pad in (ops.q8[:, :, d:], ops.k8[:, :, d:], ops.v16[:, :, d:]):
        assert (pad == 0).all()
    assert (ops.meta[:, :lk, 1] == 0).all()
    assert (ops.meta[:, lk:, 0] == 0).all() and (ops.meta[:, lk:, 1] == -float("inf")).all()
    assert ops.meta.shape[1] == p.lk_pad


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 40])
@pytest.mark.parametrize("lk", [1024, 1050, 4096])
@pytest.mark.parametrize("mask", ["none", "bias", "half", "all"])
def test_int8_sm90_kernel_matches_plain(cuda_device, d, lk, mask):
    """K6 (prelude and attention kernel, two launches) against
    `int8_reference`: a random per-key bias, half the keys at MASK_VALUE, or
    all of them (every row gives 0)."""
    gen = torch.Generator(device=cuda_device).manual_seed(41)
    lq = 1056
    q, k, v = (_heads_major(gen, cuda_device, 1, n, 12, d) for n in (lq, lk, lk))
    bias = None
    if mask == "bias":
        bias = torch.randn(1, lk, generator=gen, device=cuda_device)
    elif mask != "none":
        bias = _masked(cuda_device, lk, lk // 2 if mask == "half" else 0)
    before = dict(flash.LAUNCHES)
    got = flash.flash_attention_int8(q, k, v, bias=bias)
    assert flash.LAUNCHES["int8_prelude"] == before["int8_prelude"] + 1
    assert flash.LAUNCHES["flash_int8"] == before["flash_int8"] + 1
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    if mask == "all":
        assert (got == 0).all()
    else:
        assert _close(got, flash.int8_reference(q, k, v, bias))


@pytest.mark.gpu
def test_int8_sm90_kernel_in_bf16_and_through_quantized_buffers(cuda_device):
    """bf16 q, k, v give a bf16 output; `flash_int8_quantized` on
    `quantize_int8`'s buffers (repacked to the kernel's layout) gives what the
    plain version gives."""
    gen = torch.Generator(device=cuda_device).manual_seed(42)
    q, k, v = (_heads_major(gen, cuda_device, 2, 1100, 4, 64, torch.bfloat16) for _ in range(3))
    got = flash.flash_attention_int8(q, k, v)
    assert got.dtype == torch.bfloat16
    assert _close(got, flash.int8_reference(q.float(), k.float(), v.float()))
    qf, kf, vf = (_heads_major(gen, cuda_device, 1, 1050, 12, 64) for _ in range(3))
    bias = _masked(cuda_device, 1050, 700)
    quant = flash.quantize_int8(qf, kf, 0.125)
    assert _close(flash.flash_int8_quantized(*quant, vf, bias=bias),
                  flash.int8_reference(qf, kf, vf, bias))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [8, 40, 64, 160])
@pytest.mark.parametrize("lk", [1, 4, 33, 304, 1056])
def test_heads_major_sm90_kernel_matches_plain(cuda_device, dtype, d, lk):
    """K3 through the wav2vec2 view at every width and key length, ragged
    Lq, in fp32 and bf16 (output in the input's type)."""
    gen = torch.Generator(device=cuda_device).manual_seed(43)
    lq = 301
    q, k, v = (_heads_major(gen, cuda_device, 2, n, 6, d, dtype) for n in (lq, lk, lk))
    got = flash.flash_attention(q, k, v)
    assert got.dtype == dtype
    assert _close(got, attention.attention_reference(q.float(), k.float(), v.float()))


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 40])
@pytest.mark.parametrize("start", ["half", "all"])
def test_heads_major_sm90_kernel_masked_keys(cuda_device, d, start):
    """K3 with MASK_VALUE on half the keys or on all of them (every row
    gives 0), contiguous heads-major tensors (per-head maps)."""
    gen = torch.Generator(device=cuda_device).manual_seed(44)
    q, k, v = (torch.randn(1, 12, n, d, generator=gen, device=cuda_device) for n in (300, 1056,
                                                                                     1056))
    bias = _masked(cuda_device, 1056, 528 if start == "half" else 0)
    got = flash.flash_attention(q, k, v, bias=bias)
    assert torch.isfinite(got).all()
    if start == "all":
        assert (got == 0).all()
    else:
        assert _close(got, attention.attention_reference(q, k, v, bias[:, None, None, :]))


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["K3", "K6"])
def test_audio_kernels_keep_a_neighbour_heads_inf_out(cuda_device, kernel):
    """inf planted in head h + 1's columns of q, k and v (the next 8 columns
    of a token's row in the wav2vec2 view, which K3's wide boxes also read)
    does not reach head h: its output equals the plain version on head h
    alone; head h + 1's is non-finite, as the plain version's is."""
    gen = torch.Generator(device=cuda_device).manual_seed(45)
    d, h = 40, 1
    rows = [torch.randn(1, n, 4, d, generator=gen, device=cuda_device) for n in (300, 1100, 1100)]
    for t in rows:
        t[:, :, h + 1, :8] = float("inf")
    q, k, v = (t.transpose(1, 2) for t in rows)
    if kernel == "K3":
        got = flash.flash_attention(q, k, v)
        want = attention.attention_reference(q[:, h:h + 1], k[:, h:h + 1], v[:, h:h + 1])
    else:
        got = flash.flash_attention_int8(q, k, v)
        want = flash.int8_reference(q[:, h:h + 1], k[:, h:h + 1], v[:, h:h + 1],
                                    scale=d ** -0.5)
    assert torch.isfinite(got[:, h]).all()
    assert _close(got[:, h:h + 1], want)
    assert not torch.isfinite(got[:, h + 1]).all()


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["K3", "K6"])
@pytest.mark.parametrize("lq,consumers", [(1056, 2), (4096, 3)])
def test_audio_kernels_at_both_consumer_counts(cuda_device, kernel, lq, consumers):
    """The audio path's shapes at d 64 take two consumer warpgroups at L
    1056 and three at L 4096 (`flash._consumers`); both instantiations
    match the plain version, with a bias on the keys."""
    gen = torch.Generator(device=cuda_device).manual_seed(47)
    q, k, v = (_heads_major(gen, cuda_device, 1, lq, 12, 64) for _ in range(3))
    bias = torch.randn(1, lq, generator=gen, device=cuda_device)
    plan = (flash.heads_major_plan if kernel == "K3" else flash.int8_plan)(q, k, v)
    assert plan.block_q == 64 * consumers
    if kernel == "K3":
        got = flash.flash_attention(q, k, v, bias=bias)
        want = attention.attention_reference(q, k, v, bias[:, None, None, :])
    else:
        got = flash.flash_attention_int8(q, k, v, bias=bias)
        want = flash.int8_reference(q, k, v, bias)
    assert _close(got, want)


@pytest.mark.gpu
def test_audio_kernel_rings_repeat_over_many_launches(cuda_device):
    """The rings' parity waits: 300 launches each of K3 (L 1056 and 4096: 9
    and 32 key tiles through 4 slots and 2 bf16 stages a CTA) and K6 (L 1056
    and 4096: 9 and 32 key tiles through 3 stages) give the first launch's
    output bit for bit."""
    gen = torch.Generator(device=cuda_device).manual_seed(46)
    for n in (1056, 4096):
        q, k, v = (_heads_major(gen, cuda_device, 1, n, 12, 64) for _ in range(3))
        first = flash.flash_attention(q, k, v)
        assert sum(not torch.equal(flash.flash_attention(q, k, v), first)
                   for _ in range(300)) == 0
    for n in (1056, 4096):
        q, k, v = (_heads_major(gen, cuda_device, 1, n, 12, 64) for _ in range(3))
        first = flash.flash_attention_int8(q, k, v)
        assert sum(not torch.equal(flash.flash_attention_int8(q, k, v), first)
                   for _ in range(300)) == 0
