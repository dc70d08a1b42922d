"""The Python side of K8's Hopper kernel (`csrc/winograd.cu`):
`winograd.winograd_plan`, the tensor maps and the persistent grid that the
wrapper computes for NHWC x and Co output channels, and the copies it makes
for channel counts the maps cannot take. The kernel itself needs a card
(tests/test_torch_kernels.py); these run on the CPU.

A unit of work is a patch of 8 x 8 output tiles (16 x 16 pixels) x 64
output channels; a CTA reads the patch's 18 x 18-pixel halo 16 channels at a
time (one box of x's map over (C, W, H, N), its zero fill past the image
being the padding) and 8 of the 16 positions of U's 16-channel slice (the
other CTA of its cluster loads the other 8 and both multicast), and writes
the unit's output with one box of y's map. Clusters of two walk the units a
grid apart.
"""

import pytest
import torch

from hallo_tpu_torch.ops import flash, winograd

BF16 = torch.bfloat16
DENOISER = [((32, 64, 64, 320), 320), ((32, 64, 64, 640), 320), ((32, 64, 64, 960), 320),
            ((32, 32, 32, 640), 640), ((32, 32, 32, 1280), 640)]


@pytest.mark.parametrize("shape,co", DENOISER,
                         ids=["l0_resnet", "l0_up", "l0_concat", "l1_resnet", "l1_up"])
def test_plan_of_the_denoiser_shapes(shape, co):
    """The five 3x3 convs at CFG batch 32: the maps are the tensors' own,
    no copies (C a multiple of 16, Co of 8), one unit per 8 x 8 tiles and 64
    channels, a persistent grid of one CTA an SM in clusters of two."""
    n, h, w, c = shape
    plan = winograd.winograd_plan(torch.empty(shape, dtype=BF16), co)
    assert (plan.c, plan.co, plan.steps) == (c, co, c // 16)
    assert plan.x == flash.TmaMap((c, w, h, n), (2 * c, 2 * c * w, 2 * c * w * h),
                                      (16, 18, 18, 1))
    assert plan.u == flash.TmaMap((co, c, 16, 1), (2 * co, 2 * co * c, 32 * co * c),
                                      (64, 16, 8, 1))
    assert plan.y == flash.TmaMap((co, w, h, n), (2 * co, 2 * co * w, 2 * co * w * h),
                                      (64, 16, 16, 1))
    patches = (h // 16, w // 16)
    assert plan.patches == patches
    assert plan.units == n * patches[0] * patches[1] // 2 * (co // 64)
    assert plan.grid == 132


@pytest.mark.parametrize("shape,co,c_pad,co_pad,patches", [
    ((2, 6, 10, 33), 70, 48, 72, (1, 1)),
    ((1, 2, 2, 3), 5, 16, 8, (1, 1)),
    ((3, 34, 18, 16), 64, 16, 64, (3, 2)),
    ((2, 16, 24, 40), 48, 48, 48, (1, 2)),
    ((1, 18, 30, 40), 24, 48, 24, (2, 2)),
], ids=["odd_c_co", "one_tile", "ragged_patches", "non_square", "ragged_both"])
def test_plan_of_odd_channels_and_ragged_patches(shape, co, c_pad, co_pad, patches):
    """C not a multiple of 16 is read from a copy with zero channels up to
    the next multiple (the map's strides, a box of 16 channels within C), Co
    not a multiple of 8 written into one up to the next multiple; H / 2 or
    W / 2 that 8 does not divide leaves the last patches partly outside the
    image (read as 0, not written). The grid never exceeds the units."""
    n, h, w, c = shape
    plan = winograd.winograd_plan(torch.empty(shape, dtype=BF16), co)
    assert (plan.c, plan.co, plan.patches) == (c_pad, co_pad, patches)
    assert plan.x.dims == (c_pad, w, h, n) and plan.x.strides[0] == 2 * c_pad
    assert plan.u.dims == (co_pad, c_pad, 16, 1) and plan.y.dims == (co_pad, w, h, n)
    units = -(-n * patches[0] * patches[1] // 2) * -(-co_pad // 64)
    assert plan.units == units and plan.grid == 2 * min(units, 66)


def test_plan_of_fp32_and_other_cards():
    """fp32 x: 4-byte strides; the grid follows the card's SMs."""
    plan = winograd.winograd_plan(torch.empty(32, 32, 32, 640), 640, sms=78)
    assert plan.x.strides == (4 * 640, 4 * 640 * 32, 4 * 640 * 32 * 32)
    assert plan.y.strides == plan.x.strides and plan.u.strides[0] == 2 * 640
    assert plan.grid == 78


@pytest.mark.parametrize("shape,dtype,error", [
    ((2, 5, 8, 16), BF16, ValueError), ((2, 8, 7, 16), BF16, ValueError),
    ((0, 8, 8, 16), BF16, ValueError), ((2, 8, 8, 16), torch.float16, TypeError),
])
def test_plan_rejects_what_the_kernel_does_not_take(shape, dtype, error):
    """Odd H or W, an empty axis, a type other than bf16 or fp32."""
    with pytest.raises(error):
        winograd.winograd_plan(torch.empty(shape, dtype=dtype), 16)


def test_plan_is_cached_and_packs_the_maps():
    """The plan is a pure function of the shapes (cached); the launch's
    `maps` array is x's, U's and y's extents and strides, 7 values each."""
    x = torch.empty(4, 32, 32, 64, dtype=BF16)
    plan = winograd.winograd_plan(x, 96)
    assert winograd.winograd_plan(x, 96) is plan
    vals = list(winograd._map_args(plan))
    assert len(vals) == 21
    assert vals[:7] == [*plan.x.dims, *plan.x.strides]
    assert vals[14:] == [*plan.y.dims, *plan.y.strides]
