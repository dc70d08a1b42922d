"""Winograd F(2x2, 3x3) convolution: the CUDA kernel `csrc/winograd.cu` (a
Hopper kernel: TMA loads, wgmma products, a producer warp; `winograd_plan`
computes its tensor maps and grid) and its plain PyTorch version.

Counterpart of hallo_tpu/ops/pallas_winograd.py (K8, `_wino_kernel`), at the
JAX layouts: x is NHWC, the kernel HWIO (3, 3, C, Co), the output NHWC. A
3x3, stride-1, pad-1 convolution as 16 transform-domain products: the input
transform V = B^T d B of every 4x4 input patch, M[k] = V[k] @ U[k] for
k = 0..15 with U = G k G^T (`winograd_weights`), and the output transform
Y = A^T M A of every 2x2 output tile, then the bias.

As in the JAX package, nothing calls it: `use_winograd()` reads the
HALLO_WINOGRAD switch and has no reader. The entry points are
`winograd_conv3x3` (forward only) and `winograd_conv3x3_vjp`
(`WinogradConvFn`: the kernel forward, cuDNN direct convolutions in the
backward, as JAX's `_wino_bwd` uses XLA's).

A CPU tensor takes the plain version (`winograd_reference`); a CUDA tensor
launches the kernel or raises. On the card, `winograd_conv3x3` raises when
grad mode is on and an input needs a gradient (the kernel has no backward;
`winograd_conv3x3_vjp` is the differentiable entry). Launches are counted
in `LAUNCHES`.

Eligibility (`winograd_eligible`) is the port's own: 3x3, stride 1, pad 1,
even H and W, any C and Co. JAX's further rules (W/2 dividing 128, H a
multiple of 2 * 128 / (W/2), the U block within a VMEM budget) are Mosaic
limits of the TPU and are dropped (ROADMAP Queue 3).
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from hallo_tpu_torch.ops import _build
from hallo_tpu_torch.ops.flash import H100_SMS, TmaMap, _forward_only, _sms

LAUNCHES = {"winograd_conv3x3": 0}
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}  # the kernel's I/O type codes

# F(2x2, 3x3) weight transform (Lavin & Gray 2015; exact in bf16).
_G = torch.tensor(
    [[1.0, 0.0, 0.0], [0.5, 0.5, 0.5], [0.5, -0.5, 0.5], [0.0, 0.0, 1.0]],
    dtype=torch.float32,
)


def winograd_weights(kernel: torch.Tensor) -> torch.Tensor:
    """(3, 3, C, Co) HWIO conv kernel -> (16, C, Co) transform-domain U,
    fp32 (the callers cast it to x's dtype, as JAX does). Two fp32 matmuls
    of depth 3 (TF32 is off for matmuls by default)."""
    g = _G.to(kernel.device)
    c, co = kernel.shape[2:]
    t = torch.matmul(g, kernel.float().reshape(3, -1)).reshape(4, 3, -1)  # (G k)[a][j]
    return torch.matmul(g, t).reshape(16, c, co)  # [a][b] = sum_j G[b][j] (G k)[a][j]


def winograd_eligible(x_shape, kernel_shape, strides, padding) -> bool:
    """3x3, stride 1, pad 1, NHWC x with even H and W, HWIO kernel over x's
    channels; any C and Co."""
    if len(x_shape) != 4 or len(kernel_shape) != 4:
        return False
    if tuple(kernel_shape[:2]) != (3, 3) or tuple(strides) != (1, 1) or padding != 1:
        return False
    n, h, w, c = x_shape
    if kernel_shape[2] != c or min(n, h, w, c, kernel_shape[3]) <= 0:
        return False
    return h % 2 == 0 and w % 2 == 0


def _check_eligible(x: torch.Tensor, kernel: torch.Tensor) -> None:
    if not winograd_eligible(tuple(x.shape), tuple(kernel.shape), (1, 1), 1):
        raise ValueError(f"winograd conv: x {tuple(x.shape)} with kernel {tuple(kernel.shape)} "
                         "is not a 3x3 pad-1 conv of an even-sized NHWC input")


def _transform_input(d):
    """V = B^T d B of each 4x4 patch: d[r][s] (rows, cols of the patch) ->
    the 16 positions a * 4 + b, each a +- sum of at most 4 values."""

    def bt(v):  # B^T applied along one axis of the patch
        return (v[0] - v[2], v[1] + v[2], v[2] - v[1], v[1] - v[3])

    rows = [bt(d[r]) for r in range(4)]  # rows[r][b] = (d B)[r][b]
    cols = [bt([rows[r][b] for r in range(4)]) for b in range(4)]  # cols[b][a]
    return [cols[b][a] for a in range(4) for b in range(4)]


def _transform_output(m):
    """Y = A^T M A: the 16 products m[a * 4 + b] -> the 2x2 output pixels
    y[row parity][column parity]."""

    def at(v):  # A^T applied along one axis
        return (v[0] + v[1] + v[2], v[1] - v[2] - v[3])

    rows = [at([m[a * 4 + b] for a in range(4)]) for b in range(4)]  # rows[b][rp]
    return [at([rows[b][rp] for b in range(4)]) for rp in range(2)]


def winograd_reference(
    x: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Plain version: the same transforms and 16 products in fp32, from U
    rounded to x's dtype; the bias added in fp32; the result in x's dtype."""
    n, h, w, c = x.shape
    co = kernel.shape[-1]
    u = winograd_weights(kernel).to(x.dtype).float()
    xp = x.new_zeros((n, h + 2, w + 2, c), dtype=torch.float32)
    xp[:, 1:h + 1, 1:w + 1] = x.float()
    # d[r][s]: the (r, s) element of every tile's 4x4 patch, (N, H/2, W/2, C)
    d = [[xp[:, r:r + h:2, s:s + w:2] for s in range(4)] for r in range(4)]
    v = torch.stack(_transform_input(d)).reshape(16, -1, c)
    m = torch.bmm(v, u).reshape(16, n, h // 2, w // 2, co)
    y = _transform_output(list(m))
    out = torch.stack([torch.stack(y[rp], dim=3) for rp in range(2)], dim=2)
    out = out.reshape(n, h, w, co)
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def conv3x3_direct(
    x: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Direct-conv oracle (same contract), through F.conv2d."""
    out = F.conv2d(x.permute(0, 3, 1, 2), kernel.to(x.dtype).permute(3, 2, 0, 1), padding=1)
    out = out.permute(0, 2, 3, 1)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def winograd_conv3x3(
    x: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """3x3 stride-1 pad-1 conv, NHWC x HWIO -> NHWC via Winograd F(2, 3),
    bf16 or fp32 I/O (fp32 tiles rounded to bf16 for the tensor cores, as
    the TPU MXU's default precision), fp32 accumulation, the bias (Co) added
    in fp32. Forward only: on the card, an input that needs a gradient
    raises (`winograd_conv3x3_vjp` differentiates)."""
    _check_eligible(x, kernel)
    if x.device.type == "cpu":
        return winograd_reference(x, kernel, bias)
    _forward_only("winograd_conv3x3", x, kernel, *([] if bias is None else [bias]))
    return _winograd_kernel(x, kernel, bias)


def kernel_weights(kernel: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The kernel's U: `winograd_weights` cast to x's `dtype` (JAX's U), then
    to bf16 for the tensor cores, with Co zero-padded to a multiple of 8 for
    the kernel's 16-byte loads: (16, C, Co8) contiguous."""
    u = winograd_weights(kernel).to(dtype).to(torch.bfloat16)
    pad = -u.shape[2] % 8
    if pad:
        u = torch.cat([u, u.new_zeros(16, u.shape[1], pad)], dim=2)
    return u.contiguous()


# The kernel's tiles (csrc/winograd.cu), mirrored here to describe its
# tensor maps and grid (the kernel checks the maps' extents).
WINO_TILES = 8  # a unit of work: 8 x 8 output tiles (16 x 16 pixels) ...
WINO_TN = 64  # ... x 64 output channels
WINO_HALO = 2 * WINO_TILES + 2  # the unit's 18 x 18 input pixels
WINO_CK = 16  # input channels a step
WINO_CLUSTER = 2  # CTAs sharing each U slice (each loads half the positions)


class WinogradPlan(NamedTuple):
    """What `csrc/winograd.cu` is launched with: x's map over (C, W, H, N)
    with one 18 x 18-pixel halo of 16 channels a box (its zero fill past the
    image is the padding), U's over (Co, C, 16, 1) with a box of 64 output
    channels x 16 channels x the 8 positions a cluster's CTA loads, y's over
    (Co, W, H, N) with a box of one unit's 16 x 16 pixels x 64 channels (one
    TMA store a unit); a persistent grid of clusters, each walking the units
    (a pair of 8 x 8-tile patches x a 64-channel slice) a grid apart."""

    x: TmaMap
    u: TmaMap
    y: TmaMap
    c: int  # channels as the kernel reads them: C rounded up to 16, zeros appended
    co: int  # output channels as the kernel writes them: Co rounded up to 8
    steps: int
    patches: Tuple[int, int]  # 8 x 8-tile patches along H and W
    units: int  # patch pairs x 64-channel slices
    grid: int  # CTAs: clusters x WINO_CLUSTER, at most one a SM


@functools.lru_cache(maxsize=256)
def _plan(n: int, h: int, w: int, c: int, co: int, elem: int, sms: int) -> WinogradPlan:
    if min(n, h, w, c, co) <= 0 or h % 2 or w % 2:
        raise ValueError(f"winograd conv: x ({n}, {h}, {w}, {c}) -> {co} unsupported "
                         "(H and W even, no empty axis)")
    if elem not in (2, 4):
        raise TypeError(f"winograd conv kernel takes bf16 or fp32 x, not {elem}-byte elements")
    cp = -(-c // WINO_CK) * WINO_CK
    cop = co + (-co % 8)
    ph, pw = -(-(h // 2) // WINO_TILES), -(-(w // 2) // WINO_TILES)
    units = -(-(n * ph * pw) // WINO_CLUSTER) * -(-cop // WINO_TN)
    if units >= 2 ** 30:
        raise ValueError(f"winograd conv: x ({n}, {h}, {w}, {c}) -> {co} too large")
    clusters = max(1, min(units, sms // WINO_CLUSTER))
    xm = TmaMap((cp, w, h, n), (elem * cp, elem * cp * w, elem * cp * w * h),
                 (WINO_CK, WINO_HALO, WINO_HALO, 1))
    um = TmaMap((cop, cp, 16, 1), (2 * cop, 2 * cop * cp, 2 * cop * cp * 16),
                 (WINO_TN, WINO_CK, 16 // WINO_CLUSTER, 1))
    ym = TmaMap((cop, w, h, n), (elem * cop, elem * cop * w, elem * cop * w * h),
                 (WINO_TN, 2 * WINO_TILES, 2 * WINO_TILES, 1))
    return WinogradPlan(xm, um, ym, cp, cop, cp // WINO_CK, (ph, pw), units,
                        clusters * WINO_CLUSTER)


def winograd_plan(x: torch.Tensor, co: int, sms: int = H100_SMS) -> WinogradPlan:
    """The tensor maps and grid of the kernel for NHWC x (bf16 or fp32) and
    `co` output channels on a card of `sms` SMs. Raises on what the kernel
    does not take: another dtype, odd H or W, an empty axis, too many units.
    C that is not a multiple of 16 is read from a copy with zero channels
    appended (TMA's strides must be multiples of 16 bytes, and a box of 16
    channels then never runs past C); Co that is not a multiple of 8 is
    written into a copy with zero channels appended (the output map's
    strides), and cut back."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"winograd conv kernel takes bf16 or fp32 x, not {x.dtype}")
    return _plan(*x.shape, co, x.element_size(), sms)


@functools.lru_cache(maxsize=256)
def _map_args(plan: WinogradPlan):
    """The kernel's `maps` argument: x's, U's and y's extents and strides."""
    vals = [v for m in (plan.x, plan.u, plan.y) for v in (*m.dims, *m.strides)]
    return (ctypes.c_longlong * len(vals))(*vals)


def _winograd_kernel(x, kernel, bias) -> torch.Tensor:
    """K8 on CUDA tensors: the weight transform, then the kernel."""
    for name, t in (("x", x), ("kernel", kernel)):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"winograd conv: {name} on {t.device}, x on {x.device}")
    return winograd_launch(x, kernel_weights(kernel, x.dtype), kernel.shape[-1], bias)


def winograd_launch(
    x: torch.Tensor, u: torch.Tensor, co: int, bias: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """The kernel alone, on `kernel_weights`' U: x (N, H, W, C) contiguous
    bf16 or fp32 on the card, H and W even -> (N, H, W, co) in x's dtype.
    C that is not a multiple of 16, or co not of 8, takes copies with zero
    channels appended (`winograd_plan`)."""
    n, h, w, c = x.shape
    for name, t in (("x", x), ("U", u)) + (() if bias is None else (("bias", bias),)):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"winograd conv: {name} on {t.device}, x on {x.device}")
    plan = winograd_plan(x, co, _sms(x.device))
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("winograd conv: x must be contiguous and 16-byte aligned")
    if u.dtype != torch.bfloat16 or tuple(u.shape) != (16, c, plan.co) or not u.is_contiguous():
        raise ValueError(f"winograd conv: U must be contiguous bf16 (16, {c}, {plan.co})")
    if plan.c != c:
        x = F.pad(x, (0, plan.c - c))
        u = F.pad(u, (0, 0, 0, plan.c - c))
    b = None
    if bias is not None:
        if bias.numel() != co:
            raise ValueError(f"winograd conv: bias has {bias.numel()} values, want {co}")
        b = F.pad(bias.float().reshape(co), (0, plan.co - co))
    y = torch.empty((n, h, w, plan.co), dtype=x.dtype, device=x.device)
    _build.call(
        "winograd_conv3x3",
        x.data_ptr(), u.data_ptr(), None if b is None else b.data_ptr(), y.data_ptr(),
        _map_args(plan), n, h, w, plan.c, plan.co, _DTYPES[x.dtype], plan.grid,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    LAUNCHES["winograd_conv3x3"] += 1
    return y if plan.co == co else y[..., :co].contiguous()


class WinogradConvFn(torch.autograd.Function):
    """K8's forward (the plain version on the CPU); the backward is JAX's
    `_wino_bwd` (pallas_winograd.py:304-327) with cuDNN direct convolutions:
    dx correlates g with the flipped, io-swapped kernel, dk convolves x with
    g over the batch (both in x's dtype with fp32 accumulation), db sums g
    in fp32."""

    @staticmethod
    def forward(ctx, x, kernel, bias):
        ctx.save_for_backward(x, kernel)
        ctx.has_bias = bias is not None
        if x.device.type == "cpu":
            return winograd_reference(x, kernel, bias)
        return _winograd_kernel(x, kernel, bias)

    @staticmethod
    def backward(ctx, g):
        x, kernel = ctx.saved_tensors
        g = g.to(x.dtype)
        xc, gc = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)  # NCHW views
        w = kernel.to(x.dtype).permute(3, 2, 0, 1)  # OIHW
        dx = dk = db = None
        if ctx.needs_input_grad[0]:
            dx = torch.nn.grad.conv2d_input(xc.shape, w, gc, padding=1).permute(0, 2, 3, 1)
        if ctx.needs_input_grad[1]:
            dk = torch.nn.grad.conv2d_weight(xc, w.shape, gc, padding=1)
            dk = dk.permute(2, 3, 1, 0).to(kernel.dtype)
        if ctx.has_bias and ctx.needs_input_grad[2]:
            db = g.float().sum(dim=(0, 1, 2))
        return dx, dk, db


def winograd_conv3x3_vjp(
    x: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """`winograd_conv3x3` with a backward (JAX's custom_vjp of the same
    name): K8 forward, cuDNN direct convolutions backward."""
    _check_eligible(x, kernel)
    return WinogradConvFn.apply(x, kernel, bias)


def use_winograd() -> bool:
    """The HALLO_WINOGRAD switch, as in the JAX package (nothing reads it)."""
    return os.environ.get("HALLO_WINOGRAD", "0") == "1"
