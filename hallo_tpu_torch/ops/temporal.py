"""Frame-axis (temporal) attention: the Hopper kernel
`csrc/temporal_attn_sm90.cu` and its plain PyTorch version.

Counterpart of hallo_tpu/ops/pallas_temporal.py::temporal_attention (K2).
The JAX kernel takes site-major (B, F, C, L) I/O, a TPU lane choice; this
one takes the natural (B, F, L, C) layout of `temporal_attention_packed`
(K7), which is what the motion module's projections produce here.

The kernel runs a persistent grid: one producer thread a CTA keeps a ring of
units -- (batch, T sites, a group of heads) -- in flight by TMA, and 12
consumer warps (8 at F > 24) run each (site, head) task on the tensor cores
(mma.sync). `temporal_plan` computes its tensor map, units, ring and grid,
cached by shape. F is at most 32 (the temporal positional encoding's limit)
and d a multiple of 8; any such F runs the same code.

A CPU tensor takes the plain version (`temporal_reference`); a CUDA tensor
launches the kernel or raises. Launches are counted in `LAUNCHES`.

Training: when grad mode is on and q, k or v needs a gradient, the call goes
through `TemporalAttentionFn`, whose backward recomputes the plain version
and differentiates it. That is JAX's `_temporal_bwd`
(pallas_temporal.py:311-317, an XLA recompute, not a kernel).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from hallo_tpu_torch.ops import _build
from hallo_tpu_torch.ops.flash import H100_SMS, TmaMap, _sms

LAUNCHES = {"temporal_attn": 0}
_LOG2E = math.log2(math.e)
MAX_FRAMES = 32  # the temporal positional encoding's limit; the kernel's 4 key tiles
# The kernel's configuration (csrc/temporal_attn_sm90.cu), mirrored here to
# lay out its units: 64-column boxes of 128-byte rows (the swizzle's width),
# the shared memory a block may take, and the ring.
BOX_COLS = 64
SMEM_LIMIT = 232448
MAX_STAGES = 4
_SMEM_RESERVE = 1024 + 16 * MAX_STAGES + 32  # alignment slack, barriers, zero and trash rows
STAGE_TARGET = 48 * 1024  # a stage's bytes that the sites a unit are sized to


class TemporalPlan(NamedTuple):
    """What `temporal_attn_sm90.cu` is launched with for one call.

    A unit is (batch, `sites` consecutive sites, `heads_per_unit` heads);
    its columns are whole 64-column boxes, `boxes` an operand, starting at
    the 64-column boundary at or below its first head's first column. Each
    box lands in a buffer of `box_rows` rows (sites x frames, rounded up to
    the swizzle atom's 8 rows). A task is one (site, head)."""

    map: TmaMap  # q's, k's and v's: (C, F, L, B), box (64, F, sites, 1)
    d: int
    heads: int
    heads_per_unit: int
    groups: int  # units across the heads
    boxes: int
    sites: int
    box_rows: int
    stages: int
    units: int
    grid: int  # persistent CTAs: min(units, SMs)
    warps: int  # consumer warps a CTA: 12, or 8 at 4 key tiles (their registers)
    k_tiles: int  # 8-key tiles of S = Q K^T (the kernel's instantiation)
    m_tiles: int  # 16-query tiles of a site
    k8_tail: bool  # d % 16 == 8: the contraction's last 8 columns by m16n8k8
    # frames read as zero rows, past F: (query rows, S's keys, PV's keys)
    zero_rows: Tuple[int, int, int]
    smem: int  # bytes a CTA


def _boxes(heads_per_unit: int, heads: int, d: int) -> int:
    """The most 64-column boxes any unit's heads span."""
    most = 0
    for g in range(-(-heads // heads_per_unit)):
        lo = g * heads_per_unit * d
        hi = min(heads, (g + 1) * heads_per_unit) * d
        most = max(most, -(-hi // BOX_COLS) - lo // BOX_COLS)
    return most


def _stage_bytes(boxes: int, rows: int) -> int:
    return 3 * boxes * rows * 128


@functools.lru_cache(maxsize=256)
def _plan(shape, heads: int, sms: int) -> TemporalPlan:
    """`temporal_plan` from the operands' contiguous (B, F, L, C) shape (a
    pure function: the main path repeats its shapes every step)."""
    b, f, l, c = shape
    if heads < 1 or c % heads:
        raise ValueError(f"temporal attention: {c} channels do not split into {heads} heads")
    d = c // heads
    if f > MAX_FRAMES or d % 8:
        raise ValueError(f"temporal attention kernel: F={f} (max {MAX_FRAMES}), d={d} "
                         "(multiple of 8)")
    if min(shape) < 1:
        raise ValueError(f"temporal attention kernel: empty shape {tuple(shape)}")
    if max(b, f, l, c) >= 1 << 32 or 2 * b * f * l * c >= 1 << 40:
        raise ValueError(f"temporal attention kernel: shape {tuple(shape)} too large for TMA")
    rows1 = -(-f // 8) * 8  # one site's rows
    budget = SMEM_LIMIT - _SMEM_RESERVE
    # heads a unit: whole 64-column boxes over lcm(d, 64) columns (8 heads of
    # 40, 4 of 80, 2 of 160), fewer while two stages of one site do not fit
    nh = min(heads, math.lcm(d, BOX_COLS) // d)
    while nh > 1 and 2 * _stage_bytes(_boxes(nh, heads, d), rows1) > budget:
        nh -= 1
    boxes = _boxes(nh, heads, d)
    if _stage_bytes(boxes, rows1) > budget:
        raise ValueError(f"temporal attention kernel: d={d} at F={f} does not fit shared "
                         "memory")
    # sites a unit: as many as keep a stage within STAGE_TARGET (at least 1)
    sites = 1
    while (sites < min(256, l)
           and _stage_bytes(boxes, -(-(sites + 1) * f // 8) * 8) <= STAGE_TARGET):
        sites += 1
    rows = -(-sites * f // 8) * 8
    stages = max(1, min(MAX_STAGES, budget // _stage_bytes(boxes, rows)))
    groups = -(-heads // nh)
    units = b * -(-l // sites) * groups
    if units >= 1 << 31:
        raise ValueError(f"temporal attention kernel: shape {tuple(shape)} has too many units")
    k_tiles = -(-f // 8)
    return TemporalPlan(
        TmaMap((c, f, l, b), (2 * l * c, 2 * c, 2 * f * l * c), (BOX_COLS, f, sites, 1)),
        d, heads, nh, groups, boxes, sites, rows, stages, units, min(units, sms),
        8 if k_tiles == 4 else 12, k_tiles,
        2 if f > 16 else 1, d % 16 == 8,
        (16 * (2 if f > 16 else 1) - f, 8 * k_tiles - f, 16 * -(-k_tiles // 2) - f),
        stages * _stage_bytes(boxes, rows) + 16 * stages + 32 + 1024)


def temporal_plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
                  sms: int = H100_SMS) -> TemporalPlan:
    """The tensor map, units, ring and grid of K2's Hopper kernel for bf16
    q, k, v of one contiguous (B, F, L, C = heads d) shape. Raises on what
    the kernel does not take: another dtype, mismatched shapes or devices,
    a view that is not contiguous or not 16-byte aligned, F > 32, d not a
    multiple of 8."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"temporal attention: {name} on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"temporal attention kernel takes bf16, {name} is {t.dtype}")
        if t.shape != q.shape or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"temporal attention: {name} must be contiguous {tuple(q.shape)}")
    return _plan(tuple(q.shape), heads, sms)


@functools.lru_cache(maxsize=256)
def _launch_args(plan: TemporalPlan):
    """The kernel's `args` array, every integer of a launch with this plan:
    the map's 4 extents and 3 byte strides, then H, d, heads a unit, sites,
    boxes, rows a box, stages, grid, consumer warps, and o's element strides
    of B, F, L (read during the call, so one array serves every call)."""
    c, f, l, _ = plan.map.dims
    vals = (*plan.map.dims, *plan.map.strides, plan.heads, plan.d, plan.heads_per_unit,
            plan.sites, plan.boxes, plan.box_rows, plan.stages, plan.grid, plan.warps,
            f * l * c, l * c, c)
    return (ctypes.c_longlong * len(vals))(*vals)


def temporal_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain version: q/k/v (B, F, L, C), C = heads * d -> (B, F, L, C).
    Scores and softmax in fp32; PV with the probabilities in v's dtype."""
    b, f, l, c = q.shape
    d = c // heads
    if scale is None:
        scale = d ** -0.5
    qh, kh, vh = (t.reshape(b, f, l, heads, d) for t in (q, k, v))
    s = torch.einsum("bflhd,bglhd->blhfg", qh.float(), kh.float()) * scale
    p = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("blhfg,bglhd->bflhd", p.float(), vh.float())
    return o.to(v.dtype).reshape(b, f, l, c)


def temporal_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    heads: int,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Self-attention over the frame axis at every site: q/k/v (B, F, L, C)
    with C = heads * d. Returns (B, F, L, C)."""
    if scale is None:
        scale = (q.shape[3] // heads) ** -0.5
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return TemporalAttentionFn.apply(q, k, v, heads, scale)
    if q.device.type == "cpu":
        return temporal_reference(q, k, v, heads, scale)
    return _temporal_kernel(q, k, v, heads, scale)


def _temporal_kernel(q, k, v, heads: int, scale: float) -> torch.Tensor:
    """K2 on CUDA tensors (`temporal_plan` checks k and v against q)."""
    if not q.is_cuda:
        raise ValueError(f"temporal attention: q on {q.device}, not a CUDA device")
    plan = temporal_plan(q, k, v, heads, _sms(q.device))
    out = torch.empty_like(q)
    _build.call("temporal_attn", q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                _launch_args(plan), float(scale) * _LOG2E,
                torch.cuda.current_stream(q.device).cuda_stream)
    LAUNCHES["temporal_attn"] += 1
    return out


class TemporalAttentionFn(torch.autograd.Function):
    """K2's forward (the plain version on the CPU); the backward recomputes
    `temporal_reference` on the saved inputs and differentiates it, as JAX's
    `_temporal_bwd` does (pallas_temporal.py:311-317)."""

    @staticmethod
    def forward(ctx, q, k, v, heads, scale):
        ctx.heads, ctx.scale = heads, scale
        ctx.save_for_backward(q, k, v)
        if q.device.type == "cpu":
            return temporal_reference(q, k, v, heads, scale)
        return _temporal_kernel(q, k, v, heads, scale)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = temporal_reference(*inputs, ctx.heads, ctx.scale)
            grads = torch.autograd.grad(out, inputs, g)
        return (*grads, None, None)
