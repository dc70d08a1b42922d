"""Flash attention: the CUDA kernels `csrc/flash_fwd_sm90.cu`,
`csrc/flash_fwd_d512_sm90.cu`, `csrc/flash_fwd_t_sm90.cu`,
`csrc/flash_int8_sm90.cu` and `csrc/flash_bwd_sm90.cu`, and their plain
PyTorch versions.

Counterpart of hallo_tpu/ops/pallas_flash.py. Its three forward layouts:

- `flash_attention_packed` (K1, `_attention_kernel_packed`): natural
  (B, L, C = heads * d) tensors -- every CrossAttention of the UNets, bf16 --
  through `flash_fwd_sm90.cu`, a Hopper kernel (TMA loads over the
  (B, L, H, d) view, wgmma products, a producer warp beside two or three
  consumer warpgroups); `sm90_plan` computes its tensor maps and tiles;
- `flash_attention` heads-major (B, H, L, D), by JAX's rule: K3
  (`_attention_kernel_t`) when d % 128 != 0 -- the wav2vec2 self-attention,
  d = 64, fp32 I/O -- through `flash_fwd_t_sm90.cu`, a Hopper kernel that
  reads K and V in their own type by TMA over the (B, L, H, d) view,
  converts them to bf16 tiles in warps of its own and runs K1's wgmma
  consumers (the TPU's transposed scores of K3 were an MXU layout choice);
  `heads_major_plan` computes its maps and tiles; K4 (`_attention_kernel`)
  otherwise -- the VAE mid-block attention
  (one head, d = 512, bf16) -- through `flash_fwd_d512_sm90.cu`, a Hopper
  kernel like K1's for d = 128 n up to 512 (two consumer warpgroups that
  each own half of d); `d512_plan` computes its tensor maps and tiles.

`flash_attention_int8` (K6, `_attention_kernel_t_q8`) is the int8-score
variant, two launches of `flash_int8_sm90.cu`: the quantisation prelude as
a kernel (XLA ops outside the Pallas call in JAX; `quantize_int8` is its
plain version), then the attention kernel (int8 wgmma for QK^T, bf16 for
PV, behind a TMA ring); `int8_plan` lays out the prelude's buffers and the
kernels' maps.

Training: when grad mode is on and q, k or v needs a gradient,
`flash_attention_packed` runs `FlashPackedFn` (JAX's `_flash_packed`
custom_vjp): K1's forward that also stores the base-2 logsumexp, and K5
(`_dkv_kernel_packed`, `_dq_kernel_packed`) as the two passes of
`csrc/flash_bwd_sm90.cu` in its backward (`flash_backward`), a Hopper
kernel like K1's whose launches `bwd_plan` computes. The bias gets no
gradient, as in JAX. Without a gradient to take, the inference path is
unchanged.

A tensor on the CPU takes the plain version (`packed_reference`,
`flash_lse_reference`, `flash_backward_reference`,
`ops.attention.attention_reference`, `int8_reference`); a CUDA tensor
launches the kernel or raises. K3, K4 and K6 have no backward kernel, so
on the card they raise when grad mode is on and an input needs a gradient
(their output would carry none). Each wrapper counts its launches in
`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from hallo_tpu_torch.ops import _build
from hallo_tpu_torch.ops.attention import attention_reference

MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
LAUNCHES = {"flash_fwd_packed": 0, "flash_fwd_t": 0, "flash_fwd": 0, "int8_prelude": 0,
            "flash_int8": 0, "flash_bwd_dkv": 0, "flash_bwd_dq": 0}
_LOG2E = math.log2(math.e)
_LN2 = math.log(2.0)


def _key_bias(bias: Optional[torch.Tensor], b: int, lk: int):
    """A per-key bias broadcastable to (B, Lk) -> (B, Lk) fp32 contiguous."""
    if bias is None:
        return None
    return bias.to(torch.float32).expand(b, lk).contiguous()


def packed_reference(q, k, v, heads: int, bias=None, scale=None):
    """Plain version of `flash_attention_packed` on natural (B, L, C)."""
    b, lq, c = q.shape
    d = c // heads

    def split(t):
        return t.reshape(t.shape[0], t.shape[1], heads, d).transpose(1, 2)

    kb = _key_bias(bias, b, k.shape[1])
    kb = None if kb is None else kb[:, None, None, :]
    out = attention_reference(split(q), split(k), split(v), kb, scale)
    return out.transpose(1, 2).reshape(b, lq, c)


_DTYPES = {torch.bfloat16: 0, torch.float32: 1}  # the kernels' I/O type codes


def _check_16b(name: str, t: torch.Tensor) -> None:
    """Innermost axis contiguous; every other stride and the base address
    on 16 bytes (the kernels' vector loads)."""
    per16 = 16 // t.element_size()
    strides = [s for s, n in zip(t.stride()[:-1], t.shape[:-1]) if n > 1]
    if t.stride(-1) != 1 or any(s % per16 for s in strides):
        raise ValueError(f"flash attention: {name} strides {t.stride()} unsupported")
    if t.data_ptr() % 16:
        raise ValueError(f"flash attention: {name} is not 16-byte aligned")


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _forward_only(what: str, *tensors) -> None:
    """Raise where a kernel without a backward is given a tensor that needs
    a gradient: autograd would not see the kernel's output."""
    if _needs_grad(*tensors):
        raise RuntimeError(f"{what}: the kernel has no backward; call it under "
                           "torch.no_grad() or on tensors that need no gradient")


def _check_devices(q, k, v):
    """q, k, v on one CUDA device, bf16 or fp32 of one type."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"flash attention: {name} is on {t.device}, q on {q.device}")
        if t.dtype not in _DTYPES or t.dtype != q.dtype:
            raise TypeError(f"flash attention kernel takes bf16 or fp32 q/k/v of one "
                            f"type, {name} is {t.dtype}, q {q.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash attention: q, k, v on different devices")


# K1's Hopper kernel, csrc/flash_fwd_sm90.cu: its tile configuration,
# mirrored here to describe the TMA boxes (the kernel checks block_q,
# block_k and stages against its instantiation at every launch).
SM90_BOX_COLS = 64  # a box row: 64 bf16 columns, 128 bytes (the swizzle's width)
SM90_MAX_D = 160
SM90_STAGES = 3  # the K/V ring
SM90_CLUSTER = 2  # CTAs that share each K/V tile (each loads 1/2, multicast)
_TMA_MAX_STRIDE = 1 << 40
_TMA_MAX_DIM = 1 << 32
H100_SMS = 132


class TmaMap(NamedTuple):
    """One operand's tensor map, innermost axis first: its extents, the byte
    strides of the other axes, and the box. K1's and K5's are 4-d with a box
    of (64 columns, rows, 1, 1); columns and rows past the extents read as
    0. A head's own map is (d, L, H, B); a wide map, (H d, L, 1, B), spans a
    token's heads, and head h's box j starts at column h d + 64 j. K4's are
    5-d (`d512_plan`)."""

    dims: Tuple[int, int, int, int]
    strides: Tuple[int, int, int]
    box: Tuple[int, int, int, int]


class Sm90Plan(NamedTuple):
    """What `flash_fwd_sm90.cu` is launched with for one call."""

    q: TmaMap
    k: TmaMap
    v: TmaMap
    wide: bool  # q, k and v through wide maps
    d_qk: int  # the contraction of S = Q K^T: d rounded up to 16
    d_v: int  # the width of O = P V: d
    boxes: int  # 64-column boxes along d
    block_q: int  # query rows per block (64 per consumer warpgroup)
    block_k: int  # keys per tile: 128, or 64 above two boxes (shared memory)
    stages: int
    grid: Tuple[int, int, int]  # (query tiles rounded up to the cluster, H, B)
    # the operands whose contraction pad (columns d .. d_qk, the next head's
    # under a wide map) the kernel zeroes in shared memory
    zeroed: Tuple[str, ...]


def _tma_map(name: str, shape, stride, rows: int, wide: bool, who: str = "K1") -> TmaMap:
    """The map of a bf16 (B, L, H, d) operand with these element strides,
    for kernel `who`."""
    b, l, h, d = shape
    if stride[3] != 1:
        raise ValueError(f"{who} kernel: {name}'s head dim is not contiguous ({stride})")
    strides = []
    for axis, n in ((1, l), (2, 1 if wide else h), (0, b)):
        s = 2 * stride[axis]
        if n == 1 and (s <= 0 or s % 16):
            s = 16  # an axis of extent 1 is never stepped
        if s <= 0 or s % 16 or s >= _TMA_MAX_STRIDE:
            raise ValueError(f"{who} kernel: {name} strides {stride} unsupported "
                             "(TMA takes positive multiples of 16 bytes below 2^40)")
        strides.append(s)
    if max(b, l, h * d) >= _TMA_MAX_DIM:
        raise ValueError(f"{who} kernel: {name} shape {shape} too large for TMA")
    dims = (h * d, l, 1, b) if wide else (d, l, h, b)
    return TmaMap(dims, tuple(strides), (SM90_BOX_COLS, rows, 1, 1))


@functools.lru_cache(maxsize=1024)
def _plan(q_shape, q_stride, k_shape, k_stride, v_shape, v_stride) -> Sm90Plan:
    """`sm90_plan` from the operands' (B, L, H, d) shapes and element
    strides (a pure function: the main path repeats its shapes every step)."""
    b, lq, h, d = q_shape
    lk = k_shape[1]
    if k_shape != (b, lk, h, d) or v_shape != k_shape:
        raise ValueError(f"K1 kernel: q {q_shape}, k {k_shape}, v {v_shape} do not match")
    if d % 8 or not 8 <= d <= SM90_MAX_D:
        raise ValueError(f"K1 kernel: head dim {d} unsupported (multiples of 8 up to 160)")
    if lq < 1 or lk < 1:
        raise ValueError(f"K1 kernel: empty sequence (Lq {lq}, Lk {lk})")
    d_qk = -(-d // 16) * 16
    boxes = -(-d_qk // SM90_BOX_COLS)
    block_k = 128 if boxes <= 2 else 64
    wide = h > 1 and q_stride[2] == k_stride[2] == v_stride[2] == d
    block_q = 192 if boxes == 1 else 128  # 3 consumer warpgroups of 64 rows, else 2
    rows = block_k // SM90_CLUSTER  # a CTA's share of a K/V tile
    tiles = -(-lq // block_q)
    return Sm90Plan(
        _tma_map("q", q_shape, q_stride, block_q, wide),
        _tma_map("k", k_shape, k_stride, rows, wide),
        _tma_map("v", v_shape, v_stride, rows, wide), wide, d_qk, d, boxes, block_q, block_k,
        SM90_STAGES, (-(-tiles // SM90_CLUSTER) * SM90_CLUSTER, h, b),
        ("q", "k") if wide and d_qk > d else ())


def _check_bf16_aligned(name: str, t: torch.Tensor, who: str = "K1") -> None:
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{who} kernel: {name} must be bf16, not {t.dtype}")
    if t.data_ptr() % 16:
        raise ValueError(f"{who} kernel: {name} is not 16-byte aligned")


def sm90_plan(q4: torch.Tensor, k4: torch.Tensor, v4: torch.Tensor) -> Sm90Plan:
    """The tensor maps and tiles of K1's Hopper kernel for (B, L, H, d)
    views of bf16 q, k, v (any strides, d contiguous). Raises on what the
    kernel does not take: another dtype, d not a multiple of 8 in 8..160,
    strides or addresses TMA cannot read, mismatched shapes.

    Q, K and V take wide maps when each token's heads are adjacent (head
    stride d, as in the natural (B, L, C) layout, with more than one head):
    a box then reads whole 128-byte rows, since TMA fills a box that runs
    past the innermost extent several times slower than it copies one
    (measured on an H100, PERF.md). The columns past d are then the next
    head's (or 0 after the last head); the kernel zeroes Q's and K's up to d
    rounded to 16 in shared memory, so no value of head h + 1 (not even an
    inf) reaches head h's scores, and V's are never read (O is d wide).
    Other layouts take per-head maps, whose columns past d read as 0. Each
    CTA of a cluster of two loads half of every K/V tile and multicasts it
    to both, so the K/V boxes are half a tile high."""
    for name, t in (("q", q4), ("k", k4), ("v", v4)):
        _check_bf16_aligned(name, t)
    return _plan(tuple(q4.shape), q4.stride(), tuple(k4.shape), k4.stride(),
                 tuple(v4.shape), v4.stride())


@functools.lru_cache(maxsize=1024)
def _map_args(plan: Sm90Plan):
    """The kernel's `maps` argument: 7 values per operand (read during the
    call, so one array serves every call with this plan)."""
    vals = [x for m in (plan.q, plan.k, plan.v) for x in (*m.dims, *m.strides)]
    return (ctypes.c_longlong * len(vals))(*vals)


def _tile_bias(bias: Optional[torch.Tensor], b: int, lk: int, block_k: int):
    """The per-key bias as K1's Hopper kernel reads it, a tile at a time:
    (B, Lk rounded up to block_k) fp32, bias * log2(e) (MASK_VALUE x log2 e
    overflows to -inf, as in the plain versions), -inf past Lk. One kernel
    where Lk is a whole number of tiles (the main path), two otherwise."""
    if bias is None:
        return None
    pad = -lk % block_k
    out = torch.empty((b, lk + pad), dtype=torch.float32, device=bias.device)
    torch.mul(bias.to(torch.float32).expand(b, lk), _LOG2E, out=out[:, :lk])
    if pad:
        out[:, lk:] = -math.inf
    return out


def _launch_sm90(plan: Sm90Plan, q, k, v, o, o_strides, bias, scale, lse=None) -> None:
    """K1's Hopper kernel on bf16 q, k, v (their data pointers; `plan`
    describes them), writing o (bf16 or fp32, (B, L, H) element strides
    `o_strides`) and the optional fp32 (B, H, Lq) lse; `bias` a per-key
    bias broadcastable to (B, Lk), or None."""
    b, lq, h, d = plan.q.dims[3], plan.q.dims[1], plan.grid[1], plan.d_v
    if bias is not None and bias.device != q.device:
        raise ValueError("flash attention: bias on another device than q")
    bias = _tile_bias(bias, b, plan.k.dims[1], plan.block_k)
    _build.call(
        "flash_fwd_sm90",
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if bias is None else bias.data_ptr(), o.data_ptr(),
        None if lse is None else lse.data_ptr(), _map_args(plan),
        b, h, lq, plan.k.dims[1], d, *o_strides,
        0 if bias is None else bias.stride(0),
        float(scale) * _LOG2E, int(o.dtype == torch.float32), int(plan.wide),
        plan.block_q, plan.block_k, plan.stages,
        torch.cuda.current_stream(q.device).cuda_stream,
    )


def _heads_view(t: torch.Tensor, heads: int):
    """The shape and element strides of t.unflatten(2, (heads, d)) for a
    (B, L, C) tensor, without making the view."""
    b, l, c = t.shape
    if c % heads:
        raise ValueError(f"flash attention: {c} channels do not split into {heads} heads")
    sb, sl, sc = t.stride()
    d = c // heads
    return (b, l, heads, d), (sb, sl, d * sc, sc)


# K3's Hopper kernel, csrc/flash_fwd_t_sm90.cu: its tile configuration,
# mirrored here to describe the TMA boxes, the ring and the grid (the kernel
# checks block_q, block_k and slots against its instantiation at every
# launch). Widths are instantiated at d rounded up to 32.
T_MAX_D = 160
SMEM_LIMIT = 232448  # the shared memory a block may use on an H100


class HeadsMajorPlan(NamedTuple):
    """What `flash_fwd_t_sm90.cu` is launched with for one call. K and V
    land in `slots` slots of `src_boxes` boxes (128-byte rows of `box_cols`
    columns x block_k keys) and are converted into bf16 tiles of `boxes`
    64-column boxes; Q is read from global memory by the consumers."""

    k: TmaMap
    v: TmaMap
    wide: bool  # K and V through maps over a token's H d columns
    d: int
    d_p: int  # the instantiation's width: d rounded up to 32
    boxes: int  # bf16 64-column boxes of a converted tile
    box_cols: int  # columns of a landed box row: 128 bytes of the I/O type
    src_boxes: int
    block_q: int  # 64 query rows per consumer warpgroup: 2, or 3 up to d 64 (`_consumers`)
    block_k: int
    slots: int
    smem: int
    grid: Tuple[int, int, int]  # (query blocks, H, B)


def _consumers(d_p: int, lq: int, heads: int, sms: int) -> int:
    """Consumer warpgroups (64 query rows each) of a K3 or K6 CTA over
    `heads` (batch, head) pairs: 2 or, up to d 64, 3. Two give more CTAs of
    fewer rows, which is faster while their grid takes no more waves of one
    CTA an SM than three's (on an H100, PERF.md §6: L 304 and 1056 take
    2, L 4096 3)."""
    if d_p > 64:
        return 2

    def waves(rows):
        return -(-(-(-lq // rows) * heads) // sms)

    return 2 if waves(128) <= waves(192) else 3


def _t_tiles(d_p: int, elem: int, consumers: int) -> Tuple[int, int, int, int, int, int]:
    """(block_q, block_k, boxes, src_boxes, slots, shared memory) of K3's
    instantiation at width d_p, I/O element size `elem` and `consumers`
    warpgroups (csrc's Tiles<T, DP, NC>)."""
    block_q, block_k = 64 * consumers, 128 if d_p <= 64 else 64
    boxes = -(-d_p // 64)
    tile = boxes * block_k * 128
    q_bytes = boxes * block_q * 128
    src_boxes = -(-d_p // (128 // elem))
    slot = src_boxes * block_k * 128
    fixed = q_bytes + 4 * tile + 2 * 4 * block_k + 1024 + 256
    slots = min(4, (SMEM_LIMIT - fixed) // slot)
    smem = q_bytes + 4 * tile + 2 * 4 * block_k + slots * slot + 8 * (2 * slots + 8) + 1024
    return block_q, block_k, boxes, src_boxes, slots, smem


def _src_map(name: str, shape, stride, elem: int, wide: bool, rows: int) -> TmaMap:
    """The map of a (B, L, H, d) operand of `elem`-byte elements with these
    element strides: boxes of 128-byte rows x `rows` keys."""
    b, l, h, d = shape
    if stride[3] != 1:
        raise ValueError(f"K3 kernel: {name}'s head dim is not contiguous ({stride})")
    strides = []
    for axis, n in ((1, l), (2, 1 if wide else h), (0, b)):
        s = elem * stride[axis]
        if n == 1 and (s <= 0 or s % 16):
            s = 16  # an axis of extent 1 is never stepped
        if s <= 0 or s % 16 or s >= _TMA_MAX_STRIDE:
            raise ValueError(f"K3 kernel: {name} strides {stride} unsupported "
                             "(TMA takes positive multiples of 16 bytes below 2^40)")
        strides.append(s)
    if max(b, l, h * d) >= _TMA_MAX_DIM:
        raise ValueError(f"K3 kernel: {name} shape {shape} too large for TMA")
    dims = (h * d, l, 1, b) if wide else (d, l, h, b)
    return TmaMap(dims, tuple(strides), (128 // elem, rows, 1, 1))


@functools.lru_cache(maxsize=1024)
def _heads_major_args(q_shape, q_stride, k_shape, k_stride, v_shape, v_stride, dtype,
                      bias_sb: int = 0, sms: int = H100_SMS):
    """K3's plan and launch array for heads-major (B, H, L, d) q, k, v with
    these element strides, a fresh contiguous output and a per-key bias of
    batch stride `bias_sb`: (HeadsMajorPlan, the kernel's `args`, every
    integer of a launch, read during the call, so one array serves every
    call of this shape). Checks what the shapes and strides alone decide (a
    pure function: the audio path repeats its shapes every layer)."""
    b, h, lq, d = q_shape
    lk = k_shape[2]
    if k_shape != (b, h, lk, d) or v_shape != k_shape:
        raise ValueError(f"flash attention: q {q_shape}, k {k_shape}, v {v_shape} do not match")
    if d % 8 or not 8 <= d <= T_MAX_D:
        raise ValueError(f"K3 kernel: head dim {d} unsupported (multiples of 8 up to 160)")
    if lq < 1 or lk < 1:
        raise ValueError(f"K3 kernel: empty sequence (Lq {lq}, Lk {lk})")
    if dtype not in _DTYPES:
        raise TypeError(f"K3 kernel takes bf16 or fp32, not {dtype}")
    elem = dtype.itemsize
    per16 = 16 // elem
    steps = [st for st, n in zip(q_stride[:-1], q_shape[:-1]) if n > 1]
    if q_stride[-1] != 1 or any(st % per16 for st in steps):
        raise ValueError(f"flash attention: q strides {q_stride} unsupported")

    def view(shape, stride):  # (B, H, L, d) -> the (B, L, H, d) view
        return (shape[0], shape[2], shape[1], shape[3]), (stride[0], stride[2], stride[1],
                                                          stride[3])

    d_p = -(-d // 32) * 32
    block_q, block_k, boxes, src_boxes, slots, smem = _t_tiles(
        d_p, elem, _consumers(d_p, lq, b * h, sms))
    wide = h > 1 and k_stride[1] == v_stride[1] == d
    plan = HeadsMajorPlan(_src_map("k", *view(k_shape, k_stride), elem, wide, block_k),
                          _src_map("v", *view(v_shape, v_stride), elem, wide, block_k),
                          wide, d, d_p, boxes, 128 // elem, src_boxes, block_q, block_k, slots,
                          smem, (-(-lq // block_q), h, b))
    vals = (b, h, lq, lk, d, d_p, _DTYPES[dtype], int(wide), q_stride[0], q_stride[2],
            q_stride[1], h * lq * d, d, lq * d, bias_sb,
            *(x for m in (plan.k, plan.v) for x in (*m.dims, *m.strides)),
            block_q, block_k, slots)
    return plan, (ctypes.c_longlong * len(vals))(*vals)


def heads_major_plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias_sb: int = 0, sms: int = H100_SMS) -> HeadsMajorPlan:
    """The tensor maps, tiles, ring and grid of K3's Hopper kernel for
    heads-major (B, H, L, d) q, k, v of one dtype (bf16 or fp32; any strides
    of 16-byte steps, d contiguous). Raises on what the kernel does not
    take: d not a multiple of 8 in 8..160, strides or addresses TMA cannot
    read, mismatched shapes. K and V take maps over a token's H d columns
    when its heads are adjacent (as in the wav2vec2 view), so every box row
    lies inside the map; the kernel's converters write zeros past d."""
    _same_dtype(q, k, v)
    return _heads_major_args(tuple(q.shape), q.stride(), tuple(k.shape), k.stride(),
                             tuple(v.shape), v.stride(), q.dtype, bias_sb, sms)[0]


def _same_dtype(q, k, v) -> None:
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash attention kernel takes q, k, v of one type, not {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")


def _key_rows(bias: Optional[torch.Tensor], b: int, lk: int):
    """A per-key bias as the K3 and K6 kernels read it: (fp32 rows of Lk,
    their batch stride), the given tensor itself where it is already an fp32
    (B or 1, Lk) tensor with contiguous keys, else a (B, Lk) copy."""
    if bias is None:
        return None, 0
    if (bias.dtype == torch.float32 and bias.dim() == 2 and bias.shape[1] == lk
            and bias.shape[0] in (1, b) and bias.stride(1) == 1):
        return bias, 0 if bias.shape[0] == 1 else bias.stride(0)
    if bias.dim() > 2:
        bias = bias.reshape(bias.shape[0], -1)
    return _key_bias(bias, b, lk), lk


def flash_forward_t(q, k, v, bias=None, scale=None) -> torch.Tensor:
    """K3 on CUDA tensors, heads-major (B, H, L, d), d a multiple of 8 up to
    160: `flash_fwd_t_sm90.cu`, which reads q, k, v in their own type (fp32
    rounded to bf16 inside) and writes the output in it."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    if scale is None:
        scale = d ** -0.5
    _forward_only("flash_attention", q, k, v)
    _check_devices(q, k, v)
    rows, bias_sb = _key_rows(bias, b, lk)
    if rows is not None and rows.device != q.device:
        raise ValueError("flash attention: bias on another device than q")
    plan, args = _heads_major_args(tuple(q.shape), q.stride(), tuple(k.shape), k.stride(),
                                   tuple(v.shape), v.stride(), q.dtype, bias_sb,
                                   _sms(q.device))
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"flash attention: {name} is not 16-byte aligned")
    out = torch.empty((b, h, lq, d), dtype=q.dtype, device=q.device)
    _build.call("flash_fwd_t", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                None if rows is None else rows.data_ptr(), out.data_ptr(), args,
                float(scale) * _LOG2E, torch.cuda.current_stream(q.device).cuda_stream)
    LAUNCHES["flash_fwd_t"] += 1
    return out


# K4's Hopper kernel, csrc/flash_fwd_d512_sm90.cu: its tile configuration,
# mirrored here to describe the TMA boxes and the grid (the kernel checks
# them against its instantiation at every launch).
D512_BLOCK_Q = 64  # query rows a block: two consumer warpgroups, each half of d
D512_BLOCK_K = 32  # keys a K/V tile
D512_CLUSTER = 2  # CTAs that share each K/V tile (each loads 1/2, multicast)
D512_MAX_D = 512
# K/V tiles in the ring by head dim: as many as shared memory holds beside Q
# (64 rows x d) and the exchange of S's halves, at most 4 (the kernel's
# Tiles<D>::kStages, which static_asserts that one more would not fit)
D512_STAGES = {128: 4, 256: 4, 384: 3, 512: 2}


class D512Plan(NamedTuple):
    """What `flash_fwd_d512_sm90.cu` is launched with for one call: 5-d
    maps (64 columns, L, d / 64 column blocks, H, B) of q, k, v, so that one
    box brings a whole tile (K's and V's: a cluster CTA's share of the column
    blocks, multicast to both), and a ring of `stages` K/V tiles
    (`D512_STAGES`)."""

    q: TmaMap
    k: TmaMap
    v: TmaMap
    d: int
    boxes: int  # 64-column boxes along d
    block_q: int
    block_k: int
    stages: int
    cluster: int
    grid: Tuple[int, int, int]  # (query tiles rounded up to the cluster, H, B)


@functools.lru_cache(maxsize=256)
def _d512_plan(q_shape, q_stride, k_shape, k_stride, v_shape, v_stride) -> D512Plan:
    """`d512_plan` from heads-major (B, H, L, d) shapes and element strides
    (a pure function: the main path repeats its shapes)."""
    b, h, lq, d = q_shape
    lk = k_shape[2]
    if k_shape != (b, h, lk, d) or v_shape != k_shape:
        raise ValueError(f"K4 kernel: q {q_shape}, k {k_shape}, v {v_shape} do not match")
    if d % 128 or not 128 <= d <= D512_MAX_D:
        raise ValueError(f"K4 kernel: head dim {d} unsupported (128, 256, 384 or 512)")
    if lq < 1 or lk < 1:
        raise ValueError(f"K4 kernel: empty sequence (Lq {lq}, Lk {lk})")

    boxes = d // 64

    def tma(name, shape, stride, rows, blocks):
        # (B, H, L, d) -> the map of the (B, L, H, d) view, then its d split
        # into (64 columns, column blocks): (64, L, d / 64, H, B)
        m = _tma_map(name, (shape[0], shape[2], shape[1], shape[3]),
                     (stride[0], stride[2], stride[1], stride[3]), rows, False, "K4")
        return TmaMap((SM90_BOX_COLS, m.dims[1], boxes, *m.dims[2:]),
                      (m.strides[0], 2 * SM90_BOX_COLS, *m.strides[1:]),
                      (SM90_BOX_COLS, rows, blocks, 1, 1))

    blocks = boxes // D512_CLUSTER  # a CTA's share of a K/V tile (multicast)
    tiles = -(-lq // D512_BLOCK_Q)
    return D512Plan(tma("q", q_shape, q_stride, D512_BLOCK_Q, boxes),
                    tma("k", k_shape, k_stride, D512_BLOCK_K, blocks),
                    tma("v", v_shape, v_stride, D512_BLOCK_K, blocks), d, boxes, D512_BLOCK_Q,
                    D512_BLOCK_K, D512_STAGES[d], D512_CLUSTER,
                    (-(-tiles // D512_CLUSTER) * D512_CLUSTER, h, b))


def d512_plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> D512Plan:
    """The tensor maps, tiles and grid of K4's Hopper kernel for heads-major
    (B, H, L, d) bf16 q, k, v (any strides, d contiguous). Raises on what
    the kernel does not take: another dtype, d other than 128, 256, 384 or
    512, strides or addresses TMA cannot read, mismatched shapes. Columns
    past d never occur (d is whole boxes); query rows past Lq and keys past
    Lk read as 0."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_bf16_aligned(name, t, "K4")
    return _d512_plan(tuple(q.shape), q.stride(), tuple(k.shape), k.stride(),
                      tuple(v.shape), v.stride())


def flash_forward_d512(q, k, v, bias=None, scale=None) -> torch.Tensor:
    """K4 on CUDA tensors, heads-major (B, H, L, d), d = 128 n up to 512:
    `flash_fwd_d512_sm90.cu`. fp32 q, k, v are rounded to bf16 first (the
    tensor cores' operands) and the output is fp32, as the input."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    if scale is None:
        scale = d ** -0.5
    _forward_only("flash_forward_d512", q, k, v)
    _check_devices(q, k, v)
    if bias is not None and bias.device != q.device:
        raise ValueError("flash attention: bias on another device than q")
    out = torch.empty((b, h, lq, d), dtype=q.dtype, device=q.device)
    if q.dtype != torch.bfloat16:
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    plan = d512_plan(q, k, v)
    tiled = _tile_bias(bias, b, lk, plan.block_k)
    _build.call(
        "flash_fwd_d512",
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if tiled is None else tiled.data_ptr(), out.data_ptr(), _map_args(plan),
        b, h, lq, lk, d, h * lq * d, d, lq * d, 0 if tiled is None else tiled.stride(0),
        float(scale) * _LOG2E, int(out.dtype == torch.float32), plan.block_q, plan.block_k,
        plan.stages, plan.cluster, torch.cuda.current_stream(q.device).cuda_stream,
    )
    LAUNCHES["flash_fwd"] += 1
    return out


def flash_attention_packed(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    heads: int,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention on natural (B, L, C) tensors, C = heads * d (K1). `bias`: an
    optional additive per-key logits bias broadcastable to (B, Lk). Returns
    (B, Lq, C) in q's dtype. When grad mode is on and q, k or v needs a
    gradient, the call goes through `FlashPackedFn` (K1 with its LSE, then
    K5 in the backward)."""
    d = q.shape[2] // heads
    if scale is None:
        scale = d ** -0.5
    if _needs_grad(q, k, v):
        return FlashPackedFn.apply(q, k, v, bias, heads, scale)
    if q.device.type == "cpu":
        return packed_reference(q, k, v, heads, bias, scale)
    return flash_forward_packed(q, k, v, heads, bias, scale)[0]


def flash_forward_packed(q, k, v, heads: int, bias=None, scale=None, with_lse: bool = False):
    """K1 on CUDA tensors: (out (B, Lq, C), lse (B, H, Lq) fp32 or None),
    through `flash_fwd_sm90.cu`. fp32 q, k, v are rounded to bf16 first (the
    tensor cores' operands) and the output is fp32. Forward only:
    `flash_attention_packed` differentiates it."""
    b, lq, c = q.shape
    d = c // heads
    if scale is None:
        scale = d ** -0.5
    _forward_only("flash_forward_packed", q, k, v)
    _check_devices(q, k, v)
    out = torch.empty((b, lq, c), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, heads, lq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if q.dtype != torch.bfloat16:
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_bf16_aligned(name, t)
    plan = _plan(*_heads_view(q, heads), *_heads_view(k, heads), *_heads_view(v, heads))
    _launch_sm90(plan, q, k, v, out, (lq * c, c, d), bias, scale, lse)
    LAUNCHES["flash_fwd_packed"] += 1
    return out, lse


def _split_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, L, C) -> (B, H, L, d) fp32."""
    return t.float().unflatten(2, (heads, t.shape[2] // heads)).transpose(1, 2)


def _log2_logits(q, k, heads, bias, scale):
    """The forward's logits in log2 units, fp32 (B, H, Lq, Lk):
    (q . k) * scale * log2(e) + bias * log2(e) (MASK_VALUE x log2(e)
    overflows to -inf, as in the kernels)."""
    s = torch.einsum("bhqd,bhkd->bhqk", _split_heads(q, heads), _split_heads(k, heads))
    s = s * (scale * _LOG2E)
    kb = _key_bias(bias, q.shape[0], k.shape[1])
    if kb is not None:
        s = s + (kb * _LOG2E)[:, None, None, :]
    return s


def flash_lse_reference(q, k, heads: int, bias=None, scale=None) -> torch.Tensor:
    """Plain version of K1's LSE output: the base-2 logsumexp of each row of
    logits, fp32 (B, H, Lq); -MASK_VALUE where every key is masked (JAX's
    `with_lse`, pallas_flash.py:311-318)."""
    if scale is None:
        scale = (q.shape[2] // heads) ** -0.5
    lse = torch.logsumexp(_log2_logits(q, k, heads, bias, scale) * _LN2, dim=-1) * _LOG2E
    return torch.where(lse > -math.inf, lse, torch.full_like(lse, -MASK_VALUE))


def flash_backward_reference(q, k, v, bias, out, lse, g, heads: int, scale=None):
    """Plain version of K5: the recurrence of `csrc/flash_bwd_sm90.cu` in
    fp32 torch ops, from the forward's output `out` and base-2 `lse`
    (B, H, Lq) and the output's gradient `g`. Returns (dq, dk, dv) in the
    dtypes of q, k, v. The bias gets no gradient."""
    if scale is None:
        scale = (q.shape[2] // heads) ** -0.5
    p = torch.exp2(_log2_logits(q, k, heads, bias, scale) - lse.float()[..., None])
    gh, vh = _split_heads(g, heads), _split_heads(v, heads)
    delta = (gh * _split_heads(out, heads)).sum(-1)  # (B, H, Lq)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, gh)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", gh, vh) - delta[..., None])
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, _split_heads(k, heads)) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, _split_heads(q, heads)) * scale

    def merge(t, like):
        return t.transpose(1, 2).reshape(like.shape).to(like.dtype)

    return merge(dq, q), merge(dk, k), merge(dv, v)


# K5's Hopper kernels, csrc/flash_bwd_sm90.cu: their tile configuration,
# mirrored here to describe the TMA boxes and the grid (the kernels check
# the tiles and stages against their instantiation at every launch).
BWD_CONSUMERS = 2  # consumer warpgroups of 64 rows
BWD_DKV_KEYS = 64 * BWD_CONSUMERS  # keys per dK/dV CTA
BWD_DKV_STAGES = 4  # the Q/dO ring of the dK/dV pass (even: see the kernel)
BWD_DQ_ROWS = 64 * BWD_CONSUMERS  # queries per dQ tile
BWD_STAT_ROWS = 64  # LSE and Delta are padded to a multiple of this


class DkvPlan(NamedTuple):
    """The dK/dV pass: a CTA owns `block_k` keys and walks `tiles` query
    tiles of `block_q` (its split of the query range) through a ring of
    `stages`; Q and dO boxes are `block_q` rows, K and V boxes `block_k`.
    With `wg_split` (Lk <= 64) both consumer warpgroups take the same 64
    keys and alternate query tiles. With `splits` > 1 each split writes fp32
    partials that the wrapper sums in order."""

    q: TmaMap
    k: TmaMap
    v: TmaMap
    g: TmaMap
    block_q: int
    block_k: int
    stages: int
    wg_split: bool
    splits: int
    tiles: int
    grid: Tuple[int, int, int]  # (key tiles x splits, H, B)


class DqPlan(NamedTuple):
    """The dQ pass: a CTA walks `tiles` query tiles of `block_q` rows; K
    and V stream through a ring of `stages` tiles of `block_k` keys, each CTA
    of a cluster of two loading half (boxes of block_k / 2 rows) and
    multicasting it; Q and dO take `q_buffers` buffers."""

    q: TmaMap
    k: TmaMap
    v: TmaMap
    g: TmaMap
    block_q: int
    block_k: int
    stages: int
    q_buffers: int
    tiles: int
    grid: Tuple[int, int, int]  # (CTAs along the queries, rounded to the cluster, H, B)


class Sm90BwdPlan(NamedTuple):
    """What `flash_bwd_sm90.cu` is launched with for one backward call."""

    wide: bool  # q, k, v, dO through wide maps (their pad zeroed in shared memory)
    d_qk: int  # the contraction of S and dP: d rounded up to 16
    d_v: int  # the width of dQ, dK, dV: d
    boxes: int
    lq_pad: int  # LSE and Delta rows: Lq rounded up to BWD_STAT_ROWS
    lk_pad: int  # the tiled bias's row: Lk rounded up to BWD_DKV_KEYS
    dkv: DkvPlan
    dq: DqPlan
    zeroed: Tuple[str, ...]  # as Sm90Plan's: the operands of S and dP


def _dkv_splits(nq: int, base: int, wg_split: bool, sms: int) -> Tuple[int, int]:
    """(splits, tiles per split) of the dK/dV pass's nq query tiles over
    `base` CTAs (key tiles x heads x batch), one CTA an SM: the split whose
    waves of CTAs, each some tiles long plus about two tiles' worth of fixed
    cost, end first (the fewest splits among equals). Without idle SMs, one."""
    if base >= sms:
        return 1, nq
    best = None
    for splits in range(1, nq + 1):
        tiles = -(-nq // splits)
        if -(-nq // tiles) != splits:
            continue  # the same tiles with fewer splits was counted
        per_wg = -(-tiles // 2) if wg_split else tiles
        cost = -(-splits * base // sms) * (per_wg + 2)
        if best is None or cost < best[0]:
            best = (cost, splits, tiles)
    return best[1], best[2]


def _dq_tiles(q_tiles: int, key_tiles: int, rows: int, sms: int) -> int:
    """Query tiles per dQ CTA: one, unless the CTA has at most two key tiles
    to walk (short Lk), when its fixed latency would run alone: then the
    fewest CTAs along the queries (a multiple of the cluster) that still give
    two CTAs an SM over the `rows` (heads x batch) and leave at most an eighth
    of the CTAs' tiles past Lq, each with an even share of the tiles."""
    if key_tiles > 2:
        return 1
    for ctas in range(SM90_CLUSTER, q_tiles + 1, SM90_CLUSTER):
        per = -(-q_tiles // ctas)
        if ctas * rows >= 2 * sms and (ctas * per - q_tiles) * 8 <= q_tiles:
            return per
    return 1


@functools.lru_cache(maxsize=1024)
def _bwd_plan(q_shape, q_stride, k_shape, k_stride, v_shape, v_stride, g_shape, g_stride,
              sms: int = H100_SMS) -> Sm90BwdPlan:
    """`bwd_plan` from the operands' (B, L, H, d) shapes and element strides
    (a pure function: the main path repeats its shapes every step)."""
    b, lq, h, d = q_shape
    lk = k_shape[1]
    if (k_shape != (b, lk, h, d) or v_shape != k_shape or g_shape != q_shape):
        raise ValueError(f"K5 kernel: q {q_shape}, k {k_shape}, v {v_shape}, "
                         f"dO {g_shape} do not match")
    if d % 8 or not 8 <= d <= SM90_MAX_D:
        raise ValueError(f"K5 kernel: head dim {d} unsupported (multiples of 8 up to 160)")
    if lq < 1 or lk < 1:
        raise ValueError(f"K5 kernel: empty sequence (Lq {lq}, Lk {lk})")
    d_qk = -(-d // 16) * 16
    boxes = -(-d_qk // SM90_BOX_COLS)
    wide = h > 1 and q_stride[2] == k_stride[2] == v_stride[2] == g_stride[2] == d

    def maps(q_rows, kv_rows):
        return (_tma_map("q", q_shape, q_stride, q_rows, wide),
                _tma_map("k", k_shape, k_stride, kv_rows, wide),
                _tma_map("v", v_shape, v_stride, kv_rows, wide),
                _tma_map("dO", g_shape, g_stride, q_rows, wide))

    # dK/dV: 64 queries a tile (32 above d 96: the registers of dK and dV)
    dkv_q = 64 if d <= 96 else 32
    key_tiles = -(-lk // BWD_DKV_KEYS)
    nq = -(-lq // dkv_q)
    wg_split = lk <= 64 and nq >= 2
    splits, tiles = _dkv_splits(nq, key_tiles * h * b, wg_split, sms)
    dkv = DkvPlan(*maps(dkv_q, BWD_DKV_KEYS), dkv_q, BWD_DKV_KEYS, BWD_DKV_STAGES, wg_split,
                  splits, tiles, (key_tiles * splits, h, b))
    # dQ: 128 keys a tile (64 above d 96: registers; 32 up to d 64 where Lk
    # <= 32, the audio and identity lengths); 3 stages and two Q buffers
    # while d fits one box, else 2 and one (shared memory)
    dq_k = 32 if lk <= 32 and d <= 64 else 128 if d <= 96 else 64
    q_buffers = 2 if boxes == 1 else 1
    q_tiles = -(-lq // BWD_DQ_ROWS)
    per = _dq_tiles(q_tiles, -(-lk // dq_k), h * b, sms)
    ctas = -(-(-(-q_tiles // per)) // SM90_CLUSTER) * SM90_CLUSTER
    dq = DqPlan(*maps(BWD_DQ_ROWS, dq_k // SM90_CLUSTER), BWD_DQ_ROWS, dq_k,
                3 if boxes == 1 else 2, q_buffers, per, (ctas, h, b))
    return Sm90BwdPlan(wide, d_qk, d, boxes, -(-lq // BWD_STAT_ROWS) * BWD_STAT_ROWS,
                       key_tiles * BWD_DKV_KEYS, dkv, dq,
                       ("q", "k", "dO", "v") if wide and d_qk > d else ())


def bwd_plan(q4, k4, v4, g4, sms: int = H100_SMS) -> Sm90BwdPlan:
    """The tensor maps, tiles, splits and grids of K5's Hopper kernels for
    (B, L, H, d) views of bf16 q, k, v and dO (any strides, d contiguous)
    on a card of `sms` SMs. Raises on what the kernels do not take: another
    dtype, d not a multiple of 8 in 8..160, strides or addresses TMA cannot
    read, mismatched shapes. The maps are K1's (`sm90_plan`): wide where a
    token's heads are adjacent in all four, and the kernels then zero the
    pad columns (d up to d rounded to 16) of Q, K, dO and V in shared memory,
    so that head h's gradients never read head h + 1's values."""
    for name, t in (("q", q4), ("k", k4), ("v", v4), ("dO", g4)):
        _check_bf16_aligned(name, t)
    return _bwd_plan(tuple(q4.shape), q4.stride(), tuple(k4.shape), k4.stride(),
                     tuple(v4.shape), v4.stride(), tuple(g4.shape), g4.stride(), sms)


@functools.lru_cache(maxsize=1024)
def _bwd_args(plan: Sm90BwdPlan, dq_pass: bool, b: int, lq: int, lk: int, h: int):
    """A K5 launch's `maps` and `cfg` arrays (csrc/flash_bwd_sm90.cu's enum
    Cfg), read during the call, so one pair serves every call with this
    plan."""
    p = plan.dq if dq_pass else plan.dkv
    vals = [x for m in (p.q, p.k, p.v, p.g) for x in (*m.dims, *m.strides)]
    extra = p.q_buffers if dq_pass else int(p.wg_split)
    cfg = (b, h, lq, lk, plan.d_v, plan.lq_pad, plan.lk_pad, b * lk * h * plan.d_v,
           int(plan.wide), p.block_q, p.block_k, p.stages, p.tiles, p.grid[0], extra)
    return (ctypes.c_longlong * len(vals))(*vals), (ctypes.c_longlong * len(cfg))(*cfg)


@functools.lru_cache(maxsize=16)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


class BackwardArgs(NamedTuple):
    """K5's checked CUDA inputs: bf16 q, k, v, dO (`g`) and their plan, the
    tiled per-key bias (or None), lse and Delta = rowsum(g * out) as fp32
    (B, H, Lq rounded up to 64) (+inf and 0 past Lq), the outputs' dtype."""

    q: torch.Tensor
    k: torch.Tensor
    v: torch.Tensor
    g: torch.Tensor
    bias: Optional[torch.Tensor]
    lse: torch.Tensor
    delta: torch.Tensor
    heads: int
    scale: float
    plan: Sm90BwdPlan
    dtype: torch.dtype


def _padded_rows(t: torch.Tensor, lq_pad: int, fill: float) -> torch.Tensor:
    """(B, H, Lq) fp32 -> contiguous (B, H, lq_pad), `fill` past Lq."""
    lq = t.shape[-1]
    if lq == lq_pad:
        return t.contiguous()
    out = torch.full((*t.shape[:-1], lq_pad), fill, dtype=torch.float32, device=t.device)
    out[..., :lq] = t
    return out


def backward_args(q, k, v, bias, out, lse, g, heads: int, scale=None) -> BackwardArgs:
    """Check K5's CUDA inputs, plan the launches, and compute Delta =
    rowsum(g * out) in fp32 torch ops, as JAX computes it in XLA outside its
    kernels (pallas_flash.py:579-581). fp32 q, k, v, g are rounded to bf16
    (the tensor cores' operands); the gradients keep q's dtype."""
    b, lq, c = q.shape
    d = c // heads
    if scale is None:
        scale = d ** -0.5
    _check_devices(q, k, v)
    for name, t in (("out", out), ("lse", lse), ("g", g)):
        if t.device != q.device:
            raise ValueError(f"flash attention backward: {name} on {t.device}, q on {q.device}")
    if bias is not None and bias.device != q.device:
        raise ValueError("flash attention backward: bias on another device than q")
    dtype = q.dtype
    q, k, v, g = (t if t.dtype == torch.bfloat16 else t.to(torch.bfloat16) for t in (q, k, v, g))
    for name, t in (("q", q), ("k", k), ("v", v), ("g", g)):
        _check_bf16_aligned(name, t)
    plan = _bwd_plan(*_heads_view(q, heads), *_heads_view(k, heads), *_heads_view(v, heads),
                     *_heads_view(g, heads), _sms(q.device))
    delta = (g.float() * out.float()).unflatten(2, (heads, d)).sum(-1).transpose(1, 2)
    return BackwardArgs(
        q, k, v, g, _tile_bias(bias, b, k.shape[1], BWD_DKV_KEYS),
        _padded_rows(lse.float(), plan.lq_pad, math.inf),
        _padded_rows(delta, plan.lq_pad, 0.0), heads, float(scale), plan, dtype)


def _bwd_call(entry: str, a: BackwardArgs, out0, out1, out_f32: bool) -> None:
    b, lq, c = a.q.shape
    maps, cfg = _bwd_args(a.plan, entry == "flash_bwd_dq", b, lq, a.k.shape[1], a.heads)
    _build.call(
        entry,
        a.q.data_ptr(), a.k.data_ptr(), a.v.data_ptr(), a.g.data_ptr(),
        None if a.bias is None else a.bias.data_ptr(), a.lse.data_ptr(), a.delta.data_ptr(),
        out0.data_ptr(), None if out1 is None else out1.data_ptr(), maps, cfg, int(out_f32),
        a.scale, a.scale * _LOG2E, torch.cuda.current_stream(a.q.device).cuda_stream,
    )


def flash_bwd_dkv(a: BackwardArgs) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5's dK/dV pass (`_dkv_kernel_packed`): (dk, dv). Where the plan
    splits the query range, the kernel writes fp32 partials, summed here in
    split order."""
    splits = a.plan.dkv.splits
    if splits == 1:
        dk = torch.empty(a.k.shape, dtype=a.dtype, device=a.k.device)
        dv = torch.empty(a.v.shape, dtype=a.dtype, device=a.v.device)
        _bwd_call("flash_bwd_dkv", a, dk, dv, a.dtype == torch.float32)
    else:
        part = torch.empty((2, splits, *a.k.shape), dtype=torch.float32, device=a.k.device)
        _bwd_call("flash_bwd_dkv", a, part[0], part[1], True)
        dk, dv = part.sum(1).to(a.dtype)
    LAUNCHES["flash_bwd_dkv"] += 1
    return dk, dv


def flash_bwd_dq(a: BackwardArgs) -> torch.Tensor:
    """K5's dQ pass (`_dq_kernel_packed`)."""
    dq = torch.empty(a.q.shape, dtype=a.dtype, device=a.q.device)
    _bwd_call("flash_bwd_dq", a, dq, None, a.dtype == torch.float32)
    LAUNCHES["flash_bwd_dq"] += 1
    return dq


def flash_backward(q, k, v, bias, out, lse, g, heads: int, scale=None):
    """K5 on CUDA tensors: the two passes of `csrc/flash_bwd_sm90.cu` from
    the forward's `out` and `lse`. Returns (dq, dk, dv)."""
    a = backward_args(q, k, v, bias, out, lse, g, heads, scale)
    dk, dv = flash_bwd_dkv(a)
    return flash_bwd_dq(a), dk, dv


class FlashPackedFn(torch.autograd.Function):
    """K1 with its LSE forward and K5 backward (JAX's `_flash_packed`
    custom_vjp, pallas_flash.py:701-742). On the CPU both directions take
    the plain versions. The residuals are JAX's: q, k, v, bias, out, lse.
    The bias (a constant mask) gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, bias, heads, scale):
        if q.device.type == "cpu":
            out = packed_reference(q, k, v, heads, bias, scale)
            lse = flash_lse_reference(q, k, heads, bias, scale)
        else:
            out, lse = flash_forward_packed(q, k, v, heads, bias, scale, with_lse=True)
        ctx.heads, ctx.scale = heads, scale
        ctx.save_for_backward(q, k, v, bias, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, out, lse = ctx.saved_tensors
        fn = flash_backward_reference if q.device.type == "cpu" else flash_backward
        dq, dk, dv = fn(q, k, v, bias, out, lse, g, ctx.heads, ctx.scale)
        return dq, dk, dv, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention heads-major (K3 when D % 128 != 0, else K4): q (B, H, Lq, D),
    k/v (B, H, Lk, D) in bf16 or fp32, bias an optional per-key logits bias
    broadcastable to (B, Lk). Returns (B, H, Lq, D) in q's dtype. fp32 q/k/v
    are rounded to bf16 for the tensor cores (the TPU MXU's default
    precision); softmax and accumulation are fp32 either way. Forward only:
    on the card, an input that needs a gradient raises. K3 takes D a
    multiple of 8 up to 160, K4 D = 128, 256, 384 or 512; any other D raises
    on the card."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    if scale is None:
        scale = d ** -0.5
    if q.device.type == "cpu":
        kb = _key_bias(bias, b, lk)
        return attention_reference(
            q, k, v, None if kb is None else kb[:, None, None, :], scale
        )
    if d % 128 == 0:
        return flash_forward_d512(q, k, v, bias, scale)
    return flash_forward_t(q, k, v, bias, scale)


def quantize_int8(q: torch.Tensor, k: torch.Tensor, scale: float):
    """K6's prelude (pallas_flash.py:886-895): K mean-smoothed over the keys
    (a per-query-row shift of the scores, which cancels in the softmax),
    per-row absmax scales (floor 1e-8), round half to even, clip to +-127.
    scale * log2(e) rides in the Q scales. Returns int8 (B, H, L, D) q and k
    (contiguous) and their fp32 (B, H, L) scales."""
    qf = q.float()
    kf = k.float()
    kf = kf - kf.mean(dim=2, keepdim=True)
    qs = torch.clamp(qf.abs().amax(dim=3, keepdim=True) / 127.0, min=1e-8)
    ks = torch.clamp(kf.abs().amax(dim=3, keepdim=True) / 127.0, min=1e-8)
    q8 = torch.clamp(torch.round(qf / qs), -127, 127).to(torch.int8)
    k8 = torch.clamp(torch.round(kf / ks), -127, 127).to(torch.int8)
    qs = (qs * (scale * _LOG2E))[..., 0]
    return (q8.contiguous(), k8.contiguous(), qs.contiguous(), ks[..., 0].contiguous())


def int8_reference(q, k, v, bias=None, scale=None):
    """Plain version of `flash_attention_int8`: the same prelude, then fp32
    products of the integer-valued q and k (exact for the kernel's head dims:
    |sum| <= 160 * 127^2 < 2^24), the same dequantisation, base-2 softmax
    and PV in fp32. A row whose keys are all masked gives 0."""
    b, h, lq, d = q.shape
    if scale is None:
        scale = d ** -0.5
    q8, k8, qs, ks = quantize_int8(q, k, scale)
    s = torch.einsum("bhqd,bhkd->bhqk", q8.float(), k8.float())
    s = s * ks[:, :, None, :] * qs[:, :, :, None]
    kb = _key_bias(bias, b, k.shape[2])
    if kb is not None:
        s = s + (kb * _LOG2E)[:, None, None, :]
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - torch.where(torch.isfinite(m), m, torch.zeros_like(m)))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    out = out / torch.where(l > 0, l, torch.ones_like(l))
    return out.to(v.dtype)


# K6's Hopper kernels, csrc/flash_int8_sm90.cu: the prelude's cluster and
# the attention kernel's tiles, mirrored here to lay out the prelude's
# buffers, the TMA boxes and the grid (the kernel checks block_q, block_k
# and stages against its instantiation at every launch). Widths are
# instantiated at d rounded up to 32.
INT8_PRELUDE_CLUSTER = 8  # CTAs that split one (b, h)'s keys and share its K mean
INT8_STAGES = 3
_INT8_ALIGN = 1024  # each buffer of the prelude's workspace starts on this


class Int8Plan(NamedTuple):
    """What `flash_int8_sm90.cu`'s two kernels are launched with for one
    call. The prelude writes, into one workspace at these byte offsets:
    q8 (B H, Lq, d_p) and k8 (B H, Lk, d_p) int8 (zeros past d), qs (B H,
    Lq) fp32, meta (B H, lk_pad, 2) fp32 (ks, bias log2 e; (0, -inf) past
    Lk) and v16 (B H, Lk, d_vp) bf16 (zeros past d). The attention kernel
    reads q8, k8 and v16 by one TMA box a tile."""

    q8: TmaMap  # (32 bytes, Lq, d_p / 32 column blocks, B H): 32-byte swizzle
    k8: TmaMap
    v16: TmaMap  # (64 columns, Lk, d_vp / 64, B H): 128-byte swizzle
    d: int
    d_p: int  # q8/k8 rows: d rounded up to 32 (int8 wgmma's k-depth)
    d_vp: int  # v16 rows: d_p rounded up to 64 (whole 128-byte boxes)
    lk_pad: int  # meta's keys: Lk rounded up to block_k
    block_q: int  # 64 query rows per consumer warpgroup: 2, or 3 up to d 64 (`_consumers`)
    block_k: int
    stages: int
    grid: Tuple[int, int, int]  # (query blocks, H, B)
    prelude_grid: Tuple[int, int, int]  # (the cluster, B H, {K, Q, V})
    offsets: Tuple[int, int, int, int, int]  # q8, k8, qs, meta, v16 in the workspace
    workspace: int  # bytes


@functools.lru_cache(maxsize=1024)
def _int8_args(q_shape, q_stride, k_shape, k_stride, v_shape, v_stride, dtype,
               bias_sb: int = 0, sms: int = H100_SMS):
    """K6's plan and launch array (csrc/flash_int8_sm90.cu's enum Arg) for
    heads-major q, k, v with these element strides and a per-key bias of
    batch stride `bias_sb` (a pure function: the audio path repeats its
    shapes every layer)."""
    b, h, lq, d = q_shape
    lk = k_shape[2]
    if k_shape != (b, h, lk, d) or v_shape != k_shape:
        raise ValueError(f"int8 flash attention: q {q_shape}, k {k_shape}, v {v_shape} "
                         "do not match")
    if d % 8 or not 8 <= d <= T_MAX_D:
        raise ValueError(f"K6 kernel: head dim {d} unsupported (multiples of 8 up to 160)")
    if lq < 1 or lk < 1:
        raise ValueError(f"K6 kernel: empty sequence (Lq {lq}, Lk {lk})")
    if dtype not in _DTYPES:
        raise TypeError(f"K6 kernel takes bf16 or fp32, not {dtype}")
    per16 = 16 // dtype.itemsize
    for name, shape, stride in (("q", q_shape, q_stride), ("k", k_shape, k_stride),
                                ("v", v_shape, v_stride)):
        steps = [st for st, n in zip(stride[:-1], shape[:-1]) if n > 1]
        if stride[-1] != 1 or any(st % per16 for st in steps):
            raise ValueError(f"int8 flash attention: {name} strides {stride} unsupported")
    if max(lq, lk) * T_MAX_D * b * h >= 1 << 31:
        raise ValueError(f"K6 kernel: shape {q_shape}, {k_shape} too large")
    d_p = -(-d // 32) * 32
    d_vp = -(-d_p // 64) * 64
    block_q, block_k = 64 * _consumers(d_p, lq, b * h, sms), 128 if d_vp <= 128 else 64
    lk_pad = -(-lk // block_k) * block_k
    bh = b * h
    sizes = (bh * lq * d_p, bh * lk * d_p, 4 * bh * lq, 8 * bh * lk_pad, 2 * bh * lk * d_vp)
    offsets, at = [], 0
    for n in sizes:
        offsets.append(at)
        at += -(-n // _INT8_ALIGN) * _INT8_ALIGN
    plan = Int8Plan(
        TmaMap((32, lq, d_p // 32, bh), (d_p, 32, lq * d_p), (32, block_q, d_p // 32, 1)),
        TmaMap((32, lk, d_p // 32, bh), (d_p, 32, lk * d_p), (32, block_k, d_p // 32, 1)),
        TmaMap((64, lk, d_vp // 64, bh), (2 * d_vp, 128, 2 * lk * d_vp),
               (64, block_k, d_vp // 64, 1)),
        d, d_p, d_vp, lk_pad, block_q, block_k, INT8_STAGES, (-(-lq // block_q), h, b),
        (INT8_PRELUDE_CLUSTER, bh, 3), tuple(offsets), at)
    vals = (b, h, lq, lk, d, d_p, d_vp, lk_pad, _DTYPES[dtype],
            q_stride[0], q_stride[2], q_stride[1], k_stride[0], k_stride[2], k_stride[1],
            v_stride[0], v_stride[2], v_stride[1], bias_sb, block_q, block_k, INT8_STAGES)
    return plan, (ctypes.c_longlong * len(vals))(*vals)


def int8_plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias_sb: int = 0,
              sms: int = H100_SMS) -> Int8Plan:
    """The prelude's buffers, the tensor maps, tiles and grids of K6's two
    Hopper kernels for heads-major (B, H, L, d) q, k, v of one dtype (bf16
    or fp32; any strides of 16-byte steps, d contiguous). Raises on what the
    kernels do not take: d not a multiple of 8 in 8..160, other strides,
    mismatched shapes."""
    _same_dtype(q, k, v)
    return _int8_args(tuple(q.shape), q.stride(), tuple(k.shape), k.stride(),
                      tuple(v.shape), v.stride(), q.dtype, bias_sb, sms)[0]


class Int8Operands(NamedTuple):
    """The prelude's output: views of its workspace (see `Int8Plan`)."""

    q8: torch.Tensor  # (B H, Lq, d_p) int8
    k8: torch.Tensor  # (B H, Lk, d_p) int8
    qs: torch.Tensor  # (B H, Lq) fp32, times scale * log2 e
    meta: torch.Tensor  # (B H, lk_pad, 2) fp32
    v16: torch.Tensor  # (B H, Lk, d_vp) bf16
    workspace: torch.Tensor
    args: object  # the launch array
    plan: Int8Plan
    dtype: torch.dtype  # the output's


def _int8_checked(q, k, v, bias):
    """K6's checked CUDA inputs: (plan, args, the bias rows or None)."""
    b, h, lq, d = q.shape
    _forward_only("flash_attention_int8", q, k, v)
    _check_devices(q, k, v)
    rows, bias_sb = _key_rows(bias, b, k.shape[2])
    if rows is not None and rows.device != q.device:
        raise ValueError("int8 flash attention: bias on another device than q")
    plan, args = _int8_args(tuple(q.shape), q.stride(), tuple(k.shape), k.stride(),
                            tuple(v.shape), v.stride(), q.dtype, bias_sb, _sms(q.device))
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"int8 flash attention: {name} is not 16-byte aligned")
    return plan, args, rows


def _launch_prelude(q, k, v, rows, ws_ptr: int, plan: Int8Plan, args, scale: float) -> None:
    o = plan.offsets
    _build.call("int8_prelude", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                None if rows is None else rows.data_ptr(), ws_ptr + o[0], ws_ptr + o[1],
                ws_ptr + o[2], ws_ptr + o[3], ws_ptr + o[4], args, float(scale) * _LOG2E,
                torch.cuda.current_stream(q.device).cuda_stream)
    LAUNCHES["int8_prelude"] += 1


def _launch_int8(ws_ptr: int, plan: Int8Plan, args, out: torch.Tensor) -> None:
    o = plan.offsets
    _build.call("flash_int8", ws_ptr + o[0], ws_ptr + o[1], ws_ptr + o[4], ws_ptr + o[3],
                ws_ptr + o[2], out.data_ptr(), args,
                torch.cuda.current_stream(out.device).cuda_stream)
    LAUNCHES["flash_int8"] += 1


def flash_attention_int8(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Heads-major attention with int8 QK^T scores (K6): q (B, H, Lq, D),
    k/v (B, H, Lk, D), bias an optional per-key logits bias broadcastable
    to (B, Lk). Returns (B, H, Lq, D) in v's dtype (bf16 or fp32). On the
    CPU the plain version (`int8_reference`); on the card two launches of
    `flash_int8_sm90.cu`: the prelude kernel (`quantize_int8`'s counterpart)
    into one workspace, then the attention kernel. q, k and v share one
    dtype there. Forward only: on the card, an input that needs a gradient
    raises."""
    d = q.shape[-1]
    if scale is None:
        scale = d ** -0.5
    if q.device.type == "cpu":
        return int8_reference(q, k, v, bias, scale)
    plan, args, rows = _int8_checked(q, k, v, bias)
    ws = torch.empty(plan.workspace, dtype=torch.uint8, device=q.device)
    out = torch.empty(q.shape, dtype=v.dtype, device=q.device)
    _launch_prelude(q, k, v, rows, ws.data_ptr(), plan, args, scale)
    _launch_int8(ws.data_ptr(), plan, args, out)
    return out


def _operands(ws: torch.Tensor, plan: Int8Plan, args, dtype) -> Int8Operands:
    """Views of the workspace's five buffers."""
    b, h = plan.grid[2], plan.grid[1]
    lq, lk = plan.q8.dims[1], plan.k8.dims[1]
    o = plan.offsets

    def part(i, n, dt, shape):
        return ws[o[i]:o[i] + n * dt.itemsize].view(dt).view(shape)

    bh = b * h
    return Int8Operands(
        part(0, bh * lq * plan.d_p, torch.int8, (bh, lq, plan.d_p)),
        part(1, bh * lk * plan.d_p, torch.int8, (bh, lk, plan.d_p)),
        part(2, bh * lq, torch.float32, (bh, lq)),
        part(3, bh * plan.lk_pad * 2, torch.float32, (bh, plan.lk_pad, 2)),
        part(4, bh * lk * plan.d_vp, torch.bfloat16, (bh, lk, plan.d_vp)),
        ws, args, plan, dtype)


def int8_prelude(q, k, v, *, bias=None, scale=None) -> Int8Operands:
    """K6's prelude kernel alone on CUDA tensors: `flash_attention_int8`'s
    first launch, its buffers returned as views (the test and the benchmark
    read them; `int8_attention` takes them)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    plan, args, rows = _int8_checked(q, k, v, bias)
    ws = torch.empty(plan.workspace, dtype=torch.uint8, device=q.device)
    _launch_prelude(q, k, v, rows, ws.data_ptr(), plan, args, scale)
    return _operands(ws, plan, args, v.dtype)


def int8_attention(ops: Int8Operands) -> torch.Tensor:
    """K6's attention kernel alone on the prelude's buffers."""
    b, h = ops.plan.grid[2], ops.plan.grid[1]
    out = torch.empty((b, h, ops.q8.shape[1], ops.plan.d), dtype=ops.dtype,
                      device=ops.workspace.device)
    _launch_int8(ops.workspace.data_ptr(), ops.plan, ops.args, out)
    return out


def flash_int8_quantized(
    q8: torch.Tensor,
    k8: torch.Tensor,
    qs: torch.Tensor,
    ks: torch.Tensor,
    v: torch.Tensor,
    *,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The K6 attention kernel on `quantize_int8`'s output: q8/k8 int8 (B, H,
    L, D) and their fp32 (B, H, L) scales (contiguous), v (B, H, Lk, D) bf16
    or fp32, bias as for `flash_attention_int8`. CUDA tensors only. The
    kernel reads the prelude kernel's layout (`Int8Plan`), so this wrapper
    repacks the given buffers into it with torch ops: rows padded with zeros
    to d rounded up to 32 (q8, k8) and to 64 (v16, V rounded to bf16), meta
    (ks, bias log2 e) with (0, -inf) past Lk."""
    b, h, lq, d = q8.shape
    lk = k8.shape[2]
    _forward_only("flash_int8_quantized", qs, ks, v)
    for name, t in (("q8", q8), ("k8", k8), ("qs", qs), ("ks", ks), ("v", v)):
        if not t.is_cuda or t.device != v.device:
            raise ValueError(f"int8 flash attention: {name} on {t.device}, v on {v.device}")
    for name, t, dtype in (("q8", q8, torch.int8), ("k8", k8, torch.int8),
                           ("qs", qs, torch.float32), ("ks", ks, torch.float32)):
        if t.dtype != dtype or not t.is_contiguous():
            raise TypeError(f"int8 flash attention: {name} must be contiguous {dtype}")
    if v.dtype not in _DTYPES:
        raise TypeError(f"int8 flash attention kernel takes bf16 or fp32 v, not {v.dtype}")
    _check_16b("v", v)
    rows, _ = _key_rows(bias, b, lk)
    if rows is not None and rows.device != v.device:
        raise ValueError("int8 flash attention: bias on another device than v")
    shape = (b, h, lq, d)
    plan, args = _int8_args(shape, (h * lq * d, lq * d, d, 1), tuple(v.shape),
                            (h * lk * d, lk * d, d, 1), tuple(v.shape),
                            (h * lk * d, lk * d, d, 1), v.dtype, 0, _sms(v.device))
    ws = torch.empty(plan.workspace, dtype=torch.uint8, device=v.device)
    ops = _operands(ws, plan, args, v.dtype)
    pad = (0, plan.d_p - d)
    ops.q8.copy_(torch.nn.functional.pad(q8.reshape(b * h, lq, d), pad))
    ops.k8.copy_(torch.nn.functional.pad(k8.reshape(b * h, lk, d), pad))
    ops.qs.copy_(qs.reshape(b * h, lq))
    ops.v16.copy_(torch.nn.functional.pad(v.reshape(b * h, lk, d).to(torch.bfloat16),
                                          (0, plan.d_vp - d)))
    ops.meta[:, :, 0] = 0.0
    ops.meta[:, :lk, 0] = ks.reshape(b * h, lk)
    ops.meta[:, :, 1] = -math.inf
    kb = 0.0 if rows is None else (rows.expand(b, lk) * _LOG2E).repeat_interleave(h, dim=0)
    ops.meta[:, :lk, 1] = kb
    return int8_attention(ops)
