"""The layout anchor: the CUDA copy kernel `csrc/layout_copy.cu` (a ring of
bulk copies, one thread a CTA of a persistent grid) and its plain PyTorch
version.

Counterpart of hallo_tpu/ops/layout.py (K9, `_copy_kernel`). On the TPU the
identity copy forced XLA to resolve a transposed HBM layout at one point of
the graph. The card has no such tiling to force: here `layout_anchor(x)` is
a fresh row-major copy of x made by this kernel, and x itself where
x.ndim < 2, as in JAX. Nothing calls it, in either package.

A CPU tensor takes the plain version (`layout_anchor_reference`); a CUDA
tensor launches the kernel or raises. The kernel reads x as a flat
contiguous buffer, so a non-contiguous x (a transposed view, say) raises
`ValueError` instead of being copied first. JAX cannot differentiate the
anchor, and the kernel has no backward: on the card an input that needs a
gradient raises. Launches are counted in `LAUNCHES`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from hallo_tpu_torch.ops import _build
from hallo_tpu_torch.ops.flash import H100_SMS, _forward_only, _sms

LAUNCHES = {"layout_copy": 0}
# The kernel's configuration (csrc/layout_copy.cu), mirrored here to split
# the work: a ring stage's bytes and a CTA's threads (one CTA an SM).
COPY_CHUNK = 16384
COPY_THREADS = 128


class CopyPlan(NamedTuple):
    """K9's split of a copy of `nbytes` bytes (head + body + tail)."""

    head: int  # bytes before the body, one a thread
    body: int  # bulk-copied bytes: 16-byte aligned in both buffers, a multiple of 16
    tail: int  # bytes after the body, one a thread
    chunks: int  # the body's ring stages of COPY_CHUNK bytes (the last may be shorter)
    grid: int  # persistent CTAs, one an SM at most


def copy_plan(src: int, dst: int, nbytes: int, sms: int = H100_SMS) -> CopyPlan:
    """The split of a copy from address `src` to `dst`: bulk copies need
    16-byte-aligned addresses and sizes, so where the two addresses agree
    modulo 16 the body runs from the first 16-byte boundary to the last;
    otherwise there is no body and every byte goes one per thread."""
    return _copy_plan(src % 16, dst % 16, nbytes, sms)


@functools.lru_cache(maxsize=256)
def _copy_plan(src16: int, dst16: int, nbytes: int, sms: int) -> CopyPlan:
    if nbytes < 1:
        raise ValueError(f"layout anchor: {nbytes} bytes to copy")
    head = body = 0
    if src16 == dst16:
        head = min(nbytes, -src16 % 16)
        body = (nbytes - head) // 16 * 16
    tail = nbytes - head - body
    chunks = -(-body // COPY_CHUNK)
    grid = min(sms, max(1, chunks, -(-(head + tail) // COPY_THREADS)))
    return CopyPlan(head, body, tail, chunks, grid)


def layout_anchor_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version: a contiguous copy."""
    return x.clone(memory_format=torch.contiguous_format)


def layout_anchor(x: torch.Tensor, block_rows: int = 1024) -> torch.Tensor:
    """x's values in a new contiguous tensor of x's shape (x itself where
    x.ndim < 2). `block_rows` is the JAX signature's block height; the
    kernel needs no divisor of the row count and ignores it."""
    if x.ndim < 2:
        return x
    if x.device.type == "cpu":
        return layout_anchor_reference(x)
    _forward_only("layout_anchor", x)
    return layout_copy(x)


def layout_copy(x: torch.Tensor) -> torch.Tensor:
    """K9 on a contiguous CUDA tensor: bulk copies of the 16-byte-aligned
    part where the two buffers sit at the same offset modulo 16, and the
    bytes before and after it (or all of them) one per thread."""
    if not x.is_cuda:
        raise ValueError(f"layout anchor: x is on {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"layout anchor: x (strides {x.stride()}) is not contiguous")
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    nbytes = x.numel() * x.element_size()
    if nbytes:
        plan = copy_plan(x.data_ptr(), out.data_ptr(), nbytes, _sms(x.device))
        _build.call("layout_copy", x.data_ptr(), out.data_ptr(), nbytes, plan.head, plan.body,
                    plan.grid, torch.cuda.current_stream(x.device).cuda_stream)
        LAUNCHES["layout_copy"] += 1
    return out
