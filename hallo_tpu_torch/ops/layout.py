"""The layout anchor: the CUDA copy kernel `csrc/layout_copy.cu` and its plain
PyTorch version.

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

import torch

from hallo_tpu_torch.ops import _build
from hallo_tpu_torch.ops.flash import _forward_only

LAUNCHES = {"layout_copy": 0}


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
    """K9 on a contiguous CUDA tensor: 16-byte vector copies where both
    buffers are 16-byte aligned, and a byte tail."""
    if not x.is_cuda:
        raise ValueError(f"layout anchor: x is on {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"layout anchor: x (strides {x.stride()}) is not contiguous")
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    nbytes = x.numel() * x.element_size()
    if nbytes:
        _build.call("layout_copy", x.data_ptr(), out.data_ptr(), nbytes,
                    torch.cuda.current_stream(x.device).cuda_stream)
        LAUNCHES["layout_copy"] += 1
    return out
