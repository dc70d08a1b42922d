"""Differentiable collectives over a process group: the port's counterparts
of `jax.lax.all_to_all` (tiled), `jax.lax.psum` and `axis_index` +
`dynamic_slice_in_dim`, which the JAX package runs inside `shard_map`.

- `all_to_all(x, group, split_dim, concat_dim)`: x is split into n equal
  chunks along `split_dim`, chunk i goes to the group's rank i, and the
  chunks received are concatenated along `concat_dim` in rank order. Its
  backward is the inverse all_to_all.
- `all_reduce_sum(x, group)`: the sum over the group; its backward is the
  sum of the cotangents over the group (each rank's output feeds only that
  rank's loss).
- `local_slice(x, group, dim)`: this rank's 1/n of `dim` (autograd's
  slicing backward pads with zeros, as JAX's).
- tensor parallelism's conjugate pairs (Megatron-LM's f and g), for a
  value that every rank of the group computes alike (a replicated
  activation, whose cotangent is replicated too):
  `copy_to_group(x, group)`: the identity, its backward the sum of the
  cotangents over the group (each rank's cotangent is its partial sum);
  `reduce_from_group(x, group)`: the sum over the group, its backward the
  identity (the replicated output's cotangent is already whole on every
  rank; `all_reduce_sum`'s backward would multiply it by the group's size);
  `gather_from_group(x, group, dim)`: every rank's x concatenated along
  `dim` (contiguous, as a dense's output), its backward this rank's slice
  of the cotangent;
  `scatter_to_group(x, group, dim)`: this rank's slice, its backward the
  concatenation of every rank's cotangent;
- `all_gather(x, group, dim)`, `reduce_scatter_sum(flat, group)`,
  `all_reduce_sum_(x, group)` (in place): the gradient-free collectives of
  the pipeline and of ZeRO.

Each runs whenever a group is passed, a group of one rank included (on one
card every collective still goes through NCCL); callers pass no group where
the JAX package drops its mesh. `LAUNCHES` counts the calls of each, the
backward passes' included.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

LAUNCHES = {"all_to_all": 0, "all_reduce": 0, "all_gather": 0, "reduce_scatter": 0}

# torch >= 2.12 names the single-tensor forms *_single and deprecates the
# *_tensor ones (a FutureWarning at every call)
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def _all_to_all(x: torch.Tensor, group, split_dim: int, concat_dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(x.shape)} does not split "
                         f"over {n} ranks")
    send = x.unflatten(split_dim, (n, -1)).movedim(split_dim, 0).contiguous()
    recv = torch.empty_like(send)
    LAUNCHES["all_to_all"] += 1
    dist.all_to_all_single(recv, send, group=group)
    # recv[i] is rank i's chunk for this rank: rank-major along concat_dim
    return recv.movedim(0, concat_dim).flatten(concat_dim, concat_dim + 1)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.args = (group, split_dim, concat_dim)
        return _all_to_all(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        group, split_dim, concat_dim = ctx.args
        return _all_to_all(g, group, concat_dim, split_dim), None, None, None


def all_to_all(x: torch.Tensor, group, split_dim: int, concat_dim: int) -> torch.Tensor:
    """`jax.lax.all_to_all(x, axis, split_dim, concat_dim, tiled=True)`."""
    split_dim %= x.ndim
    concat_dim %= x.ndim
    return _AllToAll.apply(x, group, split_dim, concat_dim)


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    LAUNCHES["all_reduce"] += 1
    dist.all_reduce(out, group=group)
    return out


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """`jax.lax.psum(x, axis)`."""
    return _AllReduceSum.apply(x, group)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's f: the identity; the backward sums the cotangents over
    the group."""
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's g: the sum over the group; the backward is the identity."""
    return _ReduceFromGroup.apply(x, group)


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.args = (group, dim)
        return all_gather(x, group, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return local_slice(g, *ctx.args).contiguous(), None, None


class _ScatterToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.args = (group, dim)
        return local_slice(x, group, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, *ctx.args).contiguous(), None, None


def gather_from_group(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's x concatenated along `dim` in rank order; the backward
    is this rank's slice of the cotangent."""
    return _GatherFromGroup.apply(x, group, dim % x.ndim)


def scatter_to_group(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's 1/n of `dim`; the backward concatenates every rank's
    cotangent."""
    return _ScatterToGroup.apply(x, group, dim % x.ndim)


def local_slice(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's 1/n of `dim` (`dynamic_slice_in_dim` at
    `axis_index * size / n`)."""
    n, i = dist.get_world_size(group), dist.get_rank(group)
    if x.shape[dim] % n:
        raise ValueError(f"local_slice: dim {dim} of {tuple(x.shape)} does not split over "
                         f"{n} ranks")
    size = x.shape[dim] // n
    return x.narrow(dim, i * size, size)


@torch.no_grad()
def all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's x concatenated along `dim` in rank order (no gradient)."""
    n = dist.get_world_size(group)
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((n * x.shape[0],) + x.shape[1:])
    LAUNCHES["all_gather"] += 1
    _all_gather(out, x, group=group)
    return out.movedim(0, dim)


@torch.no_grad()
def all_reduce_sum_(x: torch.Tensor, group) -> torch.Tensor:
    """`x` summed over the group in place (no gradient, no copy); returns x."""
    LAUNCHES["all_reduce"] += 1
    dist.all_reduce(x, group=group)
    return x


@torch.no_grad()
def reduce_scatter_sum(flat: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group of the 1-D `flat`, of which this rank keeps its
    1/n (rank order)."""
    n = dist.get_world_size(group)
    out = flat.new_empty(flat.numel() // n)
    LAUNCHES["reduce_scatter"] += 1
    _reduce_scatter(out, flat, group=group)
    return out
