"""Tensor parallelism over the mesh's "model" axis (counterpart of
hallo_tpu/parallel/tp.py).

The plan is JAX's one local rule over every 2-D dense of the trainers'
parameters (`tp_plan`): the `nn.Linear`s and the 1x1 convs that JAX writes
as Dense (`layers.TokenConv1x1`: the spatial stages' proj_in / proj_out and
the audio branches' zero_conv_*). A dense (in -> out) whose `out` is at
least `min_dim` and divisible by n_model is column-parallel: its weight's
rows and its bias are sharded (JAX's kernel P(None, "model"), bias
P("model"); `nn.Linear.weight` is JAX's kernel transposed). Otherwise one
whose `in` is is row-parallel: the weight's columns sharded, the bias
replicated. The larger side wins and a tie goes column
(hallo_tpu/parallel/tp.py:53-55), so a 1280 -> 1280 to_out is
column-parallel.

JAX lets GSPMD write the collectives. Here `shard_modules` swaps each
planned dense for a `ParallelDense` holding this rank's piece, with
`collectives`' conjugate pairs written out:
- column: f (`copy_to_group`), the local matmul with the bias's piece, then
  the output gathered (`gather_from_group`);
- row: the input's slice (`scatter_to_group`), the local matmul, then g
  (`reduce_from_group`). The bias joins each rank's partial sum as
  bias / n, its gradient passed back whole, so that it is rounded once, as
  a plain dense's fused bias, and a group of one rank computes the plain
  dense bit for bit.
Each takes and returns a replicated activation. Where the module structure
lets the activation stay sharded, the pair between two layers is dropped:
- a GEGLU feed-forward (net.0.proj column-parallel): the shard of net.0.proj
  holds the same rows of the value and of the gate halves (rank r: value[r]
  and gate[r], `Shard.parts` 2: a permuted slice of JAX's contiguous shard,
  a divergence of layout, not of math), so the gated activation is this
  rank's columns of net.2's input, which takes it sharded;
- an attention whose to_q, to_k and to_v are all column-parallel over whole
  heads (heads divisible by n_model): K1 or K2 run on this rank's heads
  (pre-projected K/V rows, `extra_kv`, must be given as this rank's heads
  of them: no model of the port passes any), and to_out takes the heads'
  outputs sharded. Where the shard would split a head, the
  projections are gathered and every rank runs every head.
A planned layer whose dimension does not split raises: it is never
replicated instead.

Every rank of the model group computes the same replicated activations,
loss and gradients of the replicated parameters; a sharded parameter's
gradient is its piece's. `train/state.py`'s `Zero` takes the plan for the
gradient norm, the 8-bit AdamW and the checkpoints. Validation renders and
exports run inside `TensorParallel.unsharded()`.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterator, List, Mapping, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from hallo_tpu_torch.models.layers import (
    GEGLU, CrossAttention, FeedForward, TemporalSelfAttention, TokenConv1x1)
from hallo_tpu_torch.parallel.collectives import (
    all_gather, copy_to_group, gather_from_group, reduce_from_group, scatter_to_group)
from hallo_tpu_torch.parallel.mesh import Mesh

# JAX's threshold: the 1280-wide levels, and the feed-forwards' 4x / 8x
# widths at every level
DEFAULT_MIN_DIM = 1280

DENSES = (nn.Linear, TokenConv1x1)


@dataclasses.dataclass(frozen=True)
class Shard:
    """How a parameter splits over the model group: along `dim`, whose
    `parts` equal contiguous parts (the GEGLU's value and gate: 2) are each
    split in n, rank r taking the r-th n-th of every part."""

    dim: int
    parts: int = 1

    def piece(self, whole: torch.Tensor, n: int, r: int) -> torch.Tensor:
        """Rank r's piece of `whole` (a view)."""
        size = whole.shape[self.dim]
        if size % (self.parts * n):
            raise ValueError(f"dim {self.dim} of {tuple(whole.shape)} does not split in "
                             f"{self.parts} x {n}")
        return whole.unflatten(self.dim, (self.parts, n, -1)).select(
            self.dim + 1, r).flatten(self.dim, self.dim + 1)

    def whole(self, pieces: torch.Tensor, n: int) -> torch.Tensor:
        """The whole tensor from every rank's piece concatenated along
        `dim` in rank order."""
        return pieces.unflatten(self.dim, (n, self.parts, -1)).transpose(
            self.dim, self.dim + 1).flatten(self.dim, self.dim + 2)


Plan = Dict[str, Optional[Shard]]


def dense_kind(d_in: int, d_out: int, n_model: int, min_dim: int) -> Optional[str]:
    """"column", "row" or None for an in -> out dense (JAX's `_dense_specs`)."""
    col_ok = d_out >= min_dim and d_out % n_model == 0
    row_ok = d_in >= min_dim and d_in % n_model == 0
    if col_ok and (d_out >= d_in or not row_ok):
        return "column"
    return "row" if row_ok else None


def _dims(dense: nn.Module) -> Tuple[int, int]:
    if isinstance(dense, nn.Linear):
        return dense.in_features, dense.out_features
    return dense.in_channels, dense.out_channels


def _name(top: str, name: str, param: str) -> str:
    return ".".join(p for p in (top, name, param) if p)


def _shards(kind: Optional[str], parts: int) -> Dict[str, Optional[Shard]]:
    if kind == "column":
        return {"weight": Shard(0, parts), "bias": Shard(0, parts)}
    if kind == "row":
        return {"weight": Shard(1), "bias": None}
    return {"weight": None, "bias": None}


def tp_plan(modules: Mapping[str, nn.Module], n_model: int,
            min_dim: Optional[int] = None) -> Plan:
    """Every parameter of `modules` ("module.name", the trainers' keys) with
    its `Shard` under JAX's rule, or None (replicated); `min_dim` is
    `DEFAULT_MIN_DIM` (read at call time) unless given."""
    min_dim = DEFAULT_MIN_DIM if min_dim is None else min_dim
    plan: Plan = {}
    for top, module in modules.items():
        gated = {id(m.proj) for m in module.modules() if isinstance(m, GEGLU)}
        for name, sub in module.named_modules():
            kind = dense_kind(*_dims(sub), n_model, min_dim) if isinstance(sub, DENSES) \
                else None
            shards = _shards(kind, 2 if id(sub) in gated else 1)
            for param, _ in sub.named_parameters(recurse=False):
                plan[_name(top, name, param)] = shards.get(param)
    return plan


def count_sharded(plan: Plan) -> int:
    """Parameters the plan shards (diagnostics and tests)."""
    return sum(s is not None for s in plan.values())


class _SplitBias(torch.autograd.Function):
    """bias / n forward, the identity backward: each of n ranks adds 1/n of
    the bias to its partial sum, and each rank's gradient is the bias's."""

    @staticmethod
    def forward(ctx, bias, n):
        return bias / n

    @staticmethod
    def backward(ctx, g):
        return g, None


class ParallelDense(nn.Module):
    """A dense of the plan on this rank: `kind` "column" or "row" holds its
    piece of the weight and bias (a `TokenConv1x1`'s weight keeps its 1x1
    axes, so that every parameter is a piece of the plain one's), None the
    whole plain layer's parameters (a replicated dense whose input arrives
    sharded). `sharded_in` / `sharded_out`: the input arrives as this rank's
    columns / the output leaves as them (the fused pairs)."""

    def __init__(self, plain: nn.Module, kind: Optional[str], group, n: int, r: int,
                 parts: int = 1):
        super().__init__()
        self.kind, self.group, self.n = kind, group, n
        self.shards = _shards(kind, parts)
        self.sharded_in = self.sharded_out = False
        for key, shard in self.shards.items():
            p = getattr(plain, key)
            if p is not None and kind is not None:
                piece = p.detach() if shard is None else shard.piece(p.detach(), n, r)
                p = nn.Parameter(piece.clone(memory_format=torch.contiguous_format),
                                 requires_grad=p.requires_grad)
            self.register_parameter(key, p)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, g = self.weight.flatten(1), self.group
        if self.kind == "row":
            if not self.sharded_in:
                x = scatter_to_group(x, g, -1)
            b = None if self.bias is None else _SplitBias.apply(self.bias, self.n)
            return reduce_from_group(F.linear(x, w, b), g)
        if self.sharded_in:
            x = gather_from_group(x, g, -1)
        if self.kind is None:
            return F.linear(x, w, self.bias)
        y = F.linear(copy_to_group(x, g), w, self.bias)
        return y if self.sharded_out else gather_from_group(y, g, -1)


@dataclasses.dataclass
class _Swap:
    parent: nn.Module
    key: str
    plain: nn.Module
    parallel: ParallelDense


@dataclasses.dataclass
class TensorParallel:
    """The sharded modules' record (`shard_modules`): the plan, the model
    group, each swapped layer with its plain original (parameters on the
    meta device) and each attention split by heads."""

    plan: Plan
    mesh: Mesh
    swaps: List[_Swap]
    split_heads: List[Tuple[nn.Module, int]]  # (attention, its whole head count)

    def unshard(self) -> None:
        """The modules with their plain layers back, holding the whole
        weights gathered over the model group (a collective: every rank of
        it enters)."""
        group, n = self.mesh.model_group, self.mesh.n_model
        for s in self.swaps:
            if s.parallel.kind is not None:
                s.plain.to_empty(device=s.parallel.weight.device)
                with torch.no_grad():
                    for key, shard in s.parallel.shards.items():
                        p = getattr(s.parallel, key)
                        if p is not None:
                            whole = p if shard is None else shard.whole(
                                all_gather(p.detach(), group, shard.dim), n)
                            getattr(s.plain, key).copy_(whole)
            s.parent._modules[s.key] = s.plain
        for attn, heads in self.split_heads:
            attn.heads = heads

    @contextlib.contextmanager
    def unsharded(self) -> Iterator[None]:
        """`unshard` for validation renders and exports; the parallel
        layers come back on exit."""
        self.unshard()
        try:
            yield
        finally:
            for s in self.swaps:
                s.parent._modules[s.key] = s.parallel
                if s.parallel.kind is not None:
                    s.plain.to("meta")
            for attn, heads in self.split_heads:
                attn.heads = heads // self.mesh.n_model


def _parallel(tp: TensorParallel, parent: nn.Module, key: str) -> ParallelDense:
    """The ParallelDense at parent.key, made from the plain dense there if
    the plan replicates it (its parameters as they are)."""
    layer = parent._modules[key]
    if not isinstance(layer, ParallelDense):
        layer = ParallelDense(layer, None, tp.mesh.model_group, tp.mesh.n_model,
                              tp.mesh.model_index)
        tp.swaps.append(_Swap(parent, key, parent._modules[key], layer))
        parent._modules[key] = layer
    return layer


def shard_modules(modules: Mapping[str, nn.Module], plan: Plan, mesh: Mesh) -> TensorParallel:
    """Swap, in place, every dense that `plan` shards for a `ParallelDense`
    holding this rank's piece (the plain layer's parameters move to the meta
    device), then fuse the GEGLU pairs and the attentions over whole heads
    (module docstring). Parameter names stay the plain ones, so the
    trainers' keys and `plan` name the pieces. Returns the record that
    `TensorParallel.unsharded` undoes."""
    n, r, group = mesh.n_model, mesh.model_index, mesh.model_group
    tp = TensorParallel(plan, mesh, [], [])
    for top, module in modules.items():
        for name, sub in list(module.named_modules()):
            shard = plan.get(_name(top, name, "weight")) if isinstance(sub, DENSES) else None
            if shard is None:
                continue
            if not name:
                raise ValueError(f"{top} is itself a dense: shard the module that holds it")
            parent_name, _, key = name.rpartition(".")
            parent = module.get_submodule(parent_name)
            layer = ParallelDense(sub, "column" if shard.dim == 0 else "row", group, n, r,
                                  shard.parts)
            tp.swaps.append(_Swap(parent, key, sub, layer))
            parent._modules[key] = layer
            sub.to("meta")
        for sub in module.modules():
            if isinstance(sub, FeedForward) and isinstance(sub.net[0], GEGLU):
                proj = sub.net[0].proj
                if isinstance(proj, ParallelDense) and proj.kind == "column":
                    proj.sharded_out = True  # value[r] * gelu(gate[r]): net.2's columns
                    _parallel(tp, sub.net, "2").sharded_in = True
            elif isinstance(sub, (CrossAttention, TemporalSelfAttention)):
                qkv = (sub.to_q, sub.to_k, sub.to_v)
                if sub.heads % n == 0 and all(isinstance(p, ParallelDense) and p.kind == "column"
                                              for p in qkv):
                    for p in qkv:
                        p.sharded_out = True
                    tp.split_heads.append((sub, sub.heads))
                    sub.heads //= n
                    _parallel(tp, sub.to_out, "0").sharded_in = True
    return tp
