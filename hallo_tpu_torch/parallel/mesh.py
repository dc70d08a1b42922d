"""The ("data", "seq", "model") mesh over `torch.distributed` process
groups, the settings of configs/parallel.yaml and the ZeRO partition plan
(counterpart of hallo_tpu/parallel/mesh.py).

The reference trains with data parallelism and ZeRO-2 on 8 GPUs
(accelerate_config.yaml); the JAX package adds clip parallelism, the
16-frame window sharded over a "seq" axis, and tensor parallelism over a
"model" axis (`parallel/tp.py`). Here each rank is one process with one
card (NCCL) or one CPU process (gloo), started by torchrun:
`maybe_initialize_distributed` joins the default group from torchrun's
environment, `make_mesh` / `mesh_from_config` split the world into data,
seq and model groups (rank = (data index x n_seq + seq index) x n_model +
model index: model is the innermost axis, then seq, as in JAX), and
`zero_plan` lays the trainable parameters out in per-rank shards of whole
blocks.

Divergences from the JAX package, each on purpose:
- the mesh must cover the world exactly (JAX takes the first devices of a
  larger set): a world size that does not match raises;
- there is no fallback: a backend that fails to initialise raises, and
  nothing quietly runs single-process.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os
from typing import List, Mapping, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from hallo_tpu_torch.config import load_yaml

# a collective that waits longer than this raises (NCCL's watchdog, gloo's
# timeout) instead of hanging the run
PROCESS_GROUP_TIMEOUT_S = 600


def torchrun_env() -> bool:
    """Whether this process was started by torchrun (or another launcher
    that sets RANK, WORLD_SIZE and LOCAL_RANK)."""
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"))


def rank_device(device) -> torch.device:
    """The card of this rank, cuda:LOCAL_RANK, for a CUDA `device`; a CPU
    device as it is."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", device.index or 0)))


def maybe_initialize_distributed(device="cuda") -> bool:
    """Join the default process group from torchrun's environment (`env://`):
    NCCL for a CUDA `device` (this rank's card, `rank_device`, becomes the
    current one), gloo for the CPU. Returns True when a group exists
    afterwards (one made earlier counts), False when the process was not
    started by torchrun: then nothing is initialised. A backend that fails
    raises."""
    if dist.is_initialized():
        return True
    if not torchrun_env():
        return False
    device = rank_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo", init_method="env://",
                            timeout=datetime.timedelta(seconds=PROCESS_GROUP_TIMEOUT_S))
    return True


def mesh_shape(n_data: Optional[int], n_model: int, n_seq: int,
               world: int) -> Tuple[int, int, int]:
    """(n_data, n_seq, n_model) of a mesh over `world` ranks (hallo_tpu
    make_mesh's rules: n_data None takes the ranks that remain). Raises for
    a mesh that does not cover the world exactly."""
    if n_data is None:
        if world % (n_seq * n_model):
            raise ValueError(f"seq={n_seq} x model={n_model} does not divide the world size "
                             f"{world}")
        n_data = world // (n_seq * n_model)
    if n_data * n_seq * n_model != world:
        raise ValueError(f"mesh data={n_data} x seq={n_seq} x model={n_model} does not match "
                         f"the world size {world} (torchrun --nproc_per_node)")
    return n_data, n_seq, n_model


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the (data, seq, model) grid and its three
    groups: the ranks with its seq and model indices (`data_group`, over
    which gradients are reduce-scattered and the batch is split), those with
    its data and model indices (`seq_group`, over which a clip's frames are
    split) and those with its data and seq indices (`model_group`, over
    which the wide denses are sharded: `parallel/tp.py`)."""

    n_data: int
    n_seq: int
    n_model: int
    rank: int
    data_group: dist.ProcessGroup
    seq_group: dist.ProcessGroup
    model_group: dist.ProcessGroup

    @property
    def shape(self) -> dict:
        return {"data": self.n_data, "seq": self.n_seq, "model": self.n_model}

    @property
    def data_index(self) -> int:
        return self.rank // (self.n_seq * self.n_model)

    @property
    def seq_index(self) -> int:
        return self.rank // self.n_model % self.n_seq

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model

    def group(self, axis: str) -> dist.ProcessGroup:
        return {"data": self.data_group, "seq": self.seq_group,
                "model": self.model_group}[axis]


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, n_seq: int = 1) -> Mesh:
    """The (data, seq, model) mesh over the initialised world (see
    `mesh_shape`). Every rank creates every group, in the same order."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(maybe_initialize_distributed under torchrun)")
    world, rank = dist.get_world_size(), dist.get_rank()
    shape = n_data, n_seq, n_model = mesh_shape(n_data, n_model, n_seq, world)
    grid = torch.arange(world).reshape(shape)  # rank = (d x n_seq + s) x n_model + m
    groups = {}
    for axis, name in enumerate(("data", "seq", "model")):
        # the ranks that differ in this axis alone, each set in turn
        for ranks in grid.movedim(axis, -1).reshape(-1, shape[axis]).tolist():
            group = dist.new_group(ranks)
            if rank in ranks:
                groups[name] = group
    return Mesh(n_data, n_seq, n_model, rank, groups["data"], groups["seq"], groups["model"])


def mesh_spec(path: Optional[str] = None) -> Tuple[Optional[int], int, int]:
    """(n_data or None, n_model, n_seq) of configs/parallel.yaml's `mesh:`
    (hallo_tpu mesh_from_config's rules: -1 or 0 data takes the ranks that
    remain; seq and model at least 1). A path that does not exist raises:
    a typo must not disable clip parallelism."""
    spec = {"data": -1, "seq": 1, "model": 1}
    if path and not os.path.exists(path):
        raise FileNotFoundError(f"parallel config not found: {path!r} (pass path=None for "
                                "the default pure-DP mesh)")
    if path:
        mesh_cfg = load_yaml(path).get("mesh") or {}
        for axis in spec:
            if axis in mesh_cfg:
                spec[axis] = int(mesh_cfg[axis])
    n_data = None if spec["data"] in (-1, 0) else spec["data"]
    return n_data, max(1, spec["model"]), max(1, spec["seq"])


def mesh_from_config(path: Optional[str] = None) -> Mesh:
    """The mesh of configs/parallel.yaml (`mesh_spec`) over the initialised
    world."""
    n_data, n_model, n_seq = mesh_spec(path)
    return make_mesh(n_data, n_model, n_seq)


def parallel_settings(path: Optional[str] = None) -> dict:
    """The other keys of configs/parallel.yaml, with JAX's defaults:
    `mixed_precision` ("no" | "bf16" | "fp16"; fp16 maps to bf16) and
    `zero_optimizer_sharding` (the reference's zero_stage: 2)."""
    out = {"mixed_precision": "no", "zero_optimizer_sharding": True}
    if path and not os.path.exists(path):
        raise FileNotFoundError(f"parallel config not found: {path!r}")
    if path:
        cfg = load_yaml(path)
        for key in out:
            if key in cfg:
                out[key] = cfg[key]
    out["mixed_precision"] = str(out["mixed_precision"]).lower()
    out["zero_optimizer_sharding"] = bool(out["zero_optimizer_sharding"])
    return out


class Piece(NamedTuple):
    """Elements [start, stop) of leaf `name`'s flattened tensor, at element
    `offset` of a shard; `whole`: the piece is the whole leaf."""

    name: str
    start: int
    stop: int
    offset: int
    whole: bool

    @property
    def key(self) -> str:
        """The piece's name in a shard's tensor dicts: the leaf's own for a
        whole leaf."""
        return self.name if self.whole else f"{self.name}@{self.start}"


@dataclasses.dataclass(frozen=True)
class ZeroPlan:
    """The ZeRO partition of a set of leaves (counterpart of
    `zero_shard_tree`): the leaves, in order, each starting on a block
    boundary and padded to whole blocks, fill `rows` rows of `block`
    elements, padded to `n_shards` equal shards of `shard_rows` rows. Shard
    k holds rows [k * shard_rows, (k + 1) * shard_rows): every shard is made
    of whole blocks, so a block-wise quantisation of a shard's pieces
    (the 8-bit AdamW) gives the codes of the unsharded leaves. JAX shards
    each leaf along its largest divisible axis instead; a flat layout is
    what `reduce_scatter` takes."""

    names: Tuple[str, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    first_rows: Tuple[int, ...]
    block: int
    n_shards: int
    shard_rows: int

    @property
    def shard_numel(self) -> int:
        return self.shard_rows * self.block

    @property
    def numel(self) -> int:
        return self.n_shards * self.shard_numel

    def leaf_range(self, i: int) -> Tuple[int, int]:
        """Flat element range of leaf i."""
        start = self.first_rows[i] * self.block
        return start, start + math.prod(self.shapes[i])

    def pieces(self, shard: int) -> List[Piece]:
        """The leaf pieces of shard `shard`, in order."""
        lo, hi = shard * self.shard_numel, (shard + 1) * self.shard_numel
        out = []
        for i, name in enumerate(self.names):
            a, b = self.leaf_range(i)
            s, e = max(a, lo), min(b, hi)
            if s < e:
                out.append(Piece(name, s - a, e - a, s - lo, s == a and e == b))
        return out


def zero_plan(shapes: Mapping[str, Sequence[int]], n_shards: int, block: int) -> ZeroPlan:
    """The `ZeroPlan` of the leaves `shapes` (name -> shape, in order) over
    `n_shards` shards of whole `block`-element blocks."""
    first, rows = [], 0
    for shape in shapes.values():
        first.append(rows)
        rows += -(-math.prod(shape) // block)
    return ZeroPlan(tuple(shapes), tuple(tuple(int(s) for s in v) for v in shapes.values()),
                    tuple(first), block, n_shards, max(1, -(-rows // n_shards)))
