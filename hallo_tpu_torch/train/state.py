"""Train state and optimizer over the trainable parameter subset
(counterpart of hallo_tpu/train/state.py).

The JAX package freezes by labels (`optax.multi_transform` with
`set_to_zero` on the frozen leaves) and steps
`optax.chain(clip_by_global_norm, adamw)`, wrapped in `optax.MultiSteps`
for gradient accumulation. The port keeps the reference's `requires_grad`
semantics instead: only the trainable parameters get gradients, and `AdamW`
steps fp32 master copies of those alone with optax's arithmetic:

- the clip scales by max_norm / norm (no epsilon) when norm >= max_norm;
- Adam's moments and bias corrections, eps outside the square root;
- decoupled weight decay on the trainable leaves;
- the learning rate of `optax.linear_schedule(0, lr, warmup)` at the
  update's count, so the first update of a warm-up moves no weight (but
  does update the moments);
- with k > 1 accumulation steps, the running mean of k micro-batch
  gradients is applied every k-th call (`MultiSteps`' `use_grad_mean`).

The masters, moments and accumulator are updated in place. With
`use_8bit_adam` the moments are stored as int8 blocks (`train/adam8bit.py`,
`make_optimizer`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Mapping, Optional, Sequence

import torch

from hallo_tpu_torch.parallel import collectives
from hallo_tpu_torch.parallel.mesh import Mesh, ZeroPlan, zero_plan
from hallo_tpu_torch.parallel.tp import Plan
from hallo_tpu_torch.utils import profiling


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    learning_rate: float = 1e-5
    weight_decay: float = 1e-2
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    max_grad_norm: float = 1.0
    # reference solver knobs (configs/train/stage2.yaml:23-37)
    lr_warmup_steps: int = 0
    gradient_accumulation_steps: int = 1
    # bnb.optim.AdamW8bit's counterpart (train_stage2.py:613-622): int8
    # block-quantised moments (train/adam8bit.py)
    use_8bit_adam: bool = False


def stage1_trainable(top_key: str, name: str) -> bool:
    """Stage 1 trains the ReferenceNet, the denoiser (2D), the face locator
    and the image projection (train_stage1.py:372-394); the VAE and the
    audio projection stay frozen."""
    return top_key in ("reference_net", "denoising_net", "face_locator", "image_proj")


def stage2_trainable(top_key: str, name: str) -> bool:
    """Stage 2 trains the motion and audio modules inside the denoiser, plus
    the audio projection (stage2.yaml:84-86, train_stage2.py:553-560). `name`
    is the parameter's name within module `top_key`; the port's names carry
    the reference keys, so JAX's substring rule selects the same leaves."""
    if top_key == "audio_proj":
        return True
    if top_key != "denoising_net":
        return False
    return any("motion_modules" in p or "audio_modules" in p for p in name.split("."))


def unfreeze(modules: Mapping[str, torch.nn.Module],
             trainable_fn: Callable[[str, str], bool]) -> Dict[str, torch.nn.Parameter]:
    """Set requires_grad on the parameters `trainable_fn` selects (the others
    stay frozen) and return them keyed "module.name"."""
    out = {}
    for top, module in modules.items():
        for name, p in module.named_parameters():
            train = trainable_fn(top, name)
            p.requires_grad_(train)
            if train:
                out[f"{top}.{name}"] = p
    return out


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over every element, in fp32
    (`optax.global_norm`): each tensor's norm, then the norm of those."""
    norms = torch._foreach_norm(list(tensors), 2, dtype=torch.float32)
    return torch.linalg.vector_norm(torch.stack(norms))


class AdamW:
    """`optax.MultiSteps(chain(clip_by_global_norm, adamw))` over the
    trainable leaves; see the module docstring."""

    # whether a leaf's update depends on the whole leaf beyond each element
    # (the 8-bit AdamW's blocks): `Zero` then steps a tensor-parallel leaf
    # whole, where AdamW steps each rank's piece
    needs_whole_leaves = False

    def __init__(self, cfg: OptimizerConfig):
        self.cfg = cfg

    def learning_rate(self, count: int) -> float:
        """optax.linear_schedule(0, lr, warmup) at `count` (lr without warm-up)."""
        lr, warmup = self.cfg.learning_rate, self.cfg.lr_warmup_steps
        if warmup <= 0:
            return lr
        frac = 1.0 - min(max(count, 0), warmup) / warmup
        return (0.0 - lr) * frac + lr

    def init(self, params: Mapping[str, torch.Tensor],
             sizes: Optional[Mapping[str, int]] = None) -> Dict[str, Any]:
        """The state of `params`. `sizes`: the element count of the leaf
        each tensor is a piece of (a ZeRO shard's); AdamW's state does not
        depend on it."""
        state: Dict[str, Any] = dict(
            count=0,
            mu={k: torch.zeros_like(p) for k, p in params.items()},
            nu={k: torch.zeros_like(p) for k, p in params.items()},
        )
        if self.cfg.gradient_accumulation_steps > 1:
            state.update(mini_step=0, gradient_step=0,
                         acc={k: torch.zeros_like(p) for k, p in params.items()})
        return state

    def update(self, grads: Mapping[str, torch.Tensor], state: Dict[str, Any],
               params: Dict[str, torch.Tensor],
               norm_fn: Callable[[Sequence[torch.Tensor]], torch.Tensor] = global_norm) -> None:
        """Step the fp32 `params` in place with `grads` (any float dtype,
        upcast per tensor). Each operation runs over every tensor at once
        (`torch._foreach_*`). `norm_fn`: the global norm of the (accumulated)
        gradients, in the order of `params`, for the clip (`Zero.norm` over a
        shard's pieces); the host waits for it (`profiling.wait`
        "grad_norm")."""
        cfg = self.cfg
        k = cfg.gradient_accumulation_steps
        names = list(params)
        gs = [grads[name].float() for name in names]
        if k > 1:
            n = state["mini_step"]
            accs = [state["acc"][name] for name in names]
            delta = torch._foreach_sub(gs, accs)
            torch._foreach_div_(delta, n + 1)
            torch._foreach_add_(accs, delta)
            if n < k - 1:
                state["mini_step"] = n + 1
                return
            gs = accs
        with profiling.wait("grad_norm"):
            norm = float(norm_fn(gs))
        if not norm < cfg.max_grad_norm:
            gs = torch._foreach_div(gs, norm)
            torch._foreach_mul_(gs, cfg.max_grad_norm)
        count = state["count"]
        self.adam(dict(zip(names, gs)), state, params, count + 1, self.learning_rate(count))
        state["count"] = count + 1
        if k > 1:
            for acc in state["acc"].values():
                acc.zero_()
            state["mini_step"] = 0
            state["gradient_step"] += 1

    def adam(self, gs: Mapping[str, torch.Tensor], state: Dict[str, Any],
             params: Dict[str, torch.Tensor], count: int, lr: float) -> None:
        """Adam's moments, bias corrections at `count`, weight decay and the
        step of `lr`, over the fp32 gradients `gs` (one per name of
        `params`)."""
        cfg = self.cfg
        names = list(gs)
        c1 = 1.0 - cfg.beta1 ** count
        c2 = 1.0 - cfg.beta2 ** count
        g = [gs[name] for name in names]
        ps = [params[name] for name in names]
        mus = [state["mu"][name] for name in names]
        nus = [state["nu"][name] for name in names]
        torch._foreach_mul_(mus, cfg.beta1)
        torch._foreach_add_(mus, g, alpha=1.0 - cfg.beta1)
        torch._foreach_mul_(nus, cfg.beta2)
        torch._foreach_addcmul_(nus, g, g, value=1.0 - cfg.beta2)
        den = torch._foreach_div(nus, c2)  # sqrt(nu / c2) + eps
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, cfg.eps)
        u = torch._foreach_div(mus, c1)
        torch._foreach_div_(u, den)
        del den
        torch._foreach_add_(u, ps, alpha=cfg.weight_decay)
        torch._foreach_mul_(u, -lr)
        torch._foreach_add_(ps, u)


def make_optimizer(cfg: OptimizerConfig) -> AdamW:
    """`AdamW`, or with `cfg.use_8bit_adam` its int8-moment form
    (`adam8bit.AdamW8bit`; JAX's `make_optimizer`)."""
    if cfg.use_8bit_adam:
        from hallo_tpu_torch.train.adam8bit import AdamW8bit

        return AdamW8bit(cfg)
    return AdamW(cfg)


@dataclasses.dataclass
class TrainState:
    """step: the number of train steps taken (skipped ones included, as in
    JAX); params: fp32 master copies of the trainable parameters, keyed
    "module.name"; opt_state: `AdamW`'s state."""

    step: int
    params: Dict[str, torch.Tensor]
    opt_state: Dict[str, Any]

    @classmethod
    def create(cls, trainable: Mapping[str, torch.nn.Parameter], opt: AdamW) -> "TrainState":
        params = {k: p.detach().float().clone() for k, p in trainable.items()}
        return cls(step=0, params=params, opt_state=opt.init(params))

    def write_to(self, trainable: Mapping[str, torch.nn.Parameter]) -> None:
        """Copy the masters into the model's parameters (in their dtype)."""
        with torch.no_grad():
            torch._foreach_copy_(list(trainable.values()),
                                 [self.params[name] for name in trainable])

    def state_dict(self) -> Dict[str, Any]:
        return dict(step=self.step, params=self.params, opt_state=self.opt_state)

    @classmethod
    def from_state_dict(cls, sd: Mapping[str, Any]) -> "TrainState":
        return cls(step=int(sd["step"]), params=dict(sd["params"]),
                   opt_state=dict(sd["opt_state"]))


# ZeRO-2 (the reference's DeepSpeed zero_stage: 2, accelerate_config.yaml;
# JAX's zero_shard_tree, hallo_tpu/parallel/mesh.py:115-138)

ZERO_BLOCK = 256  # the 8-bit AdamW's block (adam8bit.BLOCK): shards of whole blocks


@dataclasses.dataclass
class ShardedTrainState(TrainState):
    """A `TrainState` of which this rank holds one ZeRO shard: `params` are
    views of `flat` (this rank's fp32 masters) keyed by piece (`Piece.key`),
    `opt_state` the optimizer's state over those pieces. `write_to`
    all-gathers the parameters into the model and `state_dict` gathers the
    single-card format on every rank (collectives: every rank of the data
    group calls them)."""

    zero: Optional["Zero"] = None
    flat: Optional[torch.Tensor] = None

    def write_to(self, trainable: Mapping[str, torch.nn.Parameter]) -> None:
        self.zero.write_params(self.flat, trainable)

    def state_dict(self) -> Dict[str, Any]:
        return self.zero.gathered_state_dict(self)


class Zero:
    """ZeRO-2 over the mesh's data group: the gradients are reduce-scattered
    into flat per-rank shards (`zero_plan`: whole blocks of `ZERO_BLOCK`
    elements), each rank keeps and steps only its shard of the fp32 masters
    and of the optimizer's moments (the 8-bit AdamW's codes and scales
    included), and the parameters are all-gathered after the update in the
    model's dtype. With `shard=False` (parallel.yaml's
    `zero_optimizer_sharding: false`) every rank holds everything and the
    gradients are all-reduced.

    The gradient of the step is the mean over every rank of the mesh of the
    gradients of its local loss (the mean over its samples and frames): the
    sum over the seq ranks of a clip's frames, averaged over the data ranks
    and the seq ranks, is the gradient of JAX's pmean'd global loss
    (hallo_tpu/train/step.py:258-296). Gradient accumulation accumulates
    shards.

    Tensor parallelism (`tp`: the plan of `parallel/tp.py`, whose sharded
    leaves `trainable` holds as this rank's pieces): the data group is the
    ranks with this rank's seq and model indices, so each rank partitions
    its own pieces. A piece's gradient is never reduced over the model
    group (replicated leaves' gradients agree there already); the gradient
    norm sums a piece's squares over the model group and counts a
    replicated leaf once. The 8-bit AdamW (`needs_whole_leaves`) steps
    blocks of the whole leaf, so there a sharded leaf is all-gathered over
    the model group (its parameters at `create`, its gradient at each
    `reduce`) and stepped whole on every model rank, each writing its piece
    back: its masters, moments and flat gradient are not divided by
    n_model, only by n_data (with AdamW they are divided by both). The
    checkpoints hold whole leaves, gathered over the data and then the model
    group."""

    def __init__(self, mesh: Mesh, trainable: Mapping[str, torch.nn.Parameter], opt: AdamW,
                 shard: bool = True, tp: Optional[Plan] = None):
        self.mesh, self.opt = mesh, opt
        self.group = mesh.data_group
        # the trainable leaves sharded over the model group: stepped whole
        # (gathered) or as pieces (split)
        sharded = {k: tp[k] for k in trainable if tp and tp.get(k) is not None}
        self.whole = sharded if opt.needs_whole_leaves else {}
        self.split = {} if opt.needs_whole_leaves else sharded
        n = mesh.n_data if shard else 1
        self.plan: ZeroPlan = zero_plan(
            {k: self._whole_shape(k, p.shape) for k, p in trainable.items()}, n, ZERO_BLOCK)
        self.pieces = self.plan.pieces(mesh.data_index if shard else 0)
        if not self.pieces:
            raise ValueError(f"ZeRO over {n} ranks: shards of {self.plan.shard_rows} blocks "
                             f"leave rank {mesh.data_index}'s empty (too few parameters)")
        self.leaf_index = {name: i for i, name in enumerate(self.plan.names)}
        self.split_mask = None
        if self.split:
            self.split_mask = torch.tensor([float(k in self.split) for k in self.plan.names],
                                           device=next(iter(trainable.values())).device)
        dtypes = {p.dtype for p in trainable.values()}
        if len(dtypes) != 1:
            raise ValueError(f"ZeRO needs one parameter dtype, got {dtypes}")
        self.dtype = dtypes.pop()
        self.device = next(iter(trainable.values())).device
        self.sizes = {p.key: math.prod(self.plan.shapes[self.leaf_index[p.name]])
                      for p in self.pieces}

    def _whole_shape(self, name: str, shape) -> tuple:
        shape = list(shape)
        if name in self.whole:
            shape[self.whole[name].dim] *= self.mesh.n_model
        return tuple(shape)

    def _model_gather(self, shards: Mapping[str, Any],
                      tensors: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """`tensors` with each one that `shards` names gathered whole over the
        model group (a collective, in the order of `tensors`)."""
        out = dict(tensors)
        for name, t in tensors.items():
            if name in shards:
                shard = shards[name]
                out[name] = shard.whole(collectives.all_gather(
                    t, self.mesh.model_group, shard.dim), self.mesh.n_model)
        return out

    def _model_piece(self, shards: Mapping[str, Any], name: str,
                     whole: torch.Tensor) -> torch.Tensor:
        """This rank's piece of a whole leaf that `shards` names, else the leaf."""
        if name not in shards:
            return whole
        return shards[name].piece(whole, self.mesh.n_model, self.mesh.model_index)

    def _views(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {p.key: flat[p.offset:p.offset + p.stop - p.start] for p in self.pieces}

    def _leaf_views(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        out = {}
        for i, name in enumerate(self.plan.names):
            a, b = self.plan.leaf_range(i)
            out[name] = flat[a:b].view(self.plan.shapes[i])
        return out

    def _gather(self, flat: torch.Tensor) -> torch.Tensor:
        if self.plan.n_shards == 1:
            return flat
        return collectives.all_gather(flat, self.group, dim=0)

    def create(self, trainable: Mapping[str, torch.nn.Parameter]) -> ShardedTrainState:
        """The state at step 0: this rank's shard of the model's parameters."""
        flat = torch.zeros(self.plan.shard_numel, device=self.device)
        params = self._views(flat)
        with torch.no_grad():
            leaves = self._model_gather(self.whole, {k: p.detach() for k, p in trainable.items()})
            for p in self.pieces:
                params[p.key].copy_(leaves[p.name].reshape(-1)[p.start:p.stop])
        return ShardedTrainState(0, params, self.opt.init(params, self.sizes), self, flat)

    def reduce(self, grads: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The step's gradient (`grads`: this rank's, of its local loss),
        averaged over the mesh (see the class docstring): this rank's shard,
        fp32, keyed by piece."""
        full = torch.zeros(self.plan.numel, device=self.device)
        views = self._leaf_views(full)
        grads = self._model_gather(self.whole, grads)
        torch._foreach_copy_([views[k] for k in self.plan.names],
                             [grads[k] for k in self.plan.names])
        n_data, n_seq = self.mesh.n_data, self.mesh.n_seq
        if self.plan.n_shards > 1:
            shard = collectives.reduce_scatter_sum(full, self.group)
        else:
            shard = collectives.all_reduce_sum_(full, self.group)
        if n_seq > 1:
            collectives.all_reduce_sum_(shard, self.mesh.seq_group)
        if n_data * n_seq > 1:
            shard.div_(n_data * n_seq)
        return self._views(shard)

    def norm(self, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        """The global norm of a gradient given as this shard's pieces (in
        piece order): each leaf's norm from its pieces' squared norms summed
        over the shards, then the norm of those. A leaf held whole gives its
        own norm bit for bit (sqrt(x * x) = x in binary floating point); with
        one shard and no tensor-parallel piece this is `global_norm`. A
        piece's squares are summed over the model group too; a replicated
        or whole leaf, the same on every model rank, is counted once."""
        if self.plan.n_shards == 1 and not self.split:
            return global_norm(tensors)
        norms = torch._foreach_norm(list(tensors), 2, dtype=torch.float32)
        sq = torch.zeros(len(self.plan.names), device=self.device)
        idx = torch.tensor([self.leaf_index[p.name] for p in self.pieces], device=self.device)
        sq.index_put_((idx,), torch.stack(norms).square())
        if self.plan.n_shards > 1:
            collectives.all_reduce_sum_(sq, self.group)
        if self.split:
            pieces = collectives.all_reduce_sum_(sq * self.split_mask, self.mesh.model_group)
            sq = torch.where(self.split_mask > 0, pieces, sq)
        return torch.linalg.vector_norm(sq.sqrt())

    def update(self, state: ShardedTrainState, shard_grads: Mapping[str, torch.Tensor]) -> None:
        """Step this rank's masters and moments with its gradient shard."""
        self.opt.update(shard_grads, state.opt_state, state.params, norm_fn=self.norm)

    @torch.no_grad()
    def write_params(self, flat: torch.Tensor,
                     trainable: Mapping[str, torch.nn.Parameter]) -> None:
        """All-gather the masters in the parameters' dtype into the model."""
        full = self._gather(flat.to(self.dtype))
        views = self._leaf_views(full)
        torch._foreach_copy_([trainable[k] for k in self.plan.names],
                             [self._model_piece(self.whole, k, views[k]) for k in self.plan.names])

    def gather_leaves(self, pieces: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Whole leaves from every rank's pieces of them, gathered over the
        data group and, for a tensor-parallel piece, the model group (a dict
        that holds a subset of the leaves, as the 8-bit AdamW's fp32
        moments, gives that subset)."""
        dtype = next(iter(pieces.values())).dtype if pieces else torch.float32
        flat = torch.zeros(self.plan.shard_numel, dtype=dtype, device=self.device)
        present = torch.zeros(len(self.plan.names), device=self.device)
        for p in self.pieces:
            if p.key in pieces:
                flat[p.offset:p.offset + p.stop - p.start] = pieces[p.key].reshape(-1)
                present[self.leaf_index[p.name]] = 1.0
        if self.plan.n_shards > 1:
            collectives.all_reduce_sum_(present, self.group)
        views = self._leaf_views(self._gather(flat))
        return self._model_gather(self.split, {
            name: views[name].clone() for i, name in enumerate(self.plan.names)
            if present[i] > 0})

    def gathered_state_dict(self, state: ShardedTrainState) -> Dict[str, Any]:
        """`TrainState.state_dict()` of the whole state, on every rank."""
        opt_state: Dict[str, Any] = {}
        for key, value in state.opt_state.items():
            if key == "q8":
                from hallo_tpu_torch.train import adam8bit

                leaves = {k: torch.empty(s, device=self.device)
                          for k, s in zip(self.plan.names, self.plan.shapes)}
                opt_state[key] = self.opt.init(leaves)["q8"]
                adam8bit.gather_q8(value, self.plan, self.pieces,
                                   lambda x: self._gather(x), opt_state[key])
            elif isinstance(value, dict):
                opt_state[key] = self.gather_leaves(value)
            else:
                opt_state[key] = value
        return dict(step=state.step, params=self.gather_leaves(state.params),
                    opt_state=opt_state)

    @torch.no_grad()
    def shard_state(self, full: TrainState) -> ShardedTrainState:
        """This rank's shard of a whole (single-card format) state, e.g. a
        checkpoint written at another world size."""
        flat = torch.zeros(self.plan.shard_numel, device=self.device)
        params = self._views(flat)

        def mine(p, leaves):
            """Piece p of this rank's part of a whole leaf."""
            return self._model_piece(self.split, p.name, leaves[p.name]).reshape(-1)[
                p.start:p.stop]

        for p in self.pieces:
            params[p.key].copy_(mine(p, full.params))
        opt_state = self.opt.init(params, self.sizes)
        for key, value in full.opt_state.items():
            if key == "q8":
                from hallo_tpu_torch.train import adam8bit

                adam8bit.shard_q8(value, self.pieces, opt_state[key])
            elif isinstance(value, dict):
                for p in self.pieces:
                    if p.name in value:
                        opt_state[key][p.key].copy_(mine(p, value))
            else:
                opt_state[key] = value
        return ShardedTrainState(full.step, params, opt_state, self, flat)
