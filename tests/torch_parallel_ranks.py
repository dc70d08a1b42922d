"""The rank programs of tests/test_torch_parallel.py,
tests/test_torch_parallel_step.py and tests/test_torch_tp.py, and `spawn`,
which runs one of them in `world` gloo ranks.

This module imports torch and the port only: the ranks are started with
`torch.multiprocessing` (spawn), so each imports this module afresh and
never JAX or tests/conftest.py. Each rank runs with one thread, joins a
process group through a `FileStore` in the case's own directory (so that
concurrent test workers never share a port) with a 60-s timeout, and writes
its result with `torch.save`; `spawn` kills every rank that outlives its
deadline and fails.
"""

from __future__ import annotations

import datetime
import os
import time
from typing import Any, Callable, Dict, List

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from hallo_tpu_torch.parallel.mesh import make_mesh

CASES: Dict[str, Callable[..., Any]] = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


def _rank_main(rank: int, name: str, world: int, root: str, kw: dict) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(root, "store"), world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        out = CASES[name](rank, world, root, **kw)
        torch.save(out, os.path.join(root, f"result-{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(name: str, world: int, root: str, timeout: float = 120.0, **kw) -> List[Any]:
    """Run CASES[name](rank, world, root, **kw) in `world` gloo ranks under
    `root` (a fresh directory); returns each rank's result, in rank order."""
    os.makedirs(root, exist_ok=False)
    ctx = mp.start_processes(_rank_main, args=(name, world, root, kw), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{name} at world {world}: ranks alive after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
    assert not any(p.is_alive() for p in ctx.processes)
    return [torch.load(os.path.join(root, f"result-{r}.pt"), weights_only=False)
            for r in range(world)]


def frames_of(x, rank: int, world: int, dim: int = 1):
    """This rank's frames (its 1/world of `dim`) of a numpy array or tensor."""
    n = x.shape[dim] // world
    index = [slice(None)] * x.ndim
    index[dim] = slice(rank * n, (rank + 1) * n)
    return x[tuple(index)]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


# --- (a) the motion module ---------------------------------------------------


@case
def motion(rank, world, root, cfg: dict, state: dict, x, mf, gy):
    """This rank's frames of the clip-parallel motion module, and the
    parameters' gradients of sum(out * gy) summed over the ranks, beside the
    unsharded module's (rank 0)."""
    from hallo_tpu_torch.config import MotionModuleConfig
    from hallo_tpu_torch.models.motion import MotionModule

    mesh = make_mesh(n_data=1, n_seq=world)
    mod = MotionModule(x.shape[2], MotionModuleConfig(**cfg))
    mod.load_state_dict({k: _t(v) for k, v in state.items()})
    mf_t = None if mf is None else _t(mf)
    out = mod(_t(frames_of(x, rank, world)), mf_t, mesh.seq_group)
    (out * _t(frames_of(gy, rank, world))).sum().backward()
    grads = {k: p.grad.clone() for k, p in mod.named_parameters()}
    for g in grads.values():
        dist.all_reduce(g)
    mod.zero_grad()
    (mod(_t(x), mf_t) * _t(gy)).sum().backward()
    plain = {k: p.grad.clone() for k, p in mod.named_parameters()}
    return dict(out=out.detach(), grads=grads, plain=plain)


# --- (b) the inflated GroupNorm ------------------------------------------------


@case
def group_norm(rank, world, root, x, weight, bias, groups: int, eps: float):
    """This rank's frames of the inflated GroupNorm over the seq group, x
    (B, F, C, H, W), and of the same norm without the group (the moments not
    all-reduced: the fault the test must see)."""
    from hallo_tpu_torch.models.layers import group_norm as gn

    mesh = make_mesh(n_data=1, n_seq=world)
    local = _t(frames_of(x, rank, world))
    return dict(out=gn(local, _t(weight), _t(bias), groups, eps, channel_dim=2,
                       group=mesh.seq_group),
                fault=gn(local, _t(weight), _t(bias), groups, eps, channel_dim=2))


# --- (c) the denoiser ----------------------------------------------------------


@case
def denoiser(rank, world, root, state: dict, inputs: dict):
    """This rank's frames of the tiny denoiser's output, clip-parallel."""
    from hallo_tpu_torch.utils.factory import build_models

    mesh = make_mesh(n_data=1, n_seq=world)
    den = build_models("tiny", device="cpu").denoising_net
    den.load_state_dict({k: _t(v) for k, v in state.items()})
    d = inputs
    b = d["x"].shape[0]

    def local_masks(lvl):
        return tuple(_t(frames_of(a.reshape(b, -1, a.shape[-1]), rank, world))
                     .flatten(0, 1) for a in lvl)

    with torch.no_grad():
        out = den(
            _t(frames_of(d["x"], rank, world)).movedim(-1, -3), _t(d["t"]), _t(d["ctx"]),
            {k: [_t(a) for a in v] for k, v in d["ref"].items()},
            {k: [_t(a) for a in v] for k, v in d["mot"].items()},
            _t(frames_of(d["audio"], rank, world)),
            _t(frames_of(d["face"], rank, world)).movedim(-1, -3),
            tuple(local_masks(lvl) for lvl in d["masks"]), _t(d["scale"]),
            _t(d["uncond"]), train=True, seq_group=mesh.seq_group,
        )
    return out


# --- (d) the stage-2 step --------------------------------------------------------


def local_batch(batch: dict, mesh) -> dict:
    """This rank's rows of a global stage-2 batch and, for the per-frame
    arrays, its frames of them."""
    n, d = batch["face_emb"].shape[0] // mesh.n_data, mesh.data_index

    def rows(x):
        return x[d * n:(d + 1) * n]

    out = {}
    for k, v in batch.items():
        if k == "masks":
            out[k] = tuple(tuple(rows(x) for x in lvl) for lvl in v)
        elif k in ("pixel_values", "audio_windows", "noise"):
            out[k] = frames_of(rows(v), mesh.seq_index, mesh.n_seq)
        else:
            out[k] = rows(v)
    return out


class CapturingZeroStep:
    """Wraps a `Zero`'s update to keep the whole gradient it was given
    (gathered from the shards)."""

    def __init__(self, zero):
        self.zero, self.update = zero, zero.update
        zero.update = self

    def __call__(self, state, shard_grads):
        self.grads = {k: v.clone() for k, v in self.zero.gather_leaves(shard_grads).items()}
        self.update(state, shard_grads)


@case
def train_step(rank, world, root, states: dict, batch: dict, n_data: int, n_seq: int,
               opt_kw: dict, train_kw: dict, runs: list):
    """For each (override, steps) of `runs`, from the weights `states`:
    `steps` stage-2 steps over the (n_data, n_seq) mesh on `batch` (the
    global batch; without `override` its noise and timesteps are dropped and
    drawn from the step generator): each step's metrics and whole gradient,
    and the gathered state after the last (rank 0)."""
    from hallo_tpu_torch.train.state import OptimizerConfig, Zero, make_optimizer, \
        stage2_trainable, unfreeze
    from hallo_tpu_torch.train.step import TrainConfig, make_train_step, step_generator
    from hallo_tpu_torch.utils.factory import build_models

    mesh = make_mesh(n_data=n_data, n_seq=n_seq)
    results = []
    for override, steps in runs:
        models = build_models("tiny", device="cpu")
        for name, module in models.modules().items():
            module.load_state_dict({k: _t(v) for k, v in states[name].items()})
        trainable = unfreeze(models.modules(), stage2_trainable)
        opt = make_optimizer(OptimizerConfig(**opt_kw))
        zero = Zero(mesh, trainable, opt)
        capture = CapturingZeroStep(zero)
        state = zero.create(trainable)
        step = make_train_step(models, trainable, opt, TrainConfig(**train_kw), mesh=mesh)
        b = batch if override else {k: v for k, v in batch.items()
                                    if k not in ("noise", "timesteps")}
        mine, out = local_batch(b, mesh), []
        for i in range(steps):
            state, metrics = step(state, mine, step_generator(0, i, "cpu"))
            out.append(dict(metrics, grads=capture.grads))
        sd = state.state_dict()  # a collective: every rank gathers
        results.append(dict(steps=out, state=sd if rank == 0 else None))
    return results


# --- (e) ZeRO ---------------------------------------------------------------------


@case
def zero_optimizer(rank, world, root, variants: list):
    """For each variant (init, grads, opt_kw, resume_grads): the optimizer
    over ZeRO shards at data = world on `grads` (one dict a call, the same on
    every rank): the gathered state (rank 0), the model's parameters after
    the last write, and the gathered state after a resume from it
    (`shard_state` of the gathered state) and `resume_grads`."""
    from hallo_tpu_torch.train.state import OptimizerConfig, TrainState, Zero, make_optimizer

    mesh = make_mesh(n_data=world, n_seq=1)
    out = []
    for init, grads, opt_kw, resume_grads in variants:
        trainable = {k: torch.nn.Parameter(_t(v)) for k, v in init.items()}
        zero = Zero(mesh, trainable, make_optimizer(OptimizerConfig(**opt_kw)))

        def run(state, calls):
            for g in calls:
                zero.update(state, zero.reduce({k: _t(v) for k, v in g.items()}))
                state.write_to(trainable)
            return state

        sd = run(zero.create(trainable), grads).state_dict()
        written = {k: p.detach().clone() for k, p in trainable.items()}
        resumed = run(zero.shard_state(TrainState.from_state_dict(sd)),
                      resume_grads).state_dict()
        norm = zero.norm(list(zero.reduce({k: _t(v) for k, v in grads[0].items()}).values()))
        out.append(dict(state=sd, written=written, resumed=resumed, norm=float(norm),
                        rows=zero.plan.shard_rows))
    return out if rank == 0 else None


# --- (f) the pipeline ------------------------------------------------------------


def run_pipeline(models, mesh, inputs: dict, pipe_kw: dict) -> dict:
    """Two clips through `FaceAnimatePipeline` (clip-parallel with a mesh):
    the video, the latents each decode received (this rank's frames, (B, f,
    4, h, w)), each step's kind and the dynamic cache's scores."""
    from hallo_tpu_torch.pipelines.face_animate import FaceAnimatePipeline

    pipe = FaceAnimatePipeline(models, mesh=mesh, **pipe_kw)
    vae, seen, decode = models.vae, [], models.vae.decode
    b = inputs["ref_image"].shape[0]

    def recording(z):
        seen.append(z.unflatten(0, (b, -1)).clone())
        return decode(z)

    vae.decode = recording
    timings: dict = {}
    try:
        video = pipe(**inputs, seed=0, timings=timings)
    finally:
        del vae.decode
    return dict(video=video, latents=seen, kinds=timings["step_kind"],
                scores=timings.get("step_cache_score", []))


@case
def pipeline_clip(rank, world, root, states: dict, inputs: dict, variants: list):
    """`run_pipeline` at seq = world, for each pipeline settings of
    `variants`."""
    from hallo_tpu_torch.utils.factory import build_models

    mesh = make_mesh(n_data=1, n_seq=world)
    models = build_models("tiny", device="cpu")
    for name, module in models.modules().items():
        module.load_state_dict({k: _t(v) for k, v in states[name].items()})
    return [run_pipeline(models, mesh, inputs, kw) for kw in variants]


# --- (h) the trainer ------------------------------------------------------------


@case
def trainer(rank, world, root, cfgs: list, tp_min_dim=None):
    """`train_stage2_process` on each config of `cfgs` in turn (a 2-step run,
    its resume to step 3, an unbroken 3-step run): each run's gathered
    final state (rank 0). `tp_min_dim` lowers tensor parallelism's
    `DEFAULT_MIN_DIM` in the ranks (the tiny models have no 1280-wide
    dense)."""
    from hallo_tpu_torch.config import DotDict
    from hallo_tpu_torch.parallel import tp
    from hallo_tpu_torch.train.stage2 import train_stage2_process

    if tp_min_dim is not None:
        tp.DEFAULT_MIN_DIM = tp_min_dim
    out = []
    for cfg in cfgs:
        sd = train_stage2_process(DotDict.wrap(cfg), device="cpu").state_dict()
        out.append(sd if rank == 0 else None)
    return out


# --- (g) the mesh ----------------------------------------------------------------


def mesh_layout(mesh) -> dict:
    """A mesh's shape, this rank's indices and its groups' ranks."""
    return dict(shape=mesh.shape, index=(mesh.data_index, mesh.seq_index, mesh.model_index),
                **{f"{axis}_ranks": dist.get_process_group_ranks(mesh.group(axis))
                   for axis in ("data", "seq", "model")})


@case
def mesh_groups(rank, world, root, path: str):
    """The mesh of the parallel config `path` and the (data, model 2) mesh
    (`mesh_layout`), and the errors of meshes that cannot be built here."""
    from hallo_tpu_torch.parallel.mesh import mesh_from_config

    mesh = mesh_from_config(path)
    errors = []
    for kw in (dict(n_data=world + 1), dict(n_seq=world + 1), dict(n_seq=2, n_model=world)):
        try:
            make_mesh(**kw)
        except ValueError as e:
            errors.append(type(e).__name__)
    return dict(config=mesh_layout(mesh), model2=mesh_layout(make_mesh(n_model=2)),
                errors=errors)


# --- (i) tensor parallelism ------------------------------------------------------


def tp_layer_kinds():
    """Each kind of sharded layer at the tiny widths (min_dim 16), with
    every parameter perturbed: a column and a row dense, a GEGLU
    feed-forward (net.0.proj column, net.2 row), cross-attentions of 4 and 2
    heads with pre-projected rows and a per-key bias (whole heads at world
    2; at world 4 the 2-head one splits a head), a temporal attention."""
    from hallo_tpu_torch.models.layers import (
        CrossAttention, FeedForward, TemporalSelfAttention, TokenConv1x1)

    torch.manual_seed(0)
    kinds = dict(column=torch.nn.Linear(16, 32), row=torch.nn.Linear(32, 16),
                 token_conv=TokenConv1x1(16, 32), geglu=FeedForward(16),
                 attention_4=CrossAttention(16, 4, 4, context_dim=12),
                 attention_2=CrossAttention(16, 2, 8, context_dim=12),
                 temporal=TemporalSelfAttention(16, 4, 4))
    with torch.no_grad():
        for module in kinds.values():
            for p in module.parameters():
                p.add_(0.5 * torch.randn(p.shape))
    return kinds


def tp_layer_inputs(name: str, gen: torch.Generator) -> list:
    def r(*shape):
        return torch.randn(shape, generator=gen).requires_grad_(True)

    if name == "temporal":
        return [r(2, 5, 3, 16)]
    if name.startswith("attention"):
        return [r(2, 6, 16), r(2, 7, 12), torch.randn(2, 10, generator=gen),
                (r(2, 3, 16), r(2, 3, 16))]
    return [r(2, 6, 32 if name == "row" else 16)]


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).norm() / b.norm())


def tp_layer_errors(mesh) -> dict:
    """Each `tp_layer_kinds` module sharded over the mesh's model group
    against its unsharded copy on the same inputs: the largest relative
    error of the output, of every input's gradient and of every
    parameter's gradient (a sharded one against its piece of the plain
    gradient), the parameters sharded and the heads each attention runs on
    this rank."""
    import copy

    from hallo_tpu_torch.parallel.tp import shard_modules, tp_plan

    world, r, out = mesh.n_model, mesh.model_index, {}
    for name, module in tp_layer_kinds().items():
        holder = torch.nn.ModuleList([module])
        plain = copy.deepcopy(holder)
        plan = tp_plan({"m": holder}, world, 16)
        heads = getattr(module, "heads", None)
        shard_modules({"m": holder}, plan, mesh)
        # an attention run on this rank's heads takes its heads of the
        # pre-projected rows (the caller slices them; the whole ones raise)
        local_heads = getattr(module, "heads", None) != heads
        runs = []
        for mod in (holder, plain):
            gen = torch.Generator().manual_seed(1)
            args = tp_layer_inputs(name, gen)
            extra = len(args) > 3 and local_heads
            if extra and mod is holder:
                try:
                    mod[0](*args)
                except ValueError as e:
                    assert "extra_kv" in str(e), e
                else:
                    raise AssertionError(f"{name}: the whole extra_kv did not raise")
                args[3] = tuple(t.detach().chunk(world, -1)[r].requires_grad_(True)
                                for t in args[3])
            y = mod[0](*args)
            (y * torch.randn(y.shape, generator=gen)).sum().backward()
            leaves = [a for a in args[:2] if a.requires_grad] + list(args[3] if len(args) > 3
                                                                    else ())
            runs.append((y.detach(), [t.grad for t in leaves],
                         {k: p.grad for k, p in mod.named_parameters()}))
        (y, gx, gp), (y0, gx0, gp0) = runs
        if extra:  # the plain gradient's piece of the rows this rank took
            gx0 = gx0[:2] + [g.chunk(world, -1)[r] for g in gx0[2:]]
        errs = [rel_err(y, y0)] + [rel_err(a, b) for a, b in zip(gx, gx0)]
        for k, g in gp.items():
            shard = plan[f"m.{k}"]
            want = gp0[k] if shard is None else shard.piece(gp0[k], world, mesh.model_index)
            errs.append(rel_err(g, want))
        out[name] = dict(err=max(errs), sharded=sum(s is not None for s in plan.values()),
                         heads=getattr(module, "heads", None))
    return out


def tp_models(states: dict, mesh, min_dim: int, trainable_fn):
    """The tiny models from `states`, sharded over the mesh's model group
    at `min_dim`: (models, plan, trainable)."""
    from hallo_tpu_torch.parallel.tp import shard_modules, tp_plan
    from hallo_tpu_torch.train.state import unfreeze
    from hallo_tpu_torch.utils.factory import build_models

    models = build_models("tiny", device="cpu")
    for name, module in models.modules().items():
        module.load_state_dict({k: _t(v) for k, v in states[name].items()})
    plan = tp_plan(models.modules(), mesh.n_model, min_dim)
    shard_modules(models.modules(), plan, mesh)
    return models, plan, unfreeze(models.modules(), trainable_fn)


def tp_steps(rank, mesh, min_dim: int, states: dict, batch: dict, opt_kw: dict,
             train_kw: dict, fault: bool) -> dict:
    """The stage-2 step over `mesh` with the tiny models sharded at
    `min_dim` (ZeRO-2 AdamW; `batch` the global one, with its noise and
    timesteps): two steps, each step's metrics and whole gradient, and the
    gathered masters after them (rank 0); with `fault`, then one step with
    the planted fault, `all_reduce_sum` (whose backward sums the cotangents
    over the group) in place of g."""
    from hallo_tpu_torch.parallel import collectives, tp
    from hallo_tpu_torch.train.state import OptimizerConfig, Zero, make_optimizer, \
        stage2_trainable
    from hallo_tpu_torch.train.step import TrainConfig, make_train_step, step_generator

    result = {}
    for run, steps in (("tp", 2), ("fault", 1))[:2 if fault else 1]:
        models, plan, trainable = tp_models(states, mesh, min_dim, stage2_trainable)
        opt = make_optimizer(OptimizerConfig(**opt_kw))
        zero = Zero(mesh, trainable, opt, tp=plan)
        capture = CapturingZeroStep(zero)
        state = zero.create(trainable)
        step = make_train_step(models, trainable, opt, TrainConfig(**train_kw), mesh=mesh)
        mine, metrics = local_batch(batch, mesh), []
        real = tp.reduce_from_group
        if run == "fault":
            tp.reduce_from_group = collectives.all_reduce_sum
        try:
            for i in range(steps):
                state, m = step(state, mine, step_generator(0, i, "cpu"))
                metrics.append(dict(m, grads=capture.grads))
        finally:
            tp.reduce_from_group = real
        params = state.state_dict()["params"]  # a collective: every rank gathers
        result[run] = dict(steps=metrics, params=params if rank == 0 else None,
                           sharded=sum(s is not None for s in plan.values()))
    return result


def stage1_tp_batch(seed: int = 0, b: int = 2, h: int = 64) -> dict:
    rng = np.random.default_rng(seed)
    return dict(
        pixel_values=rng.uniform(-1, 1, (b, 1, h, h, 3)).astype(np.float32),
        ref_pixels=rng.uniform(-1, 1, (b, h, h, 3)).astype(np.float32),
        face_emb=rng.normal(size=(b, 16)).astype(np.float32),
        face_region=rng.uniform(0, 1, (b, h, h, 3)).astype(np.float32),
        noise=rng.normal(size=(b, 1, h // 8, h // 8, 4)).astype(np.float32),
        timesteps=np.array([999, 321][:b], np.int32),
    )


def tp_stage1(rank, mesh, variants: list, min_dim: int = 16) -> list:
    """The stage-1 step of the tiny 2D models (every parameter perturbed,
    64x64, B 2) over `mesh` (data 1), against the same step on one process
    (computed on rank 0 alone), for each optimizer settings of `variants`:
    two steps' metrics, the gathered state after them (rank 0) and the
    global norm that counts the replicated leaves once a rank (the fault the
    clip's norm must not have) beside the one `Zero.norm` gave."""
    import copy

    from hallo_tpu_torch.parallel.tp import shard_modules, tp_plan
    from hallo_tpu_torch.train.state import (
        OptimizerConfig, TrainState, Zero, make_optimizer, stage1_trainable, unfreeze)
    from hallo_tpu_torch.train.step import TrainConfig, make_train_step, step_generator
    from hallo_tpu_torch.utils.factory import build_models

    world = mesh.n_model
    torch.manual_seed(0)
    base = build_models("tiny", device="cpu", seed=0, unet_overrides=dict(
        use_motion_module=False, use_audio_module=False))
    with torch.no_grad():
        for module in base.modules().values():
            for p in module.parameters():
                p.add_(0.05 * torch.randn(p.shape))
    batch = stage1_tp_batch()
    cfg = TrainConfig(stage=1, uncond_img_ratio=0.0, uncond_audio_ratio=0.0,
                      uncond_ia_ratio=0.0, start_ratio=0.0)
    out = []
    for opt_kw in variants:
        opt_kw = dict(opt_kw, lr_warmup_steps=0)
        runs = {}
        for sharded in (False, True) if rank == 0 else (True,):
            models = copy.deepcopy(base)
            plan = tp_plan(models.modules(), world, min_dim)
            if sharded:
                shard_modules(models.modules(), plan, mesh)
            trainable = unfreeze(models.modules(), stage1_trainable)
            opt = make_optimizer(OptimizerConfig(**opt_kw))
            norms = []
            if sharded:
                zero = Zero(mesh, trainable, opt, tp=plan)
                zero.norm = recording_norm(zero.norm, mesh.model_group, norms)
                state = zero.create(trainable)
            else:
                state = TrainState.create(trainable, opt)
            step = make_train_step(models, trainable, opt, cfg, mesh=mesh if sharded else None)
            metrics = []
            for i in range(2):
                state, m = step(state, batch, step_generator(0, i, "cpu"))
                metrics.append(m)
            sd = state.state_dict()  # sharded: a collective, every rank gathers
            runs["tp" if sharded else "one"] = dict(
                steps=metrics, state=sd if rank == 0 else None,
                faulty_norms=norms if sharded else None)
        out.append(runs)
    return out


def recording_norm(norm, group, faulty: list):
    """`norm` (Zero.norm), appending to `faulty` at each call the norm that
    sums every local square over the model group: a replicated leaf counted
    once a rank."""
    def recording(tensors):
        local = torch.stack([t.float().square().sum() for t in tensors]).sum()
        dist.all_reduce(local, group=group)
        faulty.append(float(local.sqrt()))
        return norm(tensors)

    return recording


@case
def tensor_parallel(rank, world, root, states: dict, batch: dict, meshes: list,
                    opt_kw: dict, train_kw: dict, stage1_variants: list):
    """Tensor parallelism at `world`: the layer kinds at model = world
    (`tp_layer_errors`); the stage-2 step over each (n_data, n_seq, n_model,
    min_dim, fault) of `meshes` (`tp_steps`); with `stage1_variants`, the
    stage-1 step at model = world against one process (`tp_stage1`)."""
    tp_mesh = make_mesh(n_data=1, n_model=world)
    out = dict(layers=tp_layer_errors(tp_mesh), steps=[], stage1=None)
    for n_data, n_seq, n_model, min_dim, fault in meshes:
        mesh = make_mesh(n_data=n_data, n_seq=n_seq, n_model=n_model)
        out["steps"].append(tp_steps(rank, mesh, min_dim, states, batch, opt_kw, train_kw,
                                     fault))
    if stage1_variants:
        out["stage1"] = tp_stage1(rank, tp_mesh, stage1_variants)
    return out
