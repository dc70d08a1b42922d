"""The rank programs of tests/test_torch_parallel.py, and `spawn`, which runs
one of them in `world` gloo ranks.

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
def trainer(rank, world, root, cfgs: list):
    """`train_stage2_process` on each config of `cfgs` in turn (a 2-step run,
    its resume to step 3, an unbroken 3-step run): each run's gathered
    final state (rank 0)."""
    from hallo_tpu_torch.config import DotDict
    from hallo_tpu_torch.train.stage2 import train_stage2_process

    out = []
    for cfg in cfgs:
        sd = train_stage2_process(DotDict.wrap(cfg), device="cpu").state_dict()
        out.append(sd if rank == 0 else None)
    return out


# --- (g) the mesh ----------------------------------------------------------------


@case
def mesh_groups(rank, world, root, path: str):
    """The mesh of the parallel config `path`: this rank's indices and its
    groups' ranks, and the errors of meshes that cannot be built here."""
    from hallo_tpu_torch.parallel.mesh import mesh_from_config

    mesh = mesh_from_config(path)
    errors = []
    for kw in (dict(n_data=world + 1), dict(n_model=2), dict(n_seq=world + 1)):
        try:
            make_mesh(**kw)
        except (ValueError, NotImplementedError) as e:
            errors.append(type(e).__name__)
    return dict(shape=mesh.shape, data_index=mesh.data_index, seq_index=mesh.seq_index,
                data_ranks=dist.get_process_group_ranks(mesh.data_group),
                seq_ranks=dist.get_process_group_ranks(mesh.seq_group), errors=errors)
