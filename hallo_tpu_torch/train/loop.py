"""What both trainers share (scripts/train_stage{1,2}.py's common parts):
the solver keys, the pretrained overlay, the ranks under torchrun, and the
loop: resume from "latest", the NaN guard with its consecutive-skip abort,
metrics.jsonl, checkpoint-N with rotation and the validation renders.

Under torchrun (`torchrun --standalone --nproc_per_node N -m
hallo_tpu_torch.train.stage2 --config ...`), `parallel_setup` joins the
process group and builds the mesh of `parallel_config` (configs/parallel.yaml
by default, as scripts/train_stage{1,2}.py read it); with `model > 1`,
`tensor_parallel` shards the wide denses over the model group
(`parallel/tp.py`, at any seq size: JAX's trainers drop it at seq > 1). The
loop then steps a ZeRO-2 state (`state.Zero`), and rank 0 alone writes
metrics.jsonl, checkpoints (gathered: the single-card format), exports and
validation renders (from the gathered weights under tensor parallelism)
while the others wait at a barrier. Without torchrun nothing of this
runs."""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Any, Callable, Dict, Iterator, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

from hallo_tpu_torch.convert.load_pretrained import load_pretrained
from hallo_tpu_torch.parallel.mesh import (
    Mesh, maybe_initialize_distributed, mesh_from_config, parallel_settings, rank_device)
from hallo_tpu_torch.parallel.tp import (
    TensorParallel, count_sharded, shard_modules, tp_plan)
from hallo_tpu_torch.train.state import AdamW, OptimizerConfig, TrainState, Zero
from hallo_tpu_torch.train.step import step_generator
from hallo_tpu_torch.utils import checkpoint as ckpt
from hallo_tpu_torch.utils.profiling import MetricsLogger

logger = logging.getLogger("hallo_tpu_torch.train")

MAX_CONSECUTIVE_SKIPS = 25


def compute_dtype(solver, default: str = "bf16") -> torch.dtype:
    """solver.mixed_precision, else `default` (the parallel config's, as
    scripts/train_stage2.py:56-61 take it): bf16 (fp16 maps to bf16, as in
    the JAX trainers) or fp32."""
    mp = str(solver.get("mixed_precision", "") or default or "no").lower()
    return torch.bfloat16 if mp in ("bf16", "fp16", "bfloat16") else torch.float32


def parallel_setup(cfg, device) -> Tuple[torch.device, Optional[Mesh], dict]:
    """(this rank's device, the mesh, `parallel_settings`) of a trainer:
    `cfg.parallel_config`, else configs/parallel.yaml where it exists (a
    path given that does not exist raises). The mesh is built when the
    process runs under torchrun (or a process group exists already), else
    it is None and the device is `device`."""
    path = str(cfg.get("parallel_config", "") or "") or (
        "configs/parallel.yaml" if os.path.exists("configs/parallel.yaml") else None)
    settings = parallel_settings(path)
    if not maybe_initialize_distributed(device):
        return torch.device(device), None, settings
    mesh = mesh_from_config(path)
    logger.info("rank %d of %d: mesh %s, ZeRO %s", mesh.rank, dist.get_world_size(),
                mesh.shape, settings["zero_optimizer_sharding"])
    return rank_device(device), mesh, settings


def tensor_parallel(models, mesh: Optional[Mesh]) -> Optional[TensorParallel]:
    """With a mesh of `model > 1`, shard `models` in place over its model
    group (`parallel/tp.py`'s plan at JAX's default min_dim); else None."""
    if mesh is None or mesh.n_model == 1:
        return None
    plan = tp_plan(models.modules(), mesh.n_model)
    logger.info("tensor parallelism over %d ranks: %d parameters sharded", mesh.n_model,
                count_sharded(plan))
    return shard_modules(models.modules(), plan, mesh)


def unsharded(tp: Optional[TensorParallel]):
    """`tp.unsharded()`, or nothing to do without tensor parallelism."""
    return tp.unsharded() if tp is not None else contextlib.nullcontext()


def is_main(mesh: Optional[Mesh]) -> bool:
    """Whether this process writes the run's files (rank 0, or no mesh)."""
    return mesh is None or mesh.rank == 0


def barrier(mesh: Optional[Mesh]) -> None:
    if mesh is not None:
        dist.barrier()


def checkpointing(solver) -> Dict[str, bool]:
    """The denoiser's recomputation flags from the solver keys
    (scripts/train_stage2.py:64-77): `gradient_checkpointing` per block
    (`remat`) and, unless `gradient_checkpointing_inner` is false, per layer
    inside each block (`remat_inner`)."""
    remat = bool(solver.get("gradient_checkpointing", False))
    return dict(remat=remat,
                remat_inner=remat and bool(solver.get("gradient_checkpointing_inner", True)))


def optimizer_config(solver) -> OptimizerConfig:
    """The YAML's solver keys (scripts/train_stage1.py:106-122)."""
    return OptimizerConfig(
        learning_rate=float(solver.learning_rate),
        max_grad_norm=float(solver.max_grad_norm),
        beta1=float(solver.get("adam_beta1", 0.9)),
        beta2=float(solver.get("adam_beta2", 0.999)),
        weight_decay=float(solver.get("adam_weight_decay", 1e-2)),
        eps=float(solver.get("adam_epsilon", 1e-8)),
        lr_warmup_steps=int(solver.get("lr_warmup_steps", 0)),
        gradient_accumulation_steps=int(solver.get("gradient_accumulation_steps", 1)),
        use_8bit_adam=bool(solver.get("use_8bit_adam", False)),
    )


def overlay_pretrained(models, cfg, keys: Mapping[str, str]) -> Dict[str, Any]:
    """`load_pretrained` with the config's paths that exist (`keys`: config
    key -> `load_pretrained` argument); an absent path is skipped with a log
    line and its modules keep their random initialisation."""
    paths = {}
    for key, arg in keys.items():
        path = str(cfg.get(key, "") or "")
        if path and os.path.exists(path):
            paths[arg] = path
        elif path:
            logger.info("%s=%s not found: skipped (random initialisation)", key, path)
    return load_pretrained(models, **paths) if paths else {}


def train_loop(
    cfg,
    device: torch.device,
    trainable: Mapping[str, torch.nn.Parameter],
    opt: AdamW,
    step_fn: Callable,
    batches: Iterator[Dict[str, Any]],
    exp_dir: str,
    validate: Optional[Callable[[int], Any]] = None,
    zero: Optional[Zero] = None,
    tp: Optional[TensorParallel] = None,
) -> TrainState:
    """Train from step 0, or from the latest checkpoint-N when
    `resume_from_checkpoint: latest`, to `solver.max_train_steps`; write
    checkpoint-N every `checkpointing_steps` (keeping `total_limit`, 3 by
    default) and call `validate(step)` every `val.validation_steps`. With
    `zero` (a mesh), the state is this rank's shard, a checkpoint of any
    world size resumes it, and rank 0 alone writes files and validates
    (with `tp`, on the weights gathered over the model group)."""
    seed = int(cfg.seed)
    mesh = zero.mesh if zero is not None else None
    main = is_main(mesh)
    start_step = 0
    if str(cfg.get("resume_from_checkpoint", "")) == "latest" and ckpt.latest_step(exp_dir):
        t0 = time.perf_counter()
        state, start_step = ckpt.load_train_state(exp_dir, device=device)
        if zero is not None:
            state = zero.shard_state(state)
        state.write_to(trainable)  # the step expects the model to hold the masters
        logger.info("resumed from checkpoint-%d in %.3f s", start_step,
                    time.perf_counter() - t0)
        # The data stream restarts with the process: replay the batches the
        # earlier run took, so that the resumed run sees what an
        # uninterrupted one would (each step's generator is a function of
        # (seed, step) already).
        for _ in range(start_step):
            next(batches)
    else:
        state = zero.create(trainable) if zero is not None else TrainState.create(trainable, opt)

    val = cfg.get("val") or {}
    val_steps = int(val.get("validation_steps", 0) or 0) if validate is not None else 0
    metrics = MetricsLogger(exp_dir) if main else None
    log_every = int(cfg.get("log_every", 10))
    t0 = time.time()
    nan_skips = consecutive_skips = 0
    td_window = 0.0  # data-loading time since the last log line
    for step in range(start_step, int(cfg.solver.max_train_steps)):
        t_data = time.time()
        batch = next(batches)
        td_window += time.time() - t_data
        state, step_metrics = step_fn(state, batch, step_generator(seed, step, device))
        if step_metrics["skipped"] > 0:
            nan_skips += 1
            consecutive_skips += 1
            logger.warning("step %d: non-finite loss/grads, update skipped (%d total)",
                           step, nan_skips)
            if consecutive_skips >= MAX_CONSECUTIVE_SKIPS:
                raise RuntimeError(f"{consecutive_skips} consecutive non-finite steps; "
                                   "aborting (checkpoints keep the last finite state)")
        else:
            consecutive_skips = 0
        if step % log_every == 0:
            line = dict(loss=step_metrics["loss"], grad_norm=step_metrics["grad_norm"],
                        td=round(td_window, 4), nan_skips=nan_skips,
                        sec=round(time.time() - t0, 3))
            td_window = 0.0
            if main:
                logger.info("%s", {"step": step, **line})
                metrics.log(step, **line)
        if (step + 1) % int(cfg.checkpointing_steps) == 0:
            t_ckpt = time.perf_counter()
            # gathered on every rank (ZeRO), written by rank 0
            whole = TrainState.from_state_dict(state.state_dict()) if zero is not None else state
            if main:
                ckpt.save_train_state(exp_dir, step + 1, whole,
                                      keep=int(cfg.get("total_limit", 3)))
                logger.info("checkpoint-%d written in %.3f s", step + 1,
                            time.perf_counter() - t_ckpt)
            del whole
            barrier(mesh)
        if val_steps and (step + 1) % val_steps == 0:
            with unsharded(tp):
                if main:
                    validate(step + 1)
            barrier(mesh)
    return state
