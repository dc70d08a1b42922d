"""What the parallel paths cost on one card: NCCL's time a call at group
size 1 beside the plain op it stands for, and the device memory after each
part of a full-width stage-2 step (512^2, B 1, 14 + 2 frames, per-block
checkpointing, AdamW), plain and through ZeRO-2.

    python -m hallo_tpu_torch.parallel.bench_collectives

Needs a CUDA card; starts a process group of one rank (NCCL over a free
localhost port). Prints one line a measurement, then one JSON line.
"""

from __future__ import annotations

import datetime
import json
import socket
import subprocess
import time

import torch
import torch.distributed as dist

from hallo_tpu_torch.parallel import collectives
from hallo_tpu_torch.parallel.mesh import make_mesh
from hallo_tpu_torch.train.bench_step import synthetic_batch
from hallo_tpu_torch.train.state import (
    AdamW, OptimizerConfig, TrainState, Zero, stage2_trainable, unfreeze)
from hallo_tpu_torch.train.step import TrainConfig, make_loss_fn, step_generator
from hallo_tpu_torch.utils.factory import build_models

GIB = 2**30


def ms_a_call(fn, n: int) -> float:
    """Mean ms of `n` calls after one, the card synchronised around them."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def step_memory(models, trainable, mesh, batch) -> list:
    """Two steps (plain without a mesh, ZeRO-2 with one) from the models'
    weights: (step, part, allocated GiB, peak GiB since the step began)
    after the loss, the backward, ZeRO's reduce, the update and the write
    into the model."""
    opt = AdamW(OptimizerConfig(learning_rate=1e-5, lr_warmup_steps=1))
    zero = Zero(mesh, trainable, opt) if mesh is not None else None
    state = zero.create(trainable) if zero is not None else TrainState.create(trainable, opt)
    loss_fn = make_loss_fn(models, TrainConfig(), mesh)
    names = list(trainable)
    rows = []

    def mark(i, part):
        torch.cuda.synchronize()
        rows.append((i, part, torch.cuda.memory_allocated() / GIB,
                     torch.cuda.max_memory_allocated() / GIB))

    for i in range(2):
        torch.cuda.reset_peak_memory_stats()
        loss = loss_fn(batch, step_generator(0, i, models.device))
        mark(i, "loss")
        params = [trainable[n] for n in names]
        grads = {n: torch.zeros_like(p) if g is None else g for n, p, g in zip(
            names, params, torch.autograd.grad(loss, params, allow_unused=True))}
        del loss
        mark(i, "backward")
        if zero is None:
            opt.update(grads, state.opt_state, state.params)
        else:
            grads = zero.reduce(grads)
            mark(i, "reduce")
            zero.update(state, grads)
        mark(i, "update")
        del grads
        state.write_to(trainable)
        mark(i, "write")
    return rows


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("bench_collectives: no CUDA device")
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=300))
    try:
        mesh = make_mesh(1, 1, 1)
        group = mesh.seq_group
        small = torch.randn(2, 32, device=dev)
        level0 = torch.randn(2, 16, 4096, 320, device=dev, dtype=torch.bfloat16)
        out = dict(device=torch.cuda.get_device_name(0), calls_ms=dict(
            all_reduce_2x32=ms_a_call(lambda: collectives.all_reduce_sum(small, group), 200),
            clone_2x32=ms_a_call(lambda: small.clone(), 200),
            all_to_all_level0=ms_a_call(lambda: collectives.all_to_all(level0, group, 2, 1), 50),
            copy_level0=ms_a_call(lambda: level0.movedim(2, 0).contiguous(), 50)))
        for name, ms in out["calls_ms"].items():
            print(f"{name}: {ms:.4f} ms a call", flush=True)
        del small, level0
        models = build_models("full", device=dev, dtype=torch.bfloat16, seed=0, remat=True)
        trainable = unfreeze(models.modules(), stage2_trainable)
        init = {k: p.detach().clone() for k, p in trainable.items()}
        batch = synthetic_batch(models, 1, 512, 14, 2, seed=0, fixed=False)
        for name, m in (("plain", None), ("zero", mesh)):
            with torch.no_grad():
                torch._foreach_copy_(list(trainable.values()), [init[k] for k in trainable])
            out[name] = step_memory(models, trainable, m, batch)
            for i, part, alloc, peak in out[name]:
                print(f"{name} step {i} after {part}: allocated {alloc:.3f} GiB, peak "
                      f"{peak:.3f} GiB", flush=True)
            torch.cuda.empty_cache()
        print(json.dumps(out), flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
