"""Tensor parallelism across the cards alone: `chip_smoke.py`'s
tensor-parallel checks (`tp_checks`) at the card count, one rank a card,
without the rest of its parallel phase.

    python -m hallo_tpu_torch.parallel.bench_tp

Run from the checkout's root (it imports `chip_smoke`). Builds the kernels,
then each rank (NCCL over a free localhost port) builds the full-width
models (seed 0, bf16), takes the plain stage-2 step at 512^2 (B 1, 14 + 2
frames, per-block checkpointing, AdamW; 3 steps: seconds and peak) and the
plain references at 256^2 (B 1 and 2), times one `step_errors` on the
host, then runs `tp_checks` on the same models: the step at model = world
at 512^2 (seconds, peak, launches a step) and, with 2 cards or more, the
checks at 256^2 against the references within TRAIN_RTOL (model = world,
its planted fault, and data 2 x model 2 on 4 cards). Each rank prints its
threads' Python stacks if it is still running after DUMP_AFTER_S. Rank 0
writes chiprun_out/bench_tp.json; the last lines print its figures.
"""

from __future__ import annotations

import datetime
import faulthandler
import json
import logging
import os
import sys
import time

import torch
import torch.distributed as dist

from hallo_tpu_torch.train.bench_step import synthetic_batch
from hallo_tpu_torch.train.state import stage2_trainable, unfreeze
from hallo_tpu_torch.utils.factory import build_models

OUT = os.path.join("chiprun_out", "bench_tp.json")
DUMP_AFTER_S = 200


def rank_main(rank: int, world: int, port: int) -> None:
    import chip_smoke as cs

    logging.basicConfig(level=logging.INFO, format="%(name)s: %(message)s")
    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    faulthandler.dump_traceback_later(DUMP_AFTER_S)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=240))
    t0 = time.monotonic()

    def progress(part: str) -> None:
        if rank == 0:
            print(f"rank 0: {part} at {time.monotonic() - t0:.1f} s", flush=True)

    models = build_models("full", device=dev, dtype=torch.bfloat16, seed=0, remat=True)
    trainable = unfreeze(models.modules(), stage2_trainable)
    init = {k: p.detach().clone() for k, p in trainable.items()}

    def restore() -> None:
        with torch.no_grad():
            torch._foreach_copy_(list(trainable.values()), [init[k] for k in trainable])

    batch = synthetic_batch(models, 1, 512, 14, 2, seed=0, fixed=False)
    plain = cs.captured_step(models, trainable, None, batch, steps=3)
    restore()
    progress("the plain step at 512^2")
    refs = {}
    for b in (1, 2):
        small = synthetic_batch(models, b, 256, 16, 2, seed=1, fixed=False)
        refs[b] = (small, cs.captured_step(models, trainable, None, small))
        restore()
    progress("the plain references at 256^2")
    t1 = time.monotonic()
    cs.step_errors(plain, plain)
    progress(f"one step_errors on the host: {time.monotonic() - t1:.1f} s")
    out = cs.tp_checks(world, models, init, batch, plain, refs, progress)
    out.update(plain_seconds=plain["seconds"], plain_peak=plain["peak"])
    faulthandler.cancel_dump_traceback_later()
    if rank == 0:
        with open(OUT, "w") as fh:
            json.dump(out, fh)
    dist.destroy_process_group()


def main() -> None:
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs

    t0 = time.perf_counter()
    cs.preflight()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    world = torch.cuda.device_count()
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    torch.multiprocessing.start_processes(
        rank_main, args=(world, cs.free_port()), nprocs=world, join=True,
        start_method="spawn")
    with open(OUT) as fh:
        out = json.load(fh)
    gib = 2**30
    print(f"world {world}: TP step at model {world}, 512^2 B 1 14 + 2 frames, "
          f"{out['tp_sharded']} parameters sharded: seconds {out['tp_seconds']}, peak "
          f"{out['tp_peak'] / gib:.3f} GiB; plain seconds {out['plain_seconds']}, peak "
          f"{out['plain_peak'] / gib:.3f} GiB; launches a step {out['tp_launches']}")
    for k in ("tp_errs_model", "tp_fault_errs", "tp_errs_data2_model2"):
        print(k, out.get(k))
    print(f"done {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
