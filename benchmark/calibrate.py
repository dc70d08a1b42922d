"""The readings a cell's limits are set from: the check's numbers of the
program and of its control (the reference in the next precision down in
the program's place) on each seed, at the cell's shapes, in one process.

    python3 -m benchmark.calibrate --workload <cell> --seeds 1,2,3

prints one JSON line a seed on standard error and the list as the last
line of standard output.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
import types

import torch

from benchmark import harness, run


def main(argv=None, device=None, overrides=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", type=int, default=3,
                   help="read the control on the first this many seeds")
    p.add_argument("--faults", type=int, default=0,
                   help="read the planted faults on the first this many seeds")
    p.add_argument("--window-only", action="store_true",
                   help="training: read only the window's step, not the set-up steps")
    p.add_argument("--window-step", type=int, default=None,
                   help="training: the step that stands for the window's last "
                        "(default: the one after the set-up steps)")
    args = p.parse_args(argv)
    overrides = overrides or {}
    man = overrides.get("manifest") or harness.manifest(run.ROOT)
    _, got = run.load(man, args.workload, overrides)
    if device is None:
        if not torch.cuda.is_available():
            run.log("no CUDA device")
            return 2
        device = torch.device("cuda", 0)
    ctx = types.SimpleNamespace(cfg=got["cfg"], traffic=got["traffic"], work=got["work"],
                                device=device, log=run.log, t0=time.perf_counter(),
                                control=args.control, faults=args.faults,
                                window_only=args.window_only, window_step=args.window_step)
    driver = importlib.import_module(f"benchmark.drivers.{got['traffic']['kind']}")
    rows = driver.readings(ctx, [int(s) for s in args.seeds.split(",")])
    print(json.dumps(rows), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
