"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The run builds the program with the seed's
weights, warms every shape the cell uses, measures for `--seconds`, checks
what the timed path produced against the frozen reference, and prints as
the last line of standard output one JSON object: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics, or with `--trace 1`
its per-layer metrics), `device`, with `--trace 1` a `breakdown`, and last
`checks`, each compared number beside its limit (also the last lines of
standard error). It exits non-zero without a result when the card or the
cards the cell needs are missing, or when JAX or the JAX package was
loaded. Build caches stay inside the checkout.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

ROOT = os.getcwd()
CACHE = os.path.join(ROOT, ".bench_cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "nv")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
os.environ["USE_TF"] = "0"
# one process with few threads: the window's host work is one Python thread
# dispatching to the card, and idle pool threads only contend with it
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

import torch  # noqa: E402

torch.set_num_threads(1)

from benchmark import harness  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "hallo_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules():
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def load(man: dict, name: str, overrides: dict):
    w = harness.cell(man, name)
    c = harness.config(man, w["config"])
    files = dict(
        cfg=lambda: harness.load_json(os.path.join(ROOT, c["file"])),
        traffic=lambda: harness.load_json(
            os.path.join(harness.HERE, "traffic", f"{w['traffic']}.json")),
        work=lambda: harness.load_json(
            os.path.join(harness.HERE, "workloads", f"{name}.json")),
    )
    got = {k: overrides[k] if k in overrides else f() for k, f in files.items()}
    for k in ("config", "traffic", "chips"):
        if got["work"].get(k) != w[k]:
            raise ValueError(f"workloads/{name}.json's {k} {got['work'].get(k)!r} is not "
                             f"BENCHMARK.json's {w[k]!r}")
    return w, got


def main(argv=None, device=None, overrides=None) -> int:
    """`device` and `overrides` (manifest, cfg, traffic, work) are for the
    harness's tests: they skip the look for a card."""
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    overrides = overrides or {}
    man = overrides.get("manifest") or harness.manifest(ROOT)
    errs = harness.validate(man)
    if errs:
        log("BENCHMARK.json: " + "; ".join(errs))
        return 2
    w, got = load(man, args.workload, overrides)
    if w["chips"] != 1:  # no driver launches ranks on more cards yet
        log(f"{args.workload} asks for {w['chips']} cards; the drivers run on one")
        return 2
    if device is None:
        if not torch.cuda.is_available():
            log(f"{args.workload} needs a CUDA device; none available")
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    ctx = types.SimpleNamespace(args=args, cfg=got["cfg"], traffic=got["traffic"],
                                work=got["work"], device=device, t0=T0, log=log, root=ROOT)
    driver = importlib.import_module(f"benchmark.drivers.{got['traffic']['kind']}")
    out = driver.run(ctx)
    result = dict(correct=bool(out["correct"]), attempted=int(out["attempted"]),
                  failed=int(out["failed"]))
    metrics = {}
    if not args.trace:
        for m in harness.metrics_for(man, "end_to_end", args.workload):
            value, unit = out["end_to_end"][m["name"]]
            metrics[m["name"]] = {"value": float(value), "unit": unit}
    else:
        sl = out.get("slice")
        name = torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu"
        rctx = types.SimpleNamespace(
            slice=sl, plan=out.get("plan"), out=out, cfg=ctx.cfg, traffic=ctx.traffic,
            kind=ctx.traffic["kind"], kernels=harness.kernels(), peak=harness.peaks(name))
        for m in harness.metrics_for(man, "per_layer", args.workload):
            value = harness.reader(m["name"])(rctx) if sl is not None else None
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result["metrics"] = metrics
    dev = {"platform": "gpu" if torch.cuda.is_available() else "cpu",
           "kind": torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu",
           "count": 1, "memory_peak_bytes": int(out["peak"])}
    if args.trace and out.get("slice") is not None:
        sl = out["slice"]
        dev["busy_s"] = sl.busy_ns() / 1e9
        dev["window_s"] = sl.wall_ns / 1e9
        result["breakdown"] = sl.breakdown()
    result["device"] = dev
    result["card"] = card_line() if torch.cuda.is_available() else "cpu"
    result["checks"] = out["checks"]
    bad = forbidden_modules()
    if bad:
        log(f"modules loaded that the benchmark must not load: {', '.join(bad)}")
        return 3
    for k, c in out["checks"].items():
        log(f"check {k} = {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
