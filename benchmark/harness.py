"""The benchmark's data: `BENCHMARK.json` at the checkout's root, and the
files it names, found by name:

- `benchmark/configs/<config>.json`: a configuration as it is run;
- `benchmark/traffic/<traffic>.json`: a traffic mix (its `kind` names the
  driver, `benchmark/drivers/<kind>.py`);
- `benchmark/workloads/<cell>.json`: a cell's check (the numbers compared
  and their limits), beside what BENCHMARK.json says of it;
- `benchmark/metrics/<metric>.py`: a per-layer metric's reader, `read(ctx)`,
  which returns a number or None when the slice holds nothing to read;
- `benchmark/kernels/<kernel>.json`: a kernel's symbols, the work it does
  (a kind of the reference's attention calls) and its bound formulas.

Also the manifest's rules (names, units, keys).
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
            "per_layer"}
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"},
}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def manifest(root: str) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def _line(s) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def validate(man: dict) -> List[str]:
    """The manifest's faults against the benchmark contract's rules of form."""
    errs = []
    if set(man) != TOP_KEYS:
        errs.append(f"top-level keys {sorted(man)}")
    if not (isinstance(man.get("run_seconds"), int) and 1 <= man["run_seconds"] <= 51):
        errs.append("run_seconds")
    cmd = man.get("command", [])
    if not (isinstance(cmd, list) and 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)):
        errs.append("command")
    for p in man.get("paths", []):
        if not re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) or p.startswith("/") or ".." in p:
            errs.append(f"path {p!r}")
    names = set()
    limits = {"configs": 24, "workloads": 24, "end_to_end": 16, "per_layer": 128}
    for section, keys in ENTRY_KEYS.items():
        entries = man.get(section, [])
        if not 1 <= len(entries) <= limits[section]:
            errs.append(f"{section}: {len(entries)} entries")
        seen = set()
        for e in entries:
            required = keys - {"workloads"} if section != "workloads" else keys
            if not required <= set(e) <= keys:
                errs.append(f"{section} {e.get('name')}: keys {sorted(e)}")
            n = e.get("name", "")
            if not NAME.match(n) or n in seen:
                errs.append(f"{section} name {n!r}")
            seen.add(n)
            if section in ("end_to_end", "per_layer"):
                if n in names:
                    errs.append(f"metric {n!r} twice")
                names.add(n)
                if not UNIT.match(e.get("unit", "")):
                    errs.append(f"{n}: unit {e.get('unit')!r}")
                if e.get("better") not in ("lower", "higher"):
                    errs.append(f"{n}: better")
                if e.get("source") not in SOURCES:
                    errs.append(f"{n}: source")
            for k in ("why", "layer"):
                if k in e and not _line(e[k]):
                    errs.append(f"{n}: {k}")
            if section == "configs" and not _line(e.get("source")):
                errs.append(f"{n}: source")
    for e in man.get("end_to_end", []):
        if e.get("source") not in ("host_clock", "device_trace"):
            errs.append(f"{e['name']}: end-to-end source")
        b = e.get("bound")
        if not (isinstance(b, (int, float)) and 0.01 <= b <= 0.25):
            errs.append(f"{e['name']}: bound {b!r}")
    if "setup_s" not in {e.get("name") for e in man.get("end_to_end", [])}:
        errs.append("no setup_s")
    cfgs = {c["name"] for c in man.get("configs", [])}
    e2e = {e["name"] for e in man.get("end_to_end", [])}
    cells = {w["name"] for w in man.get("workloads", [])}
    pairs = set()
    for w in man.get("workloads", []):
        if w.get("config") not in cfgs:
            errs.append(f"{w['name']}: config")
        if w.get("chips") not in (1, 4):
            errs.append(f"{w['name']}: chips")
        if not NAME.match(str(w.get("traffic", ""))):
            errs.append(f"{w['name']}: traffic")
        pair = (w.get("config"), w.get("traffic"))
        if pair in pairs:
            errs.append(f"{w['name']}: config and traffic twice")
        pairs.add(pair)
    for c in man.get("configs", []):
        if not all(NAME.match(k) for k in c.get("reduced", [])) or len(c.get("reduced", [])) > 16:
            errs.append(f"{c['name']}: reduced")
    for m in man.get("per_layer", []):
        if m.get("moves") not in e2e:
            errs.append(f"{m['name']}: moves")
    for m in man.get("end_to_end", []) + man.get("per_layer", []):
        if not set(m.get("workloads", [])) <= cells:
            errs.append(f"{m['name']}: workloads")
    if len(json.dumps(man)) > 64 * 1024:
        errs.append("larger than 64 KiB")
    return errs


def cell(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(man: dict, name: str) -> dict:
    for c in man["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(name)


def metrics_for(man: dict, section: str, cell_name: str) -> List[dict]:
    """The metrics of `section` that the cell reports: those listing it, and
    those with no list that move (or are) an end-to-end metric it reports."""
    mine_e2e = [m for m in man["end_to_end"]
                if "workloads" not in m or cell_name in m["workloads"]]
    if section == "end_to_end":
        return mine_e2e
    names = {m["name"] for m in mine_e2e}
    return [m for m in man["per_layer"]
            if cell_name in m.get("workloads", [])
            or ("workloads" not in m and m["moves"] in names)]


def reader(name: str):
    """`benchmark/metrics/<name>.py`'s `read`."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def kernels() -> Dict[str, dict]:
    d = os.path.join(HERE, "kernels")
    return {f[:-5]: load_json(os.path.join(d, f)) for f in sorted(os.listdir(d))
            if f.endswith(".json")}


def peaks(device_name: str) -> Optional[dict]:
    return load_json(os.path.join(HERE, "peaks.json")).get(device_name)


def bound_s(formula: dict, call: Dict[str, float], peak: dict) -> float:
    """max(ops / peak FLOP/s, bytes / peak bytes/s) of one call."""
    env = {k: float(v) for k, v in call.items()}
    ops = eval(formula["ops"], {"__builtins__": {}}, env)  # noqa: S307 - our own files
    nbytes = eval(formula["bytes"], {"__builtins__": {}}, env)  # noqa: S307
    return max(ops / peak["bf16_flops"], nbytes / peak["hbm_bytes_per_s"])


def roofline(ctx, kernel: str) -> Optional[float]:
    """100 x the sum of the bounds of the kernel's work in the traced slice
    over the device time of its symbols there. The work is the plan's
    attention calls of the kernel's kind, each stage's calls times the
    number of its spans in the slice; None where nothing is there to read."""
    k = ctx.kernels.get(kernel)
    if k is None or ctx.peak is None or ctx.plan is None or ctx.slice is None:
        return None
    bound = 0.0
    for stage, span in ctx.plan["stage_spans"].items():
        n = ctx.slice.span_count(span)
        for kind, b, lq, lk, c, heads, grad in ctx.plan[stage][1]:
            if kind != k["work"] or (k["grad"] and not grad):
                continue
            call = dict(N=b, Lq=lq, Lk=lk, C=c, H=heads)
            bound += n * sum(bound_s(p, call, ctx.peak) for p in k["passes"])
    busy = sum(ctx.slice.kernel_ns(p["symbol"])[0] for p in k["passes"]) / 1e9
    if bound <= 0 or busy <= 0:
        return None
    return 100.0 * bound / busy
