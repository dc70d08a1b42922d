"""Tracing, stage timings and the training metrics log (counterpart of
hallo_tpu/utils/profiling.py, without the TensorBoard writer).

- `trace(log_dir)`: torch.profiler over the enclosed block (the host's
  activity, and the card's where there is one), written to
  `log_dir/trace.json` as a Chrome trace (chrome://tracing, Perfetto).
- `summarize_device_time(trace_dir)`: that file read back into device time
  by category and by kernel, as JAX's `summarize_hlo_stats` reads its
  xplane. The categories follow the layers of PERF.md: the port's kernels
  K1-K9 by their symbols in `csrc/`, then GEMM, convolution, norms,
  elementwise work, copies, NCCL and the rest.
- `card_line()`: the card's name and power limit, written beside every
  figure taken on it.
- `span(name)`, `wait(site)`, `count(name)`, `counters()`: the program's
  own spans and counters. A span is a profiler range while a profiler
  records (a host range of the trace, on the device trace's clock), and a
  shared no-op context otherwise: one boolean check, no synchronisation,
  no device value read. Nesting on a thread gives each span's parent. The
  range is an operation's (`RecordFunctionFast`), not a user
  annotation: the profiler gives a user annotation a device-side copy
  over the kernels launched inside it, which a reader of events that lack
  their activity type (PyTorch 2.11's) counts as device work. `wait(site)`
  wraps a call that blocks the host until the card's queue drains: the
  span `hallo.wait.<site>` and the counter `wait.<site>`. The counters are
  always on (an integer add); `counters()` merges them with the ops'
  launch tables (`launch.<kernel>`). The spans, the counters and the
  metrics that read them are listed in PERF.md, section 3.
- `StageTimer`, `MetricsLogger`: host stage timings and metrics.jsonl.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import re
import subprocess
import time
from collections import defaultdict
from typing import Any, Dict, Iterator, Optional

import torch

TRACE_FILE = "trace.json"

# (category, pattern) in the order they are tried on a device event's name.
# The port's kernels first (K7 is K2's kernel at another layout, so the two
# share a symbol); convolution before GEMM (cuDNN's implicit GEMMs carry
# both words; its NCHW/NHWC transposes count as the convolution's); copies
# before elementwise work (PyTorch's copies run as elementwise kernels).
# "norms" holds every reduction: the port's GroupNorm and LayerNorm are
# reduce kernels plus elementwise work, and nothing else on the main path
# reduces at any size.
DEVICE_CATEGORIES = (
    ("K1 flash_fwd_sm90", r"flash_fwd_sm90_kernel"),
    ("K2/K7 temporal_sm90", r"temporal_sm90_kernel"),
    ("K3 flash_fwd_t_sm90", r"flash_fwd_t_sm90_kernel"),
    ("K4 flash_fwd_d512", r"flash_fwd_d512_kernel"),
    ("K5 flash_bwd_sm90", r"flash_bwd_(dkv|dq)_sm90_kernel"),
    ("K6 flash_int8_sm90", r"flash_int8_sm90_kernel|int8_prelude_kernel"),
    ("K8 winograd", r"winograd_kernel"),
    ("K9 layout_copy", r"layout_copy_kernel"),
    ("nccl", r"nccl"),
    ("convolution", r"conv(?!ert)|fprop|dgrad|wgrad|cudnn|nchwtonhwc|nhwctonchw"),
    ("gemm", r"gemm|gemv|nvjet|cublas|cutlass|xmma|splitkreduce"),
    ("norms", r"_norm|reduce|welford"),
    ("copies", r"copy|memcpy|memset|catarray|index|gather|scatter|upsample|transpose"),
    ("elementwise", r"elementwise|vectorized|unrolled"),
)
_CATEGORY_RES = tuple((name, re.compile(pat, re.IGNORECASE)) for name, pat in DEVICE_CATEGORIES)
# Chrome-trace categories of the card's work
DEVICE_EVENT_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the device-side spans of `record_function` ranges (c10d's "nccl:all_gather"
# among them): they overlap the kernels they hold, so they are kept apart
ANNOTATION_CAT = "gpu_user_annotation"


_COUNTS: collections.Counter = collections.Counter()
_NOOP = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled


def span(name: str):
    """A profiler range named `name` while a profiler records, else a
    shared no-op context."""
    if not _profiling():
        return _NOOP
    return torch._C._profiler._RecordFunctionFast(name)


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name`."""
    _COUNTS[name] += n


def wait(site: str):
    """The span `hallo.wait.<site>` around a call that blocks the host on
    the card, counted under `wait.<site>`."""
    _COUNTS["wait." + site] += 1
    return span("hallo.wait." + site)


def counters() -> collections.Counter:
    """A snapshot of the counters, with each op's launch count as
    `launch.<kernel>` (`ops/flash.py`, `temporal.py`, `layout.py`,
    `winograd.py`, `parallel/collectives.py`)."""
    from hallo_tpu_torch.ops import flash, layout, temporal, winograd
    from hallo_tpu_torch.parallel import collectives

    out = collections.Counter(_COUNTS)
    for table in (flash.LAUNCHES, temporal.LAUNCHES, layout.LAUNCHES, winograd.LAUNCHES,
                  collectives.LAUNCHES):
        out.update({"launch." + k: v for k, v in table.items()})
    return out


def card_line() -> str:
    """nvidia-smi's name and power limit of the cards, one line each."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def device_category(name: str) -> str:
    """The `DEVICE_CATEGORIES` entry of a device event's name, else "other"."""
    return next((cat for cat, pat in _CATEGORY_RES if pat.search(name)), "other")


def short_name(name: str, width: int = 100) -> str:
    """A kernel's name without its leading `void ` and argument list."""
    name = name[5:] if name.startswith("void ") else name
    return name.split("(")[0][:width] or name[:width]


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """torch.profiler over the enclosed block, with CPU and (when CUDA is
    available) CUDA activities; the card is synchronised before the
    profiler stops, and the Chrome trace goes to `log_dir/TRACE_FILE`.
    Yields the profiler, whose `key_averages()` stay readable after."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def summarize_device_time(trace_dir: str, top_n: int = 12) -> Dict[str, Any]:
    """Device time from the Chrome trace `trace` wrote (`trace_dir` or the
    file itself), over the card's kernel, memcpy and memset events only:
    `total_ms` (the sum of their durations: the device's busy time),
    `by_category_ms` and `launches_by_category` (`device_category`), and the
    `top_n` kernels by time (`top_ops_ms`, by `short_name`); also
    `launch_calls`, the host's kernel-launch calls (cudaLaunchKernel and
    kin), and the device spans of annotated ranges by name
    (`annotations_ms`, `annotation_counts`), outside the total. Raises
    FileNotFoundError when there is no trace."""
    path = trace_dir if os.path.isfile(trace_dir) else os.path.join(trace_dir, TRACE_FILE)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {TRACE_FILE} under {trace_dir}")
    with open(path) as fh:
        events = json.load(fh).get("traceEvents", [])
    by_cat: Dict[str, float] = defaultdict(float)
    counts: Dict[str, int] = defaultdict(int)
    by_op: Dict[str, float] = defaultdict(float)
    spans: Dict[str, float] = defaultdict(float)
    span_counts: Dict[str, int] = defaultdict(int)
    total = 0.0
    launches = 0
    for e in events:
        cat, name = e.get("cat"), e.get("name", "")
        if cat == "cuda_runtime" or cat == "cuda_driver":
            launches += "LaunchKernel" in name
            continue
        if cat == ANNOTATION_CAT and e.get("ph") == "X":
            spans[name] += float(e.get("dur", 0.0))
            span_counts[name] += 1
            continue
        if cat not in DEVICE_EVENT_CATS or e.get("ph") != "X":
            continue
        us = float(e.get("dur", 0.0))
        total += us
        c = device_category(name)
        by_cat[c] += us
        counts[c] += 1
        by_op[short_name(name)] += us

    def ms_desc(d, n=None):
        return dict(sorted(((k, v / 1e3) for k, v in d.items()), key=lambda kv: -kv[1])[:n])

    return {
        "total_ms": total / 1e3,
        "by_category_ms": ms_desc(by_cat),
        "launches_by_category": {k: counts[k] for k in ms_desc(by_cat)},
        "top_ops_ms": ms_desc(by_op, top_n),
        "launch_calls": launches,
        "annotations_ms": ms_desc(spans),
        "annotation_counts": dict(span_counts),
    }


class StageTimer:
    """Named wall-clock stage timers with a summary dict. With a CUDA
    `device`, each stage ends with a `torch.cuda.synchronize`, so that a
    stage's seconds hold the device work it queued."""

    def __init__(self, device: Optional[torch.device] = None) -> None:
        self.device = None if device is None else torch.device(device)
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.device is not None and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, Any]:
        return {
            name: {
                "total_s": round(total, 4),
                "count": self.counts[name],
                "mean_s": round(total / self.counts[name], 4),
            }
            for name, total in self.totals.items()
        }


class MetricsLogger:
    """Appends one JSON line per `log` call to out_dir/metrics.jsonl:
    {"step": ..., "ts": unix seconds, <scalars as floats>}."""

    def __init__(self, out_dir: str) -> None:
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, "metrics.jsonl")

    def log(self, step: int, **scalars: float) -> None:
        record = {"step": step, "ts": time.time()}
        record.update({key: float(value) for key, value in scalars.items()})
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")
