"""The traced slice of a run, read from torch.profiler in memory.

`Tracer` starts and stops the profiler around the slice, which it opens and
closes with a synchronised card and marks with a host range named
`SLICE`. `Slice` reduces the events to what the per-layer metrics read:

- the card's busy time as the union of its kernel, memcpy and memset
  intervals inside the slice (work on two streams at once counts once),
  and the slice's wall span (the `SLICE` range);
- device time and counts by category and by kernel symbol (the category
  table is a copy of `hallo_tpu_torch/utils/profiling.py`'s);
- each kernel's host launch time (by correlation id), so that the device
  time of the kernels launched inside a host span (`span_device_ns`) and
  the host's launch calls inside it (`span_launches`) can be read;
- the longest idle gaps, each with the host operation that was running at
  its middle.

Nothing is written to disk.
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

SLICE = "bench.slice"
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
CATEGORIES = (
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
_CAT_RES = tuple((n, re.compile(p, re.IGNORECASE)) for n, p in CATEGORIES)


def category(name: str) -> str:
    return next((c for c, pat in _CAT_RES if pat.search(name)), "other")


def short_name(name: str, width: int = 90) -> str:
    name = name[5:] if name.startswith("void ") else name
    return (name.split("(")[0] or name)[:width]


_RUNTIME = re.compile(r"^(cuda[A-Z_]|cu[A-Z])")


def _kind(e, spans) -> str:
    """The event's activity type; where the event object does not give it
    (older PyTorch), told from its device and name: a device event named
    after a host span is that span's device copy, a host event named after
    one is the span, and the CUDA runtime and driver calls are named cuda*
    and cu*."""
    if hasattr(e, "activity_type"):
        return str(e.activity_type())
    name = e.name()
    if e.device_type() == torch.autograd.DeviceType.CUDA:
        if name in spans:
            return "gpu_user_annotation"
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    if name in spans:
        return "user_annotation"
    return "cuda_runtime" if _RUNTIME.match(name) else "cpu_op"


def union_ns(intervals: List[Tuple[int, int]]) -> int:
    """The length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0)


def gaps(intervals: List[Tuple[int, int]], lo: int, hi: int) -> List[Tuple[int, int]]:
    """The stretches of [lo, hi) that no interval covers."""
    out, cur = [], lo
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [g for g in out if g[1] > g[0]]


class Slice:
    """The reduced events of one traced slice (times in ns)."""

    def __init__(self, events, span_names=()) -> None:
        names = set(span_names) | {SLICE}
        self.lo = self.hi = None
        host, launch_at, device, spans = [], {}, [], defaultdict(list)
        launches = []
        for e in events:
            kind = _kind(e, names)
            name = e.name()
            s, d = e.start_ns(), e.duration_ns()
            if kind in DEVICE_KINDS:
                device.append((s, s + d, name, e.correlation_id()))
            elif kind in ("cuda_runtime", "cuda_driver"):
                launch_at[e.correlation_id()] = s
                if "LaunchKernel" in name or "LaunchCooperativeKernel" in name:
                    launches.append(s)
                host.append((s, s + d, name))
            elif kind == "user_annotation":
                if name == SLICE:
                    self.lo, self.hi = s, s + d
                else:
                    spans[name].append((s, s + d))
            elif kind == "cpu_op":
                host.append((s, s + d, name))
        if self.lo is None:
            kinds: Dict[str, int] = defaultdict(int)
            for e in events:
                kinds[_kind(e, names)] += 1
            raise RuntimeError(f"no {SLICE} range among {len(events)} events: {dict(kinds)}")
        self.device = [(max(s, self.lo), min(e, self.hi), n, launch_at.get(c))
                       for s, e, n, c in device if e > self.lo and s < self.hi]
        self.spans = {k: sorted(v) for k, v in spans.items()}
        self.launches = sorted(t for t in launches if self.lo <= t <= self.hi)
        self.host = sorted(host)
        self._host_starts = [h[0] for h in self.host]

    @property
    def wall_ns(self) -> int:
        return self.hi - self.lo

    def busy_ns(self) -> int:
        return union_ns([(s, e) for s, e, _, _ in self.device])

    def by(self, key) -> Dict[str, Tuple[float, int]]:
        """{key(name): (device ns, events)} over the slice."""
        out: Dict[str, list] = defaultdict(lambda: [0, 0])
        for s, e, n, _ in self.device:
            acc = out[key(n)]
            acc[0] += e - s
            acc[1] += 1
        return {k: (v[0], v[1]) for k, v in out.items()}

    def kernel_ns(self, pattern: str) -> Tuple[int, int]:
        """(device ns, events) of the kernels whose name matches `pattern`."""
        pat = re.compile(pattern)
        hits = [(e - s) for s, e, n, _ in self.device if pat.search(n)]
        return sum(hits), len(hits)

    def span_count(self, name: str) -> int:
        return sum(1 for s, e in self.spans.get(name, ()) if s >= self.lo and e <= self.hi)

    def _inside(self, t: Optional[int], ranges) -> bool:
        if t is None:
            return False
        i = bisect.bisect_right(ranges, (t, float("inf"))) - 1
        return i >= 0 and ranges[i][0] <= t <= ranges[i][1]

    def span_device_ns(self, name: str) -> int:
        """Device time of the kernels launched inside the host spans `name`."""
        ranges = self.spans.get(name, [])
        return sum(e - s for s, e, _, t in self.device if self._inside(t, ranges))

    def host_at(self, t: int) -> str:
        """The innermost host operation running at time t, with the
        innermost benchmark span around it."""
        i = bisect.bisect_right(self._host_starts, t)
        best = None
        for j in range(i - 1, max(-1, i - 4000), -1):
            s, e, n = self.host[j]
            if e >= t and (best is None or e - s < best[1] - best[0]):
                best = (s, e, n)
        around = [k for k, v in self.spans.items() if self._inside(t, v)]
        where = ">".join(sorted(around)) if around else "-"
        return f"{where}:{best[2] if best else 'python'}"

    def idle_gaps(self, n: int = 10) -> List[Tuple[str, float]]:
        gs = gaps([(s, e) for s, e, _, _ in self.device], self.lo, self.hi)
        gs.sort(key=lambda g: g[0] - g[1])
        return [(self.host_at((s + e) // 2), (e - s) / 1e9) for s, e in gs[:n]]

    def breakdown(self) -> dict:
        cats = sorted(self.by(category).items(), key=lambda kv: -kv[1][0])[:5]
        syms = sorted(self.by(short_name).items(), key=lambda kv: -kv[1][0])[:5]
        ops = [[f"cat:{k}", v[0] / 1e9] for k, v in cats] + \
              [[f"sym:{k}", v[0] / 1e9] for k, v in syms]
        return {"device_ops": ops, "idle_gaps": [[k, v] for k, v in self.idle_gaps(10)]}


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class Tracer:
    """Profiles one slice: `start()` and `stop()` each synchronise the card."""

    def __init__(self, span_names=()) -> None:
        self.span_names = tuple(span_names)
        self.prof = None
        self.range = None
        self.slice: Optional[Slice] = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        _sync()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available()
                                         else [])
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.range = torch.autograd.profiler.record_function(SLICE)
        self.range.__enter__()

    def stop(self) -> None:
        if self.prof is None or self.slice is not None:
            return
        _sync()
        self.range.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.slice = Slice(self.prof.profiler.kineto_results.events(), self.span_names)
        self.prof = None


class Spans:
    """Host ranges named after modules, opened and closed by forward hooks
    on them (`record_function`), for the traced run."""

    def __init__(self, modules: Dict[str, torch.nn.Module]) -> None:
        self.handles = []
        for name, mod in modules.items():
            stack: list = []

            def pre(m, args, name=name, stack=stack):
                r = torch.autograd.profiler.record_function(name)
                r.__enter__()
                stack.append(r)

            def post(m, args, out, stack=stack):
                stack.pop().__exit__(None, None, None)

            self.handles += [mod.register_forward_pre_hook(pre),
                             mod.register_forward_hook(post)]

    def remove(self) -> None:
        for h in self.handles:
            h.remove()
