"""The program's own spans and counters (`hallo_tpu_torch/utils/profiling.py`)
as the per-layer metrics read them.

The program names its profiler ranges `hallo.*`: `hallo.wait.<site>`
around each call that blocks the host on the card, `hallo.train.*` around
the train step's phases, and more (PERF.md, section 3). They are host
operations' ranges (no device-side copy), which `trace.Slice` files among
its `host` operations whether or not the profiler gives each event's
activity type. The counters are the program's `profiling.counters()`,
over the whole run. Where the program has no such range or counter (a
checkout older than them), each reader returns None.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from benchmark import trace as tr

PREFIX = "hallo."
WAIT = "hallo.wait."


def ranges(sl, match) -> List[Tuple[int, int]]:
    """The (start, end) of the slice's program ranges whose name passes
    `match`, sorted."""
    return sorted((s, e) for s, e, name in sl.host if name.startswith(PREFIX) and match(name))


def _merged(rs: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Sorted ranges merged where they overlap, as `Slice._inside` takes them."""
    out: List[list] = []
    for s, e in rs:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def sync_idle_pct(sl) -> Optional[float]:
    """100 x the device-idle gaps of the slice that open while the host is
    inside a `hallo.wait.*` range, over the slice's wall span; None where
    the slice holds no program range."""
    if not ranges(sl, lambda n: True) or sl.wall_ns <= 0:
        return None
    waits = _merged(ranges(sl, lambda n: n.startswith(WAIT)))
    gaps = tr.gaps([(s, e) for s, e, _, _ in sl.device], sl.lo, sl.hi)
    return 100.0 * sum(e - s for s, e in gaps if sl._inside(s, waits)) / sl.wall_ns


def device_ms_per_span(sl, name: str) -> Optional[float]:
    """Device ms of the kernels, copies and sets launched inside the ranges
    `name`, per such range; None where there is none."""
    rs = ranges(sl, lambda n: n == name)
    if not rs:
        return None
    merged = _merged(rs)
    ns = sum(e - s for s, e, _, t in sl.device if sl._inside(t, merged))
    return ns / len(rs) / 1e6


def counters() -> Optional[Dict[str, int]]:
    """The program's counters, or None where it has none."""
    try:
        from hallo_tpu_torch.utils.profiling import counters as read
    except ImportError:
        return None
    return read()


def waits_per(counts: Optional[Dict[str, int]], *keys: str) -> Optional[float]:
    """The `wait.*` counters' sum over the sum of the counters `keys`."""
    if not counts:
        return None
    per = sum(counts.get(k, 0) for k in keys)
    waits = sum(v for k, v in counts.items() if k.startswith("wait."))
    return waits / per if per else None
