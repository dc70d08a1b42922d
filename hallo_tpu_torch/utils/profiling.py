"""Stage timings and the training metrics log (counterpart of
hallo_tpu/utils/profiling.py's `StageTimer` and `MetricsLogger`, without
the profiler trace and the TensorBoard writer)."""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict, Iterator, Optional

import torch


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
