"""Training metrics log (counterpart of hallo_tpu/utils/profiling.py's
`MetricsLogger`, without the TensorBoard writer)."""

from __future__ import annotations

import json
import os
import time


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
