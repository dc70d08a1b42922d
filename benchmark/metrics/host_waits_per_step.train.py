"""The program's `wait.*` counters over its train steps (`train.step`), over
the whole run (`profiling.counters()`, `train/step.py`)."""

from benchmark import program


def read(ctx):
    return program.waits_per(program.counters(), "train.step") if ctx.kind == "train" else None
