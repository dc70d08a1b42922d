"""100 x the device-idle gaps of the traced train step that open while the
host is inside a `hallo.wait.*` span (`train/step.py`, `train/state.py`),
over the slice's wall span: the part of `device_idle_pct.train` that the
host's waits explain."""

from benchmark import program


def read(ctx):
    return program.sync_idle_pct(ctx.slice) if ctx.kind == "train" else None
