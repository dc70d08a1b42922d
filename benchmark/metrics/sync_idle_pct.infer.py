"""100 x the device-idle gaps of the traced clip that open while the host is
inside a `hallo.wait.*` span (a call that blocks on the card,
`pipelines/face_animate.py`), over the slice's wall span: the part of
`device_idle_pct.infer` that the host's waits explain; the rest is
dispatch-bound."""

from benchmark import program


def read(ctx):
    return program.sync_idle_pct(ctx.slice) if ctx.kind == "infer" else None
