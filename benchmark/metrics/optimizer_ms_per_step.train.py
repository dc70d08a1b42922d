"""Device ms of the kernels launched inside the span `hallo.train.optimizer`
(the gradient's norm and clip, AdamW, the write-back; `train/step.py`), per
such span, in the traced train step."""

from benchmark import program


def read(ctx):
    if ctx.kind != "train":
        return None
    return program.device_ms_per_span(ctx.slice, "hallo.train.optimizer")
