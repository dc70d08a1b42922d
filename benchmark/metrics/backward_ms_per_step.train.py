"""Device ms of the kernels launched inside the span `hallo.train.backward`
(`torch.autograd.grad`, the checkpoints' replays included;
`train/step.py`), per such span, in the traced train step."""

from benchmark import program


def read(ctx):
    if ctx.kind != "train":
        return None
    return program.device_ms_per_span(ctx.slice, "hallo.train.backward")
