"""Host kernel-launch calls in the traced train step (`train/step.py`)."""


def read(ctx):
    if ctx.kind != "train":
        return None
    steps = ctx.slice.span_count("train_step")
    n = len(ctx.slice.launches)
    return n / steps if steps and n else None
