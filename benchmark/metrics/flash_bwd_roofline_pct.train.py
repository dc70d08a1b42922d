"""K5's share of its roofline (both passes) in the traced train step
(`kernels/flash_bwd_sm90.json`)."""

from benchmark import harness


def read(ctx):
    return harness.roofline(ctx, "flash_bwd_sm90") if ctx.kind == "train" else None
