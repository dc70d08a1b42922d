"""K1's share of its roofline in the traced clip (`kernels/flash_fwd_sm90.json`)."""

from benchmark import harness


def read(ctx):
    return harness.roofline(ctx, "flash_fwd_sm90") if ctx.kind == "infer" else None
