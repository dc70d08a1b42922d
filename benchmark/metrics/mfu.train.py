"""Model FLOPs of the steps completed in the window (the reference's forward
and backward at the cell's shapes, without the checkpoints' replays) over
the window's seconds times the card's peak bf16 rate, in percent."""


def read(ctx):
    if ctx.kind != "train" or ctx.peak is None or ctx.plan is None:
        return None
    flops = ctx.out["steps"] * ctx.plan["step_flops"]
    return 100.0 * flops / (ctx.out["window_s"] * ctx.peak["bf16_flops"])
