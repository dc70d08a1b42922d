"""100 x (1 - the union of the card's kernel, memcpy and memset intervals
over the traced clip's wall span)."""


def read(ctx):
    if ctx.kind != "infer" or ctx.slice.wall_ns <= 0:
        return None
    return 100.0 * (1.0 - ctx.slice.busy_ns() / ctx.slice.wall_ns)
