"""Model FLOPs of the work dispatched to the card in the window (each clip's
conditioning, each denoiser evaluation and each decode, counted by the
harness's hooks, at the reference's count at the cell's shapes in the
program's plan) over the window's seconds times the card's peak bf16 rate,
in percent."""


def read(ctx):
    if ctx.kind != "infer" or ctx.peak is None or ctx.plan is None or not ctx.out["work"]:
        return None
    w, plan = ctx.out["work"], ctx.plan
    flops = (w["clips"] * plan["conditioning"][0] + w["evals"] * plan["eval"][0]
             + w["decodes"] * plan["decode"][0])
    return 100.0 * flops / (ctx.out["window_s"] * ctx.peak["bf16_flops"])
