"""The program's `wait.*` counters over its denoiser evaluations
(`denoiser.eval.full` + `denoiser.eval.cond`), over the whole run
(`profiling.counters()`, `pipelines/face_animate.py`). The run's warm-up
request is counted too, and each request's copies weigh on the clips the
window happens to hold, so the ratio moves with the window's length."""

from benchmark import program


def read(ctx):
    if ctx.kind != "infer":
        return None
    return program.waits_per(program.counters(), "denoiser.eval.full", "denoiser.eval.cond")
