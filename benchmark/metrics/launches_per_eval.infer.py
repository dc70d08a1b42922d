"""Host kernel-launch calls in the traced clip per denoiser evaluation
(pipeline dispatch, `pipelines/face_animate.py`): every launch of the clip,
the conditioning and the VAE included, over its evaluations."""


def read(ctx):
    if ctx.kind != "infer":
        return None
    evals = ctx.slice.span_count("denoising_net")
    n = len(ctx.slice.launches)
    return n / evals if evals and n else None
