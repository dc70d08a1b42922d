"""Device ms of the kernels launched inside the denoiser's forward spans,
per evaluation (`models/unet_denoise.py`), in the traced clip."""


def read(ctx):
    if ctx.kind != "infer":
        return None
    evals = ctx.slice.span_count("denoising_net")
    ns = ctx.slice.span_device_ns("denoising_net")
    return ns / evals / 1e6 if evals and ns else None
