"""Device ms of the kernels launched inside the VAE encoder's and decoder's
spans (`models/vae.py`), per decoded clip, in the traced clip."""


def read(ctx):
    if ctx.kind != "infer":
        return None
    clips = ctx.slice.span_count("vae.decoder")
    ns = ctx.slice.span_device_ns("vae.encoder") + ctx.slice.span_device_ns("vae.decoder")
    return ns / clips / 1e6 if clips and ns else None
