"""Device time of one denoiser step by category (counterpart of
scripts/profile_step.py).

    python -m hallo_tpu_torch.profile_step [--loops 3] [--top 20]
        [--trace-dir .cache/profile_step]

The full-width models (random weights from a seed, bf16) run `--loops`
denoiser forwards in a row at 512^2, CFG batch 2, 16 + 2 frames, with
`cfg_split` as the pipeline calls it, each output the next input; one
warm-up pass first, then the same loop under `utils.profiling.trace`. It
prints the card's name and power limit, then one JSON line:
`summarize_device_time`'s total, categories (K1-K9, GEMM, convolution,
norms, elementwise, copies, NCCL, other), launches and top kernels, with
`ms_per_step_device` (device busy ms a forward), the profiled wall ms a
forward and the device's busy share of it. Without a card it exits
non-zero; `profile` takes any models and device (on the CPU the trace holds
no device time and the device fields are null).
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Any, Dict, Optional, Sequence

import torch

from hallo_tpu_torch.utils import profiling
from hallo_tpu_torch.utils.factory import build_models

SIZE, FRAMES, MOTION, CFG_BATCH = 512, 16, 2, 2


def step_inputs(models, size: int, frames: int, device: torch.device) -> Dict[str, Any]:
    """The denoiser's arguments at the pipeline's shapes for CFG batch 2:
    zero latents through the ReferenceNet for the reference and motion
    features, zero identity and audio tokens and face condition, all-ones
    masks."""
    den = models.denoising_net
    dtype = den.conv_in.weight.dtype
    hl = wl = size // 8
    tokens = models.image_proj.config.clip_extra_context_tokens
    ctx = torch.zeros((CFG_BATCH, tokens, den.config.cross_attention_dim), dtype=dtype,
                      device=device)
    one_m = 1 + MOTION
    with torch.inference_mode():
        _, feats = models.reference_net(
            torch.zeros((CFG_BATCH * one_m, 4, hl, wl), dtype=dtype, device=device),
            torch.zeros((), device=device), ctx.repeat(one_m, 1, 1))
    split = {k: [x.unflatten(0, (CFG_BATCH, one_m)) for x in v] for k, v in feats.items()}
    ap = models.audio_proj.config
    return dict(
        context=ctx,
        ref_features={k: [x[:, 0] for x in v] for k, v in split.items()},
        motion_features={k: [x[:, 1:] for x in v] for k, v in split.items()},
        audio_context=torch.zeros((CFG_BATCH, frames, ap.context_tokens,
                                   den.config.audio_attention_dim), dtype=dtype, device=device),
        face_cond=torch.zeros((CFG_BATCH, frames, den.config.block_out_channels[0], hl, wl),
                              dtype=dtype, device=device),
        masks=tuple(tuple(torch.ones((CFG_BATCH * frames, (hl >> d) * (wl >> d)), dtype=dtype,
                                     device=device) for _ in range(3)) for d in range(4)),
        motion_scale=torch.ones(3, device=device),
    )


def profile(models, size: int, frames: int, loops: int, trace_dir: str,
            top: int = 20) -> Dict[str, Any]:
    """`loops` denoiser forwards of `models` at `size`^2 and `frames`
    frames, once to warm up, then under `profiling.trace(trace_dir)`: the
    summary with the per-forward figures (device figures only on a card)."""
    den = models.denoising_net
    device = den.conv_in.weight.device
    dtype = den.conv_in.weight.dtype
    cuda = device.type == "cuda"
    kw = step_inputs(models, size, frames, device)
    lat0 = torch.zeros((CFG_BATCH, frames, 4, size // 8, size // 8), dtype=dtype, device=device)
    t = torch.tensor(500, device=device)

    @torch.inference_mode()
    def loop() -> None:
        x = lat0
        for _ in range(loops):
            x = den(x, t, cfg_split=True, **kw).to(x.dtype)
        x.float().sum().item()

    t0 = time.perf_counter()
    loop()
    first = time.perf_counter() - t0
    with profiling.trace(trace_dir):
        t0 = time.perf_counter()
        loop()
        wall_ms = (time.perf_counter() - t0) * 1e3
    stats = profiling.summarize_device_time(trace_dir, top_n=top)
    stats.update(
        device=torch.cuda.get_device_name(device) if cuda else str(device),
        loops=loops, size=size, frames=frames, first_loop_s=first,
        wall_ms_per_step=wall_ms / loops,
        ms_per_step_device=stats["total_ms"] / loops if cuda else None,
        busy_share=stats["total_ms"] / wall_ms if cuda else None,
    )
    return stats


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--loops", type=int, default=3)
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--trace-dir", default=".cache/profile_step")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: no CUDA device")
    print(profiling.card_line(), flush=True)
    dev = torch.device("cuda", 0)
    models = build_models("full", device=dev, dtype=torch.bfloat16, seed=0)
    stats = profile(models, SIZE, FRAMES, args.loops, args.trace_dir, args.top)
    print(json.dumps(stats), flush=True)
    return stats


if __name__ == "__main__":
    main()
