"""Milliseconds of K8, the Winograd 3x3 conv (`csrc/winograd.cu`), on the
card at the denoiser's five 3x3-conv shapes, beside cuDNN on the same inputs.

    python -m hallo_tpu_torch.ops.bench_conv [--iters 20] [--repeats 3]

The shapes are NHWC at CFG batch 32 (2 x 16 frames at 512^2): level 0's
resnet, up-block and concat convs, level 1's resnet and up-block, bf16 with
an fp32 bias. Each time is the median over `--repeats` runs of the mean of
`--iters` launches of the kernel alone (`winograd_launch` on a prepared U)
after a warm-up (CUDA events); cuDNN is one `F.conv2d` on the channels-last
view, the port's yardstick and nothing it calls. It uses only entry points
that every tree of the port since K8's first port has, so it also times an
older tree when copied into it: compare two versions only within one machine session, in turns. It
prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import torch
import torch.nn.functional as F

from hallo_tpu_torch.ops import winograd

SHAPES = (  # name, (N, H, W, C), Co
    ("level 0 resnet", (32, 64, 64, 320), 320), ("level 0 up", (32, 64, 64, 640), 320),
    ("level 0 concat", (32, 64, 64, 960), 320), ("level 1 resnet", (32, 32, 32, 640), 640),
    ("level 1 up", (32, 32, 32, 1280), 640),
)


def _ms(fn, iters: int, repeats: int) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_conv: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    result = {}
    for name, shape, co in SHAPES:
        x = torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)
        k = (torch.randn(3, 3, shape[-1], co, generator=gen, device=dev) / 30).to(torch.bfloat16)
        b = torch.randn(co, generator=gen, device=dev)
        u = winograd.kernel_weights(k, torch.bfloat16)
        xc = x.permute(0, 3, 1, 2)  # NHWC memory is channels-last NCHW: no copy
        wc = k.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        row = dict(k8=_ms(lambda: winograd.winograd_launch(x, u, co, b), args.iters, args.repeats),
                   cudnn=_ms(lambda: F.conv2d(xc, wc, b.to(torch.bfloat16), padding=1),
                             args.iters, args.repeats))
        result[f"{name} {shape} -> {co}"] = row
        del x, k, u, xc, wc
        torch.cuda.empty_cache()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "ms": result}), flush=True)


if __name__ == "__main__":
    main()
