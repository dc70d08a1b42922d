"""Milliseconds of K2 (frame-axis attention) and K9 (the layout copy) on the
card at the main path's shapes, beside one PyTorch call on the same inputs.

    python -m hallo_tpu_torch.ops.bench_temporal [--iters 20] [--repeats 5]

K2 (`temporal.temporal_attention`, 8 heads, bf16) at the 512^2 denoiser's
four levels (B 2, F 18: 16 clip + 2 motion frames), training's level 0 (B
1, F 16), F 17 and F 32 at level 1 and 0, and K7's two test cases; K9
(`layout.layout_anchor`) at the level-0 activation (131072, 320) bf16
beside `clone`. Each case gives `ms`, launches back to back after a
warm-up (CUDA events: the host's enqueue included, as chip_smoke.py times
them), `graph_ms`, the same launches replayed from a CUDA graph (the
device's time alone), each the median over `--repeats` runs of the mean of
`--iters` launches, and `host_us`, the host's microseconds a call (host
clock, no synchronisation inside). It uses only entry points that every
tree of the port has, so it also times an older tree when copied into it:
compare two versions only on one card in one sitting, in turns. It prints
the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import torch

from hallo_tpu_torch.ops import layout, temporal

K2_CASES = (  # name, (B, F, L, C), heads
    ("level 0", (2, 18, 4096, 320), 8), ("level 1", (2, 18, 1024, 640), 8),
    ("level 2", (2, 18, 256, 1280), 8), ("level 3", (2, 18, 64, 1280), 8),
    ("training level 0", (1, 16, 4096, 320), 8), ("F 17 level 1", (2, 17, 1024, 640), 8),
    ("F 32 level 0", (2, 32, 4096, 320), 8), ("K7 B 1 F 6 d 8", (1, 6, 256, 16), 2),
    ("K7 B 2 F 5 d 16", (2, 5, 200, 32), 2),
)


def _events_ms(run, repeats: int) -> float:
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def timings(fn, iters: int, repeats: int) -> dict:
    """`ms` and `graph_ms` of one call of `fn` (see the module's doc) and
    its host microseconds."""
    fn()
    torch.cuda.synchronize()

    def loop():
        for _ in range(iters):
            fn()

    ms = _events_ms(loop, repeats) / iters
    t0 = time.perf_counter()
    loop()
    host_us = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        fn()
        torch.cuda.synchronize()
        with torch.cuda.graph(graph, stream=stream):
            loop()
    torch.cuda.synchronize()
    graph_ms = _events_ms(graph.replay, repeats) / iters
    return dict(ms=round(ms, 5), graph_ms=round(graph_ms, 5), host_us=round(host_us, 2))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_temporal: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    result = {}
    with torch.no_grad():
        for name, shape, heads in K2_CASES:
            q, k, v = (torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)
                       for _ in range(3))
            result[f"K2 {name}"] = timings(
                lambda: temporal.temporal_attention(q, k, v, heads=heads), args.iters,
                args.repeats)
            del q, k, v
        x = torch.randn(131072, 320, generator=gen, device=dev).to(torch.bfloat16)
        result["K9 (131072, 320)"] = timings(lambda: layout.layout_anchor(x), args.iters,
                                             args.repeats)
        result["clone (131072, 320)"] = timings(lambda: x.clone(), args.iters, args.repeats)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "ms": result}), flush=True)


if __name__ == "__main__":
    main()
