"""Milliseconds of the flash-attention kernels K1, K5 and K4 on the card at
the main path's shapes, beside PyTorch's SDPA on the same inputs.

    python -m hallo_tpu_torch.ops.bench_flash [--iters 20] [--repeats 3]
        [--k4-only]

K1 at level 0 (B 2, Lq 4096, Lk 8192, C 320, 8 heads of d 40) without LSE,
then K1 with its LSE and K5's two passes (`flash_bwd_dkv`, `flash_bwd_dq`)
at the five attentions of a 512^2 step, B 14 (levels 0-2 with the
CFG-uncond bias on the ref half of half the batch, audio Lk 32, identity
Lk 4); K4, the VAE mid-block's attention (one head of d 512, L 4096) at
B 3 (the encode) and B 16 (the decode), and at d 128 (B 2, 4 heads, L
2048) and d 256 (B 2, 2 heads, L 2048); each the median over `--repeats`
runs of the mean of `--iters` launches after a warm-up (CUDA events); a
shape the kernel refuses gets its error in place of a time.
`--k4-only` times K4 alone. It uses only the entry points
that every tree of the port since K5's first port has, so it also times
an older tree when copied into it: compare two versions only within one
machine session, in turns. It prints the card's name and power limit,
then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import torch
import torch.nn.functional as F

from hallo_tpu_torch.ops import flash

SHAPES = (  # name, B, Lq, Lk, C, the CFG-uncond bias
    ("level 0", 14, 4096, 8192, 320, True), ("level 1", 14, 1024, 2048, 640, True),
    ("level 2", 14, 256, 512, 1280, True), ("audio", 14, 4096, 32, 320, False),
    ("identity", 14, 4096, 4, 320, False),
)

K4_SHAPES = (  # name, (B, H, L, d)
    ("K4 B 3", (3, 1, 4096, 512)), ("K4 B 16", (16, 1, 4096, 512)),
    ("K4 d 128", (2, 4, 2048, 128)), ("K4 d 256", (2, 2, 2048, 256)),
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
    ap.add_argument("--k4-only", action="store_true", help="time K4 alone")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_flash: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    def ms(fn):
        return _ms(fn, args.iters, args.repeats)

    result = {}
    for name, shape in K4_SHAPES:
        q, k, v = (randn(*shape) for _ in range(3))
        try:
            k4 = ms(lambda: flash.flash_attention(q, k, v))
        except ValueError as exc:  # an older tree's kernel that does not take this d
            k4 = str(exc)
        result[name] = dict(k4=k4, sdpa=ms(lambda: F.scaled_dot_product_attention(q, k, v)))
        del q, k, v
    if args.k4_only:
        print(json.dumps({"device": torch.cuda.get_device_name(0), "ms": result}), flush=True)
        return
    q, k, v = randn(2, 4096, 320), randn(2, 8192, 320), randn(2, 8192, 320)
    with torch.no_grad():
        result["K1 level 0 B 2"] = ms(lambda: flash.flash_attention_packed(q, k, v, heads=8))
    for name, b, lq, lk, c, with_bias in SHAPES:
        q, k, v, g = randn(b, lq, c), randn(b, lk, c), randn(b, lk, c), randn(b, lq, c)
        bias = None
        if with_bias:
            bias = torch.zeros(b, lk, device=dev)
            bias[: b // 2, lk // 2:] = -1e9
        out, lse = flash.flash_forward_packed(q, k, v, 8, bias, with_lse=True)
        a = flash.backward_args(q, k, v, bias, out, lse, g, 8)
        row = dict(
            k1_lse=ms(lambda: flash.flash_forward_packed(q, k, v, 8, bias, with_lse=True)),
            k5_dkv=ms(lambda: flash.flash_bwd_dkv(a)), k5_dq=ms(lambda: flash.flash_bwd_dq(a)))

        def heads_major(t):
            return t.unflatten(2, (8, c // 8)).transpose(1, 2)

        qh, kh, vh = (heads_major(t).detach().requires_grad_() for t in (q, k, v))
        mask = None if bias is None else bias[:, None, None, :].to(q.dtype)
        oh = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)
        gh = heads_major(g)
        row["sdpa_bwd"] = ms(lambda: torch.autograd.grad(oh, (qh, kh, vh), gh, retain_graph=True))
        result[name] = row
        del q, k, v, g, out, lse, a, oh, qh, kh, vh
        torch.cuda.empty_cache()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "ms": result}), flush=True)


if __name__ == "__main__":
    main()
