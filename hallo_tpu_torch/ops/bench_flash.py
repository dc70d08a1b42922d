"""Milliseconds of the flash-attention kernels K1, K5, K4, K3 and K6 on the
card at the main path's shapes, beside PyTorch's SDPA on the same inputs.

    python -m hallo_tpu_torch.ops.bench_flash [--iters 20] [--repeats 3]
        [--k4-only | --audio-only]

K1 at level 0 (B 2, Lq 4096, Lk 8192, C 320, 8 heads of d 40) without LSE,
then K1 with its LSE and K5's two passes (`flash_bwd_dkv`, `flash_bwd_dq`)
at the five attentions of a 512^2 step, B 14 (levels 0-2 with the
CFG-uncond bias on the ref half of half the batch, audio Lk 32, identity
Lk 4); K4, the VAE mid-block's attention (one head of d 512, L 4096) at
B 3 (the encode) and B 16 (the decode), and at d 128 (B 2, 4 heads, L
2048) and d 256 (B 2, 2 heads, L 2048); each the median over `--repeats`
runs of the mean of `--iters` launches after a warm-up (CUDA events); a
shape the kernel refuses gets its error in place of a time.
K3 and K6, the wav2vec2 self-attention (B 1, 12 heads of d 64, fp32 q, k
and v through the model's (B, T, H, d) -> (B, H, T, d) view): K3 at L 304
(12 s of audio) and L 1056 (42 s), and with a per-key bias at L 1056; K6
(`flash_attention_int8`) at L 1056, with half the keys at MASK_VALUE, at a
ragged Lk 1050, and at L 4096 (about 2.7 minutes of audio), each with its
prelude and its attention kernel timed apart. Each K3/K6 case gives `ms`
(launches back to back, CUDA events: the host's enqueue included),
`graph_ms` (the same launches replayed from a CUDA graph: the device's time
alone), `host_us` (`ops/bench_temporal.py`'s `timings`), SDPA's `graph_ms`
on the same inputs, and the bound (bytes: q, k, v read once and o written
once in fp32, over 3.35 TB/s; operations: QK^T and PV over 989 TFLOP/s
bf16, K6's QK^T over 1979 TOP/s int8). `--audio-only` times K3 and K6
alone, `--k4-only` K4 alone. `--wav2vec N` times instead what the users
of those kernels wait for: `AudioProcessor.preprocess` (full-width
wav2vec2-base, fp32, random weights from seed 0) on
examples/driving_audios/1.wav tiled to 12 s (K3) and to 42 s under
HALLO_INT8_ATTN=1 (K6), each warmed up at its length, N calls each, and
the wav2vec2 forward alone on the input it prepares, N calls (host clock
around a synchronised call; the tiled WAVs are written under
hallo_tpu_torch/_build/). It uses only the entry points
that every tree of the port since K5's first port has, so it also times
an older tree when copied into it: compare two versions only within one
machine session, in turns. It prints the card's name and power limit,
then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import time

import numpy as np

import torch
import torch.nn.functional as F

from hallo_tpu_torch.ops import flash
from hallo_tpu_torch.ops.bench_temporal import timings

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


AUDIO_CASES = (  # name, kernel, Lq, Lk, a bias with half the keys at MASK_VALUE
    ("K3 L 304", "K3", 304, 304, False), ("K3 L 1056", "K3", 1056, 1056, False),
    ("K3 L 1056 bias", "K3", 1056, 1056, True), ("K6 L 1056", "K6", 1056, 1056, False),
    ("K6 L 1056 half masked", "K6", 1056, 1056, True),
    ("K6 L 1056 Lk 1050", "K6", 1056, 1050, False), ("K6 L 4096", "K6", 4096, 4096, False),
)


def audio_bound_ms(kernel: str, lq: int, lk: int, bias: bool, b=1, h=12, d=64) -> float:
    """The least time of one call: fp32 q, k, v read and o written once (and
    the bias), or the products at the tensor cores' peak, whichever is
    longer."""
    nbytes = 4 * b * h * d * (2 * lq + 2 * lk) + (4 * b * lk if bias else 0)
    prods = 2.0 * b * h * lq * lk * d
    ops_s = prods / 989e12 + (prods / 1979e12 if kernel == "K6" else prods / 989e12)
    return 1e3 * max(nbytes / 3.35e12, ops_s)


def audio_cases(dev, gen, iters: int, repeats: int) -> dict:
    """K3 and K6 at the audio path's shapes (see the module's doc). K6's
    parts: the prelude kernel and the attention kernel where the tree has
    them (`flash.int8_prelude`, `flash.int8_attention`), else the torch
    prelude `quantize_int8` and `flash_int8_quantized`."""
    result = {}
    for name, kernel, lq, lk, with_bias in AUDIO_CASES:
        def heads_major(n):  # the model's view: (B, T, H, d) -> (B, H, T, d)
            return torch.randn(1, n, 12, 64, generator=gen, device=dev).transpose(1, 2)

        q, k, v = heads_major(lq), heads_major(lk), heads_major(lk)
        bias = None
        if with_bias:
            bias = torch.zeros(1, lk, device=dev)
            bias[:, lk // 2:] = flash.MASK_VALUE
        if kernel == "K3":
            row = timings(lambda: flash.flash_attention(q, k, v, bias=bias), iters, repeats)
        else:
            row = timings(lambda: flash.flash_attention_int8(q, k, v, bias=bias), iters, repeats)
            if hasattr(flash, "int8_prelude"):
                ops = flash.int8_prelude(q, k, v, bias=bias)
                parts = (lambda: flash.int8_prelude(q, k, v, bias=bias),
                         lambda: flash.int8_attention(ops))
            else:
                qk = flash.quantize_int8(q, k, 64 ** -0.5)
                parts = (lambda: flash.quantize_int8(q, k, 64 ** -0.5),
                         lambda: flash.flash_int8_quantized(*qk, v, bias=bias))
            row["prelude"] = timings(parts[0], iters, repeats)
            row["attention"] = timings(parts[1], iters, repeats)
        mask = None if bias is None else bias[:, None, None, :]
        row["sdpa"] = timings(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask),
                              iters, repeats)
        row["bound_ms"] = round(audio_bound_ms(kernel, lq, lk, with_bias), 5)
        result[name] = row
        print(name, json.dumps(row), flush=True)
        del q, k, v
    return result


def wav2vec_cases(dev, runs: int) -> dict:
    """Seconds of `AudioProcessor.preprocess` at 12 s and 42 s of audio (see
    the module's doc), and of its wav2vec2 forward alone on the same input:
    each call's, in order, and their medians."""
    from scipy.io import wavfile

    from hallo_tpu_torch.data.audio_processor import AudioProcessor, load_wav
    from hallo_tpu_torch.utils.factory import build_wav2vec

    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    wav = os.path.join(os.path.dirname(pkg), "examples", "driving_audios", "1.wav")
    out_dir = os.path.join(pkg, "_build", "bench_wav")
    os.makedirs(out_dir, exist_ok=True)
    data, sr = load_wav(wav)
    model = build_wav2vec("full", device=dev, seed=0)
    proc = AudioProcessor(wav2vec_state_dict=model.state_dict(), device=dev)
    del model
    encoder = proc.model

    def seconds(fn):
        out = []
        for _ in range(runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(round(time.perf_counter() - t0, 5))
        return dict(median_s=statistics.median(out), seconds=out)

    result = {}
    saved = os.environ.get("HALLO_INT8_ATTN")
    try:
        for tiles, int8 in ((4, False), (14, True)):
            path = os.path.join(out_dir, f"1_x{tiles}.wav")
            wavfile.write(path, sr, np.tile(data, tiles).astype(np.float32))
            os.environ["HALLO_INT8_ATTN"] = "1" if int8 else "0"
            inputs = []  # the encoder's input, as `preprocess` prepares it
            proc.model = lambda x, n: inputs.append((x, n)) or encoder(x, n)
            proc.preprocess(path, clip_length=16)
            proc.model = encoder
            name = f"wav2vec2 {len(data) * tiles / sr:.0f} s{' int8' if int8 else ''}"
            result[name] = dict(preprocess=seconds(lambda: proc.preprocess(path, clip_length=16)),
                                forward=seconds(lambda: encoder(*inputs[0])))
            print(name, json.dumps(result[name]), flush=True)
    finally:
        if saved is None:
            os.environ.pop("HALLO_INT8_ATTN", None)
        else:
            os.environ["HALLO_INT8_ATTN"] = saved
    return result


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--k4-only", action="store_true", help="time K4 alone")
    ap.add_argument("--audio-only", action="store_true", help="time K3 and K6 alone")
    ap.add_argument("--wav2vec", type=int, default=0, metavar="N",
                    help="time N calls of the audio preprocessing at 12 and 42 s instead")
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
    if args.wav2vec:
        with torch.no_grad():
            result = wav2vec_cases(dev, args.wav2vec)
        print(json.dumps({"device": torch.cuda.get_device_name(0), "s": result}), flush=True)
        return
    with torch.no_grad():
        result.update(audio_cases(dev, gen, args.iters, args.repeats))
    if args.audio_only:
        print(json.dumps({"device": torch.cuda.get_device_name(0), "ms": result}), flush=True)
        return
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
