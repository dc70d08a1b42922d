"""Smoke run of the PyTorch port (`hallo_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py                 # a few DDIM steps per clip
    python3 chip_smoke.py --steps 40      # the exact profile
    python3 chip_smoke.py --profile-out out/profile.txt   # + kernel profile

Phases, each synchronised so that a device fault surfaces where it happened:

1. preflight: the card's name and power limit, and the kernels' build
   (nvcc, sm_90a) from `hallo_tpu_torch/csrc/`;
2. every hand-written kernel against its plain PyTorch version at the main
   path's shapes, in bf16, with both times;
3. the slice: the full-width models (random weights from a seed, bf16) drive
   `FaceAnimatePipeline.__call__` at 512^2 over 2 clips of 16 frames with 2
   motion frames, counting each kernel's launches; then the port on the card
   is held against the same weights and inputs run on the CPU in fp32 at a
   small size.

The last line of standard output is
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`;
the line before it holds the kernels' table as JSON. Any failure raises and
exits non-zero without that line. Without a CUDA device it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

from hallo_tpu_torch.ops import _build, flash, temporal
from hallo_tpu_torch.pipelines.face_animate import FaceAnimatePipeline, HalloModels
from hallo_tpu_torch.utils.factory import build_models, dummy_clip_inputs

# Max abs error of a bf16 kernel against its plain version computed in fp32
# from the same bf16 inputs (unit-normal q, k, v): the output and the
# probabilities are rounded to bf16 (8 bits of mantissa) in the kernel, so
# |o| ~ 1 carries ~4e-3 of rounding, plus the bf16 rounding of P in PV.
KERNEL_ATOL = 2e-2

# The port on the card (bf16, kernels) against the same weights on the CPU
# (fp32, plain versions) at a small input: relative L2 error of each output.
# bf16 keeps 8 bits of mantissa, so every layer adds ~0.4% relative rounding;
# through the UNets' depth that stays within a few percent.
SLICE_RTOL = 5e-2

KERNELS = {
    "flash_fwd_packed": dict(
        route="cuda", source="hallo_tpu_torch/csrc/flash_fwd.cu",
        replaces="hallo_tpu/ops/pallas_flash.py:236",
    ),
    "flash_fwd": dict(
        route="cuda", source="hallo_tpu_torch/csrc/flash_fwd.cu",
        replaces="hallo_tpu/ops/pallas_flash.py:73",
    ),
    "temporal_attn": dict(
        route="cuda", source="hallo_tpu_torch/csrc/temporal_attn.cu",
        replaces="hallo_tpu/ops/pallas_temporal.py:42",
    ),
}


def log(*a) -> None:
    print(*a, flush=True)


def launch_counts() -> dict:
    return {**flash.LAUNCHES, **temporal.LAUNCHES}


def reset_counts() -> None:
    for table in (flash.LAUNCHES, temporal.LAUNCHES):
        for key in table:
            table[key] = 0


def cuda_ms(fn, iters: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def preflight() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    # Stated explicitly: fp32 matmuls and convolutions in full fp32 (the plain
    # references below); the main path runs in bf16 and is unaffected.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("tf32: matmul False, cudnn False")
    t0 = time.perf_counter()
    _build.build()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s")
    for name in sorted(_build.build_log):
        log(f"--- nvcc {name}.cu ({_build.build_seconds[name]:.1f} s)")
        log(_build.build_log[name].strip())
    for name in _build.SIGNATURES:
        _build.lib(name)
    return smi


def kernel_cases(dev):
    """(kernel, label, kernel fn, plain fn) at the main path's shapes."""
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    def packed(label, b, lq, lk, c, heads=8, bias=None):
        q, k, v = randn(b, lq, c), randn(b, lk, c), randn(b, lk, c)
        return ("flash_fwd_packed", label,
                lambda: flash.flash_attention_packed(q, k, v, heads=heads, bias=bias),
                lambda: flash.packed_reference(q.float(), k.float(), v.float(), heads, bias))

    half_masked = torch.zeros(2, 8192, device=dev)
    half_masked[:, 4096:] = flash.MASK_VALUE
    cases = [
        packed("K1 level 0 ref concat Lq 4096 Lk 8192 C 320", 2, 4096, 8192, 320),
        packed("K1 level 1 ref concat Lq 1024 Lk 2048 C 640", 2, 1024, 2048, 640),
        packed("K1 level 2 d=160 Lq 256 Lk 512 C 1280", 2, 256, 512, 1280),
        packed("K1 audio Lk 32", 2, 4096, 32, 320),
        packed("K1 identity Lk 4", 2, 4096, 4, 320),
        packed("K1 Lq 1 Lk 1", 1, 1, 1, 320),
        packed("K1 MASK_VALUE bias on half the keys", 2, 4096, 8192, 320,
               bias=half_masked),
    ]
    q, k, v = randn(3, 1, 4096, 512), randn(3, 1, 4096, 512), randn(3, 1, 4096, 512)
    from hallo_tpu_torch.ops.attention import attention_reference

    cases.append((
        "flash_fwd", "K4 VAE mid d=512 L 4096 B 3",
        lambda: flash.flash_attention(q, k, v),
        lambda: attention_reference(q.float(), k.float(), v.float()),
    ))
    for label, b, f, l, c in (
        ("K2 F 18 L 4096 C 320", 2, 18, 4096, 320),
        ("K2 F 16 L 4096 C 320 (level 0 without motion frames)", 2, 16, 4096, 320),
        ("K2 F 18 L 256 C 1280 d=160", 2, 18, 256, 1280),
        ("K2 F 17 L 1024 C 640 (any other frame count)", 2, 17, 1024, 640),
    ):
        tq, tk, tv = randn(b, f, l, c), randn(b, f, l, c), randn(b, f, l, c)
        cases.append((
            "temporal_attn", label,
            (lambda tq=tq, tk=tk, tv=tv: temporal.temporal_attention(tq, tk, tv, heads=8)),
            (lambda tq=tq, tk=tk, tv=tv: temporal.temporal_reference(
                tq.float(), tk.float(), tv.float(), 8)),
        ))
    return cases


def phase_kernels(dev) -> dict:
    """Each kernel vs its plain version; returns {kernel: stats of its first
    (main-path) case, with the worst error over all its cases}."""
    table = {}
    for kernel, label, fn, plain in kernel_cases(dev):
        got = fn().float()
        want = plain().float()
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if not torch.isfinite(got).all():
            raise RuntimeError(f"{label}: non-finite kernel output")
        ms, plain_ms = cuda_ms(fn), cuda_ms(plain)
        log(f"{label}: max_abs_err {err:.3e} (atol {KERNEL_ATOL}) "
            f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
        if not err <= KERNEL_ATOL:
            raise RuntimeError(f"{label}: kernel disagrees with plain version ({err})")
        row = table.setdefault(kernel, dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms))
        row["max_abs_err"] = max(row["max_abs_err"], err)
        del got, want
        torch.cuda.empty_cache()
    return table


def on_cpu_fp32(models: HalloModels, scale: str) -> HalloModels:
    """The same weights as `models`, in fp32 on the CPU."""
    host = {name: {k: v.float().cpu() for k, v in module.state_dict().items()}
            for name, module in models.modules().items()}
    cpu = build_models(scale, device=torch.device("meta"))
    for name, module in cpu.modules().items():
        module.to_empty(device="cpu").load_state_dict(host[name], strict=True)
    return cpu


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float().cpu(), want.float().cpu()
    return ((got - want).norm() / want.norm()).item()


def phase_reference(models: HalloModels, dev, scale: str = "full") -> dict:
    """ReferenceNet, one cfg_split denoiser forward, VAE encode and decode at
    a small input (64x64 pixels, 4 frames, 2 motion frames), on the card and
    on the CPU in fp32 with the same weights and inputs."""
    cpu = on_cpu_fp32(models, scale)
    gen = torch.Generator().manual_seed(1)

    def r(*shape):
        return torch.randn(*shape, generator=gen)

    b, f, m, hl = 1, 4, 2, 8
    den = models.denoising_net.config
    ap = models.audio_proj.config
    pixels = r(b * (1 + m), 3, 8 * hl, 8 * hl).clamp(-1, 1)
    ctx = r(2 * b * (1 + m), 4, den.cross_attention_dim)
    lat = r(2 * b, f, 4, hl, hl)
    audio = r(2 * b, f, ap.context_tokens, den.audio_attention_dim)
    face = r(2 * b, f, den.block_out_channels[0], hl, hl)
    masks = tuple(
        tuple((torch.rand(2 * b * f, (hl >> d) ** 2, generator=gen) > 0.3).float()
              for _ in range(3))
        for d in range(4)
    )
    scale = torch.tensor([1.0, 0.8, 0.6])

    def run(ms: HalloModels, device):
        def put(x):
            return x.to(device)

        with torch.inference_mode():
            z = ms.vae.encode_mean(put(pixels))
            _, feats = ms.reference_net(put(z).repeat(2, 1, 1, 1), torch.zeros((), device=device), put(ctx))
            split = {k: [x.unflatten(0, (2 * b, 1 + m)) for x in v] for k, v in feats.items()}
            ref = {k: [x[:, 0] for x in v] for k, v in split.items()}
            mot = {k: [x[:, 1:] for x in v] for k, v in split.items()}
            out = ms.denoising_net(
                put(lat), torch.tensor(500, device=device), put(ctx[:2 * b]), ref, mot,
                put(audio), put(face), tuple(tuple(put(x) for x in lvl) for lvl in masks),
                put(scale), None, cfg_split=True,
            )
            pix = ms.vae.decode(put(lat[0]))
        return dict(vae_encode=z, reference_net=feats["up_3"][-1], denoiser=out, vae_decode=pix)

    got = run(models, dev)
    torch.cuda.synchronize()
    want = run(cpu, torch.device("cpu"))
    errs = {k: rel_err(got[k], want[k]) for k in want}
    for k, e in errs.items():
        log(f"slice vs CPU fp32 at 64x64: {k} rel_err {e:.3e} (rtol {SLICE_RTOL})")
        if not e <= SLICE_RTOL:
            raise RuntimeError(f"{k}: card disagrees with the CPU fp32 reference ({e})")
    return errs


def phase_slice(dev, steps: int) -> dict:
    """Full-width models, 512^2, 2 clips of 16 frames + 2 motion frames."""
    t0 = time.perf_counter()
    models = build_models("full", device=dev, dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for mod in models.modules().values() for p in mod.parameters())
    log(f"build_models(full, bf16): {time.perf_counter() - t0:.1f} s, {n_params} parameters")
    h = w = 512
    clip, motion_frames, clips = 16, 2, 2
    pipe = FaceAnimatePipeline(models, num_inference_steps=steps, clip_length=clip,
                               n_motion_frames=motion_frames)
    inputs = dummy_clip_inputs(models, h, w, clip, batch=1, seed=0)
    rng = np.random.default_rng(1)
    inputs["audio_windows"] = rng.normal(
        size=(clips * clip,) + inputs["audio_windows"].shape[1:]).astype(np.float32)

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    timings: dict = {}
    t0 = time.perf_counter()
    video = pipe(**inputs, seed=0, timings=timings)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()

    steps_s = timings["denoise_step"]
    log(f"slice: {clips} clips x {clip} frames at {h}x{w}, {steps} DDIM steps, "
        f"{total:.3f} s total")
    per_clip = [sum(timings[k][c] for k in ("vae_encode", "conditioning", "vae_decode"))
                + sum(steps_s[c * steps:(c + 1) * steps]) for c in range(clips)]
    log(f"seconds per clip: {[round(x, 4) for x in per_clip]}")
    log(f"seconds per denoiser step: first {steps_s[0]:.4f}, "
        f"mean of the rest {np.mean(steps_s[1:]):.4f}")
    log(f"seconds VAE encode {[round(x, 4) for x in timings['vae_encode']]}, "
        f"conditioning (ReferenceNet etc.) {[round(x, 4) for x in timings['conditioning']]}, "
        f"VAE decode {[round(x, 4) for x in timings['vae_decode']]}")
    log(f"peak device memory: {peak / 2**30:.3f} GiB")
    log(f"kernel launches in the slice: {counts}")

    if video.shape != (1, clips * clip, h, w, 3):
        raise RuntimeError(f"video shape {video.shape}")
    if not np.isfinite(video).all():
        raise RuntimeError("non-finite video")
    motion = np.abs(np.diff(video[0], axis=0)).mean()
    log(f"mean |frame difference|: {motion:.5f}")
    if not motion > 0:
        raise RuntimeError("video does not vary over time")
    for name, n in counts.items():
        if n <= 0:
            raise RuntimeError(f"kernel {name} was not launched by the slice")
    return dict(models=models, counts=counts, pipe=pipe, inputs=inputs)


def phase_profile(pipe: FaceAnimatePipeline, inputs: dict, out_path: str) -> None:
    """One clip under torch.profiler: device time by kernel (top rows here,
    all rows to `out_path`) and the device's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    one = dict(inputs, audio_windows=inputs["audio_windows"][:pipe.clip_length])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe(**one, seed=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue
        us = getattr(e, "self_device_time_total", None)
        us = e.self_cuda_time_total if us is None else us
        if us > 0:
            rows.append((us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    lines = [f"profiled clip: wall {wall * 1e3:.1f} ms (profiler on), device busy "
             f"{busy:.1f} ms ({100 * busy / (wall * 1e3):.1f}% of wall)"]
    lines += [f"{ms:10.3f} ms {100 * ms / busy:5.1f}% x{n:<6d} {name[:110]}"
              for ms, n, name in rows]
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    for line in lines[:31]:
        log(line)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=4, help="DDIM steps per clip")
    ap.add_argument("--profile-out", metavar="PATH",
                    help="also profile one clip; write every kernel's device time to PATH")
    args = ap.parse_args()

    preflight()
    dev = torch.device("cuda", 0)
    table = phase_kernels(dev)
    torch.cuda.synchronize()
    slice_ = phase_slice(dev, args.steps)
    torch.cuda.synchronize()
    if args.profile_out:
        phase_profile(slice_["pipe"], slice_["inputs"], args.profile_out)
    phase_reference(slice_["models"], dev)
    torch.cuda.synchronize()

    rows = [dict(name=name, **KERNELS[name], launches=slice_["counts"][name], **table[name])
            for name in KERNELS]
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
