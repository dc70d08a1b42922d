"""The inference cells: a closed loop of one client whose requests of
`clips_per_request` clips stream through `FaceAnimatePipeline.__call__`
(`on_clip`, `return_video=False`), each request with a new identity,
audio and noise from the seed.

The window opens when the first request is sent and ends at the first clip
delivered at or after `--seconds` (once a request's first two clips are
in); `frames_per_s` is the frames delivered in it over its length. Forward hooks copy, for the first two clips of each
request, every denoiser call's input latents and output to pinned host
memory (asynchronously, on the compute stream), and each clip's decoded
latents' finiteness. After the window the program is freed and the frozen
reference judges one request drawn from the seed (`check_request`):

- `start_rel`: the first denoiser input against the noise given;
- `sampler_rel`: each step's next latents against the reference's sampler
  update from the program's latents and outputs, with the guidance
  combination in fp32 or rounded to the served dtype, whichever is nearer
  over the whole clip (the served variant's last step is decoded below);
- `denoiser_rel`: the CFG halves' outputs against the reference's denoiser
  at the program's latents, at `steps_per_clip` steps drawn from the seed
  (every step where a clip has no more),
  with the reference's own conditioning (VAE encode, identity tokens,
  ReferenceNet, audio tokens, face locator) from the request's inputs; the
  second clip's motion frames are the program's first clip's frames;
- `frames_mad`: the worst frame's mean absolute difference, in levels,
  between the program's uint8 frames and the reference's decode of the
  replayed final latents.

With `--trace 1` the second clip of the window is profiled (`trace.Tracer`)
and the modules' spans are recorded.
"""

from __future__ import annotations

import json
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import inputs, trace as tr
from benchmark.drivers import common
from benchmark.reference import clip as ref_clip
from benchmark.reference import nn as ref_nn
from benchmark.reference import sampling as ref_sampling

SPAN_MODULES = ("denoising_net", "reference_net", "vae.encoder", "vae.decoder")


class _WindowEnd(Exception):
    pass


class Capture:
    """Pinned copies of the denoiser's inputs and outputs for the first
    `clips` clips of the first `slots` requests, and a finiteness flag a
    clip."""

    def __init__(self, models, slots: int, clips: int, steps: int, batch: int, lat_shape):
        self.models, self.batch = models, batch
        self.slots, self.clips, self.steps = slots, clips, steps
        n = slots * clips * steps
        out_shape = (2 * batch,) + tuple(lat_shape[1:])
        dt = models.denoising_net.conv_out.weight.dtype
        self.lat = [torch.empty(lat_shape, dtype=torch.float32, pin_memory=torch.cuda.is_available())
                    for _ in range(n)]
        self.out = [torch.empty(out_shape, dtype=dt, pin_memory=torch.cuda.is_available()) for _ in range(n)]
        self.active = False
        self.req = self.clip = self.step = 0
        self.finite: List[torch.Tensor] = []
        self.evals = 0  # denoiser calls while active
        self.taken: Dict[tuple, int] = {}
        self.on_clip_start = None
        self.clips_started = 0
        self.handles = [
            models.vae.encoder.register_forward_pre_hook(self._clip_start),
            models.denoising_net.register_forward_hook(self._denoised),
            models.vae.post_quant_conv.register_forward_pre_hook(self._decoding),
        ]

    def begin(self, req: int) -> None:
        self.req, self.clip = req, -1

    def _clip_start(self, mod, args):
        if not self.active:
            return
        self.clip += 1
        self.step = 0
        self.clips_started += 1
        if self.on_clip_start is not None:
            self.on_clip_start(self.clips_started)

    def _denoised(self, mod, args, out):
        self.evals += int(self.active)
        if not (self.active and self.req < self.slots and 0 <= self.clip < self.clips):
            return
        k = (self.req * self.clips + self.clip) * self.steps + self.step
        if self.step < self.steps:
            self.lat[k].copy_(args[0][:self.batch], non_blocking=True)
            self.out[k].copy_(out, non_blocking=True)
            self.taken[(self.req, self.clip)] = self.step + 1
        self.step += 1

    def _decoding(self, mod, args):
        if self.active:
            self.finite.append(torch.isfinite(args[0]).all())

    def steps_of(self, req: int, clip: int):
        base = (req * self.clips + clip) * self.steps
        n = self.taken.get((req, clip), 0)
        return self.lat[base:base + n], self.out[base:base + n]

    def remove(self):
        for h in self.handles:
            h.remove()


def _pipeline(models, cfg, traffic, steps):
    from hallo_tpu_torch.config import SchedulerConfig
    from hallo_tpu_torch.pipelines.face_animate import FaceAnimatePipeline

    return FaceAnimatePipeline(
        models, scheduler=SchedulerConfig(**cfg["scheduler"]), num_inference_steps=steps,
        guidance_scale=cfg["guidance_scale"], clip_length=cfg["clip_length"],
        n_motion_frames=cfg["n_motion_frames"], sampler=traffic["sampler"])


def _call(pipe, req, on_clip, seed):
    return pipe(req["ref_image"], req["audio_windows"], req["face_emb"], req["face_region"],
                req["masks"], seed=seed, latents=req["noise"], on_clip=on_clip,
                return_video=False)


def sampler_gaps(samp, outs, lats, got_traj, g: float) -> Dict[str, float]:
    """The largest relative gap of a clip's next latents `got_traj` against
    the reference's updates from the program's latents `lats` and outputs
    `outs`, with the guidance combination rounded to the served dtype
    ("served") and in fp32 ("fp32")."""
    gaps = {}
    for name, served in (("served", True), ("fp32", False)):
        traj = ref_sampling.sample_trajectory(samp, outs, lats[0], g, inputs=lats,
                                              served=served)
        gaps[name] = max((common.rel(got_traj[i], traj[i]) for i in range(len(lats) - 1)),
                         default=0.0)
    return gaps


def judge(cfg: dict, traffic: dict, check: dict, seed: int, req: dict, lat_caps, out_caps,
          frames: List[np.ndarray], device, control: bool = False) -> Dict[str, float]:
    """The check's numbers for the first clips of one request (see the
    module docstring). `control`: the reference in fp8 (its GEMMs and
    convolutions) with a bfloat16 sampler stands in the program's place at
    each stage and is judged instead."""
    mods = common.build_reference(cfg, seed, device)
    b = req["face_emb"].shape[0]
    f, m = cfg["clip_length"], cfg["n_motion_frames"]
    g = float(cfg["guidance_scale"])
    samp = ref_sampling.make_sampler(cfg["scheduler"], traffic["sampler"], traffic["steps"])
    pick = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, 7])

    def put(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)

    ref_img = put(req["ref_image"])
    face_emb, face_region = put(req["face_emb"]), put(req["face_region"])
    masks = tuple(tuple(put(x) for x in lvl) for lvl in req["masks"])
    scale = torch.ones(3, device=device)
    num: Dict[str, float] = dict(start_rel=0.0, sampler_served=0.0, sampler_fp32=0.0,
                                 denoiser_rel=0.0, frames_mad=0.0)
    motion = ref_img[:, None].expand(-1, m, -1, -1, -1)
    for c in range(len(frames)):
        lats = [put(x) for x in lat_caps[c]]
        outs = [(o[:b].to(device), o[b:].to(device)) for o in out_caps[c]]
        if len(lats) != samp.timesteps.shape[0]:
            raise RuntimeError(f"clip {c}: {len(lats)} denoiser calls captured, "
                               f"{samp.timesteps.shape[0]} planned")
        noise = put(req["noise"][c]).permute(0, 1, 4, 2, 3)
        px = torch.cat([ref_img[:, None], motion], dim=1)
        audio = put(req["audio_windows"][c * f:(c + 1) * f])[None].expand(b, -1, -1, -1, -1)
        steps = sorted(pick.choice(len(lats), size=min(check["steps_per_clip"], len(lats)),
                                   replace=False).tolist())
        with torch.no_grad():
            traj = ref_sampling.sample_trajectory(samp, outs, lats[0], g, inputs=lats)
            cond = ref_clip.conditioning(mods, px, face_emb, face_region, audio, masks)
            evals = {i: ref_clip.evaluate(mods, cond, lats[i], int(samp.timesteps[i]), scale)
                     for i in steps}
            ref_frames = ref_clip.decode_uint8(mods, traj[-1])
            if control:
                with ref_nn.fp8(), ref_sampling.bf16():
                    got_start = noise.to(torch.bfloat16).float()
                    got_traj = ref_sampling.sample_trajectory(samp, outs, lats[0], g,
                                                              inputs=lats)
                    cond8 = ref_clip.conditioning(mods, px, face_emb, face_region, audio, masks)
                    got_evals = {i: ref_clip.evaluate(mods, cond8, lats[i],
                                                      int(samp.timesteps[i]), scale)
                                 for i in steps}
                    got_frames = ref_clip.decode_uint8(mods, got_traj[-1])
            else:
                got_start, got_traj = lats[0], lats[1:]
                got_evals = {i: outs[i] for i in steps}
                got_frames = torch.as_tensor(frames[c], device=device)
        num["start_rel"] = max(num["start_rel"], common.rel(got_start, noise))
        for k, v in sampler_gaps(samp, outs, lats, got_traj, g).items():
            num[f"sampler_{k}"] = max(num[f"sampler_{k}"], v)
        for i in steps:
            for half in (0, 1):
                num["denoiser_rel"] = max(num["denoiser_rel"], common.rel(
                    got_evals[i][half].float(), evals[i][half]))
        diff = (got_frames.float() - ref_frames.float()).abs()
        num["frames_mad"] = max(num["frames_mad"], float(diff.mean(dim=(0, 2, 3, 4)).max()))
        motion = torch.as_tensor(frames[c][:, -m:], device=device).float() / 127.5 - 1.0
        del cond, evals
    del mods
    common.free()
    num["sampler_rel"] = min(num["sampler_served"], num["sampler_fp32"])
    return num


def work_plan(cfg: dict, batch: int) -> dict:
    """FLOPs and attention calls of one clip, by stage, from the reference
    on meta tensors at the cell's shapes: "conditioning" (VAE encode,
    projections, ReferenceNet, face locator), "eval" (one CFG evaluation
    of the denoiser, in the program's plan: the unconditional half without
    reference tokens and with zero audio), "decode"."""
    mods = common.ref_models.build(cfg, "meta")
    h, f, m = cfg["height"], cfg["clip_length"], cfg["n_motion_frames"]
    ap, ip = cfg["audio_proj"], cfg["image_proj"]
    meta = dict(device="meta")
    px = torch.empty(batch, 1 + m, h, h, 3, **meta)
    emb = torch.empty(batch, ip["clip_embeddings_dim"], **meta)
    region = torch.empty(batch, h, h, 3, **meta)
    audio = torch.empty(batch, f, ap["seq_len"], ap["blocks"], ap["channels"], **meta)
    masks = tuple(tuple(torch.empty(batch, (h // 8 // 2 ** d) ** 2, **meta) for _ in range(3))
                  for d in range(4))
    lat = torch.empty(batch, f, 4, h // 8, h // 8, **meta)
    box = {}

    def cond():
        box["cond"] = ref_clip.conditioning(mods, px, emb, region, audio, masks)

    with torch.no_grad(), ref_nn.flop_plan():
        out = {"conditioning": common.count(cond)}
        out["eval"] = common.count(lambda: ref_clip.evaluate(
            mods, box["cond"], lat, 999, torch.ones(3, **meta)))
        out["decode"] = common.count(lambda: ref_clip.decode_uint8(mods, lat))
    out["stage_spans"] = {"conditioning": "reference_net", "eval": "denoising_net",
                          "decode": "vae.decoder"}
    return out


def run(ctx) -> dict:
    cfg, traffic, work, args = ctx.cfg, ctx.traffic, ctx.work, ctx.args
    dev = ctx.device
    batch, clips = traffic["batch"], traffic["clips_per_request"]
    f, h = cfg["clip_length"], cfg["height"]
    check = work["check"]

    models = common.build_program(cfg, args.seed, dev)
    pipe = _pipeline(models, cfg, traffic, traffic["steps"])
    warm = _pipeline(models, cfg, traffic, traffic["warmup_steps"])
    slots = traffic["requests_captured"]
    reqs = [inputs.clip_request(args.seed, r, cfg, batch, clips)
            for r in range(traffic["requests_made"])]
    cap = Capture(models, slots, 2, traffic["steps"], batch, (batch, f, 4, h // 8, h // 8))
    warm_req = inputs.clip_request(args.seed, 10_000, cfg, batch, 2)
    warm_req["audio_windows"] = warm_req["audio_windows"][:2 * f]
    _call(warm, warm_req, None, 0)
    common.sync()

    tracer = spans = None
    if args.trace:
        tracer = tr.Tracer(SPAN_MODULES)
        spans = tr.Spans({"denoising_net": models.denoising_net,
                          "reference_net": models.reference_net,
                          "vae.encoder": models.vae.encoder,
                          "vae.decoder": models.vae.decoder})

        def on_clip_start(n):
            if n == 2:
                tracer.start()
            elif n == 3:
                tracer.stop()

        cap.on_clip_start = on_clip_start

    delivered: List[tuple] = []  # (time, request, clip, frames)
    work: Dict[str, int] = {}  # what was dispatched to the card in the window
    kept: Dict[tuple, np.ndarray] = {}
    failed_calls = 0
    common.reset_peak()
    cap.active = True
    t_start = time.perf_counter()
    setup_s = t_start - ctx.t0
    r = 0
    try:
        while True:
            cap.begin(r)
            box = {"c": 0}

            def on_clip(arr, r=r, box=box):
                now = time.perf_counter() - t_start
                c = box["c"]
                box["c"] += 1
                if r < slots and c < 2:
                    kept[(r, c)] = np.array(arr)
                delivered.append((now, r, c, arr.shape[0] * arr.shape[1]))
                # the window ends at the first clip at or after --seconds, once
                # a request's first two clips (what the check compares) are in
                if now >= args.seconds and any(k[1] == 1 for k in kept):
                    work.update(clips=cap.clips_started, evals=cap.evals,
                                decodes=len(cap.finite))
                    raise _WindowEnd

            try:
                _call(pipe, reqs[r % len(reqs)], on_clip, r)
            except _WindowEnd:
                raise
            except Exception as e:  # a request that fails counts its clips as failed
                failed_calls += clips - box["c"]
                ctx.log(f"request {r} failed: {type(e).__name__}: {e}")
            r += 1
    except _WindowEnd:
        pass
    common.sync()
    cap.active = False
    if tracer is not None:
        tracer.stop()
        spans.remove()
    window_s = delivered[-1][0]
    frames = sum(d[3] for d in delivered)
    peak = common.peak_bytes()
    finite = [bool(x) for x in cap.finite[:len(delivered)]]
    attempted = len(delivered) + failed_calls
    failed = failed_calls + sum(1 for x in finite if not x)

    # the judged request: drawn from the seed among those whose first two
    # clips were delivered and captured in full
    done = [q for q in range(slots)
            if all((q, c) in kept and cap.taken.get((q, c)) == traffic["steps"]
                   for c in range(2))]
    cap.remove()
    out = dict(attempted=attempted, failed=failed, window_s=window_s, setup_s=setup_s,
               peak=peak, frames=frames, clips=len(delivered),
               completions=[d[0] for d in delivered], work=work)
    lat_caps = out_caps = None
    if done:
        q = int(np.random.default_rng([args.seed & 0xFFFFFFFF, args.seed >> 32, 5]).choice(done))
        lat_caps, out_caps = [], []
        for c in range(2):
            la, ou = cap.steps_of(q, c)
            lat_caps.append([x.clone() for x in la])
            out_caps.append([x.clone() for x in ou])
        judged_req, judged_frames = reqs[q % len(reqs)], [kept[(q, 0)], kept[(q, 1)]]
    del pipe, warm, models, cap
    common.free()
    if done:
        numbers = judge(cfg, traffic, check, args.seed, judged_req, lat_caps, out_caps,
                        judged_frames, dev)
    else:
        numbers = {}
        ctx.log("no request had its first two clips delivered in the window")
    out["correct"], out["checks"] = common.judged(numbers, check["limits"])
    out["end_to_end"] = {
        "frames_per_s": (frames / window_s, "frames/s"),
        "peak_gib": (peak / 2 ** 30, "GiB"),
        "setup_s": (setup_s, "s"),
    }
    if tracer is not None and tracer.slice is not None:
        out["slice"] = tracer.slice
        out["plan"] = work_plan(cfg, batch)
    return out


def readings(ctx, seeds) -> list:
    """The check's numbers of the program and of the control on each seed,
    from one request's first two clips at the cell's shapes (no window):
    the readings the limits are set from."""
    cfg, traffic, check = ctx.cfg, ctx.traffic, ctx.work["check"]
    f, h, batch = cfg["clip_length"], cfg["height"], traffic["batch"]
    rows = []
    for k, seed in enumerate(seeds):
        models = common.build_program(cfg, seed, ctx.device)
        pipe = _pipeline(models, cfg, traffic, traffic["steps"])
        cap = Capture(models, 1, 2, traffic["steps"], batch, (batch, f, 4, h // 8, h // 8))
        req = inputs.clip_request(seed, 0, cfg, batch, 2)
        req["audio_windows"] = req["audio_windows"][:2 * f]
        frames: List[np.ndarray] = []
        cap.active = True
        cap.begin(0)
        t0 = time.perf_counter()
        _call(pipe, req, lambda a: frames.append(np.array(a)), 0)
        common.sync()
        seconds = time.perf_counter() - t0
        caps = [cap.steps_of(0, c) for c in range(2)]
        lat_caps = [[x.clone() for x in la] for la, _ in caps]
        out_caps = [[x.clone() for x in ou] for _, ou in caps]
        cap.remove()
        del pipe, models, cap
        common.free()
        row = {"seed": seed, "two_clips_s": seconds}
        for name, control in (("program", False), ("control", True))[:1 + (k < ctx.control)]:
            row[name] = judge(cfg, traffic, check, seed, req, lat_caps, out_caps, frames,
                              ctx.device, control=control)
        ctx.log(json.dumps(row))
        rows.append(row)
    return rows
