"""Audio-driven portrait animation pipeline (counterpart of
hallo_tpu/pipelines/face_animate.py).

One clip: VAE-encode the reference frame and the motion frames (posterior
mean) -> identity tokens and one ReferenceNet pass -> face-locator and audio
conditioning, each with a zeroed CFG-uncond half -> the CFG [uncond | cond]
denoise loop over the denoising UNet with `cfg_split`, advanced by DDIM,
DPM-Solver++ (2M) or UniPC and optionally thinned by the step and CFG caches
-> one batched VAE decode to uint8, whose last frames are the next clip's
motion frames. `__call__` slides that clip program over the audio windows,
dispatching clip c+1 before it fetches clip c's frames.

Clip parallelism (a mesh whose "seq" axis has more than one rank): each
rank denoises its share of the clip's frames, and the denoiser's inflated
GroupNorms and motion modules exchange what crosses frames
(models/motion.py); the VAE encode, the ReferenceNet and the conditioning
stay replicated, and each rank decodes its frames, which are then gathered.

Public layouts are the JAX package's: pixels (B, H, W, 3) in [-1, 1],
latents (B, F, H/8, W/8, 4). Inside, tensors are NCHW.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from hallo_tpu_torch.config import (
    AudioProjConfig,
    FaceLocatorConfig,
    ImageProjConfig,
    SchedulerConfig,
    UNetConfig,
    VAEConfig,
)
from hallo_tpu_torch.diffusion.cache import make_allow_mask, make_cfg_plan, make_skip_mask
from hallo_tpu_torch.diffusion.sampler import make_sampler
from hallo_tpu_torch.models.face_locator import FaceLocator
from hallo_tpu_torch.models.projections import AudioProj, ImageProj
from hallo_tpu_torch.models.unet_denoise import DenoisingUNet
from hallo_tpu_torch.models.unet_ref import ReferenceNet
from hallo_tpu_torch.models.vae import AutoencoderKL
from hallo_tpu_torch.parallel.collectives import all_gather, all_reduce_sum, local_slice
from hallo_tpu_torch.utils import profiling

MaskPyramid = Tuple[Tuple[np.ndarray, np.ndarray, np.ndarray], ...]

# the counter of each step kind of `FaceAnimatePipeline.clip`
STEP_COUNTERS = {"full": "denoiser.eval.full", "cond": "denoiser.eval.cond",
                 "reuse": "denoiser.step.reuse"}

MODULE_NAMES = (
    "vae", "reference_net", "denoising_net", "face_locator", "image_proj", "audio_proj",
)


@dataclasses.dataclass
class HalloModels:
    """The five networks plus the VAE (reference `Net`,
    scripts/inference.py:51-94)."""

    vae: AutoencoderKL
    reference_net: ReferenceNet
    denoising_net: DenoisingUNet
    face_locator: FaceLocator
    image_proj: ImageProj
    audio_proj: AudioProj

    @classmethod
    def create(
        cls,
        ref_config: UNetConfig,
        denoise_config: UNetConfig,
        vae_config: VAEConfig = VAEConfig(),
        face_locator_config: FaceLocatorConfig = FaceLocatorConfig(),
        image_proj_config: ImageProjConfig = ImageProjConfig(),
        audio_proj_config: AudioProjConfig = AudioProjConfig(),
        device: torch.device = torch.device("cuda"),
        dtype: torch.dtype = torch.float32,
        seed: int = 0,
    ) -> "HalloModels":
        """Random-initialised modules (PyTorch's default inits; the zero-init
        heads as in the reference), built on `device` (the card unless the
        caller asks for another) from `seed`."""
        device = torch.device(device)
        with torch.random.fork_rng(devices=[device] if device.type == "cuda" else []):
            torch.manual_seed(seed)
            with torch.device(device):
                mods = dict(
                    vae=AutoencoderKL(vae_config),
                    reference_net=ReferenceNet(ref_config),
                    denoising_net=DenoisingUNet(denoise_config),
                    face_locator=FaceLocator(face_locator_config),
                    image_proj=ImageProj(image_proj_config),
                    audio_proj=AudioProj(audio_proj_config),
                )
        return cls(**{k: m.to(dtype).eval().requires_grad_(False) for k, m in mods.items()})

    def modules(self) -> Dict[str, torch.nn.Module]:
        return {name: getattr(self, name) for name in MODULE_NAMES}

    @property
    def device(self) -> torch.device:
        return self.denoising_net.conv_in.weight.device


def window_audio_embeddings(audio_emb: np.ndarray, margin: int = 2) -> np.ndarray:
    """(T, blocks, C) -> (T, 2*margin+1, blocks, C) edge-padded windows
    (reference scripts/inference.py:95-116 process_audio_emb)."""
    t = audio_emb.shape[0]
    pads = np.concatenate(
        [np.repeat(audio_emb[:1], margin, axis=0), audio_emb,
         np.repeat(audio_emb[-1:], margin, axis=0)],
        axis=0,
    )
    idx = np.arange(t)[:, None] + np.arange(2 * margin + 1)[None, :]
    return pads[idx]


def _synced_clock(device: torch.device) -> float:
    """The host clock after the card's queue has drained (`timings`' marks)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def _relative_change(lat: torch.Tensor, anchor: torch.Tensor, group) -> torch.Tensor:
    """mean |lat - anchor| / (mean |anchor| + 1e-8), the dynamic step
    cache's score; with a `group`, over the frames of all its ranks (sums
    all-reduced), so that every rank decides alike."""
    if group is None:
        return (lat - anchor).abs().mean() / (anchor.abs().mean() + 1e-8)
    sums = all_reduce_sum(torch.stack([(lat - anchor).abs().sum(), anchor.abs().sum()]), group)
    n = lat.numel() * dist.get_world_size(group)
    return (sums[0] / n) / (sums[1] / n + 1e-8)


def _half(tree, b: int):
    """The CFG-cond half (rows b:) of a tensor, a list or a dict of lists."""
    if isinstance(tree, dict):
        return {k: _half(v, b) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_half(x, b) for x in tree)
    return tree[b:]


class FaceAnimatePipeline:
    def __init__(
        self,
        models: HalloModels,
        scheduler: SchedulerConfig = SchedulerConfig(),
        num_inference_steps: int = 40,
        guidance_scale: float = 3.5,
        clip_length: int = 16,
        n_motion_frames: int = 2,
        legacy_context_tiling: bool = True,
        step_cache: Optional[str] = None,
        step_cache_threshold: float = 0.10,
        cfg_cache_stride: int = 1,
        sampler: str = "ddim",
        cfg_tail: int = 0,
        cfg_cache_warmup: Optional[int] = None,
        cfg_cache_cooldown: Optional[int] = None,
        timestep_schedule: str = "trailing",
        schedule_rho: float = 1.0,
        mesh=None,
        seq_axis: str = "seq",
    ):
        """`legacy_context_tiling=True` tiles the identity tokens over the
        ReferenceNet batch the way the reference does
        (mutual_self_attention.py:341-349, misaligned with the frames: what
        the trained checkpoint saw); False repeats them per frame.

        `step_cache="uniform"` reuses the previous prediction on the steps
        of `cache.make_skip_mask` (the sampler update still advances);
        "dynamic" reuses it while the accumulated relative latent change
        since the last recompute stays under `step_cache_threshold`, on the
        steps `cache.make_allow_mask` allows (decided on the host: one
        synchronisation each such step).

        `cfg_cache_stride > 1` recomputes the CFG-uncond half only every
        stride-th step between warm-up and cool-down and otherwise runs the
        cond half alone against the cached uncond prediction; the last
        `cfg_tail` steps run cond-only at guidance 1 (`cache.make_cfg_plan`).
        Both compose with `step_cache` None or "dynamic", not "uniform".

        `sampler` ("ddim", "dpm++2m", "unipc"), `timestep_schedule`
        ("trailing" or "logsnr") and `schedule_rho`: `make_sampler`'s.

        `mesh` (`parallel.mesh.Mesh`) whose `seq_axis` has more than one
        rank: each denoise step runs clip-parallel over that axis's group,
        this rank's `clip_length / n` frames of the latents, audio tokens,
        face condition and masks (hallo_tpu/pipelines/face_animate.py:
        202-259, :441-501); the dynamic step cache decides from scores
        all-reduced over the group, so every rank takes the same steps.
        With one rank on the axis the mesh is dropped, as in JAX
        (`seq_group` is then None)."""
        self.models = models
        self.guidance_scale = float(guidance_scale)
        self.clip_length = clip_length
        self.n_motion_frames = n_motion_frames
        self.legacy_context_tiling = legacy_context_tiling
        self.seq_group = None
        if mesh is not None and mesh.shape[seq_axis] > 1:
            if clip_length % mesh.shape[seq_axis]:
                raise ValueError(f"clip_length={clip_length} does not split over "
                                 f"{seq_axis}={mesh.shape[seq_axis]}")
            self.seq_group = mesh.group(seq_axis)
        if step_cache in ("", "off", "none", "exact"):
            step_cache = None
        if step_cache not in (None, "uniform", "dynamic"):
            raise ValueError(
                f"step_cache={step_cache!r}: expected None/'off', 'uniform' or 'dynamic'")
        self.step_cache = step_cache
        self.step_cache_threshold = float(step_cache_threshold)
        stride, tail = int(cfg_cache_stride), int(cfg_tail)
        if stride < 1:
            raise ValueError(f"cfg_cache_stride={cfg_cache_stride} must be >= 1")
        if (stride > 1 or tail > 0) and step_cache == "uniform":
            raise ValueError(
                "cfg_cache_stride/cfg_tail compose with step_cache None or 'dynamic', "
                "not 'uniform'")
        self.sampler = make_sampler(scheduler, sampler, num_inference_steps,
                                    timestep_schedule=timestep_schedule,
                                    schedule_rho=schedule_rho)
        n = self.sampler.num_steps
        # the per-step plans: reuse on skip[i]; the dynamic criterion only
        # where allow[i]; the CFG pair where cfg_plan's mask, else cond only
        self.skip = make_skip_mask(n) if step_cache == "uniform" else None
        self.allow = make_allow_mask(n) if step_cache == "dynamic" else None
        self.cfg_plan = None
        if (stride > 1 or tail > 0) and self.guidance_scale > 1.0:
            self.cfg_plan = make_cfg_plan(n, stride, self.guidance_scale, warmup=cfg_cache_warmup,
                                          cooldown=cfg_cache_cooldown, tail=tail)

    @torch.inference_mode()
    def clip(
        self,
        ref_pixels: torch.Tensor,     # (B, 1+M, H, W, 3) in [-1, 1]
        latents: torch.Tensor,        # (B, F, H/8, W/8, 4)
        audio_windows: torch.Tensor,  # (B, F, 2*margin+1, blocks, C)
        face_emb: torch.Tensor,       # (B, 512)
        face_region: torch.Tensor,    # (B, H, W, 3)
        masks: Sequence[Sequence[torch.Tensor]],  # 4 x (full, face, lip), each (B, L_d)
        motion_scale: torch.Tensor,   # (3,)
        timings: Optional[dict] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One clip. Returns (frames (B, F, H, W, 3) uint8, next clip's
        motion frames (B, M, H, W, 3) in [-1, 1]).

        With `timings`, the card is synchronised at the end of each phase
        and the seconds since the last such mark are appended under
        "vae_encode", "conditioning", "denoise_step" (one a step) and
        "vae_decode"; each step's kind ("full": the CFG pair, "cond": the
        cond half alone, "reuse": no denoiser call) goes under "step_kind"
        and, with the dynamic step cache, each allowed step's accumulated
        change under "step_cache_score". Without it nothing synchronises
        but the waits named in `profiling.wait`.

        The clip is the span `hallo.clip`, holding `hallo.clip.encode`,
        `hallo.clip.condition`, one `hallo.step` a sampler step (inside it
        `hallo.step.denoise` and `hallo.step.sampler`) and
        `hallo.clip.decode`."""
        profiling.count("clip")
        with profiling.span("hallo.clip"):
            m = self.models
            dev = m.device
            last = _synced_clock(dev) if timings is not None else 0.0

            def mark(phase: str) -> None:
                """With `timings`: the seconds since the last mark under `phase`."""
                nonlocal last
                if timings is not None:
                    now = _synced_clock(dev)
                    timings.setdefault(phase, []).append(now - last)
                    last = now

            b, one_m, hp, wp = ref_pixels.shape[:4]
            group = self.seq_group
            if group is not None:
                # this rank's frames of every per-frame input
                latents = local_slice(latents, group, dim=1)
                audio_windows = local_slice(audio_windows, group, dim=1)
            f = latents.shape[1]

            # --- VAE-encode reference + motion frames (posterior mean) ---
            with profiling.span("hallo.clip.encode"):
                flat_ref = ref_pixels.reshape(b * one_m, hp, wp, 3).permute(0, 3, 1, 2)
                ref_latents = m.vae.encode_mean(flat_ref).repeat(2, 1, 1, 1)  # CFG-major
            mark("vae_encode")

            with profiling.span("hallo.clip.condition"):
                # --- identity tokens (uncond = zero embedding) + ReferenceNet ---
                tokens_c = m.image_proj(face_emb)
                tokens_u = m.image_proj(torch.zeros_like(face_emb))
                context = torch.cat([tokens_u, tokens_c], dim=0)  # (2B, T, D)
                if self.legacy_context_tiling:
                    ref_context = context.repeat(one_m, 1, 1)
                else:
                    ref_context = context.repeat_interleave(one_m, 0)
                _, feats = m.reference_net(
                    ref_latents, torch.zeros((), device=dev), ref_context
                )
                split = {k: [x.unflatten(0, (2 * b, one_m)) for x in v] for k, v in feats.items()}
                ref_feats = {k: [x[:, 0] for x in v] for k, v in split.items()}
                motion_feats = {k: [x[:, 1:] for x in v] for k, v in split.items()}

                # --- face locator (same mask every frame) and audio tokens, each
                # with a zeroed CFG-uncond half ---
                fc = m.face_locator(face_region.permute(0, 3, 1, 2))  # (B, C0, h, w)
                fc = fc[:, None].expand(-1, f, -1, -1, -1)
                face_cond = torch.cat([torch.zeros_like(fc), fc], dim=0)
                audio_tokens = m.audio_proj(audio_windows)
                audio_tokens = torch.cat([torch.zeros_like(audio_tokens), audio_tokens], dim=0)
                masks_cfg = tuple(
                    tuple(x[:, None].expand(-1, f, -1).repeat(2, 1, 1).flatten(0, 1) for x in lvl)
                    for lvl in masks
                )
            mark("conditioning")

            den = m.denoising_net
            g = self.guidance_scale

            def run_halves(t, lat):
                # cfg_split: the uncond half runs plain self-attention and the
                # zero-audio fast path
                out = den(lat.repeat(2, 1, 1, 1, 1), t, context, ref_feats, motion_feats,
                          audio_tokens, face_cond, masks_cfg, motion_scale, None, cfg_split=True,
                          seq_group=group)
                return out[:b], out[b:]

            def run_step(t, lat):
                un, co = run_halves(t, lat)
                return (un + g * (co - un) if g > 1.0 else co).float()

            if self.cfg_plan is not None:
                un_mask, guid_w = self.cfg_plan
                # every conditioning tensor sliced to the cond half (rows b:;
                # the masks' rows are CFG-major over B*F); with cfg_split off and
                # no uncond mask, every sample takes the conditional path
                cond = (_half(context, b), _half(ref_feats, b), _half(motion_feats, b),
                        audio_tokens[b:], face_cond[b:], _half(masks_cfg, b * f))

                def run_cached_cfg(i, t, lat, u_prev):
                    """(pred, uncond to cache, kind): the CFG pair where
                    un_mask[i], else the cond half against the cached uncond; the
                    guidance weight is the plan's (1.0 in the cfg_tail steps)."""
                    if un_mask[i]:
                        un, co = run_halves(t, lat)
                        un, co, kind = un.float(), co.float(), "full"
                    else:
                        co = den(lat, t, *cond, motion_scale, None, cfg_split=False,
                                 seq_group=group).float()
                        un, kind = u_prev, "cond"
                    return un + float(np.float32(guid_w[i])) * (co - un), un, kind

            lat = latents.permute(0, 1, 4, 2, 3).float()  # (B, F, 4, h, w)
            samp = self.sampler
            carry = samp.init_carry(lat)
            prev_out = u_prev = torch.zeros_like(lat)
            anchor, accum = lat, torch.zeros((), device=dev)
            thresh = float(np.float32(self.step_cache_threshold))
            kinds, scores = [], []
            for i in range(samp.num_steps):
                with profiling.span("hallo.step"):
                    with profiling.wait("timestep"):
                        t = torch.tensor(int(samp.timesteps[i]), device=dev)
                    if self.allow is not None and self.allow[i]:
                        # The dynamic criterion, in fp32 as in the JAX package; the
                        # host needs the decision, so this step synchronises once.
                        diff = _relative_change(lat, anchor, group)
                        with profiling.wait("cache_score"):
                            score = (accum + diff).item()
                        scores.append(score)
                        reuse = score < thresh
                    else:
                        reuse = self.skip is not None and bool(self.skip[i])
                    if reuse:
                        out, kind = prev_out, "reuse"
                        if self.allow is not None:
                            accum = accum + diff
                    else:
                        with profiling.span("hallo.step.denoise"):
                            if self.cfg_plan is not None:
                                out, u_prev, kind = run_cached_cfg(i, t, lat, u_prev)
                            else:
                                out, kind = run_step(t, lat), "full"
                        anchor, accum, prev_out = lat, torch.zeros((), device=dev), out
                    kinds.append(kind)
                    profiling.count(STEP_COUNTERS[kind])
                    with profiling.span("hallo.step.sampler"):
                        lat, carry = samp.step(i, out, lat, carry)
                mark("denoise_step")
            if timings is not None:
                timings.setdefault("step_kind", []).extend(kinds)
                if self.allow is not None:
                    timings.setdefault("step_cache_score", []).extend(scores)

            # --- batched VAE decode -> uint8 (each rank its frames, gathered);
            # motion carry from the uint8 ---
            with profiling.span("hallo.clip.decode"):
                pix = m.vae.decode(lat.flatten(0, 1))  # (B*F, 3, H, W)
                pix = torch.clamp(pix.float() / 2 + 0.5, 0.0, 1.0)
                frames = torch.round(pix * 255.0).to(torch.uint8)
                frames = frames.permute(0, 2, 3, 1).unflatten(0, (b, f))
                if group is not None:
                    frames = all_gather(frames, group, dim=1)
                next_motion = frames[:, -self.n_motion_frames:].float() / 127.5 - 1.0
            mark("vae_decode")
            return frames, next_motion

    @torch.inference_mode()
    def __call__(
        self,
        ref_image: np.ndarray,       # (B, H, W, 3) in [-1, 1]
        audio_windows: np.ndarray,   # (T, 2*margin+1, blocks, C), T % clip_length == 0
        face_emb: np.ndarray,        # (B, 512)
        face_region: np.ndarray,     # (B, H, W, 3)
        masks: MaskPyramid,          # 4 x (full, face, lip), each (B, L_d)
        motion_scale=(1.0, 1.0, 1.0),
        seed: int = 42,
        audio_length: Optional[int] = None,
        on_clip: Optional[Callable[[np.ndarray], None]] = None,
        return_video: bool = True,
        latents: Optional[Sequence[np.ndarray]] = None,
        timings: Optional[dict] = None,
    ) -> Optional[np.ndarray]:
        """Generate the video clip by clip with the motion-frame carry.
        Each clip's initial noise (B, F, H/8, W/8, 4) is `latents[c]` when
        given, else drawn from a torch.Generator seeded with `seed`.
        Returns (B, T_out, H, W, 3) float32 in [0, 1].

        Clip c+1 depends on clip c only through the motion frames on the
        device, so it is dispatched before clip c's frames are fetched: on
        the card, clip c's uint8 frames go to pinned host memory on a side
        stream that waits for clip c's decode alone, while clip c+1 runs
        (`timings`, which synchronises at every mark, serialises this).
        `on_clip(frames_uint8)` receives each clip's (B, f', H, W, 3) frames,
        trimmed to `audio_length`. With `return_video=False` no frames are
        kept and None is returned.

        The waits are `inputs` (each host array copied to the card) and
        `frames` (each clip's fetch); each `on_clip` call is the span
        `hallo.emit`, the caller's own time."""
        profiling.count("request")
        dev = self.models.device
        b, h, w, _ = ref_image.shape
        f, m_frames = self.clip_length, self.n_motion_frames
        t_total = audio_windows.shape[0]
        if t_total % f:
            raise ValueError(f"{t_total} audio windows: pad them to a multiple of "
                             f"clip_length={f} first")
        num_clips = t_total // f

        def put(x):
            with profiling.wait("inputs"):
                return torch.tensor(np.asarray(x), dtype=torch.float32, device=dev)

        ref = put(ref_image)
        face_emb_t, face_region_t = put(face_emb), put(face_region)
        masks_t = tuple(tuple(put(x) for x in lvl) for lvl in masks)
        motion_scale_t = put(motion_scale)
        gen = torch.Generator(device=dev).manual_seed(seed)
        # First clip: the motion frames are copies of the reference image.
        motion = ref[:, None].expand(-1, m_frames, -1, -1, -1)
        copy_stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None

        def start_fetch(frames: torch.Tensor):
            """Begin the copy of one clip's frames to the host; returns a
            function that waits for it and gives the numpy array."""
            if copy_stream is None:
                return frames.numpy
            decoded = torch.cuda.Event()
            decoded.record()
            host = torch.empty(frames.shape, dtype=frames.dtype, pin_memory=True)
            with torch.cuda.stream(copy_stream):
                copy_stream.wait_event(decoded)
                host.copy_(frames, non_blocking=True)
                copied = torch.cuda.Event()
                copied.record()
            frames.record_stream(copy_stream)

            def wait():
                copied.synchronize()
                return host.numpy()

            return wait

        limit = audio_length if audio_length is not None else t_total
        outputs, emitted, pending = [], 0, None

        def emit(fetch) -> None:
            nonlocal emitted
            take = min(f, limit - emitted)
            if take <= 0:
                return
            with profiling.wait("frames"):
                arr = fetch()[:, :take]
            emitted += take
            if on_clip is not None:
                with profiling.span("hallo.emit"):
                    on_clip(arr)
            if return_video:
                outputs.append(arr.astype(np.float32) / 255.0)

        for c in range(num_clips):
            if latents is not None:
                noise = put(latents[c])
            else:
                noise = torch.randn((b, f, h // 8, w // 8, 4), generator=gen, device=dev)
            clip_audio = put(audio_windows[c * f:(c + 1) * f])[None].expand(b, -1, -1, -1, -1)
            ref_pixels = torch.cat([ref[:, None], motion], dim=1)
            frames, motion = self.clip(
                ref_pixels, noise, clip_audio, face_emb_t, face_region_t, masks_t,
                motion_scale_t, timings,
            )
            if pending is not None:
                emit(pending)
            pending = start_fetch(frames)
        emit(pending)
        return np.concatenate(outputs, axis=1) if return_video else None
