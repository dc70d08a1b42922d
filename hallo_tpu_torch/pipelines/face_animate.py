"""Audio-driven portrait animation pipeline (counterpart of
hallo_tpu/pipelines/face_animate.py).

One clip: VAE-encode the reference frame and the motion frames (posterior
mean) -> identity tokens and one ReferenceNet pass -> face-locator and audio
conditioning, each with a zeroed CFG-uncond half -> the CFG [uncond | cond]
DDIM loop over the denoising UNet with `cfg_split` -> one batched VAE decode
to uint8, whose last frames are the next clip's motion frames. `__call__`
slides that clip program over the audio windows.

Public layouts are the JAX package's: pixels (B, H, W, 3) in [-1, 1],
latents (B, F, H/8, W/8, 4). Inside, tensors are NCHW.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from hallo_tpu_torch.config import (
    AudioProjConfig,
    FaceLocatorConfig,
    ImageProjConfig,
    SchedulerConfig,
    UNetConfig,
    VAEConfig,
)
from hallo_tpu_torch.diffusion.sampler import make_sampler
from hallo_tpu_torch.models.face_locator import FaceLocator
from hallo_tpu_torch.models.projections import AudioProj, ImageProj
from hallo_tpu_torch.models.unet_denoise import DenoisingUNet
from hallo_tpu_torch.models.unet_ref import ReferenceNet
from hallo_tpu_torch.models.vae import AutoencoderKL

MaskPyramid = Tuple[Tuple[np.ndarray, np.ndarray, np.ndarray], ...]

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


class _Phases:
    """Wall-clock seconds per phase, synchronising the card at each mark;
    a no-op without a dict to fill."""

    def __init__(self, out: Optional[dict], device: torch.device):
        self.out, self.device = out, device
        self.t = self._now() if out is not None else 0.0

    def _now(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def mark(self, name: str) -> None:
        if self.out is None:
            return
        now = self._now()
        self.out.setdefault(name, []).append(now - self.t)
        self.t = now


class FaceAnimatePipeline:
    def __init__(
        self,
        models: HalloModels,
        scheduler: SchedulerConfig = SchedulerConfig(),
        num_inference_steps: int = 40,
        guidance_scale: float = 3.5,
        clip_length: int = 16,
        n_motion_frames: int = 2,
    ):
        self.models = models
        self.guidance_scale = float(guidance_scale)
        self.clip_length = clip_length
        self.n_motion_frames = n_motion_frames
        self.sampler = make_sampler(scheduler, "ddim", num_inference_steps)

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
        motion frames (B, M, H, W, 3) in [-1, 1])."""
        m = self.models
        dev = m.device
        phases = _Phases(timings, dev)
        b, one_m, hp, wp = ref_pixels.shape[:4]
        f = latents.shape[1]

        # --- VAE-encode reference + motion frames (posterior mean) ---
        flat_ref = ref_pixels.reshape(b * one_m, hp, wp, 3).permute(0, 3, 1, 2)
        ref_latents = m.vae.encode_mean(flat_ref).repeat(2, 1, 1, 1)  # CFG-major
        phases.mark("vae_encode")

        # --- identity tokens (uncond = zero embedding) + ReferenceNet ---
        tokens_c = m.image_proj(face_emb)
        tokens_u = m.image_proj(torch.zeros_like(face_emb))
        context = torch.cat([tokens_u, tokens_c], dim=0)  # (2B, T, D)
        # The identity tokens tile over the ReferenceNet batch the way the
        # reference does (mutual_self_attention.py:341-349, misaligned with
        # the frames): what the trained checkpoint saw.
        ref_context = context.repeat(one_m, 1, 1)
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
        phases.mark("conditioning")

        # --- CFG DDIM loop (cfg_split: the uncond half runs plain
        # self-attention and the zero-audio fast path) ---
        lat = latents.permute(0, 1, 4, 2, 3).float()  # (B, F, 4, h, w)
        samp = self.sampler
        for i in range(samp.num_steps):
            t = torch.tensor(int(samp.timesteps[i]), device=dev)
            out = m.denoising_net(
                lat.repeat(2, 1, 1, 1, 1), t, context, ref_feats, motion_feats,
                audio_tokens, face_cond, masks_cfg, motion_scale, None, cfg_split=True,
            )
            un, co = out[:b], out[b:]
            pred = un + self.guidance_scale * (co - un) if self.guidance_scale > 1.0 else co
            lat = samp.step(i, pred, lat)
            phases.mark("denoise_step")

        # --- batched VAE decode -> uint8; motion carry from the uint8 ---
        pix = m.vae.decode(lat.flatten(0, 1))  # (B*F, 3, H, W)
        pix = torch.clamp(pix.float() / 2 + 0.5, 0.0, 1.0)
        frames = torch.round(pix * 255.0).to(torch.uint8)
        frames = frames.permute(0, 2, 3, 1).unflatten(0, (b, f))
        next_motion = frames[:, -self.n_motion_frames:].float() / 127.5 - 1.0
        phases.mark("vae_decode")
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
        latents: Optional[Sequence[np.ndarray]] = None,
        timings: Optional[dict] = None,
    ) -> np.ndarray:
        """Generate the video clip by clip with the motion-frame carry.
        Each clip's initial noise (B, F, H/8, W/8, 4) is `latents[c]` when
        given, else drawn from a torch.Generator seeded with `seed`.
        Returns (B, T_out, H, W, 3) float32 in [0, 1]."""
        dev = self.models.device
        b, h, w, _ = ref_image.shape
        f, m_frames = self.clip_length, self.n_motion_frames
        t_total = audio_windows.shape[0]
        if t_total % f:
            raise ValueError(f"{t_total} audio windows: pad them to a multiple of "
                             f"clip_length={f} first")
        num_clips = t_total // f

        def put(x):
            return torch.tensor(np.asarray(x), dtype=torch.float32, device=dev)

        ref = put(ref_image)
        face_emb_t, face_region_t = put(face_emb), put(face_region)
        masks_t = tuple(tuple(put(x) for x in lvl) for lvl in masks)
        motion_scale_t = put(motion_scale)
        gen = torch.Generator(device=dev).manual_seed(seed)
        # First clip: the motion frames are copies of the reference image.
        motion = ref[:, None].expand(-1, m_frames, -1, -1, -1)

        outputs = []
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
            outputs.append(frames.cpu().numpy())
        video = np.concatenate(outputs, axis=1)
        limit = audio_length if audio_length is not None else t_total
        return video[:, :limit].astype(np.float32) / 255.0
