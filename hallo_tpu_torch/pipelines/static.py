"""Static (single-image) pipeline, the stage-1 validation path (counterpart
of hallo_tpu/pipelines/static.py; reference
hallo/animate/face_animate_static.py:76-481).

The video pipeline's skeleton with a single frame, no motion frames and no
audio: VAE-encode the reference (posterior mean) -> one ReferenceNet pass
over both CFG halves with the identity context [image_proj(0) |
image_proj(emb)] (so the halves' features differ) -> face conditioning
[0 | face_locator(region)] -> the CFG denoise loop over the 2D denoiser,
whose uncond half is masked from the ref tokens by `uncond_mask` [1... |
0...] (JAX's batch layout; no `cfg_split`) -> VAE decode, clip(x/2 + 0.5).

Public layouts are the JAX package's: pixels (B, H, W, 3) in [-1, 1],
latents (B, 1, H/8, W/8, 4). The JAX package's `HALLO_HOIST_REF_KV` (the
ref K/V hoisted out of the loop, measured slower there) is not ported.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from hallo_tpu_torch.config import SchedulerConfig
from hallo_tpu_torch.diffusion.sampler import make_sampler
from hallo_tpu_torch.pipelines.face_animate import HalloModels


class StaticPipeline:
    """One reference portrait -> one generated image (identity transfer)."""

    def __init__(
        self,
        models: HalloModels,
        scheduler: SchedulerConfig = SchedulerConfig(),
        num_inference_steps: int = 20,
        guidance_scale: float = 3.5,
        sampler: str = "ddim",
    ):
        self.models = models
        self.guidance_scale = float(guidance_scale)
        self.sampler = make_sampler(scheduler, sampler, num_inference_steps)

    @torch.inference_mode()
    def denoise(
        self,
        ref_pixels: torch.Tensor,   # (B, H, W, 3) in [-1, 1]
        latents: torch.Tensor,      # (B, 1, H/8, W/8, 4)
        face_emb: torch.Tensor,     # (B, E)
        face_region: torch.Tensor,  # (B, H, W, 3)
    ) -> torch.Tensor:
        """The final latents (B, 1, 4, H/8, W/8) fp32, what the sampler hands
        the VAE decoder, on the models' device."""
        m = self.models
        dev = m.device
        b = ref_pixels.shape[0]
        ref_latents = m.vae.encode_mean(ref_pixels.permute(0, 3, 1, 2)).repeat(2, 1, 1, 1)
        tokens_c = m.image_proj(face_emb)
        tokens_u = m.image_proj(torch.zeros_like(face_emb))
        context = torch.cat([tokens_u, tokens_c], dim=0)  # (2B, T, D)
        # a single reference frame: the bank is the whole batch
        _, ref_feats = m.reference_net(ref_latents, torch.zeros((), device=dev), context)

        fc = m.face_locator(face_region.permute(0, 3, 1, 2))[:, None]  # (B, 1, C0, h, w)
        face_cond = torch.cat([torch.zeros_like(fc), fc], dim=0)
        uncond_mask = torch.cat([torch.ones(b, device=dev), torch.zeros(b, device=dev)])

        den, g, samp = m.denoising_net, self.guidance_scale, self.sampler
        lat = latents.permute(0, 1, 4, 2, 3).float()  # (B, 1, 4, h, w)
        carry = samp.init_carry(lat)
        for i in range(samp.num_steps):
            t = torch.tensor(int(samp.timesteps[i]), device=dev)
            out = den(lat.repeat(2, 1, 1, 1, 1), t, context, ref_feats, None, None,
                      face_cond, None, None, uncond_mask).float()
            un, co = out[:b], out[b:]
            lat, carry = samp.step(i, un + g * (co - un), lat, carry)
        return lat

    @torch.inference_mode()
    def sample(self, ref_pixels: torch.Tensor, latents: torch.Tensor, face_emb: torch.Tensor,
               face_region: torch.Tensor) -> torch.Tensor:
        """`denoise`, then the decode: images (B, H, W, 3) fp32 in [0, 1]."""
        lat = self.denoise(ref_pixels, latents, face_emb, face_region)
        img = self.models.vae.decode(lat[:, 0])  # (B, 3, H, W)
        return torch.clamp(img.float() / 2 + 0.5, 0.0, 1.0).permute(0, 2, 3, 1)

    def __call__(
        self,
        ref_image: np.ndarray,
        face_emb: np.ndarray,
        face_region: np.ndarray,
        seed: int = 42,
        latents: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """(B, H, W, 3) fp32 images in [0, 1]. The initial noise is `latents`
        (B, 1, H/8, W/8, 4) when given, else drawn from a torch.Generator
        seeded with `seed` (JAX draws it from `jax.random`, so one seed gives
        another image in each package)."""
        dev = self.models.device
        b, h, w, _ = ref_image.shape

        def put(x):
            return torch.tensor(np.asarray(x), dtype=torch.float32, device=dev)

        if latents is None:
            gen = torch.Generator(device=dev).manual_seed(seed)
            noise = torch.randn((b, 1, h // 8, w // 8, 4), generator=gen, device=dev)
        else:
            noise = put(latents)
        img = self.sample(put(ref_image), noise, put(face_emb), put(face_region))
        return img.cpu().numpy()
