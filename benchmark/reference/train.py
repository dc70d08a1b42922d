"""The reference's stage-2 training step in plain PyTorch (Hallo's
scripts/train_stage2.py as configs/train/stage2.yaml sets it): the VAE
encode of the clip, the noise, the timesteps and the per-step dropout
draws from the step's generator, the v-prediction target, the Min-SNR-5
weighted loss, the backward through the denoiser (the stage-1 modules
frozen and without gradient; the denoiser's spatial layers frozen but on
the gradient's path) to the motion modules, the audio modules and the
audio projection, the clip of the global gradient norm and AdamW with a
linear warm-up, over fp32 parameters.

The generator's draws come in the order the measured program makes them:
noise (B, F, 4, h, w), the noise offset (B, 1, 4, 1, 1), the timesteps
(B,), then the two uniform dropout draws.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from benchmark.reference.sampling import alphas_cumprod


def trainable(top: str, name: str) -> bool:
    if top == "audio_proj":
        return True
    return top == "denoising_net" and any(
        "motion_modules" in p or "audio_modules" in p for p in name.split("."))


def leaf_norms(tensors: List[torch.Tensor]) -> torch.Tensor:
    return torch.stack([t.float().norm() for t in tensors])


class Stage2:
    def __init__(self, mods: Dict[str, torch.nn.Module], cfg: dict, device):
        self.mods, self.cfg, self.device = mods, cfg, device
        self.params: Dict[str, torch.nn.Parameter] = {}
        for top, mod in mods.items():
            for name, p in mod.named_parameters():
                p.requires_grad_(trainable(top, name))
                if p.requires_grad:
                    self.params[f"{top}.{name}"] = p
        mods["denoising_net"].checkpoint = True
        self.acp = torch.tensor(alphas_cumprod(cfg["scheduler"]), device=device)
        self.count = 0
        self.mu = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in self.params.items()}

    def encode(self, px: torch.Tensor, chunk: int = 8) -> torch.Tensor:
        """(N, H, W, 3) pixels -> latents, `chunk` images at a time."""
        vae = self.mods["vae"]
        return torch.cat([vae.encode_mean(px[s:s + chunk].permute(0, 3, 1, 2))
                          for s in range(0, px.shape[0], chunk)])

    def loss(self, batch: Dict[str, torch.Tensor], gen: torch.Generator = None,
             meta: bool = False) -> torch.Tensor:
        """The step's loss; `meta`: on meta tensors, with no draws (no
        dropout), for counting the work."""
        m, tc = self.mods, self.cfg["train"]
        dev = self.device
        px = batch["pixel_values"]
        b, f = px.shape[:2]
        with torch.no_grad():
            lat = self.encode(px.flatten(0, 1)).unflatten(0, (b, f))
        if meta:
            noise = torch.empty_like(lat)
            t = torch.zeros(b, dtype=torch.long, device=dev)
        else:
            noise = torch.randn((b, f) + lat.shape[2:], generator=gen, device=dev)
            if tc["noise_offset"] > 0:
                noise = noise + tc["noise_offset"] * torch.randn(
                    (b, 1, lat.shape[2], 1, 1), generator=gen, device=dev)
            t = torch.randint(0, self.cfg["scheduler"]["num_train_timesteps"], (b,),
                              generator=gen, device=dev)
        a = self.acp[t].float().reshape(b, 1, 1, 1, 1)
        noisy = a.sqrt() * lat + (1 - a).sqrt() * noise
        target = a.sqrt() * noise - (1 - a).sqrt() * lat
        if meta:
            u = u_start = 0.5
        else:
            u = torch.rand((), generator=gen, device=dev).item()
            u_start = torch.rand((), generator=gen, device=dev).item()
        p_i, p_a, p_ia = tc["uncond_img_ratio"], tc["uncond_audio_ratio"], tc["uncond_ia_ratio"]
        both = u >= np.float32(1.0 - p_ia)
        drop_img = bool(u < np.float32(p_i)) or both
        drop_audio = bool(np.float32(p_i) <= u < np.float32(p_i + p_a)) or both
        start = u_start < np.float32(tc["start_ratio"])

        emb = batch["face_emb"] * (0.0 if drop_img else 1.0)
        motion_px = batch["motion_pixels"] * (0.0 if start else 1.0)
        ref_px = torch.cat([batch["ref_pixels"][:, None], motion_px], dim=1)
        one_m = ref_px.shape[1]
        with torch.no_grad():
            ref_lat = self.encode(ref_px.flatten(0, 1))
            tokens = m["image_proj"](emb)
            feats = m["reference_net"](ref_lat, tokens.repeat(one_m, 1, 1))
            fc = m["face_locator"](batch["face_region"].permute(0, 3, 1, 2))
        split = {k: [x.unflatten(0, (b, one_m)) for x in v] for k, v in feats.items()}
        ref = None if drop_img else {k: [x[:, 0] for x in v] for k, v in split.items()}
        motion = {k: [x[:, 1:] for x in v] for k, v in split.items()}
        audio = m["audio_proj"](batch["audio_windows"] * (0.0 if drop_audio else 1.0))
        masks = tuple(tuple(x.repeat_interleave(f, dim=0) for x in lvl) for lvl in batch["masks"])
        pred = m["denoising_net"](noisy, t, tokens, ref, motion, audio,
                                  fc[:, None].expand(-1, f, -1, -1, -1), masks,
                                  torch.ones(3, device=dev), uncond=False, fusion="all")
        per = (pred - target).square().mean(dim=(1, 2, 3, 4))
        snr = (a / (1 - a)).reshape(b) + 1.0
        gamma = tc["snr_gamma"]
        return (per * torch.clamp(snr, max=gamma) / snr).mean()

    def step(self, batch, gen, masters: Dict[str, torch.Tensor] = None) -> dict:
        """One step; returns the loss, the clipped gradient's leaf norms and
        whether the step was taken. With `masters` (fp32 copies, keyed as
        `params`), the loss and gradient are taken at `params` and the
        update is made to `masters`."""
        o = self.cfg["optimizer"]
        loss = self.loss(batch, gen)
        names = list(self.params)
        grads = torch.autograd.grad(loss, [self.params[n] for n in names], allow_unused=True)
        gs = [torch.zeros_like(self.params[n]) if g is None else g.detach()
              for n, g in zip(names, grads)]
        lv = float(loss.detach())
        norm = float(leaf_norms(gs).norm())
        if not (np.isfinite(lv) and np.isfinite(norm)):
            return dict(loss=lv, grad_norms=None, taken=False)
        if not norm < o["max_grad_norm"]:
            gs = [g / norm * o["max_grad_norm"] for g in gs]
        count = self.count
        warm = o["lr_warmup_steps"]
        lr = o["learning_rate"] * (min(max(count, 0), warm) / warm if warm > 0 else 1.0)
        c = count + 1
        c1, c2 = 1.0 - o["beta1"] ** c, 1.0 - o["beta2"] ** c
        target = self.params if masters is None else masters
        with torch.no_grad():
            for n, g in zip(names, gs):
                p, mu, nu = target[n], self.mu[n], self.nu[n]
                mu.mul_(o["beta1"]).add_(g, alpha=1 - o["beta1"])
                nu.mul_(o["beta2"]).addcmul_(g, g, value=1 - o["beta2"])
                upd = (mu / c1) / ((nu / c2).sqrt() + o["eps"]) + o["weight_decay"] * p
                p.add_(upd, alpha=-lr)
        self.count = c
        return dict(loss=lv, grad_norms=leaf_norms(gs), taken=True)
