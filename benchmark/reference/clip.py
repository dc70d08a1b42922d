"""One clip of the reference pipeline, stage by stage, in plain PyTorch:
the conditioning (VAE encode of the reference and motion frames, identity
tokens, ReferenceNet, audio tokens, face condition, mask pyramid), one CFG
evaluation of the denoiser, and the VAE decode to uint8 frames.

The identity tokens tile over the ReferenceNet batch as the reference
implementation tiles them (mutual_self_attention.py): the 2B CFG-major rows
[uncond | cond] repeat (1+M) times over the B*(1+M) frame-major latents,
so a row's tokens are those of its index modulo 2B. Public layouts: pixels
(B, ..., H, W, 3) in [-1, 1]; latents (B, F, 4, h, w).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch


def conditioning(mods: Dict[str, torch.nn.Module], ref_pixels, face_emb, face_region,
                 audio_windows, masks: Sequence[Sequence[torch.Tensor]]) -> dict:
    """ref_pixels (B, 1+M, H, W, 3); face_emb (B, E); face_region (B, H, W, 3);
    audio_windows (B, F, window, blocks, C); masks per depth (full, face, lip)
    each (B, L_d)."""
    b, one_m = ref_pixels.shape[:2]
    f = audio_windows.shape[1]
    lat = mods["vae"].encode_mean(ref_pixels.flatten(0, 1).permute(0, 3, 1, 2))
    tok_u = mods["image_proj"](torch.zeros_like(face_emb))
    tok_c = mods["image_proj"](face_emb)
    ctx = torch.cat([tok_u, tok_c], dim=0)
    feats = mods["reference_net"](lat.repeat(2, 1, 1, 1), ctx.repeat(one_m, 1, 1))
    split = {k: [x.unflatten(0, (2 * b, one_m)) for x in v] for k, v in feats.items()}
    audio = mods["audio_proj"](audio_windows)
    fc = mods["face_locator"](face_region.permute(0, 3, 1, 2))
    return dict(
        frames=f,
        ctx_u=tok_u, ctx_c=tok_c,
        ref_c={k: [x[b:, 0] for x in v] for k, v in split.items()},
        mot_u={k: [x[:b, 1:] for x in v] for k, v in split.items()},
        mot_c={k: [x[b:, 1:] for x in v] for k, v in split.items()},
        audio_c=audio, audio_u=torch.zeros_like(audio),
        face=fc[:, None].expand(-1, f, -1, -1, -1),
        masks=tuple(tuple(m[:, None].expand(-1, f, -1).flatten(0, 1) for m in lvl)
                    for lvl in masks),
    )


def evaluate(mods, cond: dict, lat: torch.Tensor, t: int, motion_scale: torch.Tensor):
    """The denoiser's (uncond, cond) outputs at latents `lat`, timestep t."""
    den = mods["denoising_net"]
    out_u = den(lat, t, cond["ctx_u"], None, cond["mot_u"], cond["audio_u"], None,
                cond["masks"], motion_scale, uncond=True)
    out_c = den(lat, t, cond["ctx_c"], cond["ref_c"], cond["mot_c"], cond["audio_c"],
                cond["face"], cond["masks"], motion_scale, uncond=False)
    return out_u, out_c


def decode_uint8(mods, lat: torch.Tensor, chunk: int = 4) -> torch.Tensor:
    """(B, F, 4, h, w) latents -> (B, F, H, W, 3) uint8, `chunk` frames at a time."""
    flat = lat.flatten(0, 1)
    outs = []
    for s in range(0, flat.shape[0], chunk):
        pix = mods["vae"].decode(flat[s:s + chunk]).float()
        pix = torch.clamp(pix / 2 + 0.5, 0.0, 1.0)
        outs.append(torch.round(pix * 255.0).to(torch.uint8).permute(0, 2, 3, 1))
    return torch.cat(outs).unflatten(0, lat.shape[:2])
