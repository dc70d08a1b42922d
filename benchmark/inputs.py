"""Seeded inputs of the benchmark's requests and training batches, made by
the benchmark itself (a copy of the arithmetic of the port's
`dummy_clip_inputs` and `synthetic_batch`, with face regions and masks
that are not all ones).

Every draw is a function of (seed, request or batch index), and every seed
gives the same shapes.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def _rng(seed: int, *index: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32, *index])


def face_box(rng: np.random.Generator, size: int) -> Tuple[int, int, int, int]:
    """A face rectangle (y0, y1, x0, x1) of 40-70% of the image, inside it."""
    side = int(rng.uniform(0.4, 0.7) * size)
    y0 = int(rng.integers(0, size - side + 1))
    x0 = int(rng.integers(0, size - side + 1))
    return y0, y0 + side, x0, x0 + side


def region_masks(boxes: List[Tuple[int, int, int, int]], h: int, w: int):
    """The face-region image (B, H, W, 3) and the mask pyramid: per depth d
    of the latent (h/8 / 2**d), (full, face, lip) each (B, L_d) float32.
    full is the face box grown by a fifth, face the box, lip its lower
    middle third."""
    b = len(boxes)
    region = np.zeros((b, h, w, 3), np.float32)
    rects = []
    for i, (y0, y1, x0, x1) in enumerate(boxes):
        region[i, y0:y1, x0:x1] = 1.0
        gy, gx = (y1 - y0) // 10, (x1 - x0) // 10
        full = (max(0, y0 - gy), min(h, y1 + gy), max(0, x0 - gx), min(w, x1 + gx))
        lip = (y0 + 2 * (y1 - y0) // 3, y1, x0 + (x1 - x0) // 3, x1 - (x1 - x0) // 3)
        rects.append((full, (y0, y1, x0, x1), lip))
    masks = []
    for d in range(4):
        s = 8 * 2 ** d
        hd, wd = h // s, w // s
        cy = (np.arange(hd) + 0.5) * s
        cx = (np.arange(wd) + 0.5) * s
        lvl = []
        for k in range(3):
            m = np.zeros((b, hd * wd), np.float32)
            for i in range(b):
                y0, y1, x0, x1 = rects[i][k]
                inside = ((cy[:, None] >= y0) & (cy[:, None] < y1)
                          & (cx[None] >= x0) & (cx[None] < x1))
                m[i] = inside.reshape(-1)
            lvl.append(m)
        masks.append(tuple(lvl))
    return region, tuple(masks)


def clip_request(seed: int, index: int, cfg: dict, batch: int, clips: int) -> Dict:
    """One request of `clips` clips for `batch` identities:
    `FaceAnimatePipeline.__call__`'s inputs, and the initial noise of each
    clip (B, F, h, w, 4)."""
    rng = _rng(seed, 1, index)
    size, f = cfg["height"], cfg["clip_length"]
    ap, ip = cfg["audio_proj"], cfg["image_proj"]
    region, masks = region_masks([face_box(rng, size) for _ in range(batch)], size, size)
    hl = size // 8
    return dict(
        ref_image=rng.uniform(-1, 1, size=(batch, size, size, 3)).astype(np.float32),
        audio_windows=rng.standard_normal(
            (clips * f, ap["seq_len"], ap["blocks"], ap["channels"]), np.float32),
        face_emb=rng.standard_normal((batch, ip["clip_embeddings_dim"]), np.float32),
        face_region=region,
        masks=masks,
        noise=[rng.standard_normal((batch, f, hl, hl, 4), np.float32) for _ in range(clips)],
    )


def train_batch(seed: int, index: int, cfg: dict, batch: int) -> Dict:
    """One stage-2 batch (JAX layouts): pixel_values (B, F, H, W, 3),
    ref_pixels (B, H, W, 3), motion_pixels (B, M, H, W, 3), audio_windows
    (B, F, window, blocks, C), face_emb, face_region, masks."""
    rng = _rng(seed, 2, index)
    size, f, m = cfg["height"], cfg["clip_length"], cfg["n_motion_frames"]
    ap, ip = cfg["audio_proj"], cfg["image_proj"]
    region, masks = region_masks([face_box(rng, size) for _ in range(batch)], size, size)

    def uniform(*shape):
        return rng.uniform(-1, 1, size=shape).astype(np.float32)

    return dict(
        pixel_values=uniform(batch, f, size, size, 3),
        ref_pixels=uniform(batch, size, size, 3),
        motion_pixels=uniform(batch, m, size, size, 3),
        audio_windows=rng.standard_normal(
            (batch, f, ap["seq_len"], ap["blocks"], ap["channels"]), np.float32),
        face_emb=rng.standard_normal((batch, ip["clip_embeddings_dim"]), np.float32),
        face_region=region,
        masks=masks,
    )
