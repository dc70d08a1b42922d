"""Face/lip mask geometry (pure numpy + cv2, host-side).

The port's copy of hallo_tpu/utils/masks.py (the port imports nothing of the
JAX package); tests/test_torch_preprocess.py holds the two equal.

Re-implements the reference's mask math (hallo/utils/util.py:323-664,
920-958): bbox masks from mediapipe-style landmarks (478 points, silhouette
and lip index sets), region expansion with border clamping, the blur/
normalize treatment, background inversion, face-minus-lip separation, union
masks with bbox fill, and the 4-scale attention-mask pyramid
(image_processor.py:71-180).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import cv2
import numpy as np

# mediapipe FaceLandmarker indices (util.py:323-329)
SILHOUETTE_IDS = [
    10, 338, 297, 332, 284, 251, 389, 356, 454, 323, 361, 288,
    397, 365, 379, 378, 400, 377, 152, 148, 176, 149, 150, 136,
    172, 58, 132, 93, 234, 127, 162, 21, 54, 103, 67, 109,
]
LIP_IDS = [61, 185, 40, 39, 37, 0, 267, 269, 270, 409, 291,
           146, 91, 181, 84, 17, 314, 405, 321, 375]


def expand_region(
    region: Sequence[float], image_w: int, image_h: int, expand_ratio: float = 1.0
) -> Tuple[int, int, int, int]:
    """Scale (min_x, max_x, min_y, max_y) about its center by expand_ratio,
    then shift the box back inside the image (size-preserving clamp).

    Behavioral spec (util.py:529-564 parity, pinned by
    tests/test_mask_fixtures.py): the center uses integer floor-division,
    the scaled half-side floors, clamping shifts low-edge first then
    high-edge, and the result is round()ed per coordinate."""

    def _axis(lo: float, hi: float, limit: int) -> Tuple[int, int]:
        center = (lo + hi) // 2
        half = ((hi - lo) * expand_ratio) // 2
        lo, hi = center - half, center + half
        if lo < 0:  # slide right until the low edge is inside
            lo, hi = 0, hi - lo
        if hi > limit:  # then slide left until the high edge is inside
            lo, hi = lo - (hi - limit), limit
        return round(lo), round(hi)

    lo_x, hi_x, lo_y, hi_y = region
    min_x, max_x = _axis(lo_x, hi_x, image_w)
    min_y, max_y = _axis(lo_y, hi_y, image_h)
    return min_x, max_x, min_y, max_y


def bbox_mask(
    bbox: Sequence[float], height: int, width: int, expand_ratio: float = 1.0
) -> np.ndarray:
    """Filled-rectangle uint8 mask from (min_x, min_y, max_x, max_y)."""
    min_x, min_y, max_x, max_y = bbox
    min_x, max_x, min_y, max_y = expand_region(
        [min_x, max_x, min_y, max_y], width, height, expand_ratio
    )
    mask = np.zeros((height, width), np.uint8)
    mask[min_y:max_y, min_x:max_x] = 255
    return mask


def _landmark_bbox(landmarks: np.ndarray, ids: Sequence[int]) -> Tuple[float, ...]:
    pts = np.take(np.asarray(landmarks), ids, axis=0)
    mn = np.round(pts.min(axis=0))
    mx = np.round(pts.max(axis=0))
    return mn[0], mn[1], mx[0], mx[1]


def face_mask_from_landmarks(
    landmarks: np.ndarray, height: int, width: int, expand_ratio: float = 1.2
) -> np.ndarray:
    """util.py:451-477 — bbox over silhouette landmarks."""
    return bbox_mask(_landmark_bbox(landmarks, SILHOUETTE_IDS), height, width, expand_ratio)


def lip_mask_from_landmarks(
    landmarks: np.ndarray, height: int, width: int, expand_ratio: float = 2.0
) -> np.ndarray:
    """util.py:407-430 — bbox over lip landmarks."""
    return bbox_mask(_landmark_bbox(landmarks, LIP_IDS), height, width, expand_ratio)


def blur_mask(
    mask: np.ndarray,
    resize_dim: Tuple[int, int] = (64, 64),
    kernel_size: Tuple[int, int] = (51, 51),
) -> np.ndarray:
    """Resize -> GaussianBlur -> minmax-stretch to [0, 255] (behavioral
    parity with util.py:589-610; the stretch matches cv2.NORM_MINMAX on
    uint8 incl. its round-half-to-even saturate_cast and its all-zero
    output for a constant input)."""
    blurred = cv2.GaussianBlur(cv2.resize(mask, resize_dim), kernel_size, 0)
    lo = float(blurred.min())
    span = float(blurred.max()) - lo
    gain = 255.0 / span if span > 0 else 0.0
    # gain/offset applied as two ops (x*gain + shift), matching OpenCV's
    # convertTo float path bit-for-bit — (x-lo)*gain rounds differently at
    # a handful of pixels.
    stretched = np.rint(blurred.astype(np.float64) * gain + (-lo * gain))
    return np.clip(stretched, 0, 255).astype(np.uint8)


def background_mask(mask: np.ndarray) -> np.ndarray:
    """Invert a [0,255] mask (util.py:611-637)."""
    return (255 - mask.astype(np.int32)).astype(np.uint8)


def sep_face_mask(face_blur: np.ndarray, lip_blur: np.ndarray) -> np.ndarray:
    """Saturating face-minus-lip (util.py:638-667, cv2.subtract)."""
    return cv2.subtract(face_blur, lip_blur)


def union_mask(masks: List[np.ndarray]) -> Optional[np.ndarray]:
    """Pixel-wise max over the masks, then fill the union's nonzero bounding
    box solid with the global max (behavioral parity with util.py:923-958;
    returns None for an empty list, the all-zero union unchanged). Unlike
    the reference this never mutates its inputs."""
    if not masks:
        return None
    out = np.array(masks[0], copy=True)
    for m in masks[1:]:
        np.maximum(out, m, out=out)
    nz_y, nz_x = np.nonzero(out)
    if nz_y.size:
        out[nz_y.min(): nz_y.max() + 1, nz_x.min(): nz_x.max() + 1] = out.max()
    return out


def separated_masks(
    face_mask: np.ndarray, lip_mask: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(background, face-minus-lip, lip) blurred masks — the inputs of the
    hierarchical audio attention (get_mask pipeline, util.py:497-527)."""
    face_blur = blur_mask(face_mask, (64, 64), (51, 51))
    lip_blur = blur_mask(lip_mask, (64, 64), (31, 31))
    return background_mask(face_blur), sep_face_mask(face_blur, lip_blur), lip_blur


def mask_pyramid(
    mask: np.ndarray, image_size: int, scales: Sequence[int] = (8, 16, 32, 64)
) -> List[np.ndarray]:
    """Resize a mask to image_size/8../64 and flatten each to (1, h*w) in
    [0,1] (image_processor.py:71-98,156-180)."""
    out = []
    for s in scales:
        size = image_size // s
        resized = cv2.resize(
            mask.astype(np.float32) / 255.0, (size, size),
            interpolation=cv2.INTER_LINEAR,
        )
        out.append(resized.reshape(1, -1).astype(np.float32))
    return out
