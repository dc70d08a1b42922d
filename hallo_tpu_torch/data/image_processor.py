"""Reference-image preprocessing: face detect/embed, masks, mask pyramid
(counterpart of hallo_tpu/data/image_processor.py; the face analyzer's
model files run on the processor's device, the card unless the caller asks
for another).

Reference: hallo/datasets/image_processor.py:25-213 (inference path) and
:215-345 (dataset-prep path). Outputs match the reference's tensors:

- ref image (H, W, 3) float32 in [-1, 1]
- face-region mask (H, W, 3) float32 in [0, 1] (FaceLocator conditioning,
  the unblurred face bbox mask)
- 512-d identity embedding
- full/face/lip attention-mask pyramids: per scale (1, L) float32 where
  "full" is the blurred background (inverted face), "face" is blurred
  face-minus-lip and "lip" is the blurred lip mask
  (image_processor.py:156-180 + util.py get_mask).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import cv2
import numpy as np
import torch

from hallo_tpu_torch.data.face_analysis import FaceAnalyzer
from hallo_tpu_torch.utils import masks as mk


@dataclasses.dataclass
class ProcessedImage:
    pixel_values: np.ndarray          # (H, W, 3) in [-1, 1]
    face_region: np.ndarray           # (H, W, 3) in [0, 1]
    face_emb: np.ndarray              # (512,)
    full_masks: List[np.ndarray]      # 4 x (1, L_scale)
    face_masks: List[np.ndarray]
    lip_masks: List[np.ndarray]


def load_image_rgb(path: str) -> np.ndarray:
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


class ImageProcessor:
    def __init__(
        self,
        img_size: Tuple[int, int] = (512, 512),
        face_analysis_model_path: Optional[str] = None,
        device: torch.device = torch.device("cuda"),
    ):
        self.img_size = img_size
        self.analyzer = FaceAnalyzer(face_analysis_model_path, device=device)

    def preprocess(
        self, source_image, face_expand_ratio: float = 1.2
    ) -> ProcessedImage:
        """source_image: path or (H, W, 3) uint8 RGB array."""
        if isinstance(source_image, str):
            image = load_image_rgb(source_image)
        else:
            image = np.asarray(source_image)
        h0, w0 = image.shape[:2]

        face_mask, lip_mask, face = self.analyzer.face_and_lip_masks(
            image, face_expand_ratio
        )
        full_m, sep_face_m, lip_m = mk.separated_masks(face_mask, lip_mask)

        w, h = self.img_size
        resized = cv2.resize(image, (w, h), interpolation=cv2.INTER_LINEAR)
        pixel_values = resized.astype(np.float32) / 255.0 * 2.0 - 1.0

        region = cv2.resize(face_mask, (w, h), interpolation=cv2.INTER_LINEAR)
        face_region = np.repeat(
            (region.astype(np.float32) / 255.0)[..., None], 3, axis=-1
        )

        return ProcessedImage(
            pixel_values=pixel_values,
            face_region=face_region,
            face_emb=np.asarray(face.embedding, np.float32),
            full_masks=mk.mask_pyramid(full_m, w),
            face_masks=mk.mask_pyramid(sep_face_m, w),
            lip_masks=mk.mask_pyramid(lip_m, w),
        )


class ImageProcessorForDataProcessing:
    """Dataset-prep variant (image_processor.py:215-345): step 1 computes
    union face/lip masks over all frames of a training video; step 2 extracts
    the identity embedding from the first valid frame."""

    def __init__(self, face_analysis_model_path: Optional[str] = None, step: int = 1,
                 device: torch.device = torch.device("cuda")):
        self.step = step
        self.analyzer = FaceAnalyzer(face_analysis_model_path, device=device)

    def union_masks(
        self, frames_rgb: List[np.ndarray]
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """(face_mask, sep_background, sep_face, sep_lip) over all frames."""
        h, w = frames_rgb[0].shape[:2]
        face_masks, lip_masks = [], []
        for frame in frames_rgb:
            fm, lm, _ = self.analyzer.face_and_lip_masks(frame, 1.2)
            face_masks.append(fm)
            lip_masks.append(lm)
        face_union = mk.union_mask(face_masks)
        lip_union = mk.union_mask(lip_masks)
        full_m, sep_face_m, lip_m = mk.separated_masks(face_union, lip_union)
        return face_union, full_m, sep_face_m, lip_m

    def face_embedding(self, frames_rgb: List[np.ndarray]) -> np.ndarray:
        """First valid-face frame's embedding (image_processor.py:278-293)."""
        for frame in frames_rgb:
            result = self.analyzer.detect(frame)
            if np.any(result.embedding):
                return np.asarray(result.embedding, np.float32)
        return np.zeros(512, np.float32)
