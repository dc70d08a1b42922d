"""Dense face landmarks through the torch ONNX executor — mediapipe parity
without mediapipe (counterpart of hallo_tpu/data/landmark_jax.py).

The reference drives all mask geometry from mediapipe FaceLandmarker's
478-point mesh (the reference's hallo/utils/util.py:351-527,
image_processor.py:253-263), a C++ tasks runtime. This module runs any
468/478-point face-mesh ONNX model (the mediapipe `.task` bundles a TFLite
model of exactly this family; public ONNX conversions are drop-in) through
`hallo_tpu_torch.convert.onnx_torch.OnnxExecutor` on the landmarker's
device (the card unless the caller asks for another) — so the full mask
path (SCRFD detect -> landmark mesh -> utils/masks geometry) is torch + the
production model files, zero extra runtimes.

Model contract (the face-mesh family):
- input: one float image tensor, square (typically 192x192), NHWC or NCHW
  (detected from the declared input shape), RGB scaled to [0, 1] (mediapipe
  convention; `input_range="signed"` selects [-1, 1] exports).
- output: a tensor with 468*3 or 478*3 elements — (x, y, z) per landmark in
  input-crop pixel units. Any extra outputs (face score, tongue/iris heads)
  are ignored; the landmark tensor is found by element count.

The detector's face box is expanded to a margined square crop (the mesh
models are trained on loose face crops), resized, run, and the (x, y)
coordinates are mapped back to source-image pixels.
"""

from __future__ import annotations

import glob
import logging
import os
from typing import Optional, Sequence, Tuple

import cv2
import numpy as np
import torch

from hallo_tpu_torch.convert.onnx_torch import OnnxExecutor

logger = logging.getLogger(__name__)

_VALID_COUNTS = (468, 478)
# face-mesh models are trained on loose crops: square box, +25% margin.
_CROP_MARGIN = 0.25


def find_landmark_model(root: Optional[str]) -> Optional[str]:
    """Locate a face-mesh ONNX under the face-analysis model root.

    Honors $HALLO_LANDMARK_ONNX first; otherwise globs the same directory
    layout the reference uses for its .task file
    (pretrained_models/face_analysis/models/)."""
    env = os.environ.get("HALLO_LANDMARK_ONNX")
    if env:
        return env if os.path.exists(env) else None
    if not root:
        return None
    for pattern in ("models/*landmark*.onnx", "models/*facemesh*.onnx",
                    "*landmark*.onnx", "*facemesh*.onnx"):
        hits = sorted(glob.glob(os.path.join(root, pattern)))
        if hits:
            return hits[0]
    return None


class TorchFaceLandmarker:
    """468/478-point face-mesh inference via the torch ONNX executor."""

    def __init__(self, model_path: str, input_range: str = "unit",
                 device: torch.device = torch.device("cuda")):
        if not os.path.exists(model_path):
            raise FileNotFoundError(model_path)
        # strict=True preflights op coverage (UnsupportedOnnxOps with the
        # full list at load, not NotImplementedError mid-inference).
        self._ex = OnnxExecutor(model_path, strict=True, device=device)
        self.input_range = input_range
        self._in_name, self._nchw, self._size = self._input_spec()
        logger.info(
            "face landmarks: %s via the torch ONNX executor (input %s %s)",
            os.path.basename(model_path), self._size,
            "NCHW" if self._nchw else "NHWC",
        )

    def _input_spec(self) -> Tuple[str, bool, int]:
        graph = self._ex.graph
        inits = set(graph.initializers)
        pairs = [(n, s) for n, s in graph.inputs if n not in inits]
        if len(pairs) != 1:
            raise ValueError(
                f"expected one image input, got {[n for n, _ in pairs]}"
            )
        name, shape = pairs[0]
        if not shape or len(shape) != 4:
            raise ValueError(f"input {name!r} must be rank-4, got {shape}")
        if shape[1] == 3 and shape[3] != 3:
            return name, True, int(shape[2])
        if shape[3] == 3:
            return name, False, int(shape[1])
        raise ValueError(f"cannot find the RGB axis in input shape {shape}")

    # ------------------------------------------------------------------
    def __call__(
        self,
        image_rgb: np.ndarray,
        bbox: Optional[Sequence[float]] = None,
    ) -> Optional[np.ndarray]:
        """(N, 2) landmark pixel coordinates in the source image, or None.

        `bbox` = (min_x, min_y, max_x, max_y) from the face detector; when
        absent the whole image is used as the crop (portrait inputs)."""
        h, w = image_rgb.shape[:2]
        if bbox is None:
            bbox = (0.0, 0.0, float(w), float(h))
        x0, y0, x1, y1 = [float(v) for v in bbox]
        cx, cy = (x0 + x1) / 2.0, (y0 + y1) / 2.0
        half = max(x1 - x0, y1 - y0) * (1.0 + _CROP_MARGIN) / 2.0
        half = max(half, 8.0)
        # clamp the square to the image; keep it square by shifting
        side = int(round(min(2.0 * half, float(min(h, w)))))
        ox = int(np.clip(round(cx - side / 2.0), 0, w - side))
        oy = int(np.clip(round(cy - side / 2.0), 0, h - side))
        crop = image_rgb[oy:oy + side, ox:ox + side]
        if crop.size == 0:
            return None
        crop = cv2.resize(crop, (self._size, self._size),
                          interpolation=cv2.INTER_LINEAR)
        x = crop.astype(np.float32) / 255.0
        if self.input_range == "signed":
            x = x * 2.0 - 1.0
        x = x[None]
        if self._nchw:
            x = x.transpose(0, 3, 1, 2)
        outs = self._ex({self._in_name: x})
        lm = self._pick_landmarks(outs)
        if lm is None:
            return None
        pts = lm[:, :2]
        # Exporter variants emit either crop-pixel coords (mediapipe facemesh
        # convention, range ~[0, size)) or normalized [0, 1] coords. A real
        # face spans most of the crop, so a max coord <= ~2 can only be the
        # normalized variant — rescale instead of collapsing to the origin.
        if np.abs(pts).max() <= 2.0:
            pts = pts * float(self._size)
        pts = pts * (side / self._size)
        pts[:, 0] += ox
        pts[:, 1] += oy
        return pts.astype(np.float32)

    @staticmethod
    def _pick_landmarks(outs) -> Optional[np.ndarray]:
        for _, v in sorted(outs.items()):
            arr = v.float().cpu().numpy().reshape(-1)
            for n in _VALID_COUNTS:
                if arr.size == n * 3:
                    return arr.reshape(n, 3)
        return None
