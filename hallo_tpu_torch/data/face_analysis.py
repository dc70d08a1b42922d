"""Pluggable face analysis: detection, landmarks, identity embedding
(counterpart of hallo_tpu/data/face_analysis.py).

The reference depends on InsightFace (SCRFD detector + ArcFace glintr100
embedding, image_processor.py:100-138) and mediapipe FaceLandmarker
(util.py:351-404) — both ONNX/C++ runtimes that are host-side, one call per
clip. This module exposes one interface with backends:

- "insightface"/"mediapipe": used when those packages are installed
  (production parity).
- "onnx-torch": the SCRFD + ArcFace .onnx model FILES executed through the
  torch executor (hallo_tpu_torch/data/insight_torch.py) on the analyzer's
  device (the card unless the caller asks for another) — production-parity
  detection and identity embedding WITHOUT onnxruntime/insightface
  installed. Picked automatically when the model files exist under
  `model_path`; a face-mesh .onnx beside them gives the dense landmarks
  (data/landmark_torch.py).
- "opencv": a dependency-free fallback (Haar cascade detection, heuristic
  lip box, zero embedding) when no model file exists, so the pipeline runs
  end-to-end in minimal environments. NOT identity-preserving — a warning
  is emitted, as the JAX package's. The fallback is about missing files,
  not about a device.

Divergence from the JAX package (face_analysis.py:62 and its landmark
call): a model file that exists but fails to load or to run raises, where
JAX's logs it and falls back.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional, Tuple

import cv2
import numpy as np
import torch

from hallo_tpu_torch.data.insight_torch import InsightTorchApp
from hallo_tpu_torch.data.landmark_torch import TorchFaceLandmarker, find_landmark_model
from hallo_tpu_torch.utils import masks as mk

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class FaceResult:
    bbox: Tuple[float, float, float, float]  # (min_x, min_y, max_x, max_y)
    embedding: np.ndarray  # (512,)
    landmarks: Optional[np.ndarray] = None  # (478, 2) mediapipe-style or None
    kps: Optional[np.ndarray] = None  # (5, 2) SCRFD keypoints: eyes, nose, mouth corners


class FaceAnalyzer:
    """Facade that picks the best available backend."""

    def __init__(self, model_path: Optional[str] = None, backend: str = "auto",
                 device: torch.device = torch.device("cuda")):
        self.backend = backend
        self._insight = None
        self._onnx_torch = None
        self._mediapipe = None
        self._cascade = None
        self._landmarker = None
        # Dense-landmark path without mediapipe: a 468/478-pt face-mesh ONNX
        # next to the SCRFD/ArcFace files runs through the torch executor
        # (data/landmark_torch.py); mediapipe still wins when installed. A
        # file that does not load raises.
        lm_path = find_landmark_model(model_path or "./pretrained_models/face_analysis")
        if lm_path:
            self._landmarker = TorchFaceLandmarker(lm_path, device=device)
        if backend in ("auto", "insightface"):
            try:
                from insightface.app import FaceAnalysis  # type: ignore

                self._insight = FaceAnalysis(
                    name="",
                    root=model_path or "./pretrained_models/face_analysis",
                    providers=["CPUExecutionProvider"],
                )
                self._insight.prepare(ctx_id=0, det_size=(640, 640))
                self.backend = "insightface"
            except Exception:
                self._insight = None
        if self._insight is None:
            if backend == "insightface":
                raise RuntimeError("insightface backend requested but unavailable")
        if self._insight is None and backend in ("auto", "onnx-torch"):
            # Same .onnx model files, executed through the torch executor.
            try:
                self._onnx_torch = InsightTorchApp(
                    root=model_path or "./pretrained_models/face_analysis", device=device
                )
                self.backend = "onnx-torch"
                logger.info(
                    "face analysis: SCRFD+ArcFace onnx weights via the torch "
                    "executor (production-parity detection/embedding)"
                )
            except FileNotFoundError:
                if backend == "onnx-torch":
                    raise
                self._onnx_torch = None
        if self._insight is None and self._onnx_torch is None:
            self.backend = "opencv"
            logger.warning(
                "insightface unavailable; falling back to OpenCV Haar detection "
                "with a ZERO identity embedding (matches the reference's "
                "no-face fallback, image_processor.py:124-135). Identity "
                "conditioning will be uninformative."
            )
            try:
                self._cascade = cv2.CascadeClassifier(
                    cv2.data.haarcascades + "haarcascade_frontalface_default.xml"
                )
            except AttributeError:  # stripped cv2 builds lack objdetect
                self._cascade = None
                self.backend = "center-crop"
                logger.warning(
                    "cv2 has no CascadeClassifier; assuming a centered "
                    "portrait (center 60%% box as the face region)."
                )

    # ------------------------------------------------------------------
    def detect(self, image_rgb: np.ndarray) -> FaceResult:
        """Detect the largest face; full-image fallback with zero embedding
        mirrors the reference (image_processor.py:124-135)."""
        h, w = image_rgb.shape[:2]
        if self._insight is not None:
            faces = self._insight.get(cv2.cvtColor(image_rgb, cv2.COLOR_RGB2BGR))
            if faces:
                faces = sorted(
                    faces,
                    key=lambda f: (f["bbox"][2] - f["bbox"][0])
                    * (f["bbox"][3] - f["bbox"][1]),
                    reverse=True,
                )
                f = faces[0]
                return FaceResult(tuple(f["bbox"]), np.asarray(f["embedding"]))
            return FaceResult((0, 0, w, h), np.zeros(512, np.float32))

        if self._onnx_torch is not None:
            faces = self._onnx_torch.get(image_rgb)
            if faces:
                f = max(
                    faces,
                    key=lambda f: (f["bbox"][2] - f["bbox"][0])
                    * (f["bbox"][3] - f["bbox"][1]),
                )
                return FaceResult(
                    tuple(float(v) for v in f["bbox"]),
                    np.asarray(f["embedding"], np.float32),
                    kps=(
                        None if f.get("kps") is None
                        else np.asarray(f["kps"], np.float32)
                    ),
                )
            return FaceResult((0, 0, w, h), np.zeros(512, np.float32))

        if self._cascade is not None:
            gray = cv2.cvtColor(image_rgb, cv2.COLOR_RGB2GRAY)
            rects = self._cascade.detectMultiScale(gray, 1.1, 5)
            if len(rects) > 0:
                x, y, bw, bh = max(rects, key=lambda r: r[2] * r[3])
                return FaceResult(
                    (float(x), float(y), float(x + bw), float(y + bh)),
                    np.zeros(512, np.float32),
                )
            return FaceResult((0, 0, w, h), np.zeros(512, np.float32))
        # center-crop heuristic (no detector available at all)
        return FaceResult(
            (0.2 * w, 0.15 * h, 0.8 * w, 0.85 * h), np.zeros(512, np.float32)
        )

    # ------------------------------------------------------------------
    def face_and_lip_masks(
        self, image_rgb: np.ndarray, face_expand_ratio: float = 1.2
    ) -> Tuple[np.ndarray, np.ndarray, FaceResult]:
        """(face_mask, lip_mask, face) uint8 masks at image resolution.

        With mediapipe installed, masks come from the 478-point landmarks
        (util.py:407-527); otherwise lip region is estimated as the lower
        middle of the face box.
        """
        h, w = image_rgb.shape[:2]
        face = self.detect(image_rgb)
        landmarks = self._landmarks(image_rgb, face.bbox)
        if landmarks is not None:
            face.landmarks = landmarks
            face_mask = mk.face_mask_from_landmarks(landmarks, h, w, face_expand_ratio)
            lip_mask = mk.lip_mask_from_landmarks(landmarks, h, w, 2.0)
            return face_mask, lip_mask, face

        min_x, min_y, max_x, max_y = face.bbox
        face_mask = mk.bbox_mask((min_x, min_y, max_x, max_y), h, w, face_expand_ratio)
        fw, fh = max_x - min_x, max_y - min_y
        if face.kps is not None and len(face.kps) >= 5:
            # SCRFD 5-point keypoints (lefteye, righteye, nose, leftmouth,
            # rightmouth): anchor the lip box on the actual mouth corners —
            # much tighter than the bbox heuristic. Height scales with the
            # nose->mouth distance (the mouth occupies roughly that band).
            lm, rm = face.kps[3], face.kps[4]
            nose = face.kps[2]
            cx, cy = (lm + rm) / 2.0
            half_w = max(abs(rm[0] - lm[0]) * 0.8, 0.08 * fw)
            mouth_h = max((cy - nose[1]) * 0.9, 0.06 * fh)
            lip_box = (cx - half_w, cy - mouth_h, cx + half_w, cy + mouth_h)
        else:
            # heuristic lip box: central lower third of the face box
            lip_box = (
                min_x + 0.3 * fw,
                min_y + 0.65 * fh,
                max_x - 0.3 * fw,
                min_y + 0.85 * fh,
            )
        lip_mask = mk.bbox_mask(lip_box, h, w, 2.0)
        return face_mask, lip_mask, face

    def _landmarks(
        self, image_rgb: np.ndarray, bbox=None
    ) -> Optional[np.ndarray]:
        if self._mediapipe is None:
            try:
                import mediapipe  # type: ignore  # noqa: F401
            except Exception:
                if self._landmarker is not None:
                    return self._landmarker(image_rgb, bbox)
                return None
        # mediapipe landmark extraction (only reached when installed)
        try:
            import mediapipe as mp
            from mediapipe.tasks import python as mp_python
            from mediapipe.tasks.python import vision

            if self._mediapipe is None:
                base = mp_python.BaseOptions(
                    model_asset_path="pretrained_models/face_analysis/models/"
                    "face_landmarker_v2_with_blendshapes.task"
                )
                self._mediapipe = vision.FaceLandmarker.create_from_options(
                    vision.FaceLandmarkerOptions(
                        base_options=base, output_face_blendshapes=True,
                        output_facial_transformation_matrixes=True, num_faces=1,
                    )
                )
            h, w = image_rgb.shape[:2]
            mp_img = mp.Image(image_format=mp.ImageFormat.SRGB, data=image_rgb)
            result = self._mediapipe.detect(mp_img)
            if len(result.face_landmarks) != 1:
                return None
            return np.asarray(
                [[p.x * w, p.y * h] for p in result.face_landmarks[0]], np.float32
            )
        except Exception:
            return None
