"""InsightFace-compatible face detection + identity embedding on PyTorch
(counterpart of hallo_tpu/data/insight_jax.py).

The reference runs `scrfd_10g_bnkps.onnx` (SCRFD face detector with 5
keypoints) and `glintr100.onnx` (ArcFace iResNet-100, 512-d embedding)
through onnxruntime inside `insightface.app.FaceAnalysis`
(image_processor.py:100-138). Here the same .onnx files execute through
`hallo_tpu_torch.convert.onnx_torch.OnnxExecutor` on the app's device (the
card unless the caller asks for another), and this module keeps the JAX
package's thin host-side logic around them:

- SCRFD: 640×640 letterbox, blob normalization (x-127.5)/128, per-stride
  {8,16,32} anchor-center decode (2 anchors per cell, distance2bbox) and
  host NMS — matching insightface's scrfd.py semantics.
- ArcFace: 5-point similarity alignment (Umeyama) to the 112×112 ArcFace
  template, blob (x-127.5)/127.5, raw (unnormalized) 512-d output —
  matching insightface's arcface_onnx.py / face_align.py.

Numbers (thresholds, template points) are the public InsightFace
constants; no code is copied — the decode math is re-derived from the
SCRFD paper's distance-regression definition.
"""

from __future__ import annotations

import functools
import logging
import os
from typing import Dict, List, Optional, Tuple

import cv2
import numpy as np
import torch

from hallo_tpu_torch.convert.onnx_torch import OnnxExecutor

logger = logging.getLogger(__name__)

# ArcFace 112x112 alignment template (lefteye, righteye, nose, leftmouth,
# rightmouth) — the standard constellation used by every ArcFace release.
ARCFACE_TEMPLATE = np.array(
    [
        [38.2946, 51.6963],
        [73.5318, 51.5014],
        [56.0252, 71.7366],
        [41.5493, 92.3655],
        [70.7299, 92.2041],
    ],
    np.float32,
)


def umeyama_similarity(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Least-squares similarity transform (scale+rotation+translation)
    mapping src -> dst, both (N, 2). Returns a 2x3 affine matrix.

    Closed form from Umeyama 1991 (the same estimator behind
    skimage.transform.SimilarityTransform used by insightface)."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    n, d = src.shape
    mu_s, mu_d = src.mean(0), dst.mean(0)
    sc, dc = src - mu_s, dst - mu_d
    cov = dc.T @ sc / n
    u, s, vt = np.linalg.svd(cov)
    sign = np.sign(np.linalg.det(u) * np.linalg.det(vt))
    diag = np.ones(d)
    diag[-1] = sign
    rot = u @ np.diag(diag) @ vt
    var_s = (sc ** 2).sum() / n
    scale = (s * diag).sum() / var_s
    t = mu_d - scale * rot @ mu_s
    m = np.zeros((2, 3))
    m[:, :2] = scale * rot
    m[:, 2] = t
    return m.astype(np.float32)


def norm_crop(image_rgb: np.ndarray, kps: np.ndarray, size: int = 112) -> np.ndarray:
    """Align a face to the ArcFace template given 5 keypoints."""
    m = umeyama_similarity(kps, ARCFACE_TEMPLATE * (size / 112.0))
    return cv2.warpAffine(image_rgb, m, (size, size), borderValue=0.0)


def distance2bbox(centers: np.ndarray, dist: np.ndarray) -> np.ndarray:
    """SCRFD regression target: distances (l, t, r, b) from the anchor
    center -> corner boxes (x1, y1, x2, y2)."""
    return np.stack(
        [
            centers[:, 0] - dist[:, 0],
            centers[:, 1] - dist[:, 1],
            centers[:, 0] + dist[:, 2],
            centers[:, 1] + dist[:, 3],
        ],
        axis=-1,
    )


def distance2kps(centers: np.ndarray, dist: np.ndarray) -> np.ndarray:
    """Keypoint offsets (x, y) x5 from anchor centers -> absolute points."""
    out = dist.reshape(-1, 5, 2).copy()
    out += centers[:, None, :]
    return out


def nms(boxes: np.ndarray, scores: np.ndarray, iou_thresh: float = 0.4) -> List[int]:
    """Greedy IoU NMS on host (tiny candidate counts after thresholding)."""
    order = scores.argsort()[::-1]
    x1, y1, x2, y2 = boxes.T
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    keep: List[int] = []
    while order.size:
        i = order[0]
        keep.append(int(i))
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        w = np.maximum(0.0, xx2 - xx1 + 1)
        h = np.maximum(0.0, yy2 - yy1 + 1)
        inter = w * h
        denom = areas[i] + areas[order[1:]] - inter
        with np.errstate(divide="ignore", invalid="ignore"):
            iou = inter / denom
        # degenerate boxes (x2<x1 from an untrained net) yield non-finite
        # IoU; treat as non-overlapping rather than propagating NaN
        iou = np.where(np.isfinite(iou), iou, 0.0)
        order = order[1:][iou <= iou_thresh]
    return keep


class ScrfdTorch:
    """SCRFD face detector running its ONNX graph through the torch executor.

    Output-head convention (scrfd_10g_bnkps): 9 outputs ordered
    [score_8, score_16, score_32, bbox_8, ..., kps_8, ...] with 2 anchors
    per spatial cell; scores already sigmoid'd in-graph."""

    STRIDES = (8, 16, 32)
    NUM_ANCHORS = 2

    def __init__(self, model_path: str, det_size: Tuple[int, int] = (640, 640),
                 device: torch.device = torch.device("cuda")):
        self.exec = OnnxExecutor(model_path, device=device)
        self.det_size = det_size
        self.input_name = self.exec.input_names[0]
        if len(self.exec.output_names) not in (6, 9):
            raise ValueError(
                f"expected 6 or 9 SCRFD outputs, got {len(self.exec.output_names)}"
            )
        self.with_kps = len(self.exec.output_names) == 9

    @functools.lru_cache(maxsize=8)
    def _anchor_centers(self, h: int, w: int, stride: int) -> np.ndarray:
        xs, ys = np.meshgrid(np.arange(w), np.arange(h))
        centers = np.stack([xs, ys], -1).astype(np.float32) * stride
        return np.repeat(
            centers.reshape(-1, 2), self.NUM_ANCHORS, axis=0
        )

    def detect(
        self,
        image_rgb: np.ndarray,
        score_thresh: float = 0.5,
        iou_thresh: float = 0.4,
    ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Returns (boxes (N,5: x1,y1,x2,y2,score), kps (N,5,2) or None)
        in original-image coordinates, NMS'd, sorted by score."""
        ih, iw = image_rgb.shape[:2]
        dw, dh = self.det_size
        scale = min(dw / iw, dh / ih)
        nw, nh = int(round(iw * scale)), int(round(ih * scale))
        resized = cv2.resize(image_rgb, (nw, nh))
        canvas = np.zeros((dh, dw, 3), np.uint8)
        canvas[:nh, :nw] = resized
        blob = (canvas.astype(np.float32) - 127.5) / 128.0
        blob = blob.transpose(2, 0, 1)[None]  # NCHW, RGB (swapRB in reference)

        outs = self.exec({self.input_name: blob})
        outs = {k: v.float().cpu().numpy() for k, v in outs.items()}
        names = self.exec.output_names
        n_lv = len(self.STRIDES)

        boxes_all, scores_all, kps_all = [], [], []
        for i, stride in enumerate(self.STRIDES):
            scores = outs[names[i]].reshape(-1)
            bbox = outs[names[n_lv + i]].reshape(-1, 4) * stride
            h, w = dh // stride, dw // stride
            centers = self._anchor_centers(h, w, stride)
            keep = np.where(scores >= score_thresh)[0]
            if keep.size == 0:
                continue
            boxes_all.append(distance2bbox(centers[keep], bbox[keep]))
            scores_all.append(scores[keep])
            if self.with_kps:
                kd = outs[names[2 * n_lv + i]].reshape(-1, 10) * stride
                kps_all.append(distance2kps(centers[keep], kd[keep]))
        if not boxes_all:
            return np.zeros((0, 5), np.float32), None
        boxes = np.concatenate(boxes_all) / scale
        scores = np.concatenate(scores_all)
        kps = np.concatenate(kps_all) / scale if kps_all else None
        keep = nms(boxes, scores, iou_thresh)
        boxes = np.concatenate([boxes[keep], scores[keep, None]], axis=1)
        return boxes.astype(np.float32), (
            kps[keep].astype(np.float32) if kps is not None else None
        )


class ArcFaceTorch:
    """ArcFace embedding (glintr100-style) through the torch executor."""

    def __init__(self, model_path: str, device: torch.device = torch.device("cuda")):
        self.exec = OnnxExecutor(model_path, device=device)
        self.input_name = self.exec.input_names[0]

    def embed(self, image_rgb: np.ndarray, kps: np.ndarray) -> np.ndarray:
        """512-d raw embedding of the face aligned from 5 keypoints."""
        crop = norm_crop(image_rgb, np.asarray(kps, np.float32))
        blob = (crop.astype(np.float32) - 127.5) / 127.5
        blob = blob.transpose(2, 0, 1)[None]
        out = self.exec({self.input_name: blob})
        emb = next(iter(out.values())).float().cpu().numpy().reshape(-1)
        return emb.astype(np.float32)


class InsightTorchApp:
    """Drop-in for the subset of insightface.app.FaceAnalysis the reference
    uses: `.get(image)` -> list of dicts with bbox/kps/embedding
    (image_processor.py:124-138 reads exactly those keys)."""

    def __init__(self, root: str, det_size: Tuple[int, int] = (640, 640),
                 device: torch.device = torch.device("cuda")):
        det_path, rec_path = find_insightface_models(root)
        if det_path is None or rec_path is None:
            raise FileNotFoundError(
                f"SCRFD/ArcFace .onnx models not found under {root!r}"
            )
        self.det = ScrfdTorch(det_path, det_size, device)
        self.rec = ArcFaceTorch(rec_path, device)

    def get(self, image_rgb: np.ndarray, max_num: int = 0) -> List[Dict]:
        boxes, kps = self.det.detect(image_rgb)
        faces: List[Dict] = []
        for i in range(boxes.shape[0] if not max_num else min(max_num, len(boxes))):
            face = {
                "bbox": boxes[i, :4],
                "det_score": float(boxes[i, 4]),
                "kps": None if kps is None else kps[i],
            }
            if kps is not None:
                face["embedding"] = self.rec.embed(image_rgb, kps[i])
            else:
                face["embedding"] = np.zeros(512, np.float32)
            faces.append(face)
        return faces


def find_insightface_models(root: str) -> Tuple[Optional[str], Optional[str]]:
    """Locate (detector, recognizer) .onnx files under an insightface model
    root (e.g. pretrained_models/face_analysis with models/ inside)."""
    det = rec = None
    for dirpath, _, files in os.walk(root):
        for f in sorted(files):
            if not f.endswith(".onnx"):
                continue
            p = os.path.join(dirpath, f)
            low = f.lower()
            if "scrfd" in low or low.startswith("det"):
                det = det or p
            elif "glintr" in low or "w600k" in low or "arcface" in low:
                rec = rec or p
    return det, rec
