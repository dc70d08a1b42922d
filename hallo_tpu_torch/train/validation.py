"""Validation renders during training, the reference's de-facto functional
test (counterpart of hallo_tpu/train/validation.py; reference
train_stage1.py:181-286 renders stills through the static pipeline,
train_stage2.py:250-418 videos through the video pipeline). Each returns
the paths it wrote."""

from __future__ import annotations

import logging
import os
from typing import List, Sequence

import numpy as np

from hallo_tpu_torch.config import SchedulerConfig

logger = logging.getLogger(__name__)


def log_validation_stage1(
    models,
    save_dir: str,
    global_step: int,
    ref_images: Sequence[np.ndarray],
    face_embs: Sequence[np.ndarray],
    face_regions: Sequence[np.ndarray],
    num_inference_steps: int = 20,
    seed: int = 42,
) -> List[str]:
    """Render an identity-transfer still per reference image (`StaticPipeline`)
    and save it as save_dir/validation/step{N}_sample{i}.png."""
    import cv2

    from hallo_tpu_torch.pipelines.static import StaticPipeline

    pipe = StaticPipeline(models, SchedulerConfig(), num_inference_steps)
    out_dir = os.path.join(save_dir, "validation")
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, (img, emb, region) in enumerate(zip(ref_images, face_embs, face_regions)):
        sample = pipe(img[None], emb[None], region[None], seed=seed)
        path = os.path.join(out_dir, f"step{global_step}_sample{i}.png")
        cv2.imwrite(path, cv2.cvtColor((sample[0] * 255).astype(np.uint8), cv2.COLOR_RGB2BGR))
        logger.info("validation still -> %s", path)
        paths.append(path)
    return paths


def log_validation_stage2(
    models,
    save_dir: str,
    global_step: int,
    ref_image: np.ndarray,
    audio_windows: np.ndarray,
    face_emb: np.ndarray,
    face_region: np.ndarray,
    masks,
    clip_length: int = 16,
    num_inference_steps: int = 40,
    fps: int = 25,
    seed: int = 42,
    n_motion_frames: int = 2,
) -> List[str]:
    """Render a validation video (`FaceAnimatePipeline`) and save it as
    save_dir/validation/step{N}.mp4."""
    from hallo_tpu_torch.pipelines.face_animate import FaceAnimatePipeline
    from hallo_tpu_torch.utils.video import write_video

    pipe = FaceAnimatePipeline(models, SchedulerConfig(), num_inference_steps,
                               clip_length=clip_length, n_motion_frames=n_motion_frames)
    video = pipe(ref_image[None], audio_windows, face_emb[None], face_region[None], masks,
                 seed=seed)
    out_dir = os.path.join(save_dir, "validation")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"step{global_step}.mp4")
    write_video(video[0], path, fps=fps)
    logger.info("validation video -> %s", path)
    return [path]
