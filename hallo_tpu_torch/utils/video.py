"""Video / audio I/O on cv2 (FFMPEG build) with graceful gating.

The port's copy of hallo_tpu/utils/video.py (the port imports nothing of the
JAX package); tests/test_torch_preprocess.py holds the two equal.

Replaces the reference's PyAV/moviepy/ffmpeg-subprocess stack
(util.py:154-321, 854-920). cv2's FFMPEG backend handles decode/encode;
audio muxing requires an ffmpeg binary and is skipped (with a warning and a
side-channel .wav) when absent.
"""

from __future__ import annotations

import logging
import os
import shutil
import subprocess
from typing import List, Optional, Tuple

import cv2
import numpy as np

logger = logging.getLogger(__name__)


def read_frames(path: str) -> List[np.ndarray]:
    """Decode all frames as RGB uint8 (util.py:244-279)."""
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise FileNotFoundError(path)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    cap.release()
    return frames


def get_fps(path: str) -> float:
    cap = cv2.VideoCapture(path)
    fps = cap.get(cv2.CAP_PROP_FPS)
    cap.release()
    return float(fps)


def write_video(
    frames: np.ndarray, path: str, fps: int = 25, audio_path: Optional[str] = None
) -> str:
    """frames: (T, H, W, 3) float in [0,1] or uint8. Writes H.264/mp4v video;
    muxes audio when an ffmpeg binary exists (util.py:297-321 tensor_to_video
    equivalent)."""
    frames = np.asarray(frames)
    if frames.dtype != np.uint8:
        frames = (np.clip(frames, 0, 1) * 255).astype(np.uint8)
    t, h, w = frames.shape[:3]
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)

    tmp = path if audio_path is None else path + ".video.mp4"
    writer = cv2.VideoWriter(
        tmp, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h)
    )
    if not writer.isOpened():
        raise RuntimeError(f"cv2.VideoWriter failed for {tmp}")
    for frame in frames:
        writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
    writer.release()

    if audio_path is not None:
        ffmpeg = shutil.which("ffmpeg")
        if ffmpeg is None:
            logger.warning(
                "no ffmpeg binary: cannot mux audio; leaving %s (video) and "
                "the driving audio separate", tmp,
            )
            if tmp != path:
                shutil.move(tmp, path)
        else:
            subprocess.run(
                [ffmpeg, "-y", "-v", "error", "-i", tmp, "-i", audio_path,
                 "-c:v", "copy", "-c:a", "aac", "-shortest", path],
                check=True,
            )
            os.remove(tmp)
    return path


class StreamingVideoWriter:
    """Incremental mp4 writer: append clips as they are fetched from the
    device so encoding hides behind the NEXT clip's on-chip denoise
    (FaceAnimatePipeline's `on_clip` hook) instead of serializing after
    generation, and so long-form runs never hold the whole video in host
    memory. Same container/mux semantics as `write_video`
    (reference: util.py:297-321 tensor_to_video, which buffers everything).
    """

    def __init__(self, path: str, fps: int = 25,
                 audio_path: Optional[str] = None):
        self.path = path
        self.fps = fps
        self.audio_path = audio_path
        os.makedirs(os.path.dirname(os.path.abspath(path)) or ".",
                    exist_ok=True)
        self._tmp = path if audio_path is None else path + ".video.mp4"
        self._writer = None  # opened lazily on the first clip (needs H, W)
        self.frames_written = 0

    def append(self, frames: np.ndarray) -> None:
        """frames: (T, H, W, 3) float in [0,1] or uint8, RGB."""
        frames = np.asarray(frames)
        if frames.dtype != np.uint8:
            frames = (np.clip(frames, 0, 1) * 255).astype(np.uint8)
        if self._writer is None:
            h, w = frames.shape[1:3]
            self._writer = cv2.VideoWriter(
                self._tmp, cv2.VideoWriter_fourcc(*"mp4v"), self.fps, (w, h)
            )
            if not self._writer.isOpened():
                raise RuntimeError(f"cv2.VideoWriter failed for {self._tmp}")
        for frame in frames:
            self._writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
        self.frames_written += len(frames)

    def close(self) -> str:
        if self._writer is None and self.frames_written == 0:
            # Never opened (e.g. generation raised before the first clip):
            # there is no tmp video to mux — don't hand ffmpeg a missing file.
            logger.warning("StreamingVideoWriter closed with 0 frames; "
                           "no output written to %s", self.path)
            return self.path
        if self._writer is not None:
            self._writer.release()
            self._writer = None
        if self.audio_path is not None:
            ffmpeg = shutil.which("ffmpeg")
            if ffmpeg is None:
                logger.warning(
                    "no ffmpeg binary: cannot mux audio; leaving %s (video) "
                    "and the driving audio separate", self._tmp,
                )
                if self._tmp != self.path:
                    shutil.move(self._tmp, self.path)
            else:
                subprocess.run(
                    [ffmpeg, "-y", "-v", "error", "-i", self._tmp,
                     "-i", self.audio_path,
                     "-c:v", "copy", "-c:a", "aac", "-shortest", self.path],
                    check=True,
                )
                os.remove(self._tmp)
        return self.path


def write_video_grid(
    videos: np.ndarray, path: str, fps: int = 25, n_rows: int = 2
) -> str:
    """videos: (N, T, H, W, 3) in [0,1] -> one tiled grid video
    (util.py:206-241 save_videos_grid equivalent)."""
    videos = np.asarray(videos)
    if videos.dtype != np.uint8:
        videos = (np.clip(videos, 0, 1) * 255).astype(np.uint8)
    n, t, h, w, c = videos.shape
    n_rows = max(1, min(n_rows, n))
    n_cols = -(-n // n_rows)
    pad = n_rows * n_cols - n
    if pad:
        videos = np.concatenate(
            [videos, np.zeros((pad, t, h, w, c), np.uint8)], axis=0
        )
    grid = (
        videos.reshape(n_rows, n_cols, t, h, w, c)
        .transpose(2, 0, 3, 1, 4, 5)
        .reshape(t, n_rows * h, n_cols * w, c)
    )
    return write_video(grid, path, fps=fps)


def extract_audio(video_path: str, out_wav: str, sample_rate: int = 16000) -> str:
    """ffmpeg-gated audio extraction (util.py:854-888)."""
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        raise RuntimeError("audio extraction requires an ffmpeg binary")
    subprocess.run(
        [ffmpeg, "-y", "-v", "error", "-i", video_path, "-vn",
         "-ar", str(sample_rate), "-ac", "1", out_wav],
        check=True,
    )
    return out_wav


def video_to_images(video_path: str, out_dir: str, fps: int = 25) -> List[str]:
    """Decode at a fixed fps to PNGs (util.py:889-920). Uses cv2 timestamps
    to resample to the target fps without ffmpeg."""
    os.makedirs(out_dir, exist_ok=True)
    cap = cv2.VideoCapture(video_path)
    src_fps = cap.get(cv2.CAP_PROP_FPS) or fps
    step = src_fps / fps
    paths = []
    idx, next_pick, out_idx = 0, 0.0, 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        if idx >= next_pick:
            out = os.path.join(out_dir, f"{out_idx:04d}.png")
            cv2.imwrite(out, frame)
            paths.append(out)
            out_idx += 1
            next_pick += step
        idx += 1
    cap.release()
    return paths
