"""The port's host preprocessing against hallo_tpu's, on the CPU.

- `utils/masks.py` (the port's copy): every function against
  `hallo_tpu.utils.masks` on seeded landmarks and boxes, and the landmark ->
  mask chain against tests/golden/masks_fixture.npz, bit for bit;
- `data/image_processor.py`: `ImageProcessor.preprocess` on
  examples/reference_images/1.jpg and on a synthetic image, every
  `ProcessedImage` field equal to JAX's (the face analyzer's fallback here:
  no model files);
- the face analyzer's choice of backend;
- `utils/video.py`: `StreamingVideoWriter` against `write_video`, and the
  readers and writers against JAX's, with and without an ffmpeg binary (a
  stand-in script that copies the video stream where none is installed).
"""

import os
import shutil

import numpy as np
import pytest

from hallo_tpu.utils import masks as jax_masks
from hallo_tpu.utils import video as jax_video
from hallo_tpu_torch.utils import masks
from hallo_tpu_torch.utils import video

from tests.test_mask_fixtures import GOLDEN_PATH, synthetic_landmarks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMAGE = os.path.join(REPO, "examples", "reference_images", "1.jpg")


def _boxes(seed):
    rng = np.random.default_rng(seed)
    x0, y0 = rng.uniform(-20, 300, 2)
    return (x0, y0, x0 + rng.uniform(5, 300), y0 + rng.uniform(5, 300))


def _mask(seed, h=96, w=80):
    return masks.bbox_mask(_boxes(seed), h, w, 1.0 + seed / 10)


MASK_CASES = {
    "expand_region": lambda m, s: m.expand_region(
        [_boxes(s)[0], _boxes(s)[2], _boxes(s)[1], _boxes(s)[3]], 320, 288, 1.0 + s / 4),
    "bbox_mask": lambda m, s: m.bbox_mask(_boxes(s), 288, 320, 1.3),
    "face_mask_from_landmarks": lambda m, s: m.face_mask_from_landmarks(
        synthetic_landmarks(320 + s, 288) + s, 288, 320 + s, 1.2),
    "lip_mask_from_landmarks": lambda m, s: m.lip_mask_from_landmarks(
        synthetic_landmarks(320, 288) - s, 288, 320, 2.0),
    "blur_mask": lambda m, s: m.blur_mask(_mask(s), (64, 64), (51, 51)),
    "background_mask": lambda m, s: m.background_mask(_mask(s)),
    "sep_face_mask": lambda m, s: m.sep_face_mask(_mask(s), _mask(s + 1)),
    "union_mask": lambda m, s: m.union_mask([_mask(s), _mask(s + 3), _mask(s + 5)]),
    "separated_masks": lambda m, s: m.separated_masks(_mask(s), _mask(s + 2)),
    "mask_pyramid": lambda m, s: m.mask_pyramid(_mask(s, 128, 128), 128),
}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", sorted(MASK_CASES))
def test_masks_match_jax(name, seed):
    got, want = MASK_CASES[name](masks, seed), MASK_CASES[name](jax_masks, seed)
    got = got if isinstance(got, (tuple, list)) else [got]
    want = want if isinstance(want, (tuple, list)) else [want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_mask_chain_matches_the_golden_fixture():
    h = w = 512
    lm = synthetic_landmarks(w, h)
    face = masks.face_mask_from_landmarks(lm, h, w, expand_ratio=1.2)
    lip = masks.lip_mask_from_landmarks(lm, h, w, expand_ratio=2.0)
    bg, sep, lip_blur = masks.separated_masks(face, lip)
    golden = np.load(GOLDEN_PATH)
    for name, arr in dict(face=face, lip=lip, bg=bg, sep=sep, lip_blur=lip_blur).items():
        np.testing.assert_array_equal(arr, golden[name], err_msg=name)


def _synthetic_image():
    import cv2

    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (300, 240, 3)).astype(np.uint8)
    cv2.circle(img, (120, 130), 60, (200, 170, 150), -1)
    return img


@pytest.mark.parametrize("source,size,ratio", [("1.jpg", (512, 512), 1.2),
                                               ("1.jpg", (64, 64), 1.0),
                                               ("synthetic", (128, 96), 1.5)])
def test_image_processor_matches_jax(source, size, ratio):
    import dataclasses

    from hallo_tpu.data.image_processor import ImageProcessor as JaxImageProcessor
    from hallo_tpu_torch.data.image_processor import ImageProcessor

    image = IMAGE if source == "1.jpg" else _synthetic_image()
    got = ImageProcessor(size, "", device="cpu").preprocess(image, ratio)
    want = JaxImageProcessor(size, "").preprocess(image, ratio)
    assert got.pixel_values.shape == (size[1], size[0], 3)
    for field in dataclasses.fields(want):
        g, w = getattr(got, field.name), getattr(want, field.name)
        if isinstance(w, list):
            assert len(g) == len(w) == 4, field.name
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b, err_msg=field.name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=field.name)


def test_data_processing_variant_matches_jax():
    from hallo_tpu.data.image_processor import (
        ImageProcessorForDataProcessing as JaxForData)
    from hallo_tpu_torch.data.image_processor import ImageProcessorForDataProcessing

    frames = [_synthetic_image(), np.roll(_synthetic_image(), 7, axis=1)]
    got = ImageProcessorForDataProcessing("", device="cpu")
    want = JaxForData("")
    for a, b in zip(got.union_masks(frames), want.union_masks(frames)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got.face_embedding(frames), want.face_embedding(frames))


def test_face_analyzer_backend_choice(tmp_path):
    """No model files: the JAX package's fallback (Haar when cv2 has it,
    else the centre crop) with its warning; SCRFD/ArcFace files: the torch
    executor; a requested backend that cannot be had raises, as JAX's."""
    from hallo_tpu.data.face_analysis import FaceAnalyzer as JaxFaceAnalyzer
    from hallo_tpu_torch.data.face_analysis import FaceAnalyzer

    from tests.test_torch_onnx import _arcface_graph, _build_tiny_scrfd

    assert FaceAnalyzer("", device="cpu").backend == JaxFaceAnalyzer("").backend
    assert FaceAnalyzer("", device="cpu").backend in ("opencv", "center-crop")
    root = tmp_path / "face_analysis" / "models"
    root.mkdir(parents=True)
    _build_tiny_scrfd(str(root / "scrfd_tiny_bnkps.onnx"), det=64)
    _arcface_graph(str(root / "glintr_tiny.onnx"), np.random.default_rng(7), out_dim=512)
    assert FaceAnalyzer(str(tmp_path / "face_analysis"), device="cpu").backend == "onnx-torch"
    with pytest.raises(FileNotFoundError):
        FaceAnalyzer(str(tmp_path / "absent"), backend="onnx-torch", device="cpu")
    with pytest.raises(RuntimeError):
        FaceAnalyzer("", backend="insightface", device="cpu")


def test_fallback_warns_as_jax(caplog):
    from hallo_tpu_torch.data.face_analysis import FaceAnalyzer

    with caplog.at_level("WARNING"):
        FaceAnalyzer("", device="cpu")
    assert any("ZERO identity embedding" in r.getMessage() for r in caplog.records)


# -- video -------------------------------------------------------------------
@pytest.fixture(params=["no_ffmpeg", "ffmpeg"])
def ffmpeg(request, tmp_path, monkeypatch):
    """Where ffmpeg is found: none, or a stand-in script that copies the
    first input (the video stream) to the output, so the mux command runs."""
    if request.param == "no_ffmpeg":
        monkeypatch.setattr(shutil, "which", lambda name: None)
        return None
    script = tmp_path / "ffmpeg"
    script.write_text('#!/bin/sh\nin=""\nwhile [ $# -gt 1 ]; do\n'
                      '  if [ "$1" = "-i" ] && [ -z "$in" ]; then in="$2"; fi\n'
                      '  shift\ndone\ncp "$in" "$1"\n')
    script.chmod(0o755)
    monkeypatch.setattr(shutil, "which", lambda name: str(script))
    return str(script)


def _clips():
    rng = np.random.default_rng(0)
    return (rng.integers(0, 255, (4, 32, 32, 3), dtype=np.uint8),
            rng.uniform(0, 1, (3, 32, 32, 3)).astype(np.float32))


def test_streaming_writer_matches_one_shot(tmp_path, ffmpeg):
    clip_a, clip_b = _clips()
    wav = tmp_path / "a.wav"
    wav.write_bytes(b"RIFF0000WAVE")  # the stand-in ffmpeg never parses it
    stream = video.StreamingVideoWriter(str(tmp_path / "stream.mp4"), fps=25,
                                        audio_path=str(wav))
    stream.append(clip_a)
    stream.append(clip_b)
    assert stream.close() == str(tmp_path / "stream.mp4") and stream.frames_written == 7
    full = np.concatenate([clip_a, (np.clip(clip_b, 0, 1) * 255).astype(np.uint8)])
    video.write_video(full, str(tmp_path / "oneshot.mp4"), fps=25, audio_path=str(wav))
    jax_video.write_video(full, str(tmp_path / "jax.mp4"), fps=25, audio_path=str(wav))
    got = np.stack(video.read_frames(str(tmp_path / "stream.mp4")))
    assert got.shape == (7, 32, 32, 3)
    np.testing.assert_array_equal(got, np.stack(video.read_frames(str(tmp_path / "oneshot.mp4"))))
    np.testing.assert_array_equal(got, np.stack(jax_video.read_frames(str(tmp_path / "jax.mp4"))))
    assert not os.path.exists(str(tmp_path / "stream.mp4.video.mp4"))


def test_streaming_writer_closed_empty_writes_nothing(tmp_path, ffmpeg):
    w = video.StreamingVideoWriter(str(tmp_path / "empty.mp4"), fps=25, audio_path="x.wav")
    assert w.close() == str(tmp_path / "empty.mp4")
    assert not os.path.exists(str(tmp_path / "empty.mp4"))


def test_video_helpers_match_jax(tmp_path):
    clip_a, _ = _clips()
    grid = np.stack([clip_a, clip_a[::-1], 255 - clip_a])
    video.write_video_grid(grid, str(tmp_path / "g.mp4"), fps=25, n_rows=2)
    jax_video.write_video_grid(grid, str(tmp_path / "gj.mp4"), fps=25, n_rows=2)
    got = np.stack(video.read_frames(str(tmp_path / "g.mp4")))
    assert got.shape == (4, 64, 64, 3)
    np.testing.assert_array_equal(got, np.stack(jax_video.read_frames(str(tmp_path / "gj.mp4"))))
    assert video.get_fps(str(tmp_path / "g.mp4")) == jax_video.get_fps(str(tmp_path / "g.mp4"))
    ours = video.video_to_images(str(tmp_path / "g.mp4"), str(tmp_path / "a"), fps=10)
    theirs = jax_video.video_to_images(str(tmp_path / "g.mp4"), str(tmp_path / "b"), fps=10)
    assert [os.path.basename(p) for p in ours] == [os.path.basename(p) for p in theirs]
    with pytest.raises(FileNotFoundError):
        video.read_frames(str(tmp_path / "absent.mp4"))
