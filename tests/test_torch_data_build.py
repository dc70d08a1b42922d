"""The port's dataset builder (`hallo_tpu_torch.data_preprocess`,
`hallo_tpu_torch.extract_meta_info`) against the JAX package's scripts
(scripts/data_preprocess.py, scripts/extract_meta_info.py), on the CPU.

Three synthetic 20-frame 96x96 mp4s (written by cv2 as
tests/test_data_pipeline_e2e.py writes one) and an unreadable one go through
both builders at --size 64, with no face model files (both take the same
OpenCV fallback). There is no ffmpeg here, so step 1 extracts no audio on
either side; the WAVs are then placed as tests/test_data_pipeline_e2e.py
places one: 0.8 s for the first video (20 frames), 0.4 s for the second
(10 frames: the stage-2 meta skips it, more than 3 frames off), none for
the third. Step 2 runs the small wav2vec2 of tests/test_torch_audio.py
(monkeypatched in for wav2vec2-base on both sides, whose files stay as they
are) from one weights file that both loaders read.

Step 1's frames, face region and every mask level are equal bit for bit;
step 2's face embedding too, and the audio embedding within
tests/test_torch_audio.py's WAV_ATOL. The meta JSONs of steps 2, stage 1
and stage 2 are equal, and the port's datasets read the clips.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch
from safetensors.torch import save_file
from scipy.io import wavfile

from hallo_tpu_torch import data_preprocess, extract_meta_info
from hallo_tpu_torch.convert.from_jax import wav2vec_state_dict_from_jax
from hallo_tpu_torch.data.datasets import FaceMaskDataset, TalkingVideoDataset
from hallo_tpu_torch.utils.factory import WAV2VEC_CONFIGS, build_wav2vec

from tests.test_data_pipeline_e2e import _write_video
from tests.test_torch_audio import WAV_ATOL, jax_config, jax_params
from tests.test_torch_load_pretrained import _seeded

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)  # the JAX package's scripts/

SIZE = 64
# seconds of audio placed for each video (None: no WAV)
AUDIO_SECONDS = {"clip0": 0.8, "clip1": 0.4, "clip2": None}


def write_wav2vec_file(root: str) -> str:
    """The small wav2vec2 with seeded weights, in the HF layout both
    loaders read."""
    _, init_tree = jax_params("tiny")
    init = wav2vec_state_dict_from_jax(build_wav2vec("tiny", device="cpu"), init_tree)
    path = os.path.join(root, "wav2vec2")
    os.makedirs(path)
    save_file({k: v.contiguous() for k, v in _seeded(init, 5).items()},
              os.path.join(path, "model.safetensors"))
    return path


def place_wavs(clips_dir: str) -> None:
    """What an ffmpeg binary would have extracted, and the clip's audio_path."""
    sr = 16000
    for name, seconds in AUDIO_SECONDS.items():
        npz = os.path.join(clips_dir, f"{name}.npz")
        if seconds is None:
            continue
        wav = os.path.join(clips_dir, f"{name}.wav")
        t = np.arange(int(seconds * sr)) / sr
        wavfile.write(wav, sr, (0.2 * np.sin(2 * np.pi * 330 * t)).astype(np.float32))
        data = dict(np.load(npz))
        data["audio_path"] = np.asarray(wav)
        np.savez_compressed(npz, **data)


def jax_main(monkeypatch, argv):
    from scripts import data_preprocess as jax_preprocess

    monkeypatch.setattr(sys, "argv", ["data_preprocess.py", *argv])
    jax_preprocess.main()


def jax_meta(monkeypatch, argv):
    from scripts import extract_meta_info as jax_extract

    monkeypatch.setattr(sys, "argv", ["extract_meta_info.py", *argv])
    jax_extract.main()


def _relative(meta_path, root):
    with open(meta_path) as fh:
        return [os.path.relpath(e["clip_path"], root) for e in json.load(fh)]


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """Both builders, steps 1 and 2 and both meta stages, into jax/ and port/."""
    import hallo_tpu.config as jax_cfg

    monkeypatch = pytest.MonkeyPatch()
    root = str(tmp_path_factory.mktemp("build"))
    videos = os.path.join(root, "videos")
    os.makedirs(videos)
    for name in AUDIO_SECONDS:
        _write_video(os.path.join(videos, f"{name}.mp4"), t=20)
    with open(os.path.join(videos, "broken.mp4"), "wb") as fh:
        fh.write(b"not a video")
    w2v = write_wav2vec_file(root)
    monkeypatch.setattr(jax_cfg, "Wav2Vec2Config", lambda: jax_config("tiny"))
    monkeypatch.setattr(data_preprocess, "WAV2VEC_CONFIG", WAV2VEC_CONFIGS["tiny"])
    common = ["-i", videos, "--size", str(SIZE), "--face_analysis_model_path",
              os.path.join(root, "no_face_models"), "--wav2vec_model_path", w2v]
    out = {}
    for side in ("jax", "port"):
        clips = os.path.join(root, side, "clips")
        for step in ("1", "2"):
            argv = common + ["-o", clips, "-s", step]
            if side == "jax":
                jax_main(monkeypatch, argv)
            else:
                data_preprocess.main(argv + ["--device", "cpu"])
            if step == "1":
                place_wavs(clips)
        for stage in ("1", "2"):
            argv = ["-i", clips, "--stage", stage,
                    "-o", os.path.join(root, side, f"stage{stage}.json")]
            if side == "jax":
                jax_meta(monkeypatch, argv)
            else:
                extract_meta_info.main(argv)
        out[side] = os.path.join(root, side)
    yield out
    monkeypatch.undo()


def test_step1_and_step2_clips_equal_jax(built):
    names = sorted(f for f in os.listdir(os.path.join(built["port"], "clips"))
                   if f.endswith(".npz"))
    assert names == ["clip0.npz", "clip1.npz", "clip2.npz"]  # broken.mp4 skipped
    for name in names:
        ours = dict(np.load(os.path.join(built["port"], "clips", name)))
        theirs = dict(np.load(os.path.join(built["jax"], "clips", name)))
        assert ours.keys() == theirs.keys(), name
        assert ours["frames"].shape == (20, SIZE, SIZE, 3)
        assert ours["frames"].dtype == np.uint8 and ours["face_emb"].shape == (512,)
        for key in ours:
            if key == "audio_path":
                assert os.path.basename(str(ours[key])) == os.path.basename(str(theirs[key]))
            elif key == "audio_emb":
                assert ours[key].shape == theirs[key].shape == (
                    int(AUDIO_SECONDS[name[:-4]] * 25), 2, 16)
                np.testing.assert_allclose(ours[key], theirs[key], atol=WAV_ATOL)
            else:
                np.testing.assert_array_equal(ours[key], theirs[key], err_msg=key)
        assert ("audio_emb" in ours) == (AUDIO_SECONDS[name[:-4]] is not None)
        for level, scale in enumerate(data_preprocess.MASK_SCALES):
            assert ours[f"lip_mask_{level}"].shape == (1, (SIZE // scale) ** 2)


def test_meta_json_equal_jax(built):
    """Step 2's dataset_stage2_r0.json, and extract_meta_info's stage 1 (every
    clip) and stage 2 (clip1's audio is 10 frames off, clip2 has none)."""
    for meta, want in (("dataset_stage2_r0.json", ["clip0", "clip1", "clip2"]),
                       ("stage1.json", ["clip0", "clip1", "clip2"]),
                       ("stage2.json", ["clip0"])):
        ours = _relative(os.path.join(built["port"], meta), built["port"])
        theirs = _relative(os.path.join(built["jax"], meta), built["jax"])
        assert ours == theirs == [f"clips/{n}.npz" for n in want], meta


def test_port_datasets_read_the_clips(built):
    stage2 = TalkingVideoDataset([os.path.join(built["port"], "stage2.json")],
                                 n_sample_frames=4, n_motion_frames=2, audio_margin=2)
    item = stage2[0]
    assert item["pixel_values"].shape == (4, SIZE, SIZE, 3)
    assert item["audio_windows"].shape == (4, 5, 2, 16)
    assert [m.shape for m in item["masks"][0]] == [((SIZE // 8) ** 2,)] * 3
    stage1 = FaceMaskDataset([os.path.join(built["port"], "stage1.json")], sample_margin=4)
    assert len(stage1) == 3 and stage1[2]["pixel_values"].shape == (1, SIZE, SIZE, 3)


def test_sharding_takes_every_pth_video(tmp_path):
    """-p 2 -r 1 takes the sorted list's videos 1, 3, ...: of broken,
    clip0, clip1 and clip2, clip0 and clip2; step 1 on the CPU."""
    videos = tmp_path / "videos"
    videos.mkdir()
    for name in ("clip0", "clip1", "clip2"):
        _write_video(str(videos / f"{name}.mp4"), t=4)
    (videos / "broken.mp4").write_bytes(b"x")
    out = tmp_path / "clips"
    data_preprocess.main(["-i", str(videos), "-o", str(out), "-s", "1", "-p", "2", "-r", "1",
                          "--size", str(SIZE), "--device", "cpu"])
    assert sorted(os.listdir(out)) == ["clip0.npz", "clip2.npz"]


def test_builder_defaults_to_the_card(tmp_path):
    assert data_preprocess.build_parser().get_default("device") == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            data_preprocess.main(["-i", str(tmp_path), "-o", str(tmp_path / "c")])


def test_missing_wav2vec_file_is_smoke_mode_and_a_broken_one_raises(tmp_path, caplog,
                                                                   monkeypatch):
    """Random weights from the seed with a warning where no file exists (as
    scripts/data_preprocess.py:82-89); a file that does not load raises."""
    import logging

    from safetensors import SafetensorError

    monkeypatch.setattr(data_preprocess, "WAV2VEC_CONFIG", WAV2VEC_CONFIGS["tiny"])
    with caplog.at_level(logging.WARNING):
        sd = data_preprocess.wav2vec_state_dict(str(tmp_path / "absent"))
    assert "smoke mode" in caplog.text
    again = data_preprocess.wav2vec_state_dict(str(tmp_path / "absent"))
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    broken = tmp_path / "broken"
    broken.mkdir()
    (broken / "model.safetensors").write_bytes(b"not safetensors")
    with pytest.raises(SafetensorError):
        data_preprocess.wav2vec_state_dict(str(broken))
