"""The port's quality audit (`hallo_tpu_torch/eval_cache_quality.py`,
`eval_lpips_samples.py`) against the JAX scripts on the CPU:

- `psnr` and `ssim` equal scripts/eval_cache_quality.py's (imported by path)
  on seeded uint8 stacks, bit for bit (the same numpy arithmetic);
- the mode matrix: the JAX script's `main` run with its pipeline, models
  and inputs stubbed records each row's pipeline arguments and its JSON row;
  the port's `mode_table` gives the same rows in the same order, under the
  same environment variables, with the same labels, samplers, steps,
  thresholds and strides;
- the tiny matrix in-process (2 seeds, 4 steps, 64^2, a HALLO_EVAL_MODES
  subset that covers the uniform, dynamic, CFG, DPM and UniPC rows) with a
  random lpips-alex file: JAX's JSON keys, mean/min/max over the seeds, the
  LPIPS column numeric, the turbo profile's row labelled;
- `eval_lpips_samples` prints the JAX script's skip JSON without weights.
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from hallo_tpu_torch import eval_cache_quality as ecq
from hallo_tpu_torch import eval_lpips_samples as els
from hallo_tpu_torch.utils.lpips import random_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV_KEYS = ("HALLO_EVAL_SCALE", "HALLO_EVAL_STEPS", "HALLO_EVAL_THRESHOLDS", "HALLO_EVAL_SEEDS",
            "HALLO_EVAL_SIZES", "HALLO_EVAL_MODES", "HALLO_EVAL_UNIPC", "HALLO_EVAL_R5",
            "HALLO_EVAL_CFG_STRIDE", "HALLO_LPIPS_WEIGHTS")
ROW_KEYS = {"mode", "sampler", "steps", "threshold", "cfg_cache_stride", "psnr_vs_exact_db",
            "ssim_vs_exact", "lpips_vs_exact", "mean_abs_diff", "clip_seconds",
            "speedup_vs_exact"}


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for the port's CPU runs here: the suite runs
    these files beside five other workers, where torch's default of one
    thread a core oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def load_script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_eval():
    return load_script("eval_cache_quality")


@pytest.fixture
def clean_env(monkeypatch):
    for key in ENV_KEYS:
        monkeypatch.delenv(key, raising=False)
    return monkeypatch


def test_psnr_ssim_match_jax(jax_eval):
    rng = np.random.default_rng(0)
    a = rng.integers(0, 256, (1, 3, 37, 45, 3), dtype=np.uint8)
    b = np.clip(a.astype(np.int16) + rng.integers(-20, 21, a.shape), 0, 255).astype(np.uint8)
    assert ecq.psnr(a, b) == jax_eval.psnr(a, b)
    assert ecq.psnr(a, a) == jax_eval.psnr(a, a) == 99.0
    for win in (8, 5):
        assert ecq.ssim(a, b, win) == jax_eval.ssim(a, b, win)
    assert ecq.ssim(a, a) == pytest.approx(1.0)


def jax_rows(jax_eval, monkeypatch, capsys, env: dict):
    """Run the JAX script's `main` with its pipeline, models and inputs
    stubbed: [(pipeline kwargs, JSON row)] per mode, in order."""
    import jax

    import hallo_tpu.pipelines.face_animate as jfa
    import hallo_tpu.utils.factory as jfactory

    made = []

    class Pipe:
        def __init__(self, models, scheduler, **kw):
            made.append(kw)

        def _generate_clip(self, params, ref_pixels, latents, *tail):
            return (np.zeros((1, 1, 8, 8, 3), np.uint8),)

    class Models:
        params = {}

        def init_params(self, *a, **k):
            pass

    def inputs(*a, **k):
        return dict(ref_image=np.zeros((1, 8, 8, 3), np.float32),
                    audio_windows=np.zeros((1, 1, 1, 1), np.float32),
                    face_emb=np.zeros((1, 4), np.float32),
                    face_region=np.zeros((1, 8, 8, 3), np.float32),
                    masks=tuple(tuple(np.ones((1, 1), np.float32) for _ in range(3))
                                for _ in range(4)))

    monkeypatch.setattr(jfa, "FaceAnimatePipeline", Pipe)
    monkeypatch.setattr(jfactory, "build_models", lambda *a, **k: Models())
    monkeypatch.setattr(jfactory, "dummy_clip_inputs", inputs)
    # the script points JAX's persistent cache at its own directory: keep
    # the test session's settings
    update = jax.config.update
    monkeypatch.setattr(jax.config, "update", lambda key, value: None
                        if key.startswith("jax_persistent_cache") or "compilation_cache" in key
                        else update(key, value))
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    capsys.readouterr()
    jax_eval.main()
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    (section,) = report["sections"]
    # made[0] is the exact pipeline, then one per mode
    assert made[0] == dict(num_inference_steps=int(env.get("HALLO_EVAL_STEPS", "40")),
                           guidance_scale=3.5, clip_length=4, n_motion_frames=2,
                           step_cache=None, step_cache_threshold=0.0, cfg_cache_stride=1,
                           sampler="ddim")
    return list(zip(made[1:], section["modes"]))


ENVS = {
    "default": {},
    "thresholds": {"HALLO_EVAL_THRESHOLDS": "0.05,0.10,0.20", "HALLO_EVAL_STEPS": "30",
                   "HALLO_EVAL_CFG_STRIDE": "2"},
    "no_unipc_r5": {"HALLO_EVAL_UNIPC": "0", "HALLO_EVAL_R5": "0"},
    "modes": {"HALLO_EVAL_MODES": "ddim,turbo,r5_unipc10"},
}


@pytest.mark.parametrize("env", list(ENVS.values()), ids=list(ENVS))
def test_mode_table_matches_jax(jax_eval, clean_env, capsys, env):
    rows = jax_rows(jax_eval, clean_env, capsys,
                    dict(env, HALLO_EVAL_SCALE="tiny", HALLO_EVAL_SEEDS="0"))
    steps = int(env.get("HALLO_EVAL_STEPS", "40"))
    thresholds = [float(t) for t in env.get("HALLO_EVAL_THRESHOLDS", "0.10").split(",")]
    modes = ecq.mode_table(thresholds, int(env.get("HALLO_EVAL_CFG_STRIDE", "3")),
                           unipc=env.get("HALLO_EVAL_UNIPC", "1") != "0",
                           r5=env.get("HALLO_EVAL_R5", "1") != "0",
                           only=env.get("HALLO_EVAL_MODES"))
    assert len(modes) == len(rows) > 0
    for mode, (kw, row) in zip(modes, rows):
        assert mode.pipeline_kwargs(steps) == {
            k: v for k, v in kw.items()
            if k not in ("guidance_scale", "clip_length", "n_motion_frames")}
        assert mode.name == row["mode"]
        assert (mode.sampler, mode.steps or steps, mode.cfg_stride) == (
            row["sampler"], row["steps"], row["cfg_cache_stride"])
        assert (mode.threshold if mode.step_cache == "dynamic" else None) == row["threshold"]


def test_cli_profiles_are_labelled():
    labels = {m.name: m.cli_profile(40) for m in ecq.mode_table([0.10])}
    assert labels.pop("r5_unipc10") == "fast" and labels.pop("r5_unipc8") == "turbo"
    assert set(labels.values()) == {None}


def test_tiny_matrix_in_process(clean_env, tmp_path, capsys):
    pth = tmp_path / "lpips_alex.pth"
    torch.save(random_state_dict(0), str(pth))
    for key, value in dict(HALLO_EVAL_SCALE="tiny", HALLO_EVAL_STEPS="4",
                           HALLO_EVAL_SEEDS="0,1", HALLO_EVAL_MODES="ddim,fast_dpm15,r5_unipc8",
                           HALLO_LPIPS_WEIGHTS=str(pth)).items():
        clean_env.setenv(key, value)
    report = ecq.main(["--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == report
    assert report["metric"] == "step_cache_quality_audit" and report["scale"] == "tiny"
    assert report["steps"] == 4 and report["lpips"] == f"loaded {pth}"
    assert report["device"] == "cpu"
    (section,) = report["sections"]
    assert section["size"] == 64 and section["seeds"] == [0, 1]
    assert set(section["exact_clip_seconds"]) == {"mean", "min", "max"}
    names = [row["mode"] for row in section["modes"]]
    assert names == ["uniform", "dynamic", "exact+cfg3", "dynamic+cfg3", "fast_dpm15",
                     "r5_unipc8", "r5_unipc8_c42"]
    for row in section["modes"]:
        assert set(row) == ROW_KEYS | {"cli_profile"}
        for col in ("psnr_vs_exact_db", "ssim_vs_exact", "lpips_vs_exact", "mean_abs_diff",
                    "clip_seconds", "speedup_vs_exact"):
            val = row[col]
            assert isinstance(val, dict) and set(val) == {"mean", "min", "max"}, (row, col)
            assert val["min"] <= val["mean"] <= val["max"]
        assert isinstance(row["lpips_vs_exact"]["mean"], float)
    rows = {row["mode"]: row for row in section["modes"]}
    assert rows["r5_unipc8"]["cli_profile"] == "turbo"
    # a different sampler departs from exact; at 4 DDIM steps the caches skip
    # nothing, so their rows equal exact
    assert rows["r5_unipc8"]["psnr_vs_exact_db"]["max"] < 99.0
    assert rows["uniform"]["mean_abs_diff"] == {"mean": 0.0, "min": 0.0, "max": 0.0}


def test_eval_lpips_samples_skip_json(clean_env, tmp_path, capsys):
    clean_env.chdir(tmp_path)  # no weights, no examples here
    report = els.main(["--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip()) == report
    jax_script = load_script("eval_lpips_samples")
    clean_env.setattr(sys, "argv", ["eval_lpips_samples.py"])
    jax_script.main()
    want = json.loads(capsys.readouterr().out.strip())
    assert report == want
    assert "metric skipped" in report["skipped"]
    assert "missing pretrained_models/hallo/net.pth" in report["skipped"]
    # with the LPIPS file present it still skips, naming the missing files only
    pth = tmp_path / "lpips_alex.pth"
    torch.save(random_state_dict(0), str(pth))
    clean_env.setenv("HALLO_LPIPS_WEIGHTS", str(pth))
    report = els.main(["--device", "cpu"])
    assert "LPIPS" not in report["skipped"]
    assert report["skipped"].startswith("missing pretrained_models/hallo/net.pth")
