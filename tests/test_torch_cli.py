"""The port's CLI (`hallo_tpu_torch/inference.py`) on the CPU.

- `TINY_YAML` of tests/test_cli_inference.py with `--device cpu`: without
  checkpoint files (`--allow-partial`), with tiny checkpoint files in the
  reference's five layouts (and then every module loads 100%, net.pth's
  values win), and with `--profile fast`: each writes an mp4 of 8 frames at
  64x64 (0.32 s of audio at 25 fps) and the timing JSON.
- A VAE file with renamed keys makes the CLI raise before generation.
- Without `--device cpu` and without a card, the CLI raises.
- `PROFILE_DEFAULTS` and the flags are scripts/inference.py's.
- `resolve_settings` on configs/inference/default.yaml for the three
  profiles and for falsy flags. Named divergence from the JAX CLI
  (scripts/inference.py:206-212): its `args.sampler or config.sampler or
  profile["sampler"]` lets default.yaml's `sampler: DDIM` win over the
  profile, so its `--profile fast` and `turbo` run DDIM at 10 and 8 steps;
  the port's run UniPC at 10 and 8, and its `exact` DDIM at 40. The JAX
  CLI's `or` also swallows a falsy `--schedule_rho`, `--inference_steps` or
  `--cfg_cache_stride`; the port's `is not None` keeps them.
"""

import argparse
import json
import os
import re

import numpy as np
import pytest
import torch
import yaml
from safetensors.torch import save_file

from hallo_tpu_torch import inference
from hallo_tpu_torch.config import DotDict, load_yaml
from hallo_tpu_torch.utils.factory import build_wav2vec
from hallo_tpu_torch.utils.video import read_frames

from tests.test_cli_inference import TINY_YAML
from tests.test_torch_load_pretrained import write_layout

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_YAML = os.path.join(REPO, "configs", "inference", "default.yaml")


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for the port's CPU runs here: the suite runs
    these files beside five other workers, where torch's default of one
    thread a core oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def inputs(tmp_path):
    """tests/test_cli_inference.py's synthetic portrait and 0.32-s WAV."""
    import cv2
    from scipy.io import wavfile

    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (64, 64, 3)).astype(np.uint8)
    cv2.circle(img, (32, 28), 14, (200, 170, 150), -1)
    cv2.imwrite(str(tmp_path / "face.png"), img)
    sr = 16000
    t = np.arange(int(0.32 * sr)) / sr
    wavfile.write(str(tmp_path / "voice.wav"), sr, (0.3 * np.sin(2 * np.pi * 220 * t)).astype(
        np.float32))
    return str(tmp_path / "face.png"), str(tmp_path / "voice.wav")


def _config(tmp_path, **paths):
    cfg = yaml.safe_load(TINY_YAML)
    for key, value in paths.items():
        node = cfg
        *parents, leaf = key.split(".")
        for p in parents:
            node = node[p]
        node[leaf] = value
    path = str(tmp_path / "tiny.yaml")
    with open(path, "w") as fh:
        yaml.safe_dump(cfg, fh)
    return path


def _args(config, inputs, out, **kw):
    parser = inference.build_parser()
    argv = ["-c", config, "--source_image", inputs[0], "--driving_audio", inputs[1],
            "--output", out, "--device", "cpu", "--timing_json", out + ".json"]
    for key, value in kw.items():
        argv += [f"--{key}"] if value is True else [f"--{key}", str(value)]
    return parser.parse_args(argv)


def _check_video(run, out):
    frames = read_frames(out)
    assert run.output == out and run.frames == len(frames) == 8
    assert frames[0].shape == (64, 64, 3)
    with open(out + ".json") as fh:
        timing = json.load(fh)
    assert set(timing["stages_s"]) == {"image_preprocess", "init_params", "load_weights",
                                       "audio_preprocess", "generate", "write_video"}
    assert timing["frames"] == 8 and timing["seconds_per_1s_output"] > 0
    counts = timing["counters"]  # the process's, over every run so far
    assert counts["request"] >= 1 and counts["wait.inputs"] >= 16 + 1
    assert counts["denoiser.eval.full"] >= 1 and "launch.flash_fwd_packed" in counts
    return timing


def test_cli_smoke_mode_without_files(tmp_path, inputs):
    out = str(tmp_path / "out.mp4")
    run = inference.inference_process(
        _args(_config(tmp_path), inputs, out, **{"allow-partial": True}))
    timing = _check_video(run, out)
    assert (timing["sampler"], timing["steps"], timing["smoke_mode"]) == ("ddim", 2, True)
    assert run.loaded.reports == {} and run.loaded.wav2vec_report is None


def _write_files(tmp_path, config_path, vae_rename=False):
    root = str(tmp_path / "pretrained_models")
    models = inference.models_from_config(load_yaml(config_path), torch.device("cpu"))
    paths, files = write_layout(root, models, vae_rename=vae_rename)
    w2v_dir = os.path.join(root, "wav2vec", "wav2vec2-base-960h")
    os.makedirs(w2v_dir)
    w2v = {"wav2vec2." + k: v.half()
           for k, v in build_wav2vec("full", device="cpu", seed=5).state_dict().items()}
    save_file(w2v, os.path.join(w2v_dir, "model.safetensors"))
    return _config(tmp_path, base_model_path=paths["base"], motion_module_path=paths["motion"],
                   **{"vae.model_path": paths["vae"],
                      "audio_ckpt_dir": os.path.dirname(paths["net"]),
                      "wav2vec.model_path": w2v_dir}), files, w2v


def test_cli_with_checkpoint_files(tmp_path, inputs):
    config, files, w2v = _write_files(tmp_path, _config(tmp_path))
    out = str(tmp_path / "out.mp4")
    run = inference.inference_process(_args(config, inputs, out))
    timing = _check_video(run, out)
    assert timing["smoke_mode"] is False
    loaded = run.loaded
    for name, module in loaded.models.modules().items():
        report = loaded.reports[name]
        assert len(report["loaded"]) == len(module.state_dict()), name
        assert not report["shape_mismatch"]
    sd = loaded.models.denoising_net.state_dict()
    assert torch.equal(sd["conv_in.weight"], files["net"]["denoising_unet.conv_in.weight"])
    assert torch.equal(loaded.models.vae.state_dict()["encoder.conv_in.weight"],
                       files["vae"]["encoder.conv_in.weight"])
    assert len(loaded.wav2vec_report["loaded"]) == 211
    key = "encoder.layers.0.attention.q_proj.weight"
    assert torch.equal(loaded.audio_proc.model.state_dict()[key], w2v["wav2vec2." + key].float())


def test_wav2vec_random_init_only_where_the_file_lacks_it(tmp_path, monkeypatch):
    """The CLI's wav2vec2 state: a complete file is laid over the model's
    meta-device shapes and no random model is made; a key the file lacks
    takes the seed-1 initial value; no file is fatal unless allow_partial."""
    built = []
    real = inference.build_wav2vec

    def spy(scale="full", device=torch.device("cuda"), seed=0):
        built.append(str(torch.device(device)))
        return real(scale, device=device, seed=seed)

    monkeypatch.setattr(inference, "build_wav2vec", spy)
    cpu = torch.device("cpu")
    w2v = {"wav2vec2." + k: v.half()
           for k, v in real("full", device="cpu", seed=5).state_dict().items()}
    save_file(w2v, str(tmp_path / "model.safetensors"))
    sd, report = inference._wav2vec_state_dict(str(tmp_path), cpu, allow_partial=False)
    assert built == ["meta"] and len(report["loaded"]) == len(sd) == 211
    key = "encoder.layers.0.attention.q_proj.weight"
    assert torch.equal(sd[key], w2v["wav2vec2." + key])

    built.clear()
    dropped = "encoder.layers.1.final_layer_norm.bias"
    save_file({k: v for k, v in w2v.items() if k != "wav2vec2." + dropped},
              str(tmp_path / "model.safetensors"))
    sd, report = inference._wav2vec_state_dict(str(tmp_path), cpu, allow_partial=False)
    assert built == ["meta", "cpu"] and report["missing_in_ckpt"] == [dropped]
    assert torch.equal(sd[dropped], real("full", device="cpu", seed=1).state_dict()[dropped])
    assert not any(t.is_meta for t in sd.values())

    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    with pytest.raises(SystemExit, match="wav2vec weights missing"):
        inference._wav2vec_state_dict(empty, cpu, allow_partial=False)
    sd, report = inference._wav2vec_state_dict(empty, cpu, allow_partial=True)
    assert report is None and not any(t.is_meta for t in sd.values())


def test_cli_fast_profile(tmp_path, inputs):
    out = str(tmp_path / "out.mp4")
    run = inference.inference_process(_args(_config(tmp_path), inputs, out, profile="fast",
                                        **{"allow-partial": True}))
    timing = _check_video(run, out)
    assert (timing["profile"], timing["sampler"], timing["steps"]) == ("fast", "unipc", 10)
    assert run.loaded.pipe.sampler.num_steps == 10


def test_cli_raises_on_a_renamed_vae_before_generation(tmp_path, inputs, monkeypatch):
    config, _, _ = _write_files(tmp_path, _config(tmp_path), vae_rename=True)
    calls = []
    monkeypatch.setattr(inference.FaceAnimatePipeline, "__call__",
                        lambda *a, **k: calls.append(1))
    out = str(tmp_path / "out.mp4")
    with pytest.raises(RuntimeError, match="vae: loaded 0/"):
        inference.inference_process(_args(config, inputs, out))
    assert calls == [] and not os.path.exists(out)


def test_cli_default_device_raises_without_a_card(tmp_path, inputs):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    args = _args(_config(tmp_path), inputs, str(tmp_path / "out.mp4"), **{"allow-partial": True})
    args.device = inference.build_parser().get_default("device")
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        inference.inference_process(args)


def test_profile_defaults_are_the_jax_clis():
    from scripts.inference import PROFILE_DEFAULTS

    assert inference.PROFILE_DEFAULTS == PROFILE_DEFAULTS


def test_flags_are_the_jax_clis_and_device():
    with open(os.path.join(REPO, "scripts", "inference.py")) as fh:
        src = fh.read()
    theirs = set(re.findall(r'"(--?[a-z_-]+)"', src[src.index("def main"):]))
    ours = {s for a in inference.build_parser()._actions for s in a.option_strings}
    assert ours - {"-h", "--help"} == theirs | {"--device"}


def _settings(**flags):
    args = argparse.Namespace(**{k: None for k in (
        "profile", "sampler", "inference_steps", "step_cache", "cfg_cache_stride", "cfg_tail",
        "timestep_schedule", "schedule_rho")})
    for key, value in flags.items():
        setattr(args, key, value)
    return inference.resolve_settings(load_yaml(DEFAULT_YAML), args)


@pytest.mark.parametrize("profile,sampler,steps", [(None, "ddim", 40), ("exact", "ddim", 40),
                                                   ("fast", "unipc", 10),
                                                   ("turbo", "unipc", 8)])
def test_resolve_settings_on_default_yaml(profile, sampler, steps):
    """default.yaml says `sampler: DDIM` and 40 steps: the profiles' own
    sampler and steps win over it (the JAX CLI gives ddim at 10 and 8 for
    fast and turbo, this module's docstring)."""
    s = _settings(profile=profile)
    assert (s["profile"], s["sampler"], s["inference_steps"]) == (profile or "exact", sampler,
                                                                  steps)
    assert (s["step_cache"], s["cfg_cache_stride"], s["cfg_tail"], s["timestep_schedule"],
            s["schedule_rho"], s["step_cache_threshold"]) == (None, 1, 0, "trailing", 1.0, 0.10)


def test_resolve_settings_keeps_falsy_flags_and_flag_precedence():
    s = _settings(profile="turbo", schedule_rho=0.0, cfg_tail=0, inference_steps=0,
                  cfg_cache_stride=0, sampler="dpm++2m", timestep_schedule="logsnr")
    assert (s["schedule_rho"], s["cfg_tail"], s["inference_steps"], s["cfg_cache_stride"]) == (
        0.0, 0, 0, 0)
    assert (s["sampler"], s["timestep_schedule"]) == ("dpm++2m", "logsnr")
    config = DotDict(load_yaml(DEFAULT_YAML), step_cache="dynamic", cfg_cache_stride=3,
                     schedule_rho=2.0, profile="fast")
    args = argparse.Namespace(profile=None, step_cache=None, cfg_cache_stride=None,
                              schedule_rho=None, inference_steps=None)
    s = inference.resolve_settings(config, args)
    assert (s["profile"], s["sampler"], s["step_cache"], s["cfg_cache_stride"],
            s["schedule_rho"]) == ("fast", "unipc", "dynamic", 3, 2.0)
    with pytest.raises(SystemExit):
        _settings(profile="warp")
