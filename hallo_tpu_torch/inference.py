"""CLI inference on PyTorch: one portrait image + one WAV -> talking-head
video (counterpart of scripts/inference.py, with the same flags):

    python -m hallo_tpu_torch.inference --source_image X.jpg --driving_audio Y.wav \
        [--output out.mp4 --profile fast -c configs/inference/default.yaml ...]

It runs on the card unless `--device cpu` is given. The flow is the JAX
CLI's (scripts/inference.py:49-326): config + CLI overrides -> reference
image preprocessing (face analysis, masks) -> the models, built and loaded
from the reference's `pretrained_models/` layout (`build_and_load`) ->
wav2vec2 audio embeddings (vocal separation first when the MDX file
exists) -> sliding windows -> `FaceAnimatePipeline`, whose clips stream
into `StreamingVideoWriter` -> mp4 (audio muxed when ffmpeg exists).

Settings resolve in `resolve_settings`: an explicit flag, then the
profile's value when the profile sets one, then the config's value, then
the default, each tested with `is not None`. Divergence from the JAX CLI
(scripts/inference.py:206-212): there the config's `sampler` wins over the
profile's and `or` swallows falsy flags, so `--profile fast` and `turbo` on
configs/inference/default.yaml (`sampler: DDIM`) run DDIM at 10 and 8 steps;
here they run UniPC, as the profiles mean.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import time
from typing import Any, Dict, Optional, Tuple

import torch

from hallo_tpu_torch import config as cfglib
from hallo_tpu_torch.config import (
    AudioProjConfig,
    FaceLocatorConfig,
    ImageProjConfig,
    SchedulerConfig,
    Wav2Vec2Config,
    unet_config_from_yaml_kwargs,
)
from hallo_tpu_torch.convert.load_pretrained import (
    Report, load_pretrained, load_wav2vec_state_dict)
from hallo_tpu_torch.data.audio_processor import AudioProcessor
from hallo_tpu_torch.data.image_processor import ImageProcessor
from hallo_tpu_torch.pipelines.face_animate import (
    FaceAnimatePipeline, HalloModels, window_audio_embeddings)
from hallo_tpu_torch.utils.factory import build_wav2vec
from hallo_tpu_torch.utils.profiling import StageTimer, counters
from hallo_tpu_torch.utils.video import StreamingVideoWriter

logger = logging.getLogger("hallo_tpu_torch.inference")

# Named speed profiles: a copy of scripts/inference.py's (a test holds the
# two equal). Explicit flags win over a profile's values.
PROFILE_DEFAULTS = {
    "exact": {},
    # UniPC (order-2 bh2) at 10 evals on the grid-nested trailing schedule.
    "fast": {"sampler": "unipc", "inference_steps": 10},
    # Nested-grid UniPC at 8 evals.
    "turbo": {"sampler": "unipc", "inference_steps": 8},
}

# The last resort of each setting (the JAX CLI's fallbacks).
SETTING_DEFAULTS = {
    "sampler": "ddim", "inference_steps": 40, "step_cache": None,
    "step_cache_threshold": 0.10, "cfg_cache_stride": 1, "cfg_tail": 0,
    "timestep_schedule": "trailing", "schedule_rho": 1.0,
}


def _first_set(*values: Any) -> Any:
    return next((v for v in values if v is not None), None)


def resolve_settings(config: Any, args: Any) -> Dict[str, Any]:
    """The sampler settings: for each, an explicit flag, then the profile's
    value when the profile sets one, then the config's, then
    `SETTING_DEFAULTS`, each tested with `is not None` (the JAX CLI's `or`
    swallows a falsy flag such as `--schedule_rho 0`). The step-cache
    threshold has no flag."""
    profile = _first_set(getattr(args, "profile", None), config.get("profile"), "exact")
    if profile not in PROFILE_DEFAULTS:
        raise SystemExit(f"--profile {profile!r}: expected exact|fast|turbo")
    prof = PROFILE_DEFAULTS[profile]
    out = {"profile": profile}
    for key, default in SETTING_DEFAULTS.items():
        flag = None if key == "step_cache_threshold" else getattr(args, key, None)
        out[key] = _first_set(flag, prof.get(key), config.get(key), default)
    out["sampler"] = str(out["sampler"]).lower()
    for key in ("inference_steps", "cfg_cache_stride", "cfg_tail"):
        out[key] = int(out[key])
    for key in ("step_cache_threshold", "schedule_rho"):
        out[key] = float(out[key])
    return out


@dataclasses.dataclass
class Loaded:
    """What `build_and_load` makes: the models with their load reports,
    the audio processor (wav2vec2 and the separator) and the pipeline."""

    models: HalloModels
    reports: Dict[str, Report]
    wav2vec_report: Optional[Report]
    audio_proc: AudioProcessor
    pipe: FaceAnimatePipeline
    settings: Dict[str, Any]


@dataclasses.dataclass
class InferenceRun:
    output: str
    frames: int
    loaded: Loaded
    timing: Dict[str, Any]


def _dtype(config: Any) -> torch.dtype:
    return torch.bfloat16 if str(config.weight_dtype) in ("bf16", "fp16") else torch.float32


def models_from_config(config: Any, device: torch.device) -> HalloModels:
    """The models of `config.unet_additional_kwargs` in `config.weight_dtype`,
    random-initialised from seed 0 on `device`; the heads sized from the
    (possibly cut) UNet config, as the JAX CLI's."""
    unet_kwargs = cfglib.to_container(config.unet_additional_kwargs)
    den_cfg = unet_config_from_yaml_kwargs(unet_kwargs)
    ref_cfg = unet_config_from_yaml_kwargs(unet_kwargs, use_motion_module=False,
                                           use_audio_module=False, use_inflated_groupnorm=False)
    return HalloModels.create(
        ref_cfg, den_cfg,
        face_locator_config=FaceLocatorConfig(
            conditioning_embedding_channels=den_cfg.block_out_channels[0]),
        image_proj_config=ImageProjConfig(cross_attention_dim=den_cfg.cross_attention_dim),
        audio_proj_config=AudioProjConfig(output_dim=den_cfg.audio_attention_dim),
        device=device, dtype=_dtype(config), seed=0)


def _wav2vec_state_dict(model_path: str, device: torch.device, allow_partial: bool
                        ) -> Tuple[Dict[str, torch.Tensor], Optional[Report]]:
    """wav2vec2's file laid over the model's keys and shapes, which come
    from a model on the meta device (nothing allocated). A random initial
    value (seed 1) is made only for what the file lacks, and for the whole
    model when no file exists, which is fatal unless `allow_partial`:
    random audio features give garbage videos, so smoke mode is an explicit
    opt-in, as for net.pth."""
    shapes = build_wav2vec("full", device="meta").state_dict()
    try:
        sd, report = load_wav2vec_state_dict(model_path, shapes)
    except FileNotFoundError:
        if not allow_partial:
            raise SystemExit(f"wav2vec weights missing at {model_path!r}; "
                             "pass --allow-partial to run in smoke mode with random init")
        logger.warning("wav2vec weights missing; using random init (smoke mode)")
        sd, report = shapes, None
    if any(t.is_meta for t in sd.values()):
        init = build_wav2vec("full", device=device, seed=1).state_dict()
        sd = {k: init[k] if t.is_meta else t for k, t in sd.items()}
    return sd, report


def build_and_load(config: Any, settings: Dict[str, Any], device: torch.device,
                   allow_partial: bool, timer: StageTimer) -> Loaded:
    """Build the models from `config` on `device` and load the reference's
    files over their initial weights (every module with a file must load
    99% of its tensors unless `allow_partial`; a missing wav2vec2 file is
    fatal unless `allow_partial`); the audio processor and the pipeline."""
    with timer.stage("init_params"):
        models = models_from_config(config, device)
    with timer.stage("load_weights"):
        reports = load_pretrained(
            models,
            base_model_path=str(config.base_model_path),
            motion_module_path=str(config.motion_module_path),
            vae_model_path=str(config.vae.model_path),
            net_pth_path=os.path.join(str(config.audio_ckpt_dir), "net.pth"),
            min_loaded_fraction=0.0 if allow_partial else 0.99,
        )
        w2v_sd, w2v_report = _wav2vec_state_dict(str(config.wav2vec.model_path), device,
                                                 allow_partial)
        separator = config.get("audio_separator") or {}
        audio_proc = AudioProcessor(
            sample_rate=int(config.data.driving_audio.sample_rate),
            fps=int(config.data.export_video.fps),
            wav2vec_state_dict=w2v_sd,
            wav2vec_config=Wav2Vec2Config(),
            device=device,
            audio_separator_model_path=str(separator.get("model_path") or "") or None,
            only_last_features=str(config.wav2vec.features) == "last",
        )
    del w2v_sd

    sched_kwargs = cfglib.to_container(config.noise_scheduler_kwargs)
    sched = SchedulerConfig(
        num_train_timesteps=int(sched_kwargs.get("num_train_timesteps", 1000)),
        beta_start=float(sched_kwargs["beta_start"]),
        beta_end=float(sched_kwargs["beta_end"]),
        beta_schedule=str(sched_kwargs["beta_schedule"]),
        prediction_type=str(sched_kwargs.get("prediction_type", "v_prediction")),
        rescale_betas_zero_snr=bool(config.enable_zero_snr),
        timestep_spacing=str(sched_kwargs.get("timestep_spacing", "trailing")),
    )
    pipe = FaceAnimatePipeline(
        models, sched,
        num_inference_steps=settings["inference_steps"],
        guidance_scale=float(config.cfg_scale),
        clip_length=int(config.data.n_sample_frames),
        n_motion_frames=int(config.data.n_motion_frames),
        step_cache=settings["step_cache"],
        step_cache_threshold=settings["step_cache_threshold"],
        cfg_cache_stride=settings["cfg_cache_stride"],
        sampler=settings["sampler"],
        cfg_tail=settings["cfg_tail"],
        timestep_schedule=settings["timestep_schedule"],
        schedule_rho=settings["schedule_rho"],
    )
    return Loaded(models, reports, w2v_report, audio_proc, pipe, settings)


def inference_process(args: argparse.Namespace) -> InferenceRun:
    """The CLI's whole flow; returns the output path, the frames written,
    what `build_and_load` made and the timing report."""
    t_start = time.perf_counter()
    device = torch.device(getattr(args, "device", None) or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device here; pass --device cpu for the CPU")
    timer = StageTimer(device)
    allow_partial = bool(getattr(args, "allow_partial", False))
    # The fp32 work (wav2vec2's convolutions and products) in full fp32, as
    # chip_smoke.py holds it against the CPU: PyTorch's default lets cuDNN
    # run fp32 convolutions in TF32. The bf16 models are not affected, and
    # the ONNX executor sets the same for its graphs.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    config = cfglib.load_yaml(args.config)
    config = cfglib.merge_cli_overrides(config, {
        "source_image": args.source_image,
        "driving_audio": args.driving_audio,
        "pose_weight": getattr(args, "pose_weight", None),
        "face_weight": getattr(args, "face_weight", None),
        "lip_weight": getattr(args, "lip_weight", None),
        "face_expand_ratio": getattr(args, "face_expand_ratio", None),
        "audio_ckpt_dir": getattr(args, "audio_ckpt_dir", None),
    })
    settings = resolve_settings(config, args)
    output = getattr(args, "output", None) or ".cache/output.mp4"
    width = int(config.data.source_image.width)
    height = int(config.data.source_image.height)
    clip_length = int(config.data.n_sample_frames)
    fps = int(config.data.export_video.fps)

    with timer.stage("image_preprocess"):
        face_analysis = config.get("face_analysis") or {}
        img_proc = ImageProcessor((width, height), face_analysis.get("model_path"), device=device)
        processed = img_proc.preprocess(str(config.source_image), float(config.face_expand_ratio))

    loaded = build_and_load(config, settings, device, allow_partial, timer)

    with timer.stage("audio_preprocess"):
        audio_emb, audio_length = loaded.audio_proc.preprocess(str(config.driving_audio),
                                                               clip_length)
        audio_windows = window_audio_embeddings(audio_emb, margin=2)

    masks = tuple((processed.full_masks[d], processed.face_masks[d], processed.lip_masks[d])
                  for d in range(4))
    # Each clip streams into the encoder as it is fetched, while the next
    # clip runs on the card; "write_video" is then the close and the mux.
    vwriter = StreamingVideoWriter(output, fps=fps, audio_path=str(config.driving_audio))
    try:
        with timer.stage("generate"):
            loaded.pipe(
                ref_image=processed.pixel_values[None],
                audio_windows=audio_windows,
                face_emb=processed.face_emb[None],
                face_region=processed.face_region[None],
                masks=masks,
                motion_scale=(float(config.pose_weight), float(config.face_weight),
                              float(config.lip_weight)),
                seed=42,
                audio_length=audio_length,
                on_clip=lambda arr: vwriter.append(arr[0]),
                return_video=False,
            )
    finally:
        # always close: flush the clips that landed even if generation raised
        with timer.stage("write_video"):
            vwriter.close()
    n_frames = int(vwriter.frames_written)
    logger.info("wrote %s (%d frames)", output, n_frames)

    total_s = time.perf_counter() - t_start
    out_seconds = n_frames / fps
    timing = {
        "metric": "e2e_inference",
        "profile": settings["profile"],
        "sampler": settings["sampler"],
        "steps": settings["inference_steps"],
        "frames": n_frames,
        "fps": fps,
        "num_clips": -(-n_frames // clip_length),
        "stages_s": {k: v["total_s"] for k, v in timer.summary().items()},
        "total_s": round(total_s, 3),
        "output_seconds": round(out_seconds, 3),
        # wall clock from the start of the run to the muxed file, per
        # second of output: preprocessing, weights and the write included
        "seconds_per_1s_output": round(total_s / out_seconds, 3) if n_frames else None,
        "smoke_mode": allow_partial,
        "device": str(device),
        # the program's counters (utils/profiling.py): the denoiser's
        # evaluations by kind, the host's waits on the card by site, the
        # kernels' launches
        "counters": dict(counters()),
    }
    timing_json = getattr(args, "timing_json", None)
    if timing_json:
        with open(timing_json, "w") as fh:
            json.dump(timing, fh)
        logger.info("timing: %s", json.dumps(timing))
    return InferenceRun(output, n_frames, loaded, timing)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="hallo_tpu_torch inference")
    parser.add_argument("-c", "--config", default="configs/inference/default.yaml")
    parser.add_argument("--source_image", type=str, default=None)
    parser.add_argument("--driving_audio", type=str, default=None)
    parser.add_argument("--output", type=str, default=None)
    parser.add_argument("--pose_weight", type=float, default=None)
    parser.add_argument("--face_weight", type=float, default=None)
    parser.add_argument("--lip_weight", type=float, default=None)
    parser.add_argument("--face_expand_ratio", type=float, default=None)
    parser.add_argument("--audio_ckpt_dir", "--checkpoint", type=str, default=None)
    parser.add_argument(
        "--allow-partial", dest="allow_partial", action="store_true",
        help="proceed even when found checkpoints load incompletely")
    parser.add_argument(
        "--step_cache", type=str, default=None, choices=("uniform", "dynamic"),
        help="cached-prediction step skipping (diffusion/cache.py)")
    parser.add_argument(
        "--cfg_cache_stride", type=int, default=None,
        help="recompute the CFG-uncond half only every Nth step (1 = off)")
    parser.add_argument(
        "--cfg_tail", type=int, default=None,
        help="run the last N steps cond-only at guidance 1")
    parser.add_argument(
        "--timestep_schedule", type=str, default=None, choices=("trailing", "logsnr"),
        help="eval-grid spacing: trailing (reference parity) or logsnr")
    parser.add_argument(
        "--schedule_rho", type=float, default=None,
        help="logsnr schedule curvature (1.0 uniform; >1 concentrates knots at the "
             "high-noise end)")
    parser.add_argument(
        "--sampler", type=str, default=None, choices=("ddim", "dpm++2m", "unipc"),
        help="solver for the denoise loop: ddim (reference parity), dpm++2m or unipc")
    parser.add_argument(
        "--inference_steps", type=int, default=None,
        help="override the denoise step count")
    parser.add_argument(
        "--timing_json", type=str, default=None,
        help="write a JSON stage-timing breakdown, the end-to-end seconds per 1 s "
             "of output and the program's counters to this path")
    parser.add_argument(
        "--profile", type=str, default=None, choices=("exact", "fast", "turbo"),
        help="named speed profile: exact (default), fast (unipc @ 10) or turbo (unipc @ 8)")
    parser.add_argument(
        "--device", type=str, default="cuda",
        help="torch device to run on (default cuda; cpu for a host without a card)")
    return parser


def main() -> None:
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(name)s: %(message)s")
    inference_process(build_parser().parse_args())


if __name__ == "__main__":
    main()
