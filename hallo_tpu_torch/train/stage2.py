"""Stage-2 training on one card: the motion and audio modules and the audio
projection are trained; the stage-1 networks stay frozen (counterpart of
scripts/train_stage2.py; reference scripts/train_stage2.py:421-959).

    python -m hallo_tpu_torch.train.stage2 --config configs/train/stage2.yaml

The config is the JAX trainer's YAML. Its `data.train_bs: 4` does not fit
an 80 GB H100 at 512^2 with per-block checkpointing (PERF.md): set it to 1
there. The mesh, clip parallelism, tensor
parallelism and ZeRO are not ported: the trainer runs on one device. What
waits for files the repository does not hold raises `NotImplementedError`:
loading pretrained weights from paths that exist (SD-1.5, the VAE, the
motion module), a stage-1 export directory that exists, the 8-bit AdamW,
and validation renders within `max_train_steps` (set
`val.validation_steps: 0`). Paths that do not exist are skipped with a log
line, as the JAX trainer's loader does, and the models keep their random
initialisation from `seed`.
"""

from __future__ import annotations

import argparse
import logging
import os
import time

import torch

from hallo_tpu_torch import config as cfglib
from hallo_tpu_torch.config import SchedulerConfig, unet_config_from_yaml_kwargs
from hallo_tpu_torch.data.datasets import TalkingVideoDataset, batch_iterator
from hallo_tpu_torch.pipelines.face_animate import HalloModels
from hallo_tpu_torch.train.state import (
    AdamW, OptimizerConfig, TrainState, stage2_trainable, unfreeze)
from hallo_tpu_torch.train.step import TrainConfig, make_train_step, step_generator
from hallo_tpu_torch.utils import checkpoint as ckpt
from hallo_tpu_torch.utils.profiling import MetricsLogger

logger = logging.getLogger("hallo_tpu_torch.train.stage2")

MAX_CONSECUTIVE_SKIPS = 25
EXPORTED = ("reference_net", "denoising_net", "face_locator", "image_proj", "audio_proj")


def _check_unported(cfg) -> None:
    """Raise on what needs files or modules the port does not have yet;
    log the checkpoint paths that are absent and skipped."""
    for key in ("base_model_path", "vae_model_path", "mm_path"):
        path = str(cfg.get(key, "") or "")
        if path and os.path.exists(path):
            raise NotImplementedError(
                f"{key}={path} exists: loading pretrained weights is not ported yet "
                "(convert/load_pretrained.py); remove the key to train from random weights")
        if path:
            logger.info("%s=%s not found: skipped (random initialisation)", key, path)
    stage1 = str(cfg.get("stage1_ckpt_dir", "") or "")
    if stage1 and os.path.isdir(stage1):
        raise NotImplementedError(
            f"stage1_ckpt_dir={stage1} exists: loading stage-1 exports is not ported yet")
    if cfg.solver.get("use_8bit_adam", False):
        raise NotImplementedError(
            "solver.use_8bit_adam: the 8-bit AdamW (train/adam8bit.py) is not ported yet; "
            "set it to false")
    val = cfg.get("val") or {}
    every = int(val.get("validation_steps", 0) or 0)
    if every and every <= int(cfg.solver.max_train_steps):
        raise NotImplementedError(
            f"val.validation_steps={every}: validation renders are not ported yet "
            "(train/validation.py waits for utils/video.py); set it to 0")


def train_stage2_process(cfg, device: torch.device = torch.device("cuda")) -> TrainState:
    """Train for `solver.max_train_steps` steps (resuming from the latest
    checkpoint when `resume_from_checkpoint: latest`), write checkpoint-N
    every `checkpointing_steps`, log metrics.jsonl, export final_net/."""
    device = torch.device(device)
    _check_unported(cfg)
    exp_dir = os.path.join(str(cfg.output_dir), str(cfg.exp_name))
    os.makedirs(exp_dir, exist_ok=True)
    solver = cfg.solver
    mp = str(solver.get("mixed_precision", "bf16") or "no").lower()
    dtype = torch.bfloat16 if mp in ("bf16", "fp16", "bfloat16") else torch.float32
    grad_ckpt = bool(solver.get("gradient_checkpointing", False))
    seed = int(cfg.seed)

    f, m = int(cfg.data.n_sample_frames), int(cfg.data.n_motion_frames)
    unet_kwargs = cfglib.to_container(cfg.unet_additional_kwargs)
    den_cfg = unet_config_from_yaml_kwargs(unet_kwargs, remat=grad_ckpt)
    ref_cfg = unet_config_from_yaml_kwargs(
        unet_kwargs, use_motion_module=False, use_audio_module=False,
        use_inflated_groupnorm=False)
    aux = {}
    if str(cfg.get("aux_scale", "")) == "tiny":  # the tiny integration tests
        from hallo_tpu_torch.utils.factory import TINY_AUX

        aux = TINY_AUX
    models = HalloModels.create(ref_cfg, den_cfg, device=device, dtype=dtype, seed=seed, **aux)

    trainable = unfreeze(models.modules(), stage2_trainable)
    opt = AdamW(OptimizerConfig(
        learning_rate=float(solver.learning_rate),
        max_grad_norm=float(solver.max_grad_norm),
        beta1=float(solver.get("adam_beta1", 0.9)),
        beta2=float(solver.get("adam_beta2", 0.999)),
        weight_decay=float(solver.get("adam_weight_decay", 1e-2)),
        eps=float(solver.get("adam_epsilon", 1e-8)),
        lr_warmup_steps=int(solver.get("lr_warmup_steps", 0)),
        gradient_accumulation_steps=int(solver.get("gradient_accumulation_steps", 1)),
    ))
    state = TrainState.create(trainable, opt)
    step_fn = make_train_step(models, trainable, opt, TrainConfig(
        uncond_img_ratio=float(cfg.uncond_img_ratio),
        uncond_audio_ratio=float(cfg.uncond_audio_ratio),
        uncond_ia_ratio=float(cfg.uncond_ia_ratio),
        start_ratio=float(cfg.start_ratio),
        noise_offset=float(cfg.noise_offset),
        snr_gamma=float(cfg.snr_gamma),
        scheduler=SchedulerConfig(beta_schedule="scaled_linear"),
    ))

    dataset = TalkingVideoDataset(
        list(cfg.data.meta_paths), n_sample_frames=f, n_motion_frames=m,
        audio_margin=int(cfg.data.audio_margin), seed=seed)
    batches = batch_iterator(dataset, int(cfg.data.train_bs))

    start_step = 0
    if str(cfg.get("resume_from_checkpoint", "")) == "latest" and ckpt.latest_step(exp_dir):
        state, start_step = ckpt.load_train_state(exp_dir, device=device)
        state.write_to(trainable)  # the step expects the model to hold the masters
        # The data stream restarts with the process: replay the batches the
        # earlier run took, so that the resumed run sees what an
        # uninterrupted one would (each step's generator is a function of
        # (seed, step) already).
        for _ in range(start_step):
            next(batches)
        logger.info("resumed from checkpoint-%d", start_step)

    metrics = MetricsLogger(exp_dir)
    log_every = int(cfg.get("log_every", 10))
    t0 = time.time()
    nan_skips = consecutive_skips = 0
    td_window = 0.0  # data-loading time since the last log line
    for step in range(start_step, int(solver.max_train_steps)):
        t_data = time.time()
        batch = next(batches)
        td_window += time.time() - t_data
        state, step_metrics = step_fn(state, batch, step_generator(seed, step, device))
        if step_metrics["skipped"] > 0:
            nan_skips += 1
            consecutive_skips += 1
            logger.warning("step %d: non-finite loss/grads, update skipped (%d total)",
                           step, nan_skips)
            if consecutive_skips >= MAX_CONSECUTIVE_SKIPS:
                raise RuntimeError(f"{consecutive_skips} consecutive non-finite steps; "
                                   "aborting (checkpoints keep the last finite state)")
        else:
            consecutive_skips = 0
        if step % log_every == 0:
            line = dict(loss=step_metrics["loss"], grad_norm=step_metrics["grad_norm"],
                        td=round(td_window, 3), nan_skips=nan_skips,
                        sec=round(time.time() - t0, 1))
            td_window = 0.0
            logger.info("%s", {"step": step, **line})
            metrics.log(step, **line)
        if (step + 1) % int(cfg.checkpointing_steps) == 0:
            ckpt.save_train_state(exp_dir, step + 1, state, keep=3)

    # the fused final export (the reference's net-N.pth, train_stage2.py:944-953)
    ckpt.save_params(os.path.join(exp_dir, "final_net"),
                     {k: getattr(models, k) for k in EXPORTED})
    logger.info("stage 2 done")
    return state


def main() -> None:
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(
        description="Stage-2 training of the PyTorch port. On an 80 GB card at 512^2, set "
                    "the YAML's data.train_bs to 1 (stage2.yaml's 4 runs out of memory) and "
                    "val.validation_steps to 0.")
    parser.add_argument("--config", default="configs/train/stage2.yaml")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args()
    train_stage2_process(cfglib.load_config(args.config), device=torch.device(args.device))


if __name__ == "__main__":
    main()
