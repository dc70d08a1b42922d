"""Stage-2 training: the motion and audio modules and the audio projection
are trained; the stage-1 networks stay frozen (counterpart of
scripts/train_stage2.py; reference scripts/train_stage2.py:421-959).

    python -m hallo_tpu_torch.train.stage2 --config configs/train/stage2.yaml
    torchrun --standalone --nproc_per_node N -m hallo_tpu_torch.train.stage2 \
        --config configs/train/stage2.yaml

The config is the JAX trainer's YAML. The pretrained files that exist are
laid over the random initialisation (`base_model_path`, `vae_model_path`,
`mm_path`, through `convert/load_pretrained.py`), then a stage-1 export
directory (`stage1_ckpt_dir`, the `final_{module}` exports of
`train.stage1`); paths that do not exist are skipped with a log line.
`solver.use_8bit_adam` selects the int8-moment AdamW, and
`val.validation_steps` renders a validation video.
`solver.gradient_checkpointing` recomputes each denoiser block in the
backward pass and, unless `solver.gradient_checkpointing_inner` is false,
each sub-layer inside a block too (`UNetConfig.remat_inner`): that is what
fits the YAML's `data.train_bs: 4` at 512^2 on one 80 GB H100. Clips are
read ahead by the C++ prefetcher (`data/native_prefetch.py`).

Under torchrun, one rank a card: the mesh of `parallel_config`
(configs/parallel.yaml by default) splits the ranks into data x seq x
model; `data.train_bs` is each data rank's batch (the global batch is
train_bs x data, as in JAX), the seq ranks split each clip's frames (clip
parallelism), the model ranks split the wide denses (tensor parallelism,
`parallel/tp.py`), the optimizer state is ZeRO-2 sharded over the data ranks
(`zero_optimizer_sharding`), and rank 0 writes the files (train/loop.py).
"""

from __future__ import annotations

import argparse
import logging
import os

import torch
import torch.distributed as dist

from hallo_tpu_torch import config as cfglib
from hallo_tpu_torch.config import SchedulerConfig, unet_config_from_yaml_kwargs
from hallo_tpu_torch.data.datasets import TalkingVideoDataset, batch_iterator
from hallo_tpu_torch.pipelines.face_animate import HalloModels
from hallo_tpu_torch.train.loop import (
    barrier, checkpointing, compute_dtype, is_main, optimizer_config, overlay_pretrained,
    parallel_setup, tensor_parallel, train_loop, unsharded)
from hallo_tpu_torch.train.state import (
    TrainState, Zero, make_optimizer, stage2_trainable, unfreeze)
from hallo_tpu_torch.train.step import TrainConfig, make_train_step
from hallo_tpu_torch.utils import checkpoint as ckpt

logger = logging.getLogger("hallo_tpu_torch.train.stage2")

EXPORTED = ("reference_net", "denoising_net", "face_locator", "image_proj", "audio_proj")
STAGE1_MODULES = ("reference_net", "denoising_net", "face_locator", "image_proj")


def load_stage1_exports(models: HalloModels, stage1_dir: str) -> list:
    """Read each `final_{module}` export under `stage1_dir` into `models`
    (scripts/train_stage2.py:100-105); returns the modules loaded."""
    loaded = []
    for name in STAGE1_MODULES:
        path = os.path.join(stage1_dir, f"final_{name}")
        if os.path.isdir(path):
            # the denoiser's motion and audio modules are not in the export
            missing = ckpt.load_params(path, {name: getattr(models, name)},
                                       strict=name != "denoising_net")[name]
            loaded.append(name)
            logger.info("loaded stage-1 %s (%d tensors kept their values)", name, len(missing))
    return loaded


def train_stage2_process(cfg, device: torch.device = torch.device("cuda")) -> TrainState:
    """Train for `solver.max_train_steps` steps (resuming from the latest
    checkpoint when `resume_from_checkpoint: latest`), write checkpoint-N
    every `checkpointing_steps`, log metrics.jsonl, render validation videos
    every `val.validation_steps`, export final_net/. Under torchrun, on this
    rank's card and share of the mesh (see the module docstring)."""
    device, mesh, settings = parallel_setup(cfg, device)
    exp_dir = os.path.join(str(cfg.output_dir), str(cfg.exp_name))
    os.makedirs(exp_dir, exist_ok=True)
    solver = cfg.solver
    seed = int(cfg.seed)

    f, m = int(cfg.data.n_sample_frames), int(cfg.data.n_motion_frames)
    if mesh is not None and f % mesh.n_seq:
        raise ValueError(f"data.n_sample_frames={f} does not split over seq={mesh.n_seq}")
    unet_kwargs = cfglib.to_container(cfg.unet_additional_kwargs)
    den_cfg = unet_config_from_yaml_kwargs(unet_kwargs, **checkpointing(solver))
    ref_cfg = unet_config_from_yaml_kwargs(
        unet_kwargs, use_motion_module=False, use_audio_module=False,
        use_inflated_groupnorm=False)
    aux = {}
    if str(cfg.get("aux_scale", "")) == "tiny":  # the tiny integration tests
        from hallo_tpu_torch.utils.factory import TINY_AUX

        aux = TINY_AUX
    models = HalloModels.create(ref_cfg, den_cfg, device=device,
                                dtype=compute_dtype(solver, settings["mixed_precision"]),
                                seed=seed, **aux)
    # SD-1.5, AnimateDiff and the VAE, then the stage-1 exports
    overlay_pretrained(models, cfg, {"base_model_path": "base_model_path",
                                     "mm_path": "motion_module_path",
                                     "vae_model_path": "vae_model_path"})
    stage1_dir = str(cfg.get("stage1_ckpt_dir", "") or "")
    if stage1_dir and os.path.isdir(stage1_dir):
        load_stage1_exports(models, stage1_dir)
    elif stage1_dir:
        logger.info("stage1_ckpt_dir=%s not found: skipped", stage1_dir)

    tp = tensor_parallel(models, mesh)
    trainable = unfreeze(models.modules(), stage2_trainable)
    opt = make_optimizer(optimizer_config(solver))
    step_fn = make_train_step(models, trainable, opt, TrainConfig(
        stage=2,
        uncond_img_ratio=float(cfg.uncond_img_ratio),
        uncond_audio_ratio=float(cfg.uncond_audio_ratio),
        uncond_ia_ratio=float(cfg.uncond_ia_ratio),
        start_ratio=float(cfg.start_ratio),
        noise_offset=float(cfg.noise_offset),
        snr_gamma=float(cfg.snr_gamma),
        scheduler=SchedulerConfig(beta_schedule="scaled_linear"),
    ), mesh=mesh)
    zero = (Zero(mesh, trainable, opt, shard=settings["zero_optimizer_sharding"],
                 tp=tp.plan if tp is not None else None)
            if mesh is not None else None)

    dataset = TalkingVideoDataset(
        list(cfg.data.meta_paths), n_sample_frames=f, n_motion_frames=m,
        audio_margin=int(cfg.data.audio_margin), seed=seed)
    batches = batch_iterator(dataset, int(cfg.data.train_bs), mesh=mesh)

    def validate(step: int) -> None:
        """A video of the first clip (reference train_stage2.py:250-418).
        The item comes from a copy of the dataset, so the training stream
        does not depend on when validations ran (the JAX trainer draws it
        from the training dataset's generator)."""
        from hallo_tpu_torch.train.validation import log_validation_stage2

        item = TalkingVideoDataset(
            list(cfg.data.meta_paths), n_sample_frames=f, n_motion_frames=m,
            audio_margin=int(cfg.data.audio_margin), seed=seed)[0]
        log_validation_stage2(
            models, exp_dir, step, ref_image=item["ref_pixels"],
            audio_windows=item["audio_windows"], face_emb=item["face_emb"],
            face_region=item["face_region"],
            masks=tuple(tuple(x[None] for x in lvl) for lvl in item["masks"]),
            clip_length=f, num_inference_steps=int((cfg.get("val") or {}).get(
                "num_inference_steps", 40)),
            seed=seed, n_motion_frames=m)

    state = train_loop(cfg, device, trainable, opt, step_fn, batches, exp_dir, validate, zero,
                       tp)
    # the fused final export (the reference's net-N.pth, train_stage2.py:944-953)
    with unsharded(tp):
        if is_main(mesh):
            ckpt.save_params(os.path.join(exp_dir, "final_net"),
                             {k: getattr(models, k) for k in EXPORTED})
    barrier(mesh)
    logger.info("stage 2 done")
    return state


def main() -> None:
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(description="Stage-2 training of the PyTorch port.")
    parser.add_argument("--config", default="configs/train/stage2.yaml")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args()
    try:
        train_stage2_process(cfglib.load_config(args.config), device=torch.device(args.device))
    finally:
        if dist.is_initialized():  # joined under torchrun
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
