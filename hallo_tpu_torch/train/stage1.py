"""Stage-1 training: the ReferenceNet, the denoising UNet in 2D mode, the
face locator and the image projection learn identity transfer from single
frames (counterpart of scripts/train_stage1.py; reference
scripts/train_stage1.py:289-793).

    python -m hallo_tpu_torch.train.stage1 --config configs/train/stage1.yaml
    torchrun --standalone --nproc_per_node N -m hallo_tpu_torch.train.stage1 \
        --config configs/train/stage1.yaml

The config is the JAX trainer's YAML, read as there: `data.train_bs` frames
of `data.train_width`^2 from the `FaceMaskDataset` clips of
`data.meta_paths`, read ahead by the C++ prefetcher; the solver keys
(`use_8bit_adam` for the int8-moment AdamW, `gradient_checkpointing` for
the denoiser's per-block recomputation, with `gradient_checkpointing_inner`,
true by default, its per-layer one inside each block); `uncond_ratio`,
`noise_offset`, `snr_gamma`; the pretrained SD-1.5 UNet and VAE from
`base_model_path` and `vae_model_path` where they exist; checkpoint-N every
`checkpointing_steps`, resumed from "latest"; a validation still through
the static pipeline every `val.validation_steps`; and the `final_{module}`
exports that `train.stage2` reads through
`stage1_ckpt_dir`. The exports hold the fp32 masters of the trained
tensors. Under torchrun, data parallelism with ZeRO-2 and tensor
parallelism over the mesh of `parallel_config` (configs/parallel.yaml by
default; `data.train_bs` a data rank's batch, rank 0 writes the files:
train/loop.py); a stage-1 item is one frame, so the mesh's seq axis must be
1.
"""

from __future__ import annotations

import argparse
import logging
import os

import torch
import torch.distributed as dist

from hallo_tpu_torch import config as cfglib
from hallo_tpu_torch.config import SchedulerConfig, unet_config_from_yaml_kwargs
from hallo_tpu_torch.data.datasets import FaceMaskDataset, batch_iterator
from hallo_tpu_torch.pipelines.face_animate import HalloModels
from hallo_tpu_torch.train.loop import (
    barrier, checkpointing, compute_dtype, is_main, optimizer_config, overlay_pretrained,
    parallel_setup, tensor_parallel, train_loop, unsharded)
from hallo_tpu_torch.train.state import (
    TrainState, Zero, make_optimizer, stage1_trainable, unfreeze)
from hallo_tpu_torch.train.step import TrainConfig, make_train_step
from hallo_tpu_torch.utils import checkpoint as ckpt

logger = logging.getLogger("hallo_tpu_torch.train.stage1")

EXPORTED = ("reference_net", "denoising_net", "face_locator", "image_proj")


def stage1_models(cfg, device: torch.device, mixed_precision: str = "bf16") -> HalloModels:
    """The stage-1 networks of `cfg` from its seed: the denoiser without
    motion or audio modules (with `solver.gradient_checkpointing`'s
    per-block recomputation and, unless `gradient_checkpointing_inner` is
    false, the per-layer one), the ReferenceNet without inflated GroupNorm
    (scripts/train_stage1.py:70-87; the ReferenceNet is not recomputed, as
    in JAX); `mixed_precision`: the default of `solver.mixed_precision`."""
    solver = cfg.solver
    unet_kwargs = (cfglib.to_container(cfg.unet_additional_kwargs)
                   if "unet_additional_kwargs" in cfg else {})
    den_cfg = unet_config_from_yaml_kwargs(
        unet_kwargs, use_motion_module=False, use_audio_module=False,
        **checkpointing(solver))
    ref_cfg = unet_config_from_yaml_kwargs(
        unet_kwargs, use_motion_module=False, use_audio_module=False,
        use_inflated_groupnorm=False)
    aux = {}
    if str(cfg.get("aux_scale", "")) == "tiny":  # the tiny integration tests
        from hallo_tpu_torch.utils.factory import TINY_AUX

        aux = TINY_AUX
    return HalloModels.create(ref_cfg, den_cfg, device=device,
                              dtype=compute_dtype(solver, mixed_precision),
                              seed=int(cfg.seed), **aux)


def train_stage1_process(cfg, device: torch.device = torch.device("cuda")) -> TrainState:
    """Train for `solver.max_train_steps` steps (resuming from the latest
    checkpoint when `resume_from_checkpoint: latest`), write checkpoint-N
    every `checkpointing_steps`, log metrics.jsonl, render validation stills
    every `val.validation_steps`, and export final_{module}/ for stage 2.
    Under torchrun, on this rank's card and share of the mesh."""
    device, mesh, settings = parallel_setup(cfg, device)
    if mesh is not None and mesh.n_seq > 1:
        raise ValueError(f"stage 1 trains single frames: mesh seq={mesh.n_seq} must be 1")
    exp_dir = os.path.join(str(cfg.output_dir), str(cfg.exp_name))
    os.makedirs(exp_dir, exist_ok=True)
    seed = int(cfg.seed)
    models = stage1_models(cfg, device, settings["mixed_precision"])
    overlay_pretrained(models, cfg, {"base_model_path": "base_model_path",
                                     "vae_model_path": "vae_model_path"})

    tp = tensor_parallel(models, mesh)
    trainable = unfreeze(models.modules(), stage1_trainable)
    opt = make_optimizer(optimizer_config(cfg.solver))
    step_fn = make_train_step(models, trainable, opt, TrainConfig(
        stage=1,
        uncond_img_ratio=float(cfg.uncond_ratio),
        uncond_audio_ratio=0.0,
        uncond_ia_ratio=0.0,
        start_ratio=0.0,
        noise_offset=float(cfg.noise_offset),
        snr_gamma=float(cfg.snr_gamma),
        scheduler=SchedulerConfig(beta_schedule="scaled_linear"),
    ), mesh=mesh)
    zero = (Zero(mesh, trainable, opt, shard=settings["zero_optimizer_sharding"],
                 tp=tp.plan if tp is not None else None)
            if mesh is not None else None)

    def dataset() -> FaceMaskDataset:
        return FaceMaskDataset(list(cfg.data.meta_paths),
                               sample_margin=int(cfg.data.sample_margin), seed=seed)

    batches = batch_iterator(dataset(), int(cfg.data.train_bs), mesh=mesh)

    def validate(step: int) -> None:
        """Stills of the first two clips' references (reference
        train_stage1.py:181-286, 728-744). The items come from a copy of the
        dataset, so the training stream does not depend on when validations
        ran (the JAX trainer draws them from the training dataset's
        generator)."""
        from hallo_tpu_torch.train.validation import log_validation_stage1

        ds = dataset()
        items = [ds[i] for i in range(min(2, len(ds)))]
        log_validation_stage1(
            models, exp_dir, step,
            ref_images=[it["ref_pixels"] for it in items],
            face_embs=[it["face_emb"] for it in items],
            face_regions=[it["face_region"] for it in items],
            num_inference_steps=int((cfg.get("val") or {}).get("num_inference_steps", 20)),
            seed=seed)

    state = train_loop(cfg, device, trainable, opt, step_fn, batches, exp_dir, validate, zero,
                       tp)
    # per-module exports for the stage hand-off (reference
    # move_final_checkpoint, train_stage1.py:752-758), of the whole masters
    masters = zero.gather_leaves(state.params) if zero is not None else state.params
    with unsharded(tp):
        if is_main(mesh):
            for name in EXPORTED:
                ckpt.save_params(os.path.join(exp_dir, f"final_{name}"),
                                 {name: getattr(models, name)}, masters=masters)
    barrier(mesh)
    logger.info("stage 1 done")
    return state


def main() -> None:
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(description="Stage-1 training of the PyTorch port.")
    parser.add_argument("--config", default="configs/train/stage1.yaml")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args()
    try:
        train_stage1_process(cfglib.load_config(args.config), device=torch.device(args.device))
    finally:
        if dist.is_initialized():  # joined under torchrun
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
