"""The training steps of both stages (counterpart of
hallo_tpu/train/step.py).

Reference semantics (scripts/train_stage1.py:559-759,
scripts/train_stage2.py:698-930), as the JAX package has them:

- the train scheduler: scaled_linear betas, zero-SNR rescale, v-prediction;
- per-STEP (not per-sample) conditioning dropouts: one draw decides the
  image, audio and both dropouts, another the zero-motion-frame "start"
  dropout (`dropout_decisions`);
- Min-SNR-gamma loss weights with the +1 shift under v-prediction;
- stage 2: the frozen modules (VAE, ReferenceNet, ImageProj, FaceLocator)
  run under `torch.no_grad` (JAX's stop_gradient); the denoiser's spatial
  layers are frozen too, but the gradient flows through them to the
  trainable motion and audio modules before them;
- stage 1: one frame (F = 1), no motion frames, audio or masks; the
  identity tokens, the ReferenceNet features (through the denoiser's K/V
  concat) and the face conditioning keep their gradients; only the VAE
  runs under `torch.no_grad`. Parameters that reach no output of the loss
  (the ReferenceNet's layers after its last harvested feature) get zero
  gradients, as under `jax.grad`;
- the NaN guard: on a non-finite loss or gradient norm the masters and the
  optimizer state stay as they were and `metrics["skipped"]` is 1.

One divergence, on purpose: `metrics["grad_norm"]` is the norm of the
trainable gradients only (the reference's `requires_grad` semantics; the
port computes no other gradient). JAX's metric also counts the frozen
denoiser weights' gradients. The update is the same: JAX's clip sees only
the trainable leaves too.

Data and clip parallelism (`mesh`, hallo_tpu/train/step.py:244-296): each
rank takes its rows of the global batch and, with a seq axis, its frames of
them. The timesteps, noise and noise offsets of the GLOBAL batch are drawn
from the step's generator on every rank and sliced by (data, seq), and so
are the per-step dropout draws (global already), so that a step at any
world size equals the one-card step on the same global batch up to the
order of the reductions. JAX folds the data index into its per-sample keys
instead: a named divergence (ROADMAP, Queue 3). The gradients are
reduced and the optimizer state sharded by `state.Zero`; the loss and the
gradient norm that the NaN guard reads are all-reduced, so every rank skips
the same steps.

Layouts at this function's inputs are the JAX package's (channels last);
latents are (B, F, C, h, w) inside.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from hallo_tpu_torch.config import SchedulerConfig
from hallo_tpu_torch.diffusion import ddim, schedule
from hallo_tpu_torch.parallel import collectives
from hallo_tpu_torch.parallel.mesh import Mesh
from hallo_tpu_torch.pipelines.face_animate import HalloModels
from hallo_tpu_torch.train.state import AdamW, TrainState, global_norm
from hallo_tpu_torch.utils import profiling


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The step's settings (JAX's TrainConfig). Stage 1 takes one dropout,
    `uncond_img_ratio` (the YAML's `uncond_ratio`), with the other ratios
    at 0."""

    stage: int = 2
    uncond_img_ratio: float = 0.05
    uncond_audio_ratio: float = 0.05
    uncond_ia_ratio: float = 0.05
    start_ratio: float = 0.05
    noise_offset: float = 0.05
    snr_gamma: float = 5.0
    # scaled_linear is the reference's training beta schedule
    scheduler: SchedulerConfig = SchedulerConfig(beta_schedule="scaled_linear")


def _min_snr_weights(alphas_cumprod, t: torch.Tensor, gamma: float,
                     prediction_type: str) -> torch.Tensor:
    """min(SNR, gamma) / SNR, with SNR + 1 under v-prediction (finite at the
    zero-SNR t = 999 there)."""
    snr = ddim.compute_snr(alphas_cumprod, t)
    if prediction_type == "v_prediction":
        snr = snr + 1.0
    return torch.clamp(snr, max=gamma) / snr


def dropout_decisions(u: torch.Tensor, u_start: torch.Tensor, cfg: TrainConfig
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(drop_img, drop_audio, start), boolean tensors, from the step's two
    fp32 uniform draws (hallo_tpu/train/step.py:147-153, reference
    train_stage2.py:795-805), compared in fp32 as JAX compares its draws.
    They stay on the draws' device: the host never waits for them."""
    p_i, p_a, p_ia = cfg.uncond_img_ratio, cfg.uncond_audio_ratio, cfg.uncond_ia_ratio
    u, u_start = u.float(), u_start.float()
    both = u >= 1.0 - p_ia
    drop_img = (u < p_i) | both
    drop_audio = ((u >= p_i) & (u < p_i + p_a)) | both
    return drop_img, drop_audio, u_start < cfg.start_ratio


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of one train step: a function of (seed, step) alone, so
    that a resumed run draws what an uninterrupted one would (JAX's
    `fold_in(rng, step)`)."""
    return torch.Generator(device=device).manual_seed(int(seed) * 1_000_003 + int(step))


def make_loss_fn(
    models: HalloModels, cfg: TrainConfig = TrainConfig(), mesh: Optional[Mesh] = None
) -> Callable[[Dict[str, Any], torch.Generator], torch.Tensor]:
    """The loss of `cfg.stage`, (batch, generator) -> scalar fp32 tensor,
    with the autograd graph of whatever parameters of `models` require grad.

    Stage-1 batch: pixel_values (B, 1, H, W, 3), ref_pixels, face_emb,
    face_region. Stage-2 batch (numpy arrays or tensors, JAX layouts): pixel_values
    (B, F, H, W, 3), ref_pixels (B, H, W, 3), motion_pixels (B, M, H, W, 3),
    audio_windows (B, F, W, blocks, C), face_emb (B, E), face_region
    (B, H, W, 3), masks 4 x (full, face, lip) each (B, L_d). Optional
    deterministic overrides: "noise" (B, F, h, w, 4) and "timesteps" (B,).

    With a `mesh`, the batch is this rank's: its rows of the global batch and
    its frames of those (F = clip / seq), "noise" and "timesteps" included;
    the loss is the mean over them.

    Each batch array's copy to the card is the wait `batch`
    (`profiling.wait`), each VAE encode the span `hallo.train.encode`."""
    dev = models.device
    dtype = models.denoising_net.conv_in.weight.dtype
    alphas = torch.tensor(schedule.alphas_cumprod(cfg.scheduler), device=dev)
    pred_type = cfg.scheduler.prediction_type
    m = models
    stage2 = cfg.stage == 2
    n_data, n_seq = (mesh.n_data, mesh.n_seq) if mesh is not None else (1, 1)
    d, s = (mesh.data_index, mesh.seq_index) if mesh is not None else (0, 0)
    seq_group = mesh.seq_group if n_seq > 1 else None
    # stage 2 keeps the stage-1 networks out of the graph (JAX's stop_gradient)
    frozen = torch.no_grad if stage2 else contextlib.nullcontext

    def put(x) -> torch.Tensor:
        with profiling.wait("batch"):
            return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                                   dtype=torch.float32, device=dev)

    def encode(px: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) pixels -> (N, 4, h, w) posterior-mean latents."""
        with profiling.span("hallo.train.encode"):
            return m.vae.encode_mean(px.permute(0, 3, 1, 2).to(dtype))

    def loss_fn(batch: Dict[str, Any], gen: torch.Generator) -> torch.Tensor:
        pixels = put(batch["pixel_values"])
        b, f = pixels.shape[:2]
        with torch.no_grad():
            lat = encode(pixels.flatten(0, 1)).unflatten(0, (b, f))  # (B, F, 4, h, w)
        # the global batch's draws, this rank's rows and frames of them
        if "noise" in batch:
            noise = put(batch["noise"]).permute(0, 1, 4, 2, 3)
        else:
            noise = torch.randn((b * n_data, f * n_seq) + lat.shape[2:], generator=gen,
                                device=dev)
            if cfg.noise_offset > 0:
                noise = noise + cfg.noise_offset * torch.randn(
                    (b * n_data, 1, lat.shape[2], 1, 1), generator=gen, device=dev)
            noise = noise[d * b:(d + 1) * b, s * f:(s + 1) * f]
        if "timesteps" in batch:
            t = torch.as_tensor(np.asarray(batch["timesteps"]), device=dev).long()
        else:
            t = torch.randint(0, cfg.scheduler.num_train_timesteps, (b * n_data,),
                              generator=gen, device=dev)[d * b:(d + 1) * b]
        noisy = ddim.add_noise(alphas, lat, noise, t)

        u = torch.rand((), generator=gen, device=dev)
        u_start = torch.rand((), generator=gen, device=dev)
        drop_img, drop_audio, start = dropout_decisions(u, u_start, cfg)

        def unless(drop: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
            return torch.where(drop, torch.zeros_like(x), x)

        face_emb = put(batch["face_emb"])
        uncond_mask = drop_img.float().expand(b)
        ref_px = put(batch["ref_pixels"])[:, None]
        if stage2 and "motion_pixels" in batch:
            ref_px = torch.cat([ref_px, unless(start, put(batch["motion_pixels"]))], dim=1)
        one_m = ref_px.shape[1]
        with torch.no_grad():
            ref_lat = encode(ref_px.flatten(0, 1))
        with frozen():
            tokens = m.image_proj(unless(drop_img, face_emb))
            # the identity tokens tile over the ReferenceNet batch the way the
            # reference does (JAX's legacy_context_tiling: jnp.tile, not a
            # per-sample repeat), misaligned with the frames; over the GLOBAL
            # batch's rows under data parallelism (as JAX's GSPMD step), so
            # that the rows of one rank take other ranks' tokens as the
            # one-card step does (stage 2: the tokens take no gradient)
            if one_m > 1 and n_data > 1:
                rows = slice(d * b * one_m, (d + 1) * b * one_m)
                ref_ctx = collectives.all_gather(tokens, mesh.data_group, dim=0).repeat(
                    one_m, 1, 1)[rows]
            else:
                ref_ctx = tokens.repeat(one_m, 1, 1)
            _, feats = m.reference_net(ref_lat, torch.zeros((), device=dev), ref_ctx)
            face_cond = None
            if "face_region" in batch:
                fc = m.face_locator(put(batch["face_region"]).permute(0, 3, 1, 2))
                face_cond = fc[:, None].expand(-1, f, -1, -1, -1)
        split = {k: [x.unflatten(0, (b, one_m)) for x in v] for k, v in feats.items()}
        ref_feats = {k: [x[:, 0] for x in v] for k, v in split.items()}
        motion_feats = ({k: [x[:, 1:] for x in v] for k, v in split.items()}
                        if one_m > 1 else None)

        audio_tokens = None
        if stage2 and "audio_windows" in batch:
            audio = put(batch["audio_windows"])
            audio_tokens = m.audio_proj(unless(drop_audio, audio))
        masks = None
        if stage2 and "masks" in batch:
            masks = tuple(tuple(put(x).repeat_interleave(f, dim=0) for x in lvl)
                          for lvl in batch["masks"])

        pred = m.denoising_net(
            noisy, t, tokens, ref_feats, motion_feats, audio_tokens, face_cond, masks,
            torch.ones(3, device=dev), uncond_mask, train=True, seq_group=seq_group,
        )
        target = ddim.get_velocity(alphas, lat, noise, t) if pred_type == "v_prediction" \
            else noise
        per_sample = (pred.float() - target.float()).square().mean(dim=(1, 2, 3, 4))
        if cfg.snr_gamma > 0:
            per_sample = per_sample * _min_snr_weights(alphas, t, cfg.snr_gamma, pred_type)
        return per_sample.mean()

    return loss_fn


def make_train_step(
    models: HalloModels,
    trainable: Mapping[str, torch.nn.Parameter],
    opt: AdamW,
    cfg: TrainConfig = TrainConfig(),
    mesh: Optional[Mesh] = None,
) -> Callable[[TrainState, Dict[str, Any], torch.Generator],
              Tuple[TrainState, Dict[str, float]]]:
    """The (state, batch, generator) -> (state, metrics) step on
    `make_loss_fn`'s loss.

    `trainable`: the parameters that get gradients ("module.name" ->
    parameter, from `state.unfreeze`); the rest of `models` is frozen.

    The model must hold `state.params` when the step is called
    (`TrainState.create` copies them from it; after `load_train_state`, call
    `state.write_to(trainable)`). The step takes the loss and the trainable
    gradients, steps the masters and the optimizer state in place (unless
    the NaN guard skips), writes the masters back into the model and returns
    the same state with `step` + 1. Metrics: loss, grad_norm (trainable),
    skipped.

    With a `mesh`, the state is a `state.ShardedTrainState` (its `Zero` of
    this mesh: `Zero(mesh, trainable, opt).create(trainable)`), the batch
    this rank's (`make_loss_fn`), and the metrics those of the global batch,
    the same on every rank.

    The step is the span `hallo.train.step`, holding `hallo.train.forward`
    (the loss), `hallo.train.backward` (the gradients, the checkpoints'
    replays included) and `hallo.train.optimizer` (the reduction under a
    mesh, the waits `loss` and `grad_norm`, the clip, AdamW and the
    write-back); the counters `train.step` and `train.skipped`."""
    loss_fn = make_loss_fn(models, cfg, mesh)
    names = list(trainable)
    params = [trainable[n] for n in names]

    def train_step(state: TrainState, batch: Dict[str, Any], gen: torch.Generator):
        profiling.count("train.step")
        with profiling.span("hallo.train.step"):
            with profiling.span("hallo.train.forward"):
                loss = loss_fn(batch, gen)
            with profiling.span("hallo.train.backward"):
                # a parameter that reaches no output of the loss gets zeros (jax.grad)
                grads = {name: torch.zeros_like(p) if g is None else g for name, p, g in zip(
                    names, params, torch.autograd.grad(loss, params, allow_unused=True))}
            with profiling.span("hallo.train.optimizer"):
                if mesh is None:
                    with profiling.wait("loss"):
                        loss_v = loss.item()
                    with profiling.wait("grad_norm"):
                        norm_v = global_norm(grads.values()).item()
                else:
                    grads = state.zero.reduce(grads)
                    world = dist.get_world_size()
                    with profiling.wait("loss"):
                        loss_v = (collectives.all_reduce_sum(loss.detach(), dist.group.WORLD)
                                  / world).item()
                    with profiling.wait("grad_norm"):
                        norm_v = state.zero.norm(list(grads.values())).item()
                finite = bool(np.isfinite(loss_v) and np.isfinite(norm_v))
                if finite:
                    if mesh is None:
                        opt.update(grads, state.opt_state, state.params)
                    else:
                        state.zero.update(state, grads)
                    state.write_to(trainable)
                else:
                    profiling.count("train.skipped")
        state.step += 1
        return state, dict(loss=loss_v, grad_norm=norm_v, skipped=0.0 if finite else 1.0)

    return train_step
