"""Smoke run of the PyTorch port (`hallo_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py                 # a few DDIM steps per clip
    python3 chip_smoke.py --steps 40      # the exact profile
    python3 chip_smoke.py --profile-out out/profile.txt   # + kernel profiles

Phases, each synchronised so that a device fault surfaces where it happened:

1. preflight: the card's name and power limit, and the kernels' build
   (nvcc, sm_90a, one process per source, all started together) from
   `hallo_tpu_torch/csrc/`;
2. every hand-written kernel against its plain PyTorch version at the main
   paths' shapes, with its time, its plain version's, one PyTorch library
   call's on the same inputs (a yardstick only) and its bound; K1 (the
   Hopper kernel `flash_fwd_sm90.cu`: TMA, wgmma, warp-specialised) also
   with its exponential floor (one ex2 per score at 16 a clock per SM) and
   its host cost per call (tensor-map encoding, the wrapper); K1's LSE
   output and K5's two backward passes (the Hopper kernels
   `flash_bwd_sm90.cu`, each with its exponential floor, launch plan and
   host cost per call) at the training shapes (14 frames at 512^2: levels
   0-2, audio and identity cross-attention), against autograd's backward
   of `F.scaled_dot_product_attention` as the library call; the host cost
   of a whole K5 call and of a K3 call at tiny shapes; K4 (the Hopper
   kernel `flash_fwd_d512_sm90.cu`) at the VAE mid-block's encode (B 3) and
   decode (B 16) and at d 128 and 256, each with its launch plan and host
   cost per call; K8, the Winograd 3x3 conv (the Hopper kernel
   `winograd.cu`: TMA, wgmma, a producer warpgroup, persistent), at the
   denoiser's five 3x3-conv shapes (CFG batch 32 = 2 x 16 frames at 512^2),
   fp32 and a small non-square one, each with its launch plan and host cost
   per call, against cuDNN's `F.conv2d` as the library call, and its autograd
   entry against autograd of the direct conv; K2 (the Hopper kernel
   `temporal_attn_sm90.cu`: a TMA ring, mma.sync, persistent) at the
   denoiser's four levels, training's shape and other frame counts, and at
   K7's test cases, each with its launch plan and host cost per call; K9,
   the layout-anchor copy (a ring of bulk copies), bit for bit, against
   `clone`; K3 (the Hopper kernel `flash_fwd_t_sm90.cu`: a TMA ring of
   fp32 tiles, converter warps, wgmma) at the wav2vec2 attention's L 304
   and 1056 and with half the keys masked, and K6 (`flash_int8_sm90.cu`:
   the quantisation prelude as a kernel, then int8 wgmma behind a TMA
   ring) at L 1056, half masked, ragged and L 4096, each with its launch
   plan, device time by CUDA-graph replay and host cost per call, K6's
   prelude and attention apart, and the prelude held against
   `quantize_int8`. Nothing on a main path calls K8 or K9, in either
   package: their launches are this phase's. Then the card checks of
   tests/test_torch_kernels.py, in a pytest process of their own: 300
   launches each of K1 (Lk 32, 4 and level 0, with and without its LSE), K4
   and K8 give the first launch's bits, and the DDIM, DPM-Solver++ and
   UniPC steps with their carries on the card match the CPU at 1e-6, with a
   planted corrector fault (UniPC's `c_dt` zeroed) that must fail. The
   kernel phase also holds K1 with its LSE and K5 at stage 1's shapes (B 8
   single frames: the ReferenceNet's self-attention at Lq = Lk, the
   denoiser's over the reference concat, the identity cross-attention at
   levels 0-3), and the card checks repeat K1 300 times at Lq = Lk;
3. the driving audio: the full-width wav2vec2-base (random weights from a
   seed, fp32) through `AudioProcessor.preprocess` on
   `examples/driving_audios/1.wav` (3 s), on it tiled 4x (12 s) and, under
   HALLO_INT8_ATTN=1, 14x (42 s), counting K3's and K6's launches (and the
   prelude's, one per K6 call), each held
   against the same weights on the CPU in fp32;
4. the slice: the full-width models (random weights from a seed, bf16) drive
   `FaceAnimatePipeline.__call__` at 512^2 with the windows of 1.wav's
   embeddings (5 clips of 16 frames, 2 motion frames), counting each
   kernel's launches; then the port on the card is held against the same
   weights and inputs run on the CPU in fp32 at a small size;
5. the profiles, on the same models and windows: fast (UniPC, 10 evals)
   and turbo (UniPC, 8 evals) over the 5 clips (seconds a clip, frames/s,
   seconds a step, peak memory, launches a clip: K2's must be 10 and 8
   times a DDIM step's of phase 4, K4's 2); one clip each of DPM-Solver++
   on the log-SNR grid, DDIM with the uniform step cache and UniPC with the
   dynamic step cache, the CFG cache and its tail, whose recorded steps
   must follow `diffusion/cache.py`'s plans (a cond-only step launching
   fewer K1 calls than a full one); the fast profile with an `on_clip`
   hook, whose frames must be the returned video bit for bit, timed beside
   a run without it; then the fast profile and a static CFG-cache plan on
   the card against the CPU in fp32 at phase 4's small size, with planted
   faults (another sampler, another CFG weight) that the check must see;
   then one clip of 2 identities at once (B 2, long-form with several
   identities): seconds and peak memory;
6. training: the same weights, with per-block gradient checkpointing, take
   stage-2 train steps (`make_train_step`, AdamW) at 512^2, batch 1, 14 + 2
   motion frames, bf16, on a synthetic batch from a seed: one warm-up
   step, then 3 timed ones, counting each kernel's launches per step (K1
   with its LSE, K5's two passes, K2, K4); then one step's loss and
   trainable gradient on the card are held against the same weights on
   the CPU in fp32 at 64x64, with a planted backward fault that the check
   must see; then the same weights in a denoiser with nested per-layer
   checkpointing (`remat_inner`, the motion feed-forward in 4 chunks): one
   batch's loss and each trainable group's gradient against the per-block
   run, with a planted replay fault (the feed-forward's last chunk
   replayed from zeros), then 1 + 3 steps (seconds, peak memory, which must
   be lower, launches a step);
7. dataset: the dataset builder, `python -m hallo_tpu_torch.data_preprocess`
   steps 1 and 2 on the card (no face model files: the Haar path; the
   full-width wav2vec2 with random weights from its seed, K3 counted), on
   two synthetic 5-s 512^2 videos of 1.jpg with 1.wav tiled (muxed where
   an ffmpeg binary exists, else placed beside the clips), then
   `extract_meta_info` at stages 1 and 2 (seconds a video for each step);
   one video's clip held against the same builder on the CPU in fp32
   (frames, region, masks bit for bit, the audio embedding at AUDIO_RTOL),
   with a planted fault (one wav2vec2 weight x1.01 on the card only);
8. the trainer: `train_stage2_process` on configs/train/stage2.yaml as
   shipped (train_bs 4, per-block and per-layer checkpointing) over phase
   7's clips, read through the C++ prefetcher: 2 steps that write
   checkpoint-2, metrics.jsonl and final_net/ (peak memory, seconds a step,
   the data wait a step, K1's, K5's, K2's and K4's launches a step; an
   out-of-memory logs the allocator's summary and fails), then a resume
   from checkpoint-2 for a third step;
9. static: `StaticPipeline` on the full-width 2D models (bf16), one 512^2
   image with 40-step DDIM (seconds, peak memory, K1's and K4's launches),
   then against the CPU in fp32 at 64x64 with a planted sampler fault;
10. stage 1: the stage-1 step at configs/train/stage1.yaml's full width (B
   8 single frames at 512^2, no checkpointing, bf16, AdamW in fp32; on an
   out-of-memory the peak is logged and checkpointing, then smaller
   batches, are tried): 1 + 3 steps (seconds, peak memory, K1's, K5's and
   K4's launches a step), then one step's loss and each module's gradient
   in fp32 on the card against the CPU at 64x64, with K5's dK/dV zeroed as
   the planted fault; then the synthetic `pretrained_models/` files that
   phases 11 and 13 read are written, once;
11. the stage-1 trainer: `train_stage1_process` on stage1.yaml (at the
   batch phase 10 ran, the 8-bit AdamW) over a synthetic 40-frame 512^2 clip
   and the synthetic SD-1.5 UNet and VAE: 2 steps and checkpoint-2 (its
   write and read timed), a resume to step 4 with a validation still and
   the four exports, bit for bit against an unbroken 4-step run; then
   `train_stage2_process` with `stage1_ckpt_dir` there holds the exports
   bit for bit (in bf16) and takes a finite step;
12. onnx: the port's ONNX executor (`convert/onnx_torch.py`) on the card
   against itself on the CPU in fp32, on seeded graphs of the four models'
   published architectures at their published depths and widths
   (`convert/synthetic.py`): SCRFD-10G at det size 640 (its detections on
   1.jpg equal), IResNet-100 at 112x112 (a planted fault, one conv weight
   x1.01 on the card only, must fail), the MediaPipe face mesh at 192x192
   and MDX-Net's TFC-TDF U-Net at Kim_Vocal_2's (3072, 256), with the
   seconds per call in fp32 and with TF32 (which must fail the check); the
   face analyzer with the three face files, the separator with the U-Net
   against the CPU, and an identity MDX graph giving back 1.wav;
13. cli: the product, `hallo_tpu_torch.inference.inference_process`, at full
   width on 1.jpg and 1.wav (turbo, bf16, 512^2, no --allow-partial) over
   synthetic fp16 checkpoint files in the reference's `pretrained_models/`
   layout (the inventories' keys and shapes, about 7.8 GB, written under
   `hallo_tpu_torch/_build/cli/` and removed afterwards) and the TFC-TDF
   U-Net as the vocal separator: every module loads 100%, named tensors hold the last file's
   values bit for bit, the separator runs, the mp4 holds 75 frames that
   move, the timing JSON holds every stage, K1-K4 launch; a VAE file with
   its keys renamed must make the CLI raise before generation;
14. parallel (run between phases 6 and 7): one rank a card,
   `max(1, device_count)` processes spawned with NCCL (`phase_parallel`),
   each building the full-width models from phase 4's seed: one clip of
   1.wav's windows (512^2, 16 + 2 frames, the steps of phase 4) through the
   clip-parallel path against the plain clip, and phase 6's step (B 1,
   14 + 2 frames, per-block checkpointing, AdamW) through ZeRO-2 against
   the plain step, then the step with the same models sharded by tensor
   parallelism over model = world (`parallel/tp.py`, min_dim 1280); at one
   card bit for bit (the collectives at group size
   1), with seconds, peak memory, the collectives' launches of each and
   the kernels' launches a tensor-parallel step. With 2 cards or more the
   clip at seq = world within PROFILE_RTOL, a planted fault (the inflated
   GroupNorms' moments not all-reduced) that must exceed it, the step at
   data = world and at seq = world, and the tensor-parallel step at model =
   world and (4 cards) data 2 x model 2, within TRAIN_RTOL of the plain step
   on the same global batch (at 256^2), with a planted fault (g's backward
   summing over the group) that must exceed it. The kernel phase holds K2
   at the clip-parallel shapes too (level 0's sites over 2 and 4 ranks, 16
   + 2 frames, B 2 and 4), and K1, K2 and K5 at the tensor-parallel head
   counts (the 1280-wide levels' 8 heads of d 160 split over 2 and 4
   ranks).

The last line of standard output is
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`;
the line before it holds the kernels' table as JSON. Any failure raises and
exits non-zero without that line. Without a CUDA device it exits non-zero.
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import faulthandler
import gc
import json
import logging
import math
import os
import shutil
import socket
import subprocess
import sys
import time

import cv2
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing
import torch.nn.functional as F
from safetensors.torch import load_file, save_file

from hallo_tpu_torch import config as cfglib
from hallo_tpu_torch import data_preprocess, extract_meta_info, inference
from hallo_tpu_torch.config import SchedulerConfig, load_config, load_yaml
from hallo_tpu_torch.convert import onnx_torch, synthetic
from hallo_tpu_torch.convert.onnx_torch import OnnxExecutor
from hallo_tpu_torch.data.audio_processor import AudioProcessor, load_wav
from hallo_tpu_torch.data.face_analysis import FaceAnalyzer
from hallo_tpu_torch.data.image_processor import load_image_rgb
from hallo_tpu_torch.data.insight_torch import ScrfdTorch, norm_crop
from hallo_tpu_torch.data.mdx_separator import MdxSeparator
from hallo_tpu_torch.diffusion import cache, schedule
from hallo_tpu_torch.models import layers
from hallo_tpu_torch.models import wav2vec as wav2vec_module
from hallo_tpu_torch.ops import _build, flash, layout, temporal, winograd
from hallo_tpu_torch.ops.attention import attention_reference
from hallo_tpu_torch.ops.bench_temporal import timings
from hallo_tpu_torch.parallel import collectives
from hallo_tpu_torch.parallel import tp as tp_module
from hallo_tpu_torch.parallel.mesh import make_mesh
from hallo_tpu_torch.parallel.tp import count_sharded, shard_modules, tp_plan
from hallo_tpu_torch.pipelines.face_animate import (
    MODULE_NAMES, FaceAnimatePipeline, HalloModels, window_audio_embeddings)
from hallo_tpu_torch.pipelines.bench_static import STATIC_2D
from hallo_tpu_torch.pipelines.static import StaticPipeline
from hallo_tpu_torch.train.bench_step import synthetic_batch
from hallo_tpu_torch.train.bench_trainer import trainer_config, write_trainer_clip
from hallo_tpu_torch.train.stage1 import train_stage1_process
from hallo_tpu_torch.train.stage2 import train_stage2_process
from hallo_tpu_torch.train.state import (
    AdamW, OptimizerConfig, TrainState, Zero, global_norm, stage1_trainable, stage2_trainable,
    unfreeze)
from hallo_tpu_torch.train.step import (
    TrainConfig, make_loss_fn, make_train_step, step_generator)
from hallo_tpu_torch.utils import checkpoint as ckpt
from hallo_tpu_torch.utils.factory import build_models, build_wav2vec, dummy_clip_inputs
from hallo_tpu_torch.utils.video import read_frames, write_video

# A kernel against its plain version computed in fp32 from the same inputs
# (unit-normal q, k, v). The kernels round q, k, v (fp32 I/O: on their way
# into shared memory), the probabilities and a bf16 output to bf16 (8 bits of
# mantissa), about 0.4% of each value. Two limits, both must hold:
# - max abs error KERNEL_ATOL, for an error local to a few rows (at short key
#   lengths |o| ~ 1, so this is ~2% of a value);
# - relative L2 error ||kernel - plain|| / ||plain|| KERNEL_RTOL, scaled to
#   the case's own output: at Lk 8192 a typical |o| is ~sqrt(e / Lk) ~ 0.02,
#   as small as KERNEL_ATOL, so only this limit sees a dropped key tile
#   there. Measured on an H100: 1.7e-3 to 3.3e-3 over every case, so the
#   limit is 3x the largest. Each case with 128 keys or more also reads the
#   plain version with its first 64 keys dropped against the full one, and
#   fails unless that planted fault exceeds KERNEL_RTOL (9.0e-2 at Lk 8192,
#   the smallest, to 0.52 at Lk 304).
KERNEL_ATOL = 2e-2
KERNEL_RTOL = 1e-2

# K1's LSE output, in log2 units: an error of x scales the backward's
# recomputed probabilities by 2^-x, so max abs 1e-3 is 0.07% of P (read
# 1.9e-6 on an H100). The planted fault (the first keys dropped) moves the
# LSE by -log2(1 - their share of the mass), 0.011 for 64 of 8192 keys.
LSE_ATOL = 1e-3
# K5's gradients grow with the length they sum over (dV with Lq, dQ with
# Lk), so their max abs error is held relative to the plain gradient's max
# |value|: KERNEL_ATOL of it; the relative L2 limit is KERNEL_RTOL. On an
# H100 the Hopper kernels (flash_bwd_sm90.cu) read 3.1e-3 to 5.2e-3 of max
# |plain| and 2.34e-3 to 2.39e-3 relative (the forward's bf16 rounding);
# the planted fault 0.11 to 0.49.

# K8 (the Winograd conv) against its plain version from the same inputs
# (unit-normal x, an N(0, 1) / 30 HWIO kernel, a unit-normal bias). The
# outputs have sigma ~ 3 and reach |y| ~ 15 at C 960, where a bf16 output's
# own rounding exceeds KERNEL_ATOL: its max abs error is held against
# KERNEL_ATOL of max |plain|, beside the relative L2 limit KERNEL_RTOL. The
# planted fault, the plain version with the first 64 input channels (half
# of them below 128) dropped, must exceed the latter. Its autograd entry
# (cuDNN backward) is held against autograd of the direct conv in fp32 with
# TF32 off: the same convolutions in another order of sums, so 1e-4 for
# both limits; a zeroed dk must exceed them.
WINOGRAD_GRAD_TOL = 1e-4

# The port on the card (bf16, kernels) against the same weights on the CPU
# (fp32, plain versions) at a small input: relative L2 error of each output.
# bf16 keeps 8 bits of mantissa, so every layer adds ~0.4% relative rounding;
# through the UNets' depth that stays within a few percent.
SLICE_RTOL = 5e-2

# The audio embeddings on the card (fp32 encoder; the attention kernels
# round q, k, v and P to bf16) against the same weights on the CPU in fp32
# with the plain versions (the same int8 quantisation where K6 runs):
# relative L2 error of the (T, 12, 768) states. Each layer's attention
# output carries ~0.4% relative bf16 rounding, and with random weights it
# is a small part of the residual sum it joins (measured on an H100:
# 1.7e-4 to 2.5e-4 at 3, 12 and 42 s), so the limit is 4x the largest of
# those. A planted fault, every attention output scaled by 1.03 on the
# 3-s WAV, must exceed it, or the check is too weak and the phase fails
# (it read 1.8e-2 on an H100).
AUDIO_RTOL = 1e-3
AUDIO_FAULT_SCALE = 1.03

# One stage-2 train step on the card (bf16, kernels, per-block
# checkpointing) against the same weights and batch on the CPU (fp32, plain
# versions) at 64x64, 4 + 2 frames: relative error of the loss and relative
# L2 error of the flattened trainable gradient. bf16 rounding through the
# whole forward and backward: the gradient read 2.4e-2 and the loss 4.2e-5
# on an H100, so the limit is 2x the gradient's reading. The planted
# backward fault (K5's dQ zeroed) read 0.119 there and must exceed it.
TRAIN_RTOL = 5e-2

# The stage-2 step with nested per-layer checkpointing (`remat_inner`)
# against the per-block checkpoint alone, on the card at 512^2, B 1, 14 + 2
# frames, the same weights and batch: relative error of the loss and
# relative L2 error of each trainable group's flattened gradient (the
# motion feed-forwards, the rest of the motion modules, the audio modules,
# the audio projection). The replays
# run the same kernels on the same inputs; what differs is the motion
# feed-forward's chunks, whose products over a quarter of the sites may
# round otherwise in bf16, and that rounding is carried through the whole
# backward as the card's bf16 is against the CPU's fp32: the limit is
# TRAIN_RTOL's. The planted fault, the feed-forward's last chunk replayed
# from zeros, must exceed it for the motion feed-forwards.
REMAT_INNER_RTOL = TRAIN_RTOL

# The dataset phase: two synthetic videos of DATASET_FRAMES frames at
# 512^2 (5 s at 25 fps) from 1.jpg, built on the card and, for one video,
# on the CPU in fp32: frames, face region and masks bit for bit, the audio
# embedding within AUDIO_RTOL. The planted fault scales the last encoder
# layer's LayerNorm weight by DATASET_FAULT_SCALE on the card only: it
# scales that layer's output, one of the 12 stacked states, by as much
# (about 1e-2 / sqrt(12) = 2.9e-3 relative), so it must exceed AUDIO_RTOL.
DATASET_FRAMES = 125
DATASET_FAULT_SCALE = 1.01
DATASET_FAULT_KEY = "encoder.layers.11.final_layer_norm.weight"

# The fast profile and a static CFG-cache plan (UniPC at 12 steps, stride 2,
# tail 2) on the card (bf16, kernels) against the same weights on the CPU
# (fp32, plain versions) at phase_reference's small size, one clip from the
# same noise: relative L2 error of the final latents (what the sampler
# hands the VAE decoder). Every denoiser call carries the bf16 rounding that
# SLICE_RTOL bounds, and the sampler mixes each step's error into the next;
# PROFILE_RTOL is that limit. The dynamic step cache is not held against the
# CPU: a decision near its threshold may rightly go either way between bf16
# and fp32 (the CPU tests hold it against the JAX package). Measured on an
# H100: 1.0e-2 (fast) and 7.3e-3 (the CFG-cache plan). Two planted faults,
# the CPU run with DDIM's update in place of UniPC's and with a CFG weight of
# 3.0 in place of 3.5, must exceed the limit.
PROFILE_RTOL = 5e-2

# The static pipeline on the card (bf16, kernels) against the same weights
# on the CPU (fp32, plain versions) at phase_reference's small size (64x64,
# B 1), DDIM at 8 steps from the same noise: relative L2 error of the final
# latents. Every denoiser call carries the bf16 rounding that SLICE_RTOL
# bounds, and the sampler mixes each step's error into the next, as in
# PROFILE_RTOL. The planted fault, the CPU run with UniPC's update in place
# of DDIM's, must exceed it.
STATIC_RTOL = 5e-2

# One stage-1 loss and gradient on the card in fp32 (kernels) against the
# same weights and batch on the CPU (fp32, plain versions) at 64x64, B 2: the
# loss's relative error and each trained module's (ReferenceNet, denoiser,
# face locator, image projection) flattened gradient's relative L2 error.
# The CPU tests hold the port's step against JAX's at rtol 1e-5 and 1e-4 a
# leaf (tests/test_torch_stage1.py). On the card K1 and K5 round fp32 q, k, v
# and dO to bf16 (the tensor cores' operands), so every attention carries
# bf16's 0.4% rounding through the forward and the backward; the limit is
# TRAIN_RTOL's. The planted fault, K5's dK/dV pass returning zeros (no
# gradient reaches a K/V projection, nor the ReferenceNet's features through
# the denoiser's K/V concat), must exceed it for the ReferenceNet.
STAGE1_RTOL = TRAIN_RTOL

# The parallel phase (`phase_parallel`): its ranks, one a card, write their
# result under PARALLEL_DIR and must end within PARALLEL_TIMEOUT_S; a minute
# before it, each rank prints its threads' Python stacks (faulthandler).
PARALLEL_DIR = os.path.join(_build.BUILD_DIR, "parallel")
PARALLEL_TIMEOUT_S = 600

# Kernel tests of tests/test_torch_kernels.py that chip_smoke.py runs after
# its kernel phase: the rings' 300-launch repeats of K1 (Lk 32, 4, level 0
# and the stage-1 ReferenceNet's Lq = Lk, with and without its LSE), K4 and
# K8, and the samplers' steps on the
# card against the CPU with a planted corrector fault.
CARD_CHECKS = ("repeats_bit_for_bit_over_300 or d512_and_winograd_kernels_are_bitwise_repeatable"
               " or sampler_steps_on_the_card or sampler_card_check")
CARD_CHECK_COUNT = 8 + 1 + 6 + 1

# A tensor that AnimateDiff's file and net.pth both hold (net.pth's wins).
CLI_MOTION_KEY = "down_blocks.0.motion_modules.0.temporal_transformer.proj_in.weight"
# The values of the synthetic files that the CLI's checks compare with.
CLI_KEEP = {
    "sd_vae_ft_mse": ["encoder.conv_in.weight", "decoder.conv_out.bias"],
    "sd15_unet": ["conv_in.weight"],
    "animatediff_mm": [CLI_MOTION_KEY],
    "net_pth": ["reference_unet.conv_in.weight", "denoising_unet.conv_in.weight",
                "denoising_unet." + CLI_MOTION_KEY, "face_locator.conv_in.weight",
                "imageproj.proj.weight", "audioproj.proj1.weight"],
    "wav2vec2": ["encoder.layers.0.attention.q_proj.weight"],
}

# The ONNX executor on the card (fp32: `OnnxExecutor.run` turns TF32 off,
# as the product runs it) against itself on the CPU in fp32 on the same
# inputs: relative L2 error of each graph's outputs. Both sides are fp32 in
# another order of sums, so the limit sits above the graphs' own fp32
# rounding and below what TF32's 10-bit products give: the graphs of
# ONNX_TF32_MUST_FAIL run with TF32 (`tf32_fault`) must exceed it, as must
# one conv weight x1.01 on the card side only.
ONNX_RTOL = 1e-5
ONNX_FAULT_SCALE = 1.01
ONNX_TF32_MUST_FAIL = ("scrfd", "arcface", "mdx")
# The separator with the U-Net on the card against the CPU, on 1.wav: the
# graph's error as the STFT of real audio (a wide range of magnitudes), the
# overlap-add, the iSTFT and the resampling carry it to the waveform. The
# same run with TF32 allowed must exceed the limit.
SEPARATOR_RTOL = 3e-5
# The identity MDX graph gives back 1.wav through the STFT, the graph, the
# iSTFT and the 16 <-> 44.1 kHz resampling, whose round trip sets this
# limit.
SEPARATOR_ROUND_TRIP_RTOL = 1e-3
# Detections on the card and on the CPU: the same boxes in the same order,
# their corners and keypoints within this many pixels.
DETECTION_ATOL = 1e-2


# The card's peaks for the bound (NVIDIA's H100 SXM data sheet, dense, at
# the full 700 W limit): bytes over the memory rate, operations over the
# tensor-core rate of their type.
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
INT8_OPS_PER_S = 1979e12
# The exponentials' floor of an attention forward: one ex2 per score, at 16
# a clock per SM (the SFU throughput of compute capability 9.0), at the
# card's maximum SM clock; `preflight` fills in the card's numbers.
EX2_PER_CLOCK_PER_SM = 16
CARD = dict(sms=0, sm_clock_hz=0.0)

REPO = os.path.dirname(os.path.abspath(__file__))
WAV = os.path.join(REPO, "examples", "driving_audios", "1.wav")
IMAGE = os.path.join(REPO, "examples", "reference_images", "1.jpg")
DEFAULT_YAML = os.path.join(REPO, "configs", "inference", "default.yaml")
STAGE1_YAML = os.path.join(REPO, "configs", "train", "stage1.yaml")

# Rows of the kernels' table: the TPU kernel each replaces, and the path
# whose run counts its launches.
KERNELS = {
    "flash_fwd_packed": dict(
        tpu="K1", route="cuda", source="hallo_tpu_torch/csrc/flash_fwd_sm90.cu",
        replaces="hallo_tpu/ops/pallas_flash.py:236", launched_by="slice",
    ),
    "temporal_attn": dict(
        tpu="K2", route="cuda", source="hallo_tpu_torch/csrc/temporal_attn_sm90.cu",
        replaces="hallo_tpu/ops/pallas_temporal.py:42", launched_by="slice",
    ),
    "flash_fwd_t": dict(
        tpu="K3", route="cuda", source="hallo_tpu_torch/csrc/flash_fwd_t_sm90.cu",
        replaces="hallo_tpu/ops/pallas_flash.py:120", launched_by="audio",
    ),
    "flash_fwd": dict(
        tpu="K4", route="cuda", source="hallo_tpu_torch/csrc/flash_fwd_d512_sm90.cu",
        replaces="hallo_tpu/ops/pallas_flash.py:73", launched_by="slice",
    ),
    "flash_int8": dict(
        tpu="K6", route="cuda", source="hallo_tpu_torch/csrc/flash_int8_sm90.cu",
        replaces="hallo_tpu/ops/pallas_flash.py:177", launched_by="audio",
    ),
    # K6's quantisation prelude (XLA ops before the Pallas call in JAX), a
    # kernel of its own in the same source: one launch per K6 call
    "int8_prelude": dict(
        tpu="K6", route="cuda", source="hallo_tpu_torch/csrc/flash_int8_sm90.cu",
        replaces="hallo_tpu/ops/pallas_flash.py:886", launched_by="audio",
    ),
    # Nothing dispatches K7 in either package: its launches are the kernel
    # phase's, at its own test cases.
    "temporal_attn_packed": dict(
        tpu="K7", route="cuda", source="hallo_tpu_torch/csrc/temporal_attn_sm90.cu",
        replaces="hallo_tpu/ops/pallas_temporal.py:104", launched_by="kernel phase",
    ),
    # Nothing calls K8 or K9 in either package (the op-level entry points
    # only): their launches are the kernel phase's.
    "winograd_conv3x3": dict(
        tpu="K8", route="cuda", source="hallo_tpu_torch/csrc/winograd.cu",
        replaces="hallo_tpu/ops/pallas_winograd.py:66", launched_by="kernel phase",
    ),
    "layout_copy": dict(
        tpu="K9", route="cuda", source="hallo_tpu_torch/csrc/layout_copy.cu",
        replaces="hallo_tpu/ops/layout.py:28", launched_by="kernel phase",
    ),
    # K5's two passes, launched by the train steps (their launches: the 3
    # timed steps' total)
    "flash_bwd_dkv": dict(
        tpu="K5", route="cuda", source="hallo_tpu_torch/csrc/flash_bwd_sm90.cu",
        replaces="hallo_tpu/ops/pallas_flash.py:425", launched_by="train",
    ),
    "flash_bwd_dq": dict(
        tpu="K5", route="cuda", source="hallo_tpu_torch/csrc/flash_bwd_sm90.cu",
        replaces="hallo_tpu/ops/pallas_flash.py:497", launched_by="train",
    ),
}


def log(*a) -> None:
    print(*a, flush=True)


LAUNCH_TABLES = (flash.LAUNCHES, temporal.LAUNCHES, winograd.LAUNCHES, layout.LAUNCHES)


def launch_counts() -> dict:
    return {k: v for table in LAUNCH_TABLES for k, v in table.items()}


def reset_counts() -> None:
    for table in LAUNCH_TABLES:
        for key in table:
            table[key] = 0


def cuda_ms(fn, iters: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def preflight() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    CARD.update(sms=torch.cuda.get_device_properties(0).multi_processor_count,
                sm_clock_hz=float(clock) * 1e6)
    log(f"SMs {CARD['sms']}, max SM clock {clock} MHz")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    # Stated explicitly: fp32 matmuls and convolutions in full fp32 (the
    # audio path and the plain references below).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("tf32: matmul False, cudnn False")
    t0 = time.perf_counter()
    _build.build()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s")
    for name in sorted(_build.build_log):
        log(f"--- nvcc {name}.cu ({_build.build_seconds[name]:.1f} s)")
        log(_build.build_log[name].strip())
    for name in _build.SOURCES:
        _build.lib(name)
    return smi


def bound_ms(bytes_moved: float, bf16_ops: float, int8_ops: float = 0.0):
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over their peak rates; and which bounds."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = bf16_ops / BF16_OPS_PER_S + int8_ops / INT8_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def host_us(fn, n: int = 50) -> float:
    """Host microseconds of one call of `fn` (host clock over n calls, no
    synchronisation inside: what the call costs the host, not the card)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def exp_floor_ms(scores: float) -> float:
    """The least time the card's SFUs take for one ex2 per score."""
    return 1e3 * scores / (EX2_PER_CLOCK_PER_SM * CARD["sms"] * CARD["sm_clock_hz"])


def kernel_cases(dev):
    """Each case: the table row it feeds, its label, the kernel call, its
    plain version, one library call computing the same function (timed
    only), and the case's bytes and operations for the bound."""
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def sdpa(q, k, v, bias=None):
        mask = None if bias is None else bias[:, None, None, :].to(q.dtype)
        return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)

    def attn_cost(b, h, lq, lk, d, elem, bias, int8=False):
        """q, k, v read once, o written once (+ an fp32 bias); QK^T and PV."""
        nbytes = elem * b * h * d * (2 * lq + 2 * lk) + (0 if bias is None else 4 * b * lk)
        ops = 2.0 * b * h * lq * lk * d
        return (nbytes, ops, ops) if int8 else (nbytes, 2 * ops, 0.0)

    def packed(label, b, lq, lk, c, heads=8, bias=None):
        q, k, v = randn(b, lq, c), randn(b, lk, c), randn(b, lk, c)

        def heads_major(t):
            return t.unflatten(2, (heads, c // heads)).transpose(1, 2)

        return dict(
            row="flash_fwd_packed", label=label,
            fn=lambda: flash.flash_attention_packed(q, k, v, heads=heads, bias=bias),
            plain=lambda: flash.packed_reference(q.float(), k.float(), v.float(), heads, bias),
            library=sdpa(heads_major(q), heads_major(k), heads_major(v), bias),
            fault=None if lk < 128 else lambda: flash.packed_reference(
                q.float(), k[:, 64:].float(), v[:, 64:].float(), heads,
                None if bias is None else bias[:, 64:]),
            note=f"exp floor {exp_floor_ms(b * heads * lq * lk):.4f} ms",
            cost=attn_cost(b, heads, lq, lk, c // heads, 2, bias))

    half_masked = torch.zeros(2, 8192, device=dev)
    half_masked[:, 4096:] = flash.MASK_VALUE
    cases = [
        packed("K1 level 0 ref concat Lq 4096 Lk 8192 C 320", 2, 4096, 8192, 320),
        packed("K1 level 1 ref concat Lq 1024 Lk 2048 C 640", 2, 1024, 2048, 640),
        packed("K1 level 2 d=160 Lq 256 Lk 512 C 1280", 2, 256, 512, 1280),
        packed("K1 audio Lk 32", 2, 4096, 32, 320),
        packed("K1 identity Lk 4", 2, 4096, 4, 320),
        packed("K1 Lq 1 Lk 1", 1, 1, 1, 320),
        packed("K1 MASK_VALUE bias on half the keys", 2, 4096, 8192, 320,
               bias=half_masked),
        packed("K1 level 1 d=80 B 14 Lq 1024 Lk 2048 C 640", 14, 1024, 2048, 640),
        packed("K1 level 2 d=160 B 14 Lq 256 Lk 512 C 1280", 14, 256, 512, 1280),
    ]
    # K4 (flash_fwd_d512_sm90.cu): the VAE mid-block's attention at the
    # encode (B 3: the reference frame and 2 motion frames) and the decode
    # (B 16 frames), then d 128 and 256 (other heads K4 takes)
    for label, b, h, lq, d in (("VAE mid encode d=512 L 4096 B 3", 3, 1, 4096, 512),
                               ("VAE mid decode d=512 L 4096 B 16", 16, 1, 4096, 512),
                               ("d=128 B 2 H 4 L 2048", 2, 4, 2048, 128),
                               ("d=256 B 2 H 2 L 2048", 2, 2, 2048, 256)):
        q4, k4, v4 = (randn(b, h, lq, d) for _ in range(3))
        plan = flash.d512_plan(q4, k4, v4)
        cases.append(dict(
            row="flash_fwd", label=f"K4 {label}",
            fn=(lambda q=q4, k=k4, v=v4: flash.flash_attention(q, k, v)),
            plain=(lambda q=q4, k=k4, v=v4: per_sample(
                lambda *t: attention_reference(*(x.float() for x in t)), q, k, v)),
            library=sdpa(q4, k4, v4),
            fault=(lambda q=q4, k=k4, v=v4: per_sample(
                lambda *t: attention_reference(*(x.float() for x in t)),
                q, k[:, :, 64:], v[:, :, 64:])),
            note=f"plan: block_q {plan.block_q}, block_k {plan.block_k}, stages "
                 f"{plan.stages}, cluster {plan.cluster}, grid {plan.grid}, boxes q "
                 f"{plan.q.box} k/v {plan.k.box}",
            host={"the K4 wrapper (flash_attention)":
                  (lambda q=q4, k=k4, v=v4: flash.flash_attention(q, k, v))},
            cost=attn_cost(b, h, lq, lq, d, 2, None), plain_iters=3))

    # K3 (flash_fwd_t_sm90.cu): the wav2vec2 self-attention, fp32, through the
    # model's (B, T, H, d) -> (B, H, T, d) view; T = 304 (12 s of audio),
    # 1056 (42 s), and 1056 with half the keys at MASK_VALUE.
    for lq, masked in ((304, False), (1056, False), (1056, True)):
        q3, k3, v3 = (randn(1, lq, 12, 64, dtype=torch.float32).transpose(1, 2)
                      for _ in range(3))
        bias3 = None
        if masked:
            bias3 = torch.zeros(1, lq, device=dev)
            bias3[:, lq // 2:] = flash.MASK_VALUE
        plan = flash.heads_major_plan(q3, k3, v3)
        kb3 = None if bias3 is None else bias3[:, None, None, :]
        cases.append(dict(
            row="flash_fwd_t",
            label=(f"K3 wav2vec2 fp32 B 1 H 12 d 64 L {lq}"
                   f"{', half the keys masked' if masked else ''}"),
            fn=(lambda q=q3, k=k3, v=v3, b=bias3: flash.flash_attention(q, k, v, bias=b)),
            plain=(lambda q=q3, k=k3, v=v3, b=kb3: attention_reference(q, k, v, b)),
            library=sdpa(q3, k3, v3, bias3),
            fault=(lambda q=q3, k=k3, v=v3, b=kb3: attention_reference(
                q, k[:, :, 64:], v[:, :, 64:], None if b is None else b[..., 64:])),
            note=f"plan: block_q {plan.block_q}, block_k {plan.block_k}, {plan.slots} slots of "
                 f"{plan.src_boxes} boxes {plan.k.box}, wide {plan.wide}, grid {plan.grid}",
            host={"the K3 wrapper (flash_attention)":
                  (lambda q=q3, k=k3, v=v3, b=bias3: flash.flash_attention(q, k, v, bias=b))},
            graph=True, cost=attn_cost(1, 12, lq, lq, 64, 4, bias3)))

    # K6 (flash_int8_sm90.cu): int8 scores at the 42-s audio's shape, fp32 V;
    # plain, half the keys at MASK_VALUE, ragged Lk, and L 4096 (about 2.7
    # minutes of audio). Parts: the prelude kernel and the attention kernel.
    for label, lq, lk, masked in (("plain", 1056, 1056, False),
                                  ("half the keys at MASK_VALUE", 1056, 1056, True),
                                  ("ragged Lk 1050", 1056, 1050, False),
                                  ("L 4096", 4096, 4096, False)):
        q6 = randn(1, lq, 12, 64, dtype=torch.float32).transpose(1, 2)
        k6, v6 = (randn(1, lk, 12, 64, dtype=torch.float32).transpose(1, 2) for _ in range(2))
        bias6 = None
        if masked:
            bias6 = torch.zeros(1, lk, device=dev)
            bias6[:, lk // 2:] = flash.MASK_VALUE
        plan = flash.int8_plan(q6, k6, v6)
        ops6 = flash.int8_prelude(q6, k6, v6, bias=bias6)
        cases.append(dict(
            row="flash_int8", label=f"K6 int8 B 1 H 12 d 64 L {lq}, {label}",
            fn=(lambda q=q6, k=k6, v=v6, b=bias6: flash.flash_attention_int8(q, k, v, bias=b)),
            plain=(lambda q=q6, k=k6, v=v6, b=bias6: flash.int8_reference(q, k, v, b)),
            library=sdpa(q6, k6, v6, bias6),
            fault=(lambda q=q6, k=k6, v=v6, b=bias6: flash.int8_reference(
                q, k[:, :, 64:], v[:, :, 64:], None if b is None else b[:, 64:])),
            parts=dict(prelude=(lambda q=q6, k=k6, v=v6, b=bias6: flash.int8_prelude(
                           q, k, v, bias=b)),
                       attention=(lambda o=ops6: flash.int8_attention(o))),
            note=f"plan: q8/k8 rows {plan.d_p} bytes, v16 rows {plan.d_vp}, block_q "
                 f"{plan.block_q}, block_k {plan.block_k}, {plan.stages} stages, grid "
                 f"{plan.grid}, prelude grid {plan.prelude_grid} (clusters of "
                 f"{flash.INT8_PRELUDE_CLUSTER}), workspace {plan.workspace} bytes",
            host={"the K6 wrapper (flash_attention_int8, both launches)":
                  (lambda q=q6, k=k6, v=v6, b=bias6: flash.flash_attention_int8(q, k, v, bias=b))},
            graph=True, plain_iters=3, cost=attn_cost(1, 12, lq, lk, 64, 4, bias6, int8=True)))
        if label == "plain":
            cases.append(prelude_case(q6, k6, v6))

    def frames(row, label, b, f, l, c, heads):
        tq, tk, tv = randn(b, f, l, c), randn(b, f, l, c), randn(b, f, l, c)
        plan = temporal.temporal_plan(tq, tk, tv, heads, CARD["sms"] or flash.H100_SMS)

        def per_site(t):  # (B, F, L, C) -> (B*L, H, F, d), made before timing
            return t.unflatten(3, (heads, c // heads)).permute(0, 2, 3, 1, 4).reshape(
                b * l, heads, f, c // heads)

        return dict(
            row=row, label=label,
            fn=lambda: temporal.temporal_attention(tq, tk, tv, heads=heads),
            plain=lambda: temporal.temporal_reference(tq.float(), tk.float(), tv.float(), heads),
            library=sdpa(per_site(tq), per_site(tk), per_site(tv)),
            note=f"plan: {plan.heads_per_unit} heads x {plan.sites} sites a unit, {plan.boxes} "
                 f"boxes of {plan.map.box} an operand ({plan.box_rows} rows), {plan.stages} "
                 f"stages, {plan.units} units, grid {plan.grid}, {plan.k_tiles} key tiles",
            host={"the K2 wrapper (temporal_attention)":
                  lambda: temporal.temporal_attention(tq, tk, tv, heads=heads)},
            cost=(4 * 2 * b * f * l * c, 4.0 * b * l * c * f * f, 0.0))

    # K2 at the 512^2 denoiser's four levels (B 2: the CFG batch; F 18: 16
    # clip + 2 motion frames), training's level 0 (B 1, F 16 = 14 + 2), level
    # 0 without motion frames, and another frame count
    for label, b, f, l, c in (
        ("K2 F 18 L 4096 C 320", 2, 18, 4096, 320),
        ("K2 F 16 L 4096 C 320 (level 0 without motion frames)", 2, 16, 4096, 320),
        ("K2 F 18 L 256 C 1280 d=160", 2, 18, 256, 1280),
        ("K2 F 17 L 1024 C 640 (any other frame count)", 2, 17, 1024, 640),
        ("K2 level 1 F 18 L 1024 C 640 d=80", 2, 18, 1024, 640),
        ("K2 level 3 F 18 L 64 C 1280 d=160", 2, 18, 64, 1280),
        ("K2 training level 0 B 1 F 16 L 4096 C 320", 1, 16, 4096, 320),
    ):
        cases.append(frames("temporal_attn", label, b, f, l, c, 8))
    # K2 under clip parallelism: level 0's sites split over seq = 2 and 4
    # ranks, the whole clip's 16 + 2 frames at each, at the CFG batch 2 and
    # stage2.yaml's training batch 4
    for n in (2, 4):
        for b in (2, 4):
            cases.append(frames("temporal_attn", f"K2 seq {n}: level 0 B {b} F 18 L {4096 // n} "
                                f"C 320", b, 18, 4096 // n, 320, 8))
    # K7's own test cases (tests/test_pallas_temporal.py), (B, F, heads, d, L)
    for b, f, heads, d, l in ((1, 6, 2, 8, 256), (2, 5, 2, 16, 200)):
        cases.append(frames("temporal_attn_packed", f"K7 B {b} F {f} heads {heads} d {d} L {l}",
                            b, f, l, heads * d, heads))
    # Training: K1 with its LSE and K5's two passes at the stage-2 shapes
    # (14 frames at 512^2): levels 0-2 of the spatial self-attention over the
    # reference concat with the CFG-uncond bias (the ref half masked on half
    # the batch), the audio (Lk 32) and the identity (Lk 4) cross-attention.
    for name, lq, lk, c, with_bias in (
        ("level 0", 4096, 8192, 320, True), ("level 1", 1024, 2048, 640, True),
        ("level 2", 256, 512, 1280, True), ("audio", 4096, 32, 320, False),
        ("identity", 4096, 4, 320, False),
    ):
        cases += training_cases(randn, sdpa, dev, name, 14, lq, lk, c, 8, with_bias)
    # Stage 1 (B 8 single frames at 512^2, where the ReferenceNet runs under
    # gradient): the ReferenceNet's self-attention (Lq = Lk), the denoiser's
    # over the reference concat with the dropout's uncond bias, and the
    # identity cross-attention (Lk 4) at levels 0-3.
    for name, lq, lk, c, with_bias in (
        ("stage 1 ReferenceNet level 0", 4096, 4096, 320, False),
        ("stage 1 level 0", 4096, 8192, 320, True),
        ("stage 1 identity level 0", 4096, 4, 320, False),
        ("stage 1 identity level 1", 1024, 4, 640, False),
        ("stage 1 identity level 2", 256, 4, 1280, False),
        ("stage 1 identity level 3", 64, 4, 1280, False),
    ):
        cases += training_cases(randn, sdpa, dev, name, 8, lq, lk, c, 8, with_bias)
    # Tensor parallelism (parallel/tp.py), after the main-path cases (each
    # row of the kernels line reports its first case): the 1280-wide
    # levels' attentions on one rank's heads of d 160, 4 at model 2 (C 640)
    # and 2 at model 4 (C 320): K1 at level 2 (the CFG batch 2) and level 3,
    # K2 at level 2, K1 with its LSE and K5's passes at level 2 in training
    # (14 frames)
    for n in (2, 4):
        c, h = 1280 // n, 8 // n
        cases.append(packed(f"K1 model {n}: level 2 d=160 Lq 256 Lk 512 C {c}", 2, 256, 512,
                            c, heads=h))
        cases.append(packed(f"K1 model {n}: level 3 d=160 Lq 64 Lk 128 C {c}", 2, 64, 128, c,
                            heads=h))
        cases.append(frames("temporal_attn", f"K2 model {n}: level 2 F 18 L 256 C {c} d=160",
                            2, 18, 256, c, h))
        cases += training_cases(randn, sdpa, dev, f"model {n} level 2", 14, 256, 512, c, h,
                                True)
    # K8 and K9, from a generator of their own
    gen = torch.Generator(device=dev).manual_seed(11)
    return cases + winograd_cases(dev, gen) + layout_cases(dev, gen)


def winograd_cases(dev, gen):
    """K8 at the denoiser's five 3x3-conv shapes (NHWC, CFG batch 32 = 2 x 16
    frames at 512^2; level 0's resnet, up-block and concat convs, level 1's
    resnet and up-block), bf16; level 1's resnet in fp32; a small
    non-square case; then the autograd entry at level 1's resnet in fp32.
    The first is the row's main-path case."""

    def conv_case(label, shape, cout, dtype=torch.bfloat16):
        n, h, w, c = shape
        x = torch.randn(*shape, generator=gen, device=dev).to(dtype)
        k = (torch.randn(3, 3, c, cout, generator=gen, device=dev) / 30).to(dtype)
        b = torch.randn(cout, generator=gen, device=dev)
        u = winograd.kernel_weights(k, dtype)
        xc = x.permute(0, 3, 1, 2)  # NHWC memory is channels_last NCHW: no copy
        wc = k.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        drop = min(64, c // 2)
        elem = x.element_size()
        tiles = n * (h // 2) * (w // 2)
        direct = bound_ms(elem * (n * h * w * (c + cout) + 9 * c * cout),
                          2.0 * 9 * n * h * w * c * cout)
        plan = winograd.winograd_plan(x, cout, CARD["sms"] or winograd.H100_SMS)
        return dict(
            row="winograd_conv3x3", label=f"K8 {label} {tuple(shape)} -> {cout}, {str(dtype)[6:]}",
            fn=lambda: winograd.winograd_conv3x3(x, k, b),
            plain=lambda: winograd.winograd_reference(x, k, b),
            library=lambda: F.conv2d(xc, wc, b.to(dtype), padding=1),
            fault=lambda: winograd.winograd_reference(x[..., drop:], k[:, :, drop:], b),
            fault_name=f"first {drop} input channels dropped",
            parts=dict(kernel=lambda: winograd.winograd_launch(x, u, cout, b),
                       weight_transform=lambda: winograd.kernel_weights(k, dtype)),
            note=f"direct-conv bound {direct[0]:.4f} ms ({direct[1]}); plan: {plan.units} units "
                 f"of 8 x 8 tiles x 64 channels, {plan.steps} steps of 16 channels, grid "
                 f"{plan.grid} CTAs, boxes x {plan.x.box} U {plan.u.box} y {plan.y.box}",
            host={"the K8 wrapper (winograd_launch)":
                  lambda: winograd.winograd_launch(x, u, cout, b)},
            cost=(elem * (n * h * w * (c + cout) + 16 * c * cout), 2.0 * 16 * tiles * c * cout,
                  0.0),
            scaled=True, plain_iters=3)

    cases = [
        conv_case("level 0 resnet", (32, 64, 64, 320), 320),
        conv_case("level 0 up", (32, 64, 64, 640), 320),
        conv_case("level 0 concat", (32, 64, 64, 960), 320),
        conv_case("level 1 resnet", (32, 32, 32, 640), 640),
        conv_case("level 1 up", (32, 32, 32, 1280), 640),
        conv_case("level 1 resnet", (32, 32, 32, 640), 640, torch.float32),
        conv_case("non-square", (2, 16, 24, 40), 48),
    ]
    # The autograd entry: K8 forward, cuDNN backward (dx, dk, db) against
    # autograd of the direct conv, fp32, on one cotangent.
    shape, cout = (32, 32, 32, 640), 640
    x, k, b = (t.requires_grad_() for t in (
        torch.randn(*shape, generator=gen, device=dev),
        torch.randn(3, 3, shape[-1], cout, generator=gen, device=dev) / 30,
        torch.randn(cout, generator=gen, device=dev)))
    g = torch.randn(*shape[:3], cout, generator=gen, device=dev)

    def grads(conv):
        return torch.autograd.grad(conv(x, k, b), (x, k, b), g)

    def zeroed_dk():
        dx, dk, db = grads(winograd.conv3x3_direct)
        return dx, torch.zeros_like(dk), db

    n, h, w, c = shape
    direct_ops = 2.0 * 9 * n * h * w * c * cout
    cases.append(dict(
        row="winograd_conv3x3", label=f"K8 autograd (winograd_conv3x3_vjp) {shape} -> {cout}, "
                                      "float32, dx dk db",
        fn=lambda: grads(winograd.winograd_conv3x3_vjp),
        plain=lambda: grads(winograd.conv3x3_direct), library=lambda: grads(winograd.conv3x3_direct),
        fault=zeroed_dk, fault_name="dk zeroed",
        cost=(4 * (2 * n * h * w * (c + cout) + n * h * w * cout + 2 * 9 * c * cout + cout),
              2.0 * 16 * n * (h // 2) * (w // 2) * c * cout + 2 * direct_ops, 0.0),
        scaled=True, atol=WINOGRAD_GRAD_TOL, rtol=WINOGRAD_GRAD_TOL, plain_iters=3))
    return cases


def layout_cases(dev, gen):
    """K9 bit for bit: the 512^2 denoiser's level-0 activation (131072, 320)
    bf16 (84 MB), and a ragged size whose bytes end past the last 16-byte
    vector. The planted fault is one element changed."""
    cases = []
    for label, shape in (("level 0 activation", (131072, 320)), ("ragged", (4099, 37))):
        x = torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

        def changed(x=x):
            y = layout.layout_anchor_reference(x)
            y.view(-1)[y.numel() // 2] += 1
            return y

        nbytes = x.numel() * x.element_size()
        cases.append(dict(
            row="layout_copy", label=f"K9 {label} {shape} bfloat16 ({nbytes} bytes)",
            fn=lambda x=x: layout.layout_anchor(x),
            plain=lambda x=x: layout.layout_anchor_reference(x),
            library=lambda x=x: x.clone(), fault=changed, fault_name="one element changed",
            fault_by="abs", atol=0.0, rtol=0.0, bitwise=True, cost=(2 * nbytes, 0.0, 0.0)))
    return cases


# The prelude kernel's k8 against `quantize_int8`'s: the K mean's summation
# order may move a centred value across a rounding boundary of round(x / ks),
# a difference of one. On an H100 that moved 0 of 811008 elements at L 1056
# and 1 of 3145728 (3.2e-7) at L 4096; the bound leaves room for other data
# (tests/test_torch_kernels.py holds the same one).
K8_OFF_BY_ONE_SHARE = 1e-5


def prelude_case(q, k, v):
    """K6's prelude kernel against `quantize_int8` on the same inputs: q8
    and qs (times scale log2 e) bit for bit (max abs error 0), and, in the
    case's check, k8 within one step on at most K8_OFF_BY_ONE_SHARE of its
    elements and ks to fp32 rounding. The planted fault is one q8 element
    off by one."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    scale = d ** -0.5

    def kernel():
        ops = flash.int8_prelude(q, k, v)
        return ops.q8[:, :, :d].reshape(b, h, lq, d), ops.qs.reshape(b, h, lq)

    def plain():
        q8, _, qs, _ = flash.quantize_int8(q, k, scale)
        return q8, qs

    def fault():
        q8, qs = plain()
        q8 = q8.clone()
        q8.view(-1)[q8.numel() // 2] += 1 if q8.view(-1)[q8.numel() // 2] < 127 else -1
        return q8, qs

    def check():
        ops = flash.int8_prelude(q, k, v)
        _, k8, _, ks = flash.quantize_int8(q, k, scale)
        off = ops.k8[:, :, :d].reshape(k8.shape).int() - k8.int()
        share = (off != 0).float().mean().item()
        ks_err = ((ops.meta[:, :lk, 0].reshape(ks.shape) - ks).abs() / ks).max().item()
        if off.abs().max().item() > 1 or share > K8_OFF_BY_ONE_SHARE or ks_err > 2e-6:
            raise RuntimeError(f"K6 prelude: k8 off by up to {off.abs().max().item()} on "
                               f"{share:.3e} of its elements, ks relative error {ks_err:.3e}")
        return (f"k8 off by one on {int((off != 0).sum())} of {off.numel()} elements "
                f"({share:.3e}; bound {K8_OFF_BY_ONE_SHARE}), ks max relative error "
                f"{ks_err:.3e}")

    elem = q.element_size()
    plan = flash.int8_plan(q, k, v)
    written = (b * h * (lq + lk) * plan.d_p + 4 * b * h * lq + 8 * b * h * plan.lk_pad
               + 2 * b * h * lk * plan.d_vp)
    return dict(row="int8_prelude", label=f"K6 prelude B {b} H {h} d {d} L {lq}, fp32",
                fn=kernel, plain=plain, library=None, fault=fault,
                fault_name="one q8 element off by one", fault_by="abs", atol=0.0, rtol=0.0,
                check=check, graph=True,
                cost=(elem * b * h * d * (lq + 2 * lk) + written, 0.0, 0.0))


def per_sample(fn, *tensors):
    """`fn` on each batch element alone, concatenated: bounds the plain
    versions' (H, Lq, Lk) fp32 temporaries at the training batch of 14."""
    outs = [fn(*(None if t is None else t[i:i + 1] for t in tensors))
            for i in range(tensors[0].shape[0])]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(x) for x in zip(*outs))
    return torch.cat(outs)


def training_cases(randn, sdpa, dev, name, b, lq, lk, c, heads, with_bias):
    """K1's LSE, K5's dK/dV pass and K5's dQ pass at one training shape,
    each against its plain version from the same inputs (K5's from the
    kernel forward's out and LSE, the residuals it is given in training).
    The planted fault drops the first n keys (n = 64, or Lk / 8 at short
    Lk); for dK/dV their rows become zero."""
    d = c // heads
    q, k, v, g = randn(b, lq, c), randn(b, lk, c), randn(b, lk, c), randn(b, lq, c)
    bias = None
    if with_bias:
        bias = torch.zeros(b, lk, device=dev)
        bias[: b // 2, lk // 2:] = -1e9  # the denoiser's NEG_INF on the ref tokens
    out, lse = flash.flash_forward_packed(q, k, v, heads, bias, with_lse=True)
    args = flash.backward_args(q, k, v, bias, out, lse, g, heads)
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    n = min(64, max(1, lk // 8))
    label = f"B {b} Lq {lq} Lk {lk} C {c}{', bias' if with_bias else ''} ({name})"

    def plain_bwd(drop=0):
        kb = None if bias is None else bias[:, drop:]
        return per_sample(
            lambda *t: flash.flash_backward_reference(*t, heads), qf, kf[:, drop:],
            vf[:, drop:], kb, out, lse, gf)

    def pad(t):  # the dropped keys' rows of dK/dV are zero
        return torch.cat([torch.zeros_like(t[:, :n]), t], dim=1)

    def heads_major(t):
        return t.unflatten(2, (heads, d)).transpose(1, 2)

    qh, kh, vh = (heads_major(t).detach().requires_grad_() for t in (q, k, v))
    mask = None if bias is None else bias[:, None, None, :].to(q.dtype)
    oh = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)
    gh = heads_major(g)

    def sdpa_backward():
        return torch.autograd.grad(oh, (qh, kh, vh), gh, retain_graph=True)

    io = 2 * b * c * (2 * lq + 2 * lk) + (0 if bias is None else 4 * b * lk)
    stats = 4 * b * heads * lq  # one fp32 (B, H, Lq) tensor
    gemm = 2.0 * b * heads * lq * lk * d
    return [
        dict(row="flash_fwd_packed", label=f"K1 with LSE, {label}",
             fn=lambda: flash.flash_forward_packed(q, k, v, heads, bias, with_lse=True)[1],
             plain=lambda: per_sample(
                 lambda q1, k1, b1: flash.flash_lse_reference(q1, k1, heads, b1), qf, kf, bias),
             library=sdpa(heads_major(q), heads_major(k), heads_major(v), bias),
             fault=lambda: per_sample(
                 lambda q1, k1, b1: flash.flash_lse_reference(q1, k1, heads, b1),
                 qf, kf[:, n:], None if bias is None else bias[:, n:]),
             cost=(io + stats, 2 * gemm, 0.0), atol=LSE_ATOL, fault_by="abs",
             note=f"exp floor {exp_floor_ms(b * heads * lq * lk):.4f} ms", plain_iters=3),
        dict(row="flash_bwd_dkv", label=f"K5 dK/dV, {label}",
             fn=lambda: flash.flash_bwd_dkv(args),
             plain=lambda: plain_bwd()[1:], library=sdpa_backward,
             fault=lambda: tuple(pad(t) for t in plain_bwd(n)[1:]),
             cost=(io + 2 * stats + 2 * b * c * 2 * lk, 4 * gemm, 0.0), scaled=True,
             plain_iters=2, note=f"exp floor {exp_floor_ms(b * heads * lq * lk):.4f} ms; "
                                 f"plan {plan_note(args.plan.dkv)}",
             host={"backward_args (checks, plan, Delta)": lambda: flash.backward_args(
                 q, k, v, bias, out, lse, g, heads), "the dK/dV wrapper": lambda:
                 flash.flash_bwd_dkv(args)}),
        dict(row="flash_bwd_dq", label=f"K5 dQ, {label}",
             fn=lambda: flash.flash_bwd_dq(args),
             plain=lambda: plain_bwd()[0], library=sdpa_backward,
             fault=lambda: plain_bwd(n)[0],
             cost=(io + 2 * stats + 2 * b * c * lq, 3 * gemm, 0.0), scaled=True,
             plain_iters=2, note=f"exp floor {exp_floor_ms(b * heads * lq * lk):.4f} ms; "
                                 f"plan {plan_note(args.plan.dq)}",
             host={"the dQ wrapper": lambda: flash.flash_bwd_dq(args)}),
    ]


def plan_note(p) -> str:
    """A K5 pass's tiles and grid, for the log."""
    fields = ("block_q", "block_k", "stages", "wg_split", "splits", "q_buffers", "tiles", "grid")
    return ", ".join(f"{f} {getattr(p, f)}" for f in fields if hasattr(p, f))


def _errors(got, want):
    """Worst max abs error, max abs error over max |plain|, and relative L2
    error over the output (or each output of a tuple)."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = scaled = rel = 0.0
    for a, w in zip(got, want):
        diff = (a.float() - w.float())
        e = diff.abs().max().item()
        err = max(err, e)
        scaled = max(scaled, e / w.float().abs().max().item())
        rel = max(rel, (diff.norm() / w.float().norm()).item())
    return err, scaled, rel


def phase_kernels(dev) -> dict:
    """Each kernel vs its plain version; returns {row: stats of its first
    (main-path) case, with the worst error over all its cases, and the
    launches its cases made}. A case holds max abs error `atol` (of max
    |plain| with `scaled`) and relative L2 error `rtol`; its planted fault
    must exceed the limit named by `fault_by` ("rel" or "abs")."""
    table = {}
    for case in kernel_cases(dev):
        label = case["label"]
        atol, rtol = case.get("atol", KERNEL_ATOL), case.get("rtol", KERNEL_RTOL)
        before = sum(launch_counts().values())
        got = case["fn"]()
        want = case["plain"]()
        torch.cuda.synchronize()
        err, scaled, rel = _errors(got, want)
        held = scaled if case.get("scaled") else err
        if not all(torch.isfinite(t).all() for t in (got if isinstance(got, tuple) else (got,))):
            raise RuntimeError(f"{label}: non-finite kernel output")
        if case.get("bitwise") and not torch.equal(got.view(torch.int16), want.view(torch.int16)):
            raise RuntimeError(f"{label}: the copy differs from its input bit for bit")
        fault = None
        if case.get("fault") is not None:
            f_err, _, f_rel = _errors(case["fault"](), want)
            fault = f_err if case.get("fault_by") == "abs" else f_rel
        ms, plain_ms = cuda_ms(case["fn"]), cuda_ms(case["plain"], case.get("plain_iters", 20))
        library_ms = None if case["library"] is None else cuda_ms(case["library"])
        launched = sum(launch_counts().values()) - before
        b_ms, b_by = bound_ms(*case["cost"])
        abs_name = "max_abs_err / max|plain|" if case.get("scaled") else "max_abs_err"
        log(f"{label}: {abs_name} {held:.3e} (atol {atol}) rel_err {rel:.3e} "
            f"(rtol {rtol}) max_abs_err {err:.3e} "
            f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms library "
            f"{'none' if library_ms is None else f'{library_ms:.4f} ms'} "
            f"bound {b_ms:.4f} ms ({b_by})")
        if "note" in case:
            log(f"  {case['note']}")
        if case.get("graph"):
            t = timings(case["fn"], 20, 3)
            log(f"  device {t['graph_ms']:.4f} ms a call (CUDA-graph replay), "
                f"{t['ms']:.4f} ms back to back, host {t['host_us']:.1f} us a call")
        if "check" in case:
            log(f"  {case['check']()}")
        if fault is not None:
            log(f"  planted fault, {case.get('fault_name', 'first keys dropped')}: "
                f"{'max_abs_err' if case.get('fault_by') == 'abs' else 'rel_err'} {fault:.3e}")
        for part, part_fn in case.get("parts", {}).items():
            if case.get("graph"):
                t = timings(part_fn, 20, 3)
                log(f"  {part} alone: {t['ms']:.4f} ms, device {t['graph_ms']:.4f} ms "
                    f"(CUDA-graph replay), host {t['host_us']:.1f} us a call")
            else:
                log(f"  {part} alone: {cuda_ms(part_fn):.4f} ms")
        for part, part_fn in case.get("host", {}).items():
            log(f"  host cost of {part}: {host_us(part_fn):.1f} us a call")
        if not (held <= atol and rel <= rtol):
            raise RuntimeError(f"{label}: kernel disagrees with plain version "
                               f"({abs_name} {held}, relative {rel})")
        limit = atol if case.get("fault_by") == "abs" else rtol
        if fault is not None and not fault > limit:
            raise RuntimeError(f"{label}: the check misses the planted fault, "
                               f"{case.get('fault_name', 'first keys dropped')} ({fault})")
        row = table.setdefault(case["row"], dict(
            max_abs_err=0.0, rel_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
            bound_ms=b_ms, bound_by=b_by, phase_launches=0))
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["rel_err"] = max(row["rel_err"], rel)
        row["phase_launches"] += launched
        del got, want
        torch.cuda.empty_cache()
    # K9 reads a flat contiguous buffer: a transposed view raises (the
    # port's choice, instead of a copy made before the kernel).
    try:
        layout.layout_anchor(torch.zeros(320, 4096, dtype=torch.bfloat16, device=dev).t())
    except ValueError as exc:
        log(f"K9 transposed (320, 4096) view: ValueError as chosen ({exc})")
    else:
        raise RuntimeError("K9: a transposed view was copied instead of raising")
    return table


def log_k1_host_cost(dev) -> None:
    """K1's host work per call: encoding its three tensor maps (timed in the
    library over 1000 calls' worth) and the whole wrapper call at a tiny
    shape (host clock over 200 calls, no synchronisation inside)."""
    q = torch.zeros(2, 4096, 320, dtype=torch.bfloat16, device=dev)
    plan = flash.sm90_plan(*(q.unflatten(2, (8, 40)),) * 3)
    encode = _build.lib("flash_fwd_sm90").hallo_flash_sm90_encode_ns
    n = 1000
    ns = encode(*(q.data_ptr(),) * 3, flash._map_args(plan), plan.block_q, plan.block_k, n)
    if ns < 0:
        raise RuntimeError("K1: cuTensorMapEncodeTiled failed")
    tiny = torch.zeros(1, 1, 320, dtype=torch.bfloat16, device=dev)
    flash.flash_attention_packed(tiny, tiny, tiny, heads=8)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        flash.flash_attention_packed(tiny, tiny, tiny, heads=8)
    call_us = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize()
    log(f"K1 host cost: {ns / n / 1e3:.2f} us to encode a call's three tensor maps; "
        f"{call_us:.2f} us per wrapper call (Lq 1, Lk 1, host clock)")


def log_small_call_host_costs(dev) -> None:
    """The host work of a whole K5 call (`flash_backward`: checks, plan,
    Delta, both passes) and of a K3 call (`flash_attention`, its launch
    arguments cached by shape), at tiny shapes (host clock, 200 calls)."""
    tiny = torch.zeros(1, 1, 320, dtype=torch.bfloat16, device=dev)
    out, lse = flash.flash_forward_packed(tiny, tiny, tiny, 8, with_lse=True)
    k5_us = host_us(lambda: flash.flash_backward(tiny, tiny, tiny, None, out, lse, tiny, 8),
                    200)
    q3 = torch.zeros(1, 12, 8, 64, device=dev)
    k3_us = host_us(lambda: flash.flash_attention(q3, q3, q3), 200)
    k6_us = host_us(lambda: flash.flash_attention_int8(q3, q3, q3), 200)
    log(f"K5 host cost: {k5_us:.2f} us per flash_backward call (Lq 1, Lk 1, both passes); "
        f"K3 host cost: {k3_us:.2f} us per flash_attention call (fp32, L 8, host clock); "
        f"K6 host cost: {k6_us:.2f} us per flash_attention_int8 call (both launches)")
    # the tensor maps, encoded on the host for every launch (passed in the
    # kernel's parameter space): their share of those costs, at the audio shape
    q = torch.zeros(1, 1056, 12, 64, device=dev).transpose(1, 2)
    n = 1000
    _, args3 = flash._heads_major_args(tuple(q.shape), q.stride(), tuple(q.shape), q.stride(),
                                       tuple(q.shape), q.stride(), q.dtype)
    ns3 = _build.lib("flash_fwd_t_sm90").hallo_flash_fwd_t_encode_ns(
        q.data_ptr(), q.data_ptr(), args3, n)
    ops = flash.int8_prelude(q, q, q)
    ws = ops.workspace.data_ptr()
    o = ops.plan.offsets
    ns6 = _build.lib("flash_int8_sm90").hallo_flash_int8_encode_ns(
        ws + o[0], ws + o[1], ws + o[4], ops.args, n)
    if ns3 < 0 or ns6 < 0:
        raise RuntimeError("K3/K6: cuTensorMapEncodeTiled failed")
    log(f"K3 host cost: {ns3 / n / 1e3:.2f} us to encode a call's two tensor maps; "
        f"K6: {ns6 / n / 1e3:.2f} us for the attention kernel's three (L 1056)")


def rel_err(got, want) -> float:
    got = torch.as_tensor(got).float().cpu()
    want = torch.as_tensor(want).float().cpu()
    return ((got - want).norm() / want.norm()).item()


def phase_audio(dev, out_dir: str) -> dict:
    """wav2vec2-base at full width through `AudioProcessor.preprocess` on the
    card, at three lengths of 1.wav, each held against the same weights on
    the CPU in fp32; K3 and K6 counted per run."""
    t0 = time.perf_counter()
    model = build_wav2vec("full", device=dev, seed=0)
    state = model.state_dict()
    proc = AudioProcessor(wav2vec_state_dict=state, device=dev)
    cpu = AudioProcessor(wav2vec_state_dict={k: v.cpu() for k, v in state.items()},
                         device="cpu")
    del model, state
    torch.cuda.synchronize()
    log(f"wav2vec2-base (fp32) on the card and on the CPU: {time.perf_counter() - t0:.1f} s")

    data, sr = load_wav(WAV)
    os.makedirs(out_dir, exist_ok=True)
    from scipy.io import wavfile

    runs = []
    for tiles, int8 in ((1, False), (4, False), (14, True)):
        path = WAV
        if tiles > 1:
            path = os.path.join(out_dir, f"1_x{tiles}.wav")
            wavfile.write(path, sr, np.tile(data, tiles).astype(np.float32))
        runs.append((tiles, int8, path))

    out = dict(counts={k: 0 for k in launch_counts()})
    saved = os.environ.get("HALLO_INT8_ATTN")
    for tiles, int8, path in runs:
        seconds = len(data) * tiles / sr
        want_len = int(np.ceil(seconds * 25))
        padded = -(-want_len // 16) * 16
        os.environ["HALLO_INT8_ATTN"] = "1" if int8 else "0"
        try:
            # warm-up at this length (cuDNN's choice for new conv shapes,
            # allocator growth), so that the timed call is a warm one
            proc.preprocess(path, clip_length=16)
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            emb, length = proc.preprocess(path, clip_length=16)
            torch.cuda.synchronize()
            card_s = time.perf_counter() - t0
            counts = launch_counts()
            t0 = time.perf_counter()
            ref, _ = cpu.preprocess(path, clip_length=16)
            cpu_s = time.perf_counter() - t0
        finally:
            if saved is None:
                os.environ.pop("HALLO_INT8_ATTN", None)
            else:
                os.environ["HALLO_INT8_ATTN"] = saved
        err = rel_err(emb, ref)
        label = f"audio {seconds:.1f} s ({'HALLO_INT8_ATTN=1' if int8 else 'bf16 scores'})"
        log(f"{label}: emb {emb.shape}, audio_length {length}, card {card_s:.4f} s, "
            f"CPU fp32 {cpu_s:.2f} s, rel_err {err:.3e} (rtol {AUDIO_RTOL}), launches {counts}")
        if emb.shape != (padded, 12, 768) or length != want_len:
            raise RuntimeError(f"{label}: emb {emb.shape}, length {length}; "
                               f"want ({padded}, 12, 768), {want_len}")
        if not np.isfinite(emb).all():
            raise RuntimeError(f"{label}: non-finite embeddings")
        if not err <= AUDIO_RTOL:
            raise RuntimeError(f"{label}: card disagrees with the CPU fp32 reference ({err})")
        k3, k6 = counts["flash_fwd_t"], counts["flash_int8"]
        if (k3, k6) != ((0, 12) if int8 else (12, 0)) or counts["int8_prelude"] != k6:
            raise RuntimeError(f"{label}: K3 launched {k3}, K6 {k6} times in one forward "
                               f"(its prelude {counts['int8_prelude']})")
        for key, n in counts.items():
            out["counts"][key] += n
        if tiles == 1:
            out.update(emb=emb, audio_length=length, ref=ref)

    # The planted fault: every attention output scaled by AUDIO_FAULT_SCALE
    # on the 3-s WAV must fail the check above.
    real = wav2vec_module.dot_product_attention
    wav2vec_module.dot_product_attention = (
        lambda *a, **kw: real(*a, **kw) * AUDIO_FAULT_SCALE)
    try:
        faulty, _ = proc.preprocess(WAV, clip_length=16)
    finally:
        wav2vec_module.dot_product_attention = real
    fault_err = rel_err(faulty, out.pop("ref"))
    log(f"planted fault, attention output x {AUDIO_FAULT_SCALE} on 3.0 s: "
        f"rel_err {fault_err:.3e} (rtol {AUDIO_RTOL})")
    if not fault_err > AUDIO_RTOL:
        raise RuntimeError(f"the audio check misses an attention output off by "
                           f"{AUDIO_FAULT_SCALE - 1:.0%} ({fault_err})")
    return out


def on_cpu_fp32(models: HalloModels, scale: str, **unet_overrides) -> HalloModels:
    """The same weights as `models` (built with `unet_overrides`), in fp32 on
    the CPU."""
    host = {name: {k: v.float().cpu() for k, v in module.state_dict().items()}
            for name, module in models.modules().items()}
    cpu = build_models(scale, device=torch.device("meta"), unet_overrides=unet_overrides)
    for name, module in cpu.modules().items():
        module.to_empty(device="cpu").load_state_dict(host[name], strict=True)
    return cpu


def phase_reference(models: HalloModels, cpu: HalloModels, dev) -> dict:
    """ReferenceNet, one cfg_split denoiser forward, VAE encode and decode at
    a small input (64x64 pixels, 4 frames, 2 motion frames), on the card and
    on the CPU in fp32 (`cpu`, `on_cpu_fp32(models)`) with the same weights
    and inputs."""
    gen = torch.Generator().manual_seed(1)

    def r(*shape):
        return torch.randn(*shape, generator=gen)

    b, f, m, hl = 1, 4, 2, 8
    den = models.denoising_net.config
    ap = models.audio_proj.config
    pixels = r(b * (1 + m), 3, 8 * hl, 8 * hl).clamp(-1, 1)
    ctx = r(2 * b * (1 + m), 4, den.cross_attention_dim)
    lat = r(2 * b, f, 4, hl, hl)
    audio = r(2 * b, f, ap.context_tokens, den.audio_attention_dim)
    face = r(2 * b, f, den.block_out_channels[0], hl, hl)
    masks = tuple(
        tuple((torch.rand(2 * b * f, (hl >> d) ** 2, generator=gen) > 0.3).float()
              for _ in range(3))
        for d in range(4)
    )
    scale = torch.tensor([1.0, 0.8, 0.6])

    def run(ms: HalloModels, device):
        def put(x):
            return x.to(device)

        with torch.inference_mode():
            z = ms.vae.encode_mean(put(pixels))
            _, feats = ms.reference_net(put(z).repeat(2, 1, 1, 1), torch.zeros((), device=device), put(ctx))
            split = {k: [x.unflatten(0, (2 * b, 1 + m)) for x in v] for k, v in feats.items()}
            ref = {k: [x[:, 0] for x in v] for k, v in split.items()}
            mot = {k: [x[:, 1:] for x in v] for k, v in split.items()}
            out = ms.denoising_net(
                put(lat), torch.tensor(500, device=device), put(ctx[:2 * b]), ref, mot,
                put(audio), put(face), tuple(tuple(put(x) for x in lvl) for lvl in masks),
                put(scale), None, cfg_split=True,
            )
            pix = ms.vae.decode(put(lat[0]))
        return dict(vae_encode=z, reference_net=feats["up_3"][-1], denoiser=out, vae_decode=pix)

    got = run(models, dev)
    torch.cuda.synchronize()
    want = run(cpu, torch.device("cpu"))
    errs = {k: rel_err(got[k], want[k]) for k in want}
    for k, e in errs.items():
        log(f"slice vs CPU fp32 at 64x64: {k} rel_err {e:.3e} (rtol {SLICE_RTOL})")
        if not e <= SLICE_RTOL:
            raise RuntimeError(f"{k}: card disagrees with the CPU fp32 reference ({e})")
    return errs


def phase_slice(dev, steps: int, audio_emb: np.ndarray, audio_length: int) -> dict:
    """Full-width models, 512^2, driven by the windows of 1.wav's embeddings:
    clips of 16 frames + 2 motion frames. The denoiser is built with
    per-block checkpointing for the train phase; it acts only where a
    gradient is taken, so inference runs as without it."""
    t0 = time.perf_counter()
    models = build_models("full", device=dev, dtype=torch.bfloat16, seed=0, remat=True)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for mod in models.modules().values() for p in mod.parameters())
    log(f"build_models(full, bf16): {time.perf_counter() - t0:.1f} s, {n_params} parameters")
    h = w = 512
    clip, motion_frames = 16, 2
    pipe = FaceAnimatePipeline(models, num_inference_steps=steps, clip_length=clip,
                               n_motion_frames=motion_frames)
    inputs = dummy_clip_inputs(models, h, w, clip, batch=1, seed=0)
    inputs["audio_windows"] = window_audio_embeddings(audio_emb, margin=2)
    clips = inputs["audio_windows"].shape[0] // clip

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    timings: dict = {}
    t0 = time.perf_counter()
    video = pipe(**inputs, seed=0, audio_length=audio_length, timings=timings)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()

    steps_s = timings["denoise_step"]
    log(f"slice: {clips} clips x {clip} frames at {h}x{w} from 1.wav, {steps} DDIM steps, "
        f"{total:.3f} s total")
    per_clip = [sum(timings[k][c] for k in ("vae_encode", "conditioning", "vae_decode"))
                + sum(steps_s[c * steps:(c + 1) * steps]) for c in range(clips)]
    log(f"seconds per clip: {[round(x, 4) for x in per_clip]}")
    log(f"seconds per denoiser step: first {steps_s[0]:.4f}, "
        f"mean of the rest {np.mean(steps_s[1:]):.4f}")
    log(f"seconds VAE encode {[round(x, 4) for x in timings['vae_encode']]}, "
        f"conditioning (ReferenceNet etc.) {[round(x, 4) for x in timings['conditioning']]}, "
        f"VAE decode {[round(x, 4) for x in timings['vae_decode']]}")
    log(f"peak device memory: {peak / 2**30:.3f} GiB")
    log(f"kernel launches in the slice: {counts}")

    if video.shape != (1, audio_length, h, w, 3):
        raise RuntimeError(f"video shape {video.shape}, want {audio_length} frames")
    if not np.isfinite(video).all():
        raise RuntimeError("non-finite video")
    motion = np.abs(np.diff(video[0], axis=0)).mean()
    log(f"video: {video.shape[1]} frames, mean |frame difference|: {motion:.5f}")
    if not motion > 0:
        raise RuntimeError("video does not vary over time")
    for name in ("flash_fwd_packed", "temporal_attn", "flash_fwd"):
        if counts[name] <= 0:
            raise RuntimeError(f"kernel {name} was not launched by the slice")
    return dict(models=models, counts=counts, pipe=pipe, inputs=inputs, steps=steps,
                audio_length=audio_length, clip=clip, h=h)


class DenoiserCalls:
    """Each denoiser forward's `cfg_split` and the K1 launches inside it,
    from forward hooks (the pipeline is not changed for it)."""

    def __init__(self, models: HalloModels):
        self.calls: list = []
        den = models.denoising_net
        self.hooks = (den.register_forward_pre_hook(self._pre, with_kwargs=True),
                      den.register_forward_hook(self._post, with_kwargs=True))

    def _pre(self, module, args, kwargs):
        self.calls.append([bool(kwargs.get("cfg_split")), flash.LAUNCHES["flash_fwd_packed"]])

    def _post(self, module, args, kwargs, out):
        self.calls[-1][1] = flash.LAUNCHES["flash_fwd_packed"] - self.calls[-1][1]

    def remove(self) -> None:
        for h in self.hooks:
            h.remove()


def final_latents(pipe: FaceAnimatePipeline, **call) -> torch.Tensor:
    """One clip through `pipe`; the latents its VAE decoder received."""
    vae, seen = pipe.models.vae, []
    decode = vae.decode

    def recording(z):
        seen.append(z.float().cpu())
        return decode(z)

    vae.decode = recording
    try:
        pipe(**call)
    finally:
        del vae.decode
    return seen[0]


def phase_profiles(models: HalloModels, cpu: HalloModels, slice_: dict) -> dict:
    """The fast and turbo profiles (UniPC at 10 and 8 evals) over 1.wav's
    clips at 512^2; one clip each of DPM-Solver++ on the log-SNR grid, DDIM
    with the uniform step cache and UniPC with the dynamic step cache and
    the CFG cache; the streaming hook; then the fast profile and a static
    CFG-cache plan on the card against the CPU in fp32 at a small size."""
    inputs, audio_length = slice_["inputs"], slice_["audio_length"]
    clip, h = slice_["clip"], slice_["h"]
    clips = inputs["audio_windows"].shape[0] // clip
    k2_per_step = slice_["counts"]["temporal_attn"] / (clips * slice_["steps"])
    log(f"profiles: phase 4 launched K2 {k2_per_step:g} times a DDIM step")

    def pipeline(m, steps, **kw):
        return FaceAnimatePipeline(m, num_inference_steps=steps, clip_length=clip,
                                   n_motion_frames=2, **kw)

    out = {}
    for name, steps in (("fast", 10), ("turbo", 8)):
        pipe = pipeline(models, steps, sampler="unipc")
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        timings: dict = {}
        t0 = time.perf_counter()
        video = pipe(**inputs, seed=0, audio_length=audio_length, timings=timings)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        counts = {k: v / clips for k, v in launch_counts().items() if v}
        peak = torch.cuda.max_memory_allocated()
        step_s = timings["denoise_step"]
        per_clip = [sum(timings[k][c] for k in ("vae_encode", "conditioning", "vae_decode"))
                    + sum(step_s[c * steps:(c + 1) * steps]) for c in range(clips)]
        warm = float(np.mean(per_clip[1:]))
        log(f"profile {name} (UniPC, {steps} evals): {clips} clips at {h}x{h}, "
            f"{total:.3f} s; seconds a clip: first {per_clip[0]:.4f}, warm "
            f"{[round(x, 4) for x in per_clip[1:]]} (mean {warm:.4f}, {clip / warm:.3f} "
            f"frames/s); a denoiser step: first {step_s[0]:.4f}, mean after the first "
            f"clip {np.mean(step_s[steps:]):.4f}; peak {peak / 2**30:.3f} GiB; "
            f"launches a clip {counts}")
        if video.shape != (1, audio_length, h, h, 3) or not np.isfinite(video).all():
            raise RuntimeError(f"profile {name}: video {video.shape}")
        if timings["step_kind"] != ["full"] * steps * clips:
            raise RuntimeError(f"profile {name}: steps {timings['step_kind']}")
        if counts.get("temporal_attn", 0) != steps * k2_per_step:
            raise RuntimeError(f"profile {name}: K2 launched {counts.get('temporal_attn', 0)} "
                               f"times a clip, want {steps} x {k2_per_step:g}")
        if counts.get("flash_fwd") != 2:
            raise RuntimeError(f"profile {name}: K4 launched {counts.get('flash_fwd')} a clip")
        out[name] = dict(seconds_per_clip=per_clip, step_seconds=step_s, peak=peak,
                         launches_per_clip=counts)

    # --- one clip each of the cache plans ---
    one = dict(inputs, audio_windows=inputs["audio_windows"][:clip])
    for label, steps, kw in (
        ("dpm++2m logsnr", 10, dict(sampler="dpm++2m", timestep_schedule="logsnr")),
        ("ddim uniform", 12, dict(sampler="ddim", step_cache="uniform")),
        ("unipc dynamic + cfg cache", 12, dict(sampler="unipc", step_cache="dynamic",
                                               cfg_cache_stride=2, cfg_tail=2)),
    ):
        pipe = pipeline(models, steps, **kw)
        calls = DenoiserCalls(models)
        timings = {}
        reset_counts()
        t0 = time.perf_counter()
        try:
            video = pipe(**one, seed=3, timings=timings)
            torch.cuda.synchronize()
        finally:
            calls.remove()
        seconds = time.perf_counter() - t0
        kinds = timings["step_kind"]
        log(f"profile {label}: {seconds:.3f} s a clip (timed), steps {kinds}, "
            f"scores {[round(x, 5) for x in timings.get('step_cache_score', [])]}, "
            f"K1 launches by denoiser call {[c[1] for c in calls.calls]}")
        if not np.isfinite(video).all():
            raise RuntimeError(f"profile {label}: non-finite video")
        if kw.get("timestep_schedule") == "logsnr":
            want_ts = schedule.logsnr_timesteps(SchedulerConfig(), steps)
            if not np.array_equal(pipe.sampler.timesteps, want_ts):
                raise RuntimeError(f"profile {label}: grid {pipe.sampler.timesteps}")
            want = ["full"] * steps
        elif kw.get("step_cache") == "uniform":
            want = ["reuse" if s else "full" for s in cache.make_skip_mask(steps)]
        else:
            plan, _ = cache.make_cfg_plan(steps, 2, pipe.guidance_scale, tail=2)
            allow = cache.make_allow_mask(steps)
            want = ["full" if p else "cond" for p in plan]
            for i, kind in enumerate(kinds):
                if kind == "reuse" and allow[i]:
                    want[i] = "reuse"
        if kinds != want:
            raise RuntimeError(f"profile {label}: steps {kinds}, want {want}")
        ran = [k for k in kinds if k != "reuse"]
        if [c[0] for c in calls.calls] != [k == "full" for k in ran]:
            raise RuntimeError(f"profile {label}: denoiser calls {calls.calls} for {ran}")
        full = [n for split, n in calls.calls if split]
        cond = [n for split, n in calls.calls if not split]
        if cond and not max(cond) < min(full):
            raise RuntimeError(f"profile {label}: a cond-only step launched K1 {max(cond)} "
                               f"times, a full one {min(full)}")
        out[label] = dict(seconds=seconds, kinds=kinds, k1_full=full, k1_cond=cond)

    # --- the streaming hook: its frames are the returned video ---
    pipe = pipeline(models, 10, sampler="unipc")
    t0 = time.perf_counter()
    plain = pipe(**inputs, seed=4, audio_length=audio_length)
    torch.cuda.synchronize()
    no_hook = time.perf_counter() - t0
    frames: list = []
    t0 = time.perf_counter()
    video = pipe(**inputs, seed=4, audio_length=audio_length, on_clip=frames.append)
    torch.cuda.synchronize()
    with_hook = time.perf_counter() - t0
    log(f"profile fast, streaming: {no_hook:.3f} s without the hook, {with_hook:.3f} s with "
        f"it ({clips} clips, no timings)")
    hooked = np.concatenate(frames, axis=1).astype(np.float32) / 255.0
    if not (np.array_equal(hooked, video) and np.array_equal(video, plain)):
        raise RuntimeError("profile fast: the hook's frames differ from the returned video")
    out["streaming"] = dict(without_hook=no_hook, with_hook=with_hook)

    # --- the card against the CPU in fp32, phase_reference's size ---
    small = dict(dummy_clip_inputs(models, 64, 64, 4, batch=1, seed=5))
    noise = [np.random.default_rng(6).normal(size=(1, 4, 8, 8, 4)).astype(np.float32)]

    def latents_of(m, steps, **kw):
        return final_latents(FaceAnimatePipeline(m, num_inference_steps=steps, clip_length=4,
                                                 n_motion_frames=2, **kw),
                             **small, latents=noise)

    fast_card = None
    for label, steps, kw in (("fast", 10, dict(sampler="unipc")),
                             ("unipc cfg cache", 12, dict(sampler="unipc", cfg_cache_stride=2,
                                                          cfg_tail=2))):
        got = latents_of(models, steps, **kw)
        err = rel_err(got, latents_of(cpu, steps, **kw))
        log(f"profile {label} at 64x64 vs CPU fp32: final latents rel_err {err:.3e} "
            f"(rtol {PROFILE_RTOL})")
        if not err <= PROFILE_RTOL:
            raise RuntimeError(f"profile {label}: card disagrees with the CPU fp32 run ({err})")
        out[f"{label} vs cpu"] = err
        fast_card = got if fast_card is None else fast_card
    # planted faults on the CPU side: DDIM's update in place of UniPC's, and
    # a CFG weight of 3.0 in place of 3.5; each must read outside the limit
    # (UniPC's corrector alone moves these latents about as much as bf16
    # does: the CPU tests hold it against the JAX package at 1e-6)
    for fault, kw in (("DDIM in place of UniPC", dict(sampler="ddim")),
                      ("guidance 3.0", dict(sampler="unipc", guidance_scale=3.0))):
        e = rel_err(fast_card, latents_of(cpu, 10, **kw))
        log(f"profile fast, planted fault ({fault} on the CPU): rel_err {e:.3e}")
        if not e > PROFILE_RTOL:
            raise RuntimeError(f"profile fast: the planted fault ({fault}) reads {e}, inside "
                               f"{PROFILE_RTOL}: the check is too weak")
    return out


def loss_and_grads(models: HalloModels, batch: dict) -> tuple:
    """One stage-2 loss (no dropouts) and the flattened fp32 gradient of the
    trainable parameters, on the CPU."""
    trainable = unfreeze(models.modules(), stage2_trainable)
    cfg = TrainConfig(uncond_img_ratio=0.0, uncond_audio_ratio=0.0, uncond_ia_ratio=0.0,
                      start_ratio=0.0)
    loss = make_loss_fn(models, cfg)(batch, torch.Generator(device=models.device))
    grads = torch.autograd.grad(loss, list(trainable.values()))
    return loss.item(), torch.cat([g.float().flatten().cpu() for g in grads])


def train_steps(models: HalloModels, dev, batch: dict) -> dict:
    """One warm-up and 3 timed stage-2 steps (stage2.yaml's AdamW) from the
    models' weights on `batch`: the state and the step function, seconds a
    step, the peak (warm-up included), the launches a step. The models'
    trainable weights move."""
    trainable = unfreeze(models.modules(), stage2_trainable)
    opt = AdamW(OptimizerConfig(learning_rate=1e-5, lr_warmup_steps=1))
    state = TrainState.create(trainable, opt)
    step = make_train_step(models, trainable, opt, TrainConfig())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    seconds = []
    for i in range(4):
        if i == 1:
            reset_counts()
        t0 = time.perf_counter()
        state, m = step(state, batch, step_generator(0, i, dev))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        log(f"train {'warm-up ' if i == 0 else ''}step {i}: {seconds[-1]:.4f} s, loss "
            f"{m['loss']:.5f} grad_norm {m['grad_norm']:.5f} skipped {m['skipped']:.0f}")
        if m["skipped"] or not np.isfinite(m["loss"]):
            raise RuntimeError(f"train step {i}: non-finite loss or gradients ({m})")
    counts = launch_counts()
    return dict(state=state, step=step, seconds=seconds[1:],
                peak=torch.cuda.max_memory_allocated(), counts=counts,
                per_step={k: v / 3 for k, v in counts.items()})


def phase_train(models: HalloModels, dev, scale: str = "full", profile_out: str = "") -> dict:
    """Stage-2 train steps on the full-width models at 512^2, B 1, 14 + 2
    frames, bf16, per-block checkpointing (with `profile_out`, one more step
    under torch.profiler, written there); then the card against the CPU.
    The snapshots that the checks compare with are kept in host memory, out
    of the peak."""
    if not models.denoising_net.config.remat:
        raise RuntimeError("the train phase needs the denoiser built with remat=True")
    trainable = unfreeze(models.modules(), stage2_trainable)
    frozen = {f"{top}.{k}": p.detach().cpu() for top, mod in models.modules().items()
              for k, p in mod.named_parameters() if not p.requires_grad}
    n_train = sum(p.numel() for p in trainable.values())
    log(f"training: {len(trainable)} trainable tensors, {n_train} parameters; "
        f"{sum(p.numel() for p in frozen.values())} frozen")
    masters0 = {k: p.detach().float().cpu() for k, p in trainable.items()}
    size, frames, motion = 512, 14, 2
    batch = synthetic_batch(models, 1, size, frames, motion, seed=0, fixed=False)
    run = train_steps(models, dev, batch)
    state, step, seconds, peak = run["state"], run["step"], run["seconds"], run["peak"]
    log(f"train at {size}^2, B 1, {frames} + {motion} frames, bf16, per-block checkpointing: "
        f"seconds per step {[round(x, 4) for x in seconds]}, median "
        f"{float(np.median(seconds)):.4f}")
    log(f"train peak device memory (warm-up included): {peak / 2**30:.3f} GiB")
    log(f"kernel launches per train step: {run['per_step']}")
    for name in ("flash_fwd_packed", "flash_bwd_dkv", "flash_bwd_dq", "temporal_attn",
                 "flash_fwd"):
        if run["per_step"][name] <= 0:
            raise RuntimeError(f"kernel {name} was not launched by the train step")

    unchanged = [k for k, v in state.params.items() if torch.equal(v.cpu(), masters0[k])]
    if unchanged:
        raise RuntimeError(f"{len(unchanged)} trainable tensors did not change: {unchanged[:5]}")
    for top, mod in models.modules().items():
        for k, p in mod.named_parameters():
            if not p.requires_grad and not torch.equal(p.cpu(), frozen[f"{top}.{k}"]):
                raise RuntimeError(f"frozen {top}.{k} changed")
    log(f"after 4 steps: all {len(state.params)} trainable tensors changed, "
        f"no frozen one did")
    if profile_out:
        rows, wall = profile_call(
            "train step", lambda: step(state, batch, step_generator(0, 4, dev)), profile_out)
        k5 = sum(ms for ms, _, name in rows if "flash_bwd" in name)
        busy = sum(r[0] for r in rows)
        log(f"K5 in the profiled train step: {k5:.1f} ms, {100 * k5 / busy:.1f}% of device "
            f"time, {100 * k5 / wall:.1f}% of wall")
    counts = run["counts"]
    del run, state, step, frozen, masters0
    torch.cuda.empty_cache()

    # The card against the CPU: the same weights, one step's loss and
    # trainable gradient at 64x64, 4 + 2 frames. The trainable parameters
    # are perturbed first: the zero-initialised motion proj_out and audio
    # zero_convs would otherwise zero the gradient of everything before them.
    gen = torch.Generator(device=dev).manual_seed(2)
    with torch.no_grad():
        for p in trainable.values():
            p.add_(0.02 * torch.randn(p.shape, generator=gen, device=dev).to(p.dtype))
    small = synthetic_batch(models, 1, 64, 4, 2, seed=1, fixed=True)
    card_loss, card_grad = loss_and_grads(models, small)
    cpu = on_cpu_fp32(models, scale)
    cpu_loss, cpu_grad = loss_and_grads(cpu, small)
    loss_err = abs(card_loss - cpu_loss) / abs(cpu_loss)
    grad_err = rel_err(card_grad, cpu_grad)
    log(f"train step vs CPU fp32 at 64x64: loss {card_loss:.6f} vs {cpu_loss:.6f} "
        f"(rel {loss_err:.3e}), trainable gradient rel_err {grad_err:.3e} "
        f"(|g| {global_norm([cpu_grad]).item():.4e}; rtol {TRAIN_RTOL})")
    if not (loss_err <= TRAIN_RTOL and grad_err <= TRAIN_RTOL):
        raise RuntimeError(f"the train step on the card disagrees with the CPU "
                           f"(loss {loss_err}, gradient {grad_err})")
    # The planted fault: K5's dQ pass returns zeros; the check must see it.
    real = flash.flash_bwd_dq
    flash.flash_bwd_dq = lambda a: torch.zeros_like(a.q)
    try:
        _, fault_grad = loss_and_grads(models, small)
    finally:
        flash.flash_bwd_dq = real
    fault_err = rel_err(fault_grad, cpu_grad)
    log(f"planted fault, K5's dQ zeroed: trainable gradient rel_err {fault_err:.3e}")
    if not fault_err > TRAIN_RTOL:
        raise RuntimeError(f"the train check misses a zeroed dQ ({fault_err})")
    return dict(counts=counts, seconds=seconds, peak=peak, loss_err=loss_err,
                grad_err=grad_err, fault_err=fault_err)


def trainable_group(name: str) -> str:
    """The group of a stage-2 trainable tensor: the motion modules'
    feed-forwards, the rest of the motion modules, the audio modules, the
    audio projection."""
    if ".motion_modules." in name:
        return "motion_ff" if ".ff." in name else "motion_modules"
    if ".audio_modules." in name:
        return "audio_modules"
    return name.split(".", 1)[0]


def grouped_loss_and_grads(models: HalloModels, batch: dict, before_backward=None) -> tuple:
    """One stage-2 loss (no dropouts) and the fp32 gradients of the
    trainable tensors, flattened by `trainable_group`, on the host;
    `before_backward()` runs between the forward and the backward."""
    trainable = unfreeze(models.modules(), stage2_trainable)
    cfg = TrainConfig(uncond_img_ratio=0.0, uncond_audio_ratio=0.0, uncond_ia_ratio=0.0,
                      start_ratio=0.0)
    loss = make_loss_fn(models, cfg)(batch, torch.Generator(device=models.device))
    if before_backward is not None:
        before_backward()
    grads = torch.autograd.grad(loss, list(trainable.values()))
    groups: dict = {}
    for name, g in zip(trainable, grads):
        groups.setdefault(trainable_group(name), []).append(g.float().flatten().cpu())
    return loss.item(), {k: torch.cat(v) for k, v in groups.items()}


@contextlib.contextmanager
def ff_replay_fault():
    """The planted fault of the nested checkpoint: FeedForward's chunks, each
    under its own checkpoint, with the last chunk computed from zeros once
    the yielded `replay()` has been called (between the forward and the
    backward, so only the replays see it). The chunk's input is scaled by
    1.0 or 0.0, so the replay records the forward's ops."""
    real = layers.FeedForward.forward
    replaying = []

    def forward(self, x):
        n = self.chunks
        if n <= 1 or x.ndim < 2 or x.shape[-2] % n:
            return real(self, x)

        def body(part, last):
            return self.ff(part * (0.0 if last and replaying else 1.0))

        return torch.cat([layers.checkpoint(body, part, i == n - 1, use_reentrant=False)
                          for i, part in enumerate(x.chunk(n, dim=-2))], dim=-2)

    layers.FeedForward.forward = forward
    try:
        yield lambda: replaying.append(True)
    finally:
        layers.FeedForward.forward = real


def phase_remat_inner(models: HalloModels, dev, block_run: dict, scale: str = "full",
                      size: int = 512, frames: int = 14) -> dict:
    """Phase 6's step with nested per-layer checkpointing: the same weights
    as `models` (per-block checkpointing) in a denoiser built with
    `remat_inner` (the motion feed-forward chunked by 4). The loss and each
    trainable group's gradient on one batch against the per-block run's
    (REMAT_INNER_RTOL), a planted replay fault, then 1 + 3 steps: seconds
    and the peak beside `block_run`'s."""
    nested = build_models(scale, device=dev, dtype=torch.bfloat16, seed=0, remat=True,
                          unet_overrides=dict(remat_inner=True))
    for name, module in models.modules().items():
        getattr(nested, name).load_state_dict(module.state_dict())
    batch = synthetic_batch(models, 1, size, frames, 2, seed=4, fixed=True)
    peaks = {}
    for name, m in (("per-block", models), ("nested", nested)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        result = grouped_loss_and_grads(m, batch)
        peaks[name] = torch.cuda.max_memory_allocated() - base
        if name == "per-block":
            block_loss, block_grads = result
        else:
            loss, grads = result
    log(f"one loss and backward at {size}^2, B 1, {frames} + 2 frames, bf16, above what was "
        f"allocated before it ({base / 2**30:.3f} GiB: both models): peak "
        f"{peaks['per-block'] / 2**30:.3f} GiB per-block, {peaks['nested'] / 2**30:.3f} GiB "
        f"nested")
    loss_err = abs(loss - block_loss) / abs(block_loss)
    errs = {k: rel_err(grads[k], g) for k, g in block_grads.items()}
    log(f"remat_inner vs per-block at {size}^2, B 1, {frames} + 2 frames, bf16: loss {loss:.6f} vs "
        f"{block_loss:.6f} (rel {loss_err:.3e}); gradient rel_err by group "
        f"{ {k: float(f'{e:.3e}') for k, e in errs.items()} } (rtol {REMAT_INNER_RTOL})")
    if not (loss_err <= REMAT_INNER_RTOL and max(errs.values()) <= REMAT_INNER_RTOL):
        raise RuntimeError(f"remat_inner disagrees with per-block checkpointing "
                           f"(loss {loss_err}, gradients {errs})")
    with ff_replay_fault() as replay:
        _, fault_grads = grouped_loss_and_grads(nested, batch, before_backward=replay)
    fault = rel_err(fault_grads["motion_ff"], block_grads["motion_ff"])
    log(f"planted fault, the motion FF's last chunk replayed from zeros: the motion "
        f"feed-forwards' gradient rel_err {fault:.3e}")
    if not fault > REMAT_INNER_RTOL:
        raise RuntimeError(f"the remat_inner check misses a wrong replay ({fault})")
    del block_grads, grads, fault_grads

    run = train_steps(nested, dev, synthetic_batch(nested, 1, size, frames, 2, seed=0,
                                                   fixed=False))
    del run["state"], run["step"]
    # the per-block models stay allocated beside the nested ones: their
    # weights are left out of the peak that is compared
    others = sum(t.nbytes for m in models.modules().values() for t in m.state_dict().values())
    peak = run["peak"] - others
    log(f"train at {size}^2, B 1, {frames} + 2 frames, bf16, per-block + per-layer checkpointing: "
        f"seconds per step {[round(x, 4) for x in run['seconds']]}, median "
        f"{float(np.median(run['seconds'])):.4f} (per-block only "
        f"{float(np.median(block_run['seconds'])):.4f}); peak {peak / 2**30:.3f} GiB without "
        f"the per-block models' {others / 2**30:.3f} GiB of weights (per-block only "
        f"{block_run['peak'] / 2**30:.3f})")
    log(f"kernel launches per remat_inner train step: {run['per_step']}")
    if not peak < block_run["peak"]:
        raise RuntimeError("remat_inner did not lower the train step's peak")
    del nested
    gc.collect()
    torch.cuda.empty_cache()
    return dict(run, peak=peak, loss_err=loss_err, grad_errs=errs, fault=fault,
                backward_peaks=peaks)


def synthetic_videos(root: str, size: int, frames: int) -> tuple:
    """Two `frames`-frame `size`^2 videos of 1.jpg with a per-frame drift
    (a shift and a brightness swing) under `root`/videos, and 1.wav tiled to
    their 5 s: muxed into them where an ffmpeg binary exists, else beside
    them for `place_wav`. Returns the videos' directory, the WAV and whether
    it was muxed."""
    videos = os.path.join(root, "videos")
    os.makedirs(videos)
    data, sr = load_wav(WAV)
    seconds = frames / 25
    wav = os.path.join(root, "voice.wav")
    from scipy.io import wavfile

    wavfile.write(wav, sr, np.resize(data, int(seconds * sr)).astype(np.float32))
    mux = shutil.which("ffmpeg") is not None
    log(f"dataset videos: audio {'muxed by ffmpeg' if mux else 'placed beside (no ffmpeg)'}")
    image = cv2.resize(load_image_rgb(IMAGE), (size, size)).astype(np.float32)
    for v in range(2):
        video = np.stack([
            np.clip(np.roll(image, (i % 9) - 4 + v, axis=1) * (0.9 + 0.1 * np.sin(i / 7 + v)),
                    0, 255).astype(np.uint8)
            for i in range(frames)])
        write_video(video, os.path.join(videos, f"video{v}.mp4"), fps=25,
                    audio_path=wav if mux else None)
    return videos, wav, mux


def place_wav(clips: str, wav: str) -> None:
    """Without ffmpeg step 1 extracts no audio: name the WAV in each clip, as
    tests/test_data_pipeline_e2e.py does."""
    for name in sorted(os.listdir(clips)):
        if name.endswith(".npz"):
            path = os.path.join(clips, name)
            data = dict(np.load(path))
            data["audio_path"] = np.asarray(wav)
            np.savez_compressed(path, **data)


def phase_dataset(dev, size: int = 512, frames: int = DATASET_FRAMES) -> dict:
    """The dataset builder (`python -m hallo_tpu_torch.data_preprocess`, steps
    1 and 2 on the card, no face model files, the full-width wav2vec2 with
    random weights from its seed), then `extract_meta_info` at stages 1 and
    2, on two synthetic 5-s videos; seconds a video for each step, K3's
    launches in step 2. One video again on the CPU in fp32 against the
    card's clip, and a planted wav2vec2 fault on the card."""
    root = os.path.join(_build.BUILD_DIR, "dataset")
    shutil.rmtree(root, ignore_errors=True)
    videos, wav, mux = synthetic_videos(root, size, frames)
    clips = os.path.join(root, "clips")
    common = ["-i", videos, "-o", clips, "--size", str(size),
              "--face_analysis_model_path", os.path.join(root, "no_face_models"),
              "--wav2vec_model_path", os.path.join(root, "no_wav2vec")]
    real = data_preprocess.process_single_video
    video_seconds: list = []

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(*args, **kwargs)
        torch.cuda.synchronize()
        video_seconds.append(time.perf_counter() - t0)
        return out

    data_preprocess.process_single_video = timed
    seconds = {}
    try:
        for step in ("1", "2"):
            video_seconds.clear()
            if step == "2":
                reset_counts()
            t0 = time.perf_counter()
            meta = data_preprocess.main(common + ["-s", step, "--device", str(dev)])
            seconds[step] = (time.perf_counter() - t0, list(video_seconds))
            if len(meta) != 2:
                raise RuntimeError(f"dataset step {step}: {len(meta)} clips, want 2")
            if step == "1" and not mux:
                place_wav(clips, wav)
    finally:
        data_preprocess.process_single_video = real
    counts = launch_counts()
    for step, (total, per_video) in seconds.items():
        log(f"dataset step {step} on the card: {total:.3f} s for 2 videos with the tools' "
            f"build; seconds per video {[round(x, 3) for x in per_video]}")
    log(f"kernel launches in dataset step 2: {counts}")
    if counts["flash_fwd_t"] <= 0:
        raise RuntimeError("the dataset builder's wav2vec2 did not launch K3")
    metas = {}
    for stage in ("1", "2"):
        metas[stage] = os.path.join(root, f"dataset_stage{stage}.json")
        entries = extract_meta_info.main(["-i", clips, "--stage", stage, "-o", metas[stage]])
        if len(entries) != 2:
            raise RuntimeError(f"extract_meta_info --stage {stage}: {entries}")
    card = dict(np.load(os.path.join(clips, "video0.npz")))
    log(f"clip video0: { {k: (v.shape, str(v.dtype)) for k, v in card.items()} }")
    if card["frames"].shape != (frames, size, size, 3) or abs(
            len(card["audio_emb"]) - frames) > 3:
        raise RuntimeError(f"clip video0: frames {card['frames'].shape}, audio_emb "
                           f"{card['audio_emb'].shape}")

    # the same builder on the CPU in fp32, for video0
    cpu_clips = os.path.join(root, "cpu_clips")
    os.makedirs(cpu_clips)
    args = data_preprocess.build_parser().parse_args(
        common[:2] + ["-o", cpu_clips] + common[4:] + ["--device", "cpu"])
    video0 = os.path.join(videos, "video0.mp4")
    t0 = time.perf_counter()
    data_preprocess.process_single_video(video0, cpu_clips, 1, args,
                                         data_preprocess.make_tools(1, args))
    if not mux:
        place_wav(cpu_clips, wav)
    cpu_tools = data_preprocess.make_tools(2, args)
    data_preprocess.process_single_video(video0, cpu_clips, 2, args, cpu_tools)
    cpu = dict(np.load(os.path.join(cpu_clips, "video0.npz")))
    log(f"the builder on the CPU for video0: {time.perf_counter() - t0:.3f} s")
    if card.keys() != cpu.keys():
        raise RuntimeError(f"card clip keys {sorted(card)} vs CPU {sorted(cpu)}")
    for key in card:
        if key not in ("audio_emb", "audio_path") and not np.array_equal(card[key], cpu[key]):
            raise RuntimeError(f"clip video0: {key} differs between the card and the CPU")
    err = rel_err(card["audio_emb"], cpu["audio_emb"])
    log(f"clip video0, card vs CPU: frames, region, masks and face_emb bit for bit; audio_emb "
        f"rel_err {err:.3e} (rtol {AUDIO_RTOL})")
    if not err <= AUDIO_RTOL:
        raise RuntimeError(f"the builder's audio_emb on the card disagrees with the CPU ({err})")
    card_tools = data_preprocess.make_tools(2, data_preprocess.build_parser().parse_args(
        common + ["--device", str(dev)]))
    with torch.no_grad():
        card_tools.audio.model.state_dict()[DATASET_FAULT_KEY].mul_(DATASET_FAULT_SCALE)
    faulty, _ = card_tools.audio.preprocess(str(card["audio_path"]))
    fault = rel_err(faulty, cpu["audio_emb"])
    log(f"planted fault, {DATASET_FAULT_KEY} x {DATASET_FAULT_SCALE} on the card: audio_emb "
        f"rel_err {fault:.3e}")
    if not fault > AUDIO_RTOL:
        raise RuntimeError(f"the builder's check misses a wav2vec2 weight off by 1% ({fault})")
    del card_tools, cpu_tools
    gc.collect()
    torch.cuda.empty_cache()
    return dict(root=root, meta=metas["2"], counts=counts, seconds=seconds, audio_err=err,
                fault=fault)


def phase_trainer(dev, meta: str) -> dict:
    """`train_stage2_process`, the trainer behind `python -m
    hallo_tpu_torch.train.stage2`, on configs/train/stage2.yaml as shipped
    (train_bs 4, per-block and per-layer checkpointing) over the dataset
    phase's clips (`meta`), read through the prefetcher, with these cuts: 2
    steps with a checkpoint at step 2, no validation renders, random weights
    (the YAML's pretrained paths are absent from the checkout). Then a
    resume from checkpoint-2 for a third step. On an out-of-memory the peak
    and the allocator's summary are logged and the phase fails."""
    root = os.path.join(_build.BUILD_DIR, "trainer")
    cfg = trainer_config(root, meta)  # the cuts above (train/bench_trainer.py)
    exp = os.path.join(root, str(cfg.exp_name))
    batch = int(cfg.data.train_bs)

    def run(steps: int):
        cfg.solver.max_train_steps = steps
        reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            state = train_stage2_process(cfg, dev)
        except torch.cuda.OutOfMemoryError:
            log(f"trainer at B {batch}: out of memory, peak "
                f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB\n"
                f"{torch.cuda.memory_summary()}")
            raise
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        with open(os.path.join(exp, "metrics.jsonl")) as fh:
            lines = [json.loads(line) for line in fh]
        log(f"trainer to step {steps} at B {batch}: {seconds:.3f} s with the model build and "
            f"the files, peak {peak / 2**30:.3f} GiB; metrics.jsonl (step, loss, grad_norm, "
            f"sec since the loop's start, data wait td): "
            f"{[(r['step'], r['loss'], r['grad_norm'], r['sec'], r['td']) for r in lines]}")
        if state.step != steps or [r["step"] for r in lines] != list(range(steps)):
            raise RuntimeError(f"trainer: step {state.step}, metrics.jsonl steps "
                               f"{[r['step'] for r in lines]}; want {steps}")
        if not all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in lines):
            raise RuntimeError(f"trainer: non-finite loss or grad norm in {lines}")
        if not os.path.isfile(os.path.join(exp, "final_net", "denoising_net.pt")):
            raise RuntimeError("trainer: no final_net/ export")
        return state, launch_counts(), seconds, peak, lines

    state, counts, seconds, peak, lines = run(2)
    step_s = [lines[0]["sec"]] + [b["sec"] - a["sec"] for a, b in zip(lines, lines[1:])]
    log(f"trainer at B {batch}: seconds per step {[round(x, 3) for x in step_s]} (the first "
        f"with its data wait), data wait per step {[r['td'] for r in lines]}, peak "
        f"{peak / 2**30:.3f} GiB")
    per_step = {k: counts[k] / 2 for k in ("flash_fwd_packed", "flash_bwd_dkv", "flash_bwd_dq",
                                           "temporal_attn", "flash_fwd")}
    log(f"kernel launches per trainer step at B {batch}: {per_step}")
    for name, n in per_step.items():
        if n <= 0:
            raise RuntimeError(f"kernel {name} was not launched by the trainer")
    if not os.path.isfile(os.path.join(exp, "checkpoint-2", "train_state.pt")):
        raise RuntimeError("trainer: no checkpoint-2 after 2 steps")
    masters = {k: v.cpu() for k, v in state.params.items()}
    del state
    torch.cuda.empty_cache()
    resumed, _, resume_s, _, _ = run(3)
    same = [k for k, v in resumed.params.items() if torch.equal(v.cpu(), masters[k])]
    if resumed.params.keys() != masters.keys() or same:
        raise RuntimeError(f"trainer resume: {len(same)} trainable tensors did not move in "
                           f"step 3: {same[:5]}")
    log(f"trainer resumed from checkpoint-2: step 3 moved all {len(masters)} trainable tensors")
    del resumed
    shutil.rmtree(root)
    torch.cuda.empty_cache()
    return dict(counts=counts, seconds=seconds, resume_seconds=resume_s, peak=peak,
                step_seconds=step_s, data_wait=[r["td"] for r in lines])


# -- stage 1, the static pipeline, several identities ------------------------
STAGE1_2D = dict(use_motion_module=False, use_audio_module=False)


def phase_batch2(models: HalloModels, steps: int = 4, size: int = 512, clip: int = 16) -> dict:
    """Long-form with several identities (BASELINE.json config 4): one clip
    of 16 + 2 frames at 512^2 for 2 identities at once (distinct references,
    embeddings and regions; shared audio), DDIM at `steps`: seconds of a warm
    clip and peak memory."""
    pipe = FaceAnimatePipeline(models, num_inference_steps=steps, clip_length=clip,
                               n_motion_frames=2)
    inputs = dummy_clip_inputs(models, size, size, clip, batch=2, seed=3)
    pipe(**inputs, seed=0)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    video = pipe(**inputs, seed=1)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    log(f"B 2 clip at {size}^2, {steps} DDIM steps: {seconds:.4f} s (warm), "
        f"{2 * clip / seconds:.3f} frames/s over both identities, peak {peak / 2**30:.3f} GiB")
    if video.shape != (2, clip, size, size, 3) or not np.isfinite(video).all():
        raise RuntimeError(f"B 2 clip: video {video.shape}, finite {np.isfinite(video).all()}")
    if not np.abs(video[0] - video[1]).mean() > 0:
        raise RuntimeError("B 2 clip: the two identities gave the same video")
    return dict(seconds=seconds, peak=peak)


def phase_static(dev, scale: str = "full", size: int = 512, steps: int = 40,
                 small: int = 64, profile_out: str = "") -> dict:
    """`StaticPipeline` (BASELINE.json config 2, scripts/bench_static.py's
    configuration): the full-width 2D models in bf16 (no motion or audio
    modules, no inflated GroupNorm), one `size`^2 image with `steps`-step
    DDIM and CFG at B 1: seconds a warm image, peak memory, K1's and K4's
    launches (with `profile_out`, one more image under torch.profiler,
    written there). Then the card against the same weights on the CPU in
    fp32 at `small`^2, DDIM at 8 steps from the same noise (`STATIC_RTOL` on
    the final latents), with a planted fault that must exceed it."""
    models = build_models(scale, device=dev, dtype=torch.bfloat16, seed=0,
                          unet_overrides=STATIC_2D)
    pipe = StaticPipeline(models, num_inference_steps=steps)
    ip = models.image_proj.config
    rng = np.random.default_rng(4)
    ref = rng.uniform(-1, 1, (1, size, size, 3)).astype(np.float32)
    emb = rng.normal(size=(1, ip.clip_embeddings_dim)).astype(np.float32)
    region = np.ones((1, size, size, 3), np.float32)
    pipe(ref, emb, region, seed=0)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    seconds = []
    for i in range(2):
        reset_counts()
        t0 = time.perf_counter()
        img = pipe(ref, emb, region, seed=i + 1)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"static: {size}^2, {steps}-step DDIM, B 1, bf16: seconds an image (warm) "
        f"{[round(s, 4) for s in seconds]}, peak {peak / 2**30:.3f} GiB; launches an image: "
        f"K1 {counts['flash_fwd_packed']}, K4 {counts['flash_fwd']}")
    if img.shape != (1, size, size, 3) or not np.isfinite(img).all() or not img.std() > 0:
        raise RuntimeError(f"static: image {img.shape}, std {img.std()}")
    for name in ("flash_fwd_packed", "flash_fwd"):
        if counts[name] <= 0:
            raise RuntimeError(f"kernel {name} was not launched by the static pipeline")
    if profile_out:
        profile_call("static image", lambda: pipe(ref, emb, region, seed=3), profile_out)

    cpu = on_cpu_fp32(models, scale, **STATIC_2D)
    gen = torch.Generator().manual_seed(5)
    call = (torch.rand(1, small, small, 3, generator=gen) * 2 - 1,
            torch.randn(1, 1, small // 8, small // 8, 4, generator=gen),
            torch.randn(1, ip.clip_embeddings_dim, generator=gen),
            (torch.rand(1, small, small, 3, generator=gen) > 0.5).float())

    def final(m, device, sampler="ddim"):
        return StaticPipeline(m, num_inference_steps=8, sampler=sampler).denoise(
            *(x.to(device) for x in call)).cpu()

    got = final(models, dev)
    want = final(cpu, torch.device("cpu"))
    err = rel_err(got, want)
    fault = rel_err(final(cpu, torch.device("cpu"), sampler="unipc"), want)
    log(f"static vs CPU fp32 at {small}x{small}, DDIM 8: final latents rel_err {err:.3e} "
        f"(rtol {STATIC_RTOL}); planted fault, UniPC's update in place of DDIM's: {fault:.3e}")
    if not err <= STATIC_RTOL:
        raise RuntimeError(f"static: the card disagrees with the CPU fp32 reference ({err})")
    if not fault > STATIC_RTOL:
        raise RuntimeError(f"static: the check misses the planted fault ({fault})")
    del models, cpu, pipe
    torch.cuda.empty_cache()
    return dict(seconds=seconds, peak=peak, counts=counts, rel_err=err, fault=fault)


def stage1_batch(b: int, size: int, emb_dim: int, seed: int, fixed: bool) -> dict:
    """A synthetic stage-1 batch of `b` single frames (numpy, the JAX
    layouts); with `fixed`, its noise and timesteps too."""
    rng = np.random.default_rng(seed)
    batch = dict(
        pixel_values=rng.uniform(-1, 1, (b, 1, size, size, 3)).astype(np.float32),
        ref_pixels=rng.uniform(-1, 1, (b, size, size, 3)).astype(np.float32),
        face_emb=rng.normal(size=(b, emb_dim)).astype(np.float32),
        face_region=(rng.uniform(size=(b, size, size, 3)) > 0.3).astype(np.float32),
    )
    if fixed:
        batch.update(noise=rng.normal(size=(b, 1, size // 8, size // 8, 4)).astype(np.float32),
                     timesteps=np.linspace(50, 950, b).astype(np.int64))
    return batch


def stage1_steps(dev, scale: str, size: int, batch: int, remat: bool,
                 profile_out: str = "") -> dict:
    """1 + 3 stage-1 train steps (stage1.yaml's settings: AdamW in fp32,
    warm-up 1, uncond_ratio 0.1, bf16) on one synthetic batch; seconds a
    step, peak memory, the launches a step; with `profile_out`, one more
    step under torch.profiler, written there."""
    models = build_models(scale, device=dev, dtype=torch.bfloat16, seed=0, remat=remat,
                          unet_overrides=STAGE1_2D)
    trainable = unfreeze(models.modules(), stage1_trainable)
    opt = AdamW(OptimizerConfig(learning_rate=1e-5, lr_warmup_steps=1))
    state = TrainState.create(trainable, opt)
    step = make_train_step(models, trainable, opt, TrainConfig(
        stage=1, uncond_img_ratio=0.1, uncond_audio_ratio=0.0, uncond_ia_ratio=0.0,
        start_ratio=0.0))
    data = stage1_batch(batch, size, models.image_proj.config.clip_embeddings_dim, 0, False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, m = step(state, data, step_generator(0, 0, dev))
    torch.cuda.synchronize()
    log(f"stage-1 warm-up step: {time.perf_counter() - t0:.3f} s, loss {m['loss']:.5f} "
        f"grad_norm {m['grad_norm']:.5f}")
    reset_counts()
    seconds, metrics = [], []
    for i in range(1, 4):
        t0 = time.perf_counter()
        state, m = step(state, data, step_generator(0, i, dev))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        metrics.append(m)
        if m["skipped"] or not (np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])):
            raise RuntimeError(f"stage-1 step {i}: non-finite loss or gradients ({m})")
    per_step = {k: v / 3 for k, v in launch_counts().items()}
    if profile_out:
        profile_call("stage-1 step", lambda: step(state, data, step_generator(0, 4, dev)),
                     profile_out)
    return dict(seconds=seconds, peak=torch.cuda.max_memory_allocated(), per_step=per_step,
                metrics=metrics, n_train=sum(p.numel() for p in trainable.values()))


def stage1_loss_and_grads(models: HalloModels, batch: dict) -> tuple:
    """One stage-1 loss (no dropout) and each trained module's flattened
    fp32 gradient, on the CPU."""
    trainable = unfreeze(models.modules(), stage1_trainable)
    cfg = TrainConfig(stage=1, uncond_img_ratio=0.0, uncond_audio_ratio=0.0,
                      uncond_ia_ratio=0.0, start_ratio=0.0)
    loss = make_loss_fn(models, cfg)(batch, torch.Generator(device=models.device))
    grads = torch.autograd.grad(loss, list(trainable.values()), allow_unused=True)
    groups: dict = {}
    for name, p, g in zip(trainable, trainable.values(), grads):
        g = torch.zeros_like(p) if g is None else g
        groups.setdefault(name.split(".", 1)[0], []).append(g.float().flatten().cpu())
    return loss.item(), {k: torch.cat(v) for k, v in groups.items()}


def phase_stage1(dev, scale: str = "full", size: int = 512, small: int = 64,
                 profile_out: str = "") -> dict:
    """The stage-1 step at configs/train/stage1.yaml's full width: 512^2,
    train_bs 8, no gradient checkpointing, bf16, AdamW in fp32. If it runs
    out of memory: its peak is logged, then the denoiser's per-block
    checkpointing (the YAML's `gradient_checkpointing: true`), then halved
    batches (with `profile_out`, one more step under torch.profiler). Then
    one step's loss and each module's gradient in fp32 on the card against
    the CPU at `small`^2, with a planted backward fault."""
    cfg = load_config(STAGE1_YAML)
    batch, remat = int(cfg.data.train_bs), bool(cfg.solver.gradient_checkpointing)
    tried = []
    while True:
        oom = None
        try:
            run = stage1_steps(dev, scale, size, batch, remat, profile_out)
        except torch.cuda.OutOfMemoryError as exc:
            oom = str(exc).splitlines()[0]
        if oom is None:
            break
        peak = torch.cuda.max_memory_allocated()
        tried.append(dict(batch=batch, remat=remat, peak=peak))
        log(f"stage-1 step at B {batch}, checkpointing {remat}: out of memory, peak "
            f"{peak / 2**30:.3f} GiB ({oom})")
        gc.collect()
        torch.cuda.empty_cache()
        if not remat:
            remat = True
        elif batch > 1:
            batch //= 2
        else:
            raise RuntimeError("stage-1 step: out of memory at B 1 with checkpointing")
    seconds = run["seconds"]
    log(f"stage-1 step at {size}^2, B {batch}, checkpointing {remat}, bf16, AdamW fp32, "
        f"{run['n_train']} trained parameters: seconds per step "
        f"{[round(s, 4) for s in seconds]}, median {float(np.median(seconds)):.4f}; peak "
        f"{run['peak'] / 2**30:.3f} GiB; losses {[round(m['loss'], 5) for m in run['metrics']]}, "
        f"grad norms {[round(m['grad_norm'], 5) for m in run['metrics']]}")
    log(f"kernel launches per stage-1 step: {run['per_step']}")
    for name in ("flash_fwd_packed", "flash_bwd_dkv", "flash_bwd_dq", "flash_fwd"):
        if run["per_step"][name] <= 0:
            raise RuntimeError(f"kernel {name} was not launched by the stage-1 step")
    gc.collect()
    torch.cuda.empty_cache()

    # The card in fp32 against the CPU at `small`^2, B 2: every trainable
    # tensor perturbed first, so that no zero-initialised layer (the face
    # locator's conv_out) hides the gradient before it.
    models = build_models(scale, device=dev, dtype=torch.float32, seed=0,
                          unet_overrides=STAGE1_2D)
    gen = torch.Generator(device=dev).manual_seed(2)
    with torch.no_grad():
        for p in unfreeze(models.modules(), stage1_trainable).values():
            p.add_(0.02 * torch.randn(p.shape, generator=gen, device=dev).to(p.dtype))
    data = stage1_batch(2, small, models.image_proj.config.clip_embeddings_dim, 1, True)
    card_loss, card_grads = stage1_loss_and_grads(models, data)
    cpu = on_cpu_fp32(models, scale, **STAGE1_2D)
    cpu_loss, cpu_grads = stage1_loss_and_grads(cpu, data)
    loss_err = abs(card_loss - cpu_loss) / abs(cpu_loss)
    errs = {k: rel_err(card_grads[k], cpu_grads[k]) for k in cpu_grads}
    log(f"stage-1 step in fp32, card vs CPU at {small}x{small}, B 2: loss {card_loss:.6f} vs "
        f"{cpu_loss:.6f} (rel {loss_err:.3e}); gradient rel_err by module "
        f"{ {k: float(f'{e:.3e}') for k, e in errs.items()} } (rtol {STAGE1_RTOL})")
    if not (loss_err <= STAGE1_RTOL and max(errs.values()) <= STAGE1_RTOL):
        raise RuntimeError(f"the stage-1 step on the card disagrees with the CPU "
                           f"(loss {loss_err}, gradients {errs})")
    real = flash.flash_bwd_dkv
    flash.flash_bwd_dkv = lambda a: tuple(
        torch.zeros(t.shape, dtype=a.dtype, device=t.device) for t in (a.k, a.v))
    try:
        _, fault_grads = stage1_loss_and_grads(models, data)
    finally:
        flash.flash_bwd_dkv = real
    fault = rel_err(fault_grads["reference_net"], cpu_grads["reference_net"])
    log(f"planted fault, K5's dK/dV zeroed: the ReferenceNet's gradient rel_err {fault:.3e}")
    if not fault > STAGE1_RTOL:
        raise RuntimeError(f"the stage-1 check misses a zeroed dK/dV ({fault})")
    del models, cpu
    gc.collect()
    torch.cuda.empty_cache()
    return dict(batch=batch, remat=remat, tried=tried, seconds=seconds, peak=run["peak"],
                per_step=run["per_step"], loss_err=loss_err, grad_errs=errs, fault=fault)


@contextlib.contextmanager
def timed_checkpoints(out: dict):
    """Wall seconds of every `save_train_state` and `load_train_state` call
    (each ends with its files written or its tensors on the card) while the
    block runs, into out["save"] and out["load"]."""
    saved = ckpt.save_train_state, ckpt.load_train_state

    def timed(kind, fn):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = fn(*args, **kwargs)
            torch.cuda.synchronize()
            out.setdefault(kind, []).append(time.perf_counter() - t0)
            return result
        return call

    ckpt.save_train_state = timed("save", saved[0])
    ckpt.load_train_state = timed("load", saved[1])
    try:
        yield out
    finally:
        ckpt.save_train_state, ckpt.load_train_state = saved


def phase_trainer1(dev, pretrained: str, batch: int, remat: bool) -> dict:
    """`train_stage1_process` (python -m hallo_tpu_torch.train.stage1) on
    configs/train/stage1.yaml at 512^2 with the 8-bit AdamW, at the batch
    and checkpointing `phase_stage1` ran (the YAML's, or its cut), reading
    the synthetic SD-1.5 UNet and VAE under `pretrained`, on a synthetic
    40-frame clip in `data/datasets.py`'s .npz layout: 2 steps with
    checkpoint-2, then a resume to step 4 with a validation still and the
    four exports, held bit for bit against an unbroken 4-step run; then
    `train_stage2_process` with `stage1_ckpt_dir` there takes a step. The
    checkpoint write and read are timed; the files are removed after."""
    root = os.path.join(_build.BUILD_DIR, "trainer1")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    free = shutil.disk_usage(root).free
    log(f"trainer1: {free / 1e9:.1f} GB free under {root}")
    cfg = load_config(STAGE1_YAML)
    cfg.data.train_bs = batch
    cfg.solver.gradient_checkpointing = remat
    cfg.solver.use_8bit_adam = True
    cfg.data.meta_paths = [write_trainer_clip(os.path.join(root, "data"), 40,
                                              int(cfg.data.train_width), seed=4)]
    cfg.base_model_path = os.path.join(pretrained, "stable-diffusion-v1-5")
    cfg.vae_model_path = os.path.join(pretrained, "sd-vae-ft-mse")
    cfg.output_dir, cfg.log_every, cfg.checkpointing_steps = root, 1, 2
    cfg.total_limit = 1
    cfg.val.validation_steps = 4

    def run(name: str, steps: int, **changes):
        c = cfglib.DotDict.wrap(json.loads(json.dumps(cfg)))
        c.exp_name = name
        c.solver.max_train_steps = steps
        c.update(changes)
        reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state = train_stage1_process(c, dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        with open(os.path.join(root, name, "metrics.jsonl")) as fh:
            lines = [json.loads(line) for line in fh]
        log(f"trainer1 {name} to step {steps}: {seconds:.3f} s with the build, the load and "
            f"the files, peak {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; "
            f"(step, loss, grad_norm, sec): "
            f"{[(r['step'], r['loss'], r['grad_norm'], r['sec']) for r in lines]}")
        if not all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in lines):
            raise RuntimeError(f"trainer1: non-finite loss or grad norm in {lines}")
        masters = {k: v.cpu() for k, v in state.params.items()}
        del state
        torch.cuda.empty_cache()
        return masters, launch_counts(), seconds

    times: dict = {}
    with timed_checkpoints(times):
        _, counts, first_s = run("stage1", 2)
        exp = os.path.join(root, "stage1")
        if not os.path.isfile(os.path.join(exp, "checkpoint-2", "train_state.pt")):
            raise RuntimeError("trainer1: no checkpoint-2 after 2 steps")
        ckpt_bytes = os.path.getsize(os.path.join(exp, "checkpoint-2", "train_state.pt"))
        # the resume writes no checkpoint of its own: checkpoint-2 is the one timed
        resumed, _, resume_s = run("stage1", 4, checkpointing_steps=100)
    log(f"trainer1 launches in the first 2 steps: {counts}")
    for name in ("flash_fwd_packed", "flash_bwd_dkv", "flash_bwd_dq", "flash_fwd"):
        if counts[name] <= 0:
            raise RuntimeError(f"kernel {name} was not launched by the stage-1 trainer")
    log(f"trainer1 checkpoint: {ckpt_bytes / 1e9:.3f} GB (8-bit AdamW); written in "
        f"{times['save'][0]:.3f} s, read into the card in {times['load'][0]:.3f} s")
    shutil.rmtree(os.path.join(exp, "checkpoint-2"))
    stills = sorted(os.listdir(os.path.join(exp, "validation")))
    if stills != ["step4_sample0.png"]:
        raise RuntimeError(f"trainer1: validation stills {stills}")
    still = cv2.imread(os.path.join(exp, "validation", stills[0]))
    log(f"trainer1 validation still: {still.shape}, std {still.std():.2f}")
    size = int(cfg.data.train_width)
    if still.shape != (size, size, 3) or not still.std() > 0:
        raise RuntimeError("trainer1: the validation still is empty")
    straight, _, straight_s = run("straight", 4, checkpointing_steps=100, val=dict(
        validation_steps=0))
    diff = [k for k, v in straight.items() if not torch.equal(resumed[k], v)]
    log(f"trainer1 resume (steps 3-4 after checkpoint-2) against the unbroken 4-step run "
        f"({straight_s:.3f} s): {len(straight) - len(diff)} of {len(straight)} masters equal "
        f"bit for bit")
    if diff or resumed.keys() != straight.keys():
        raise RuntimeError(f"trainer1: the resumed masters differ from the unbroken run's "
                           f"in {len(diff)} tensors: {diff[:5]}")
    shutil.rmtree(os.path.join(root, "straight"))

    # stage 2 from the exports, over the same synthetic pretrained files
    exports = {name: torch.load(os.path.join(exp, f"final_{name}", f"{name}.pt"),
                                map_location="cpu", weights_only=True)
               for name in ("reference_net", "denoising_net", "face_locator", "image_proj")}
    for name, sd in exports.items():
        for key, value in sd.items():
            if f"{name}.{key}" in resumed and not torch.equal(value, resumed[f"{name}.{key}"]):
                raise RuntimeError(f"trainer1: export {name}.{key} is not the master")
    cfg2 = trainer_config(os.path.join(root, "stage2"))
    cfg2.solver.max_train_steps = 1
    cfg2.stage1_ckpt_dir = exp
    cfg2.base_model_path, cfg2.vae_model_path = cfg.base_model_path, cfg.vae_model_path
    cfg2.mm_path = os.path.join(pretrained, "motion_module", "mm_sd_v15_v2.ckpt")
    reset_counts()
    t0 = time.perf_counter()
    state2 = train_stage2_process(cfg2, dev)
    torch.cuda.synchronize()
    stage2_s = time.perf_counter() - t0
    with open(os.path.join(cfg2.output_dir, cfg2.exp_name, "metrics.jsonl")) as fh:
        line = json.loads(fh.readline())
    final = os.path.join(cfg2.output_dir, cfg2.exp_name, "final_net")
    unequal = []
    for name, sd in exports.items():
        got = torch.load(os.path.join(final, f"{name}.pt"), map_location="cpu",
                         weights_only=True)
        unequal += [f"{name}.{k}" for k, v in sd.items()
                    if not torch.equal(got[k], v.to(got[k].dtype))]
    log(f"stage 2 from the stage-1 exports: {stage2_s:.3f} s, step {state2.step}, loss "
        f"{line['loss']:.5f}, grad_norm {line['grad_norm']:.5f}; "
        f"{sum(len(sd) for sd in exports.values()) - len(unequal)} exported tensors held bit "
        f"for bit (in bf16) by the stage-2 models")
    if unequal or state2.step != 1 or not (np.isfinite(line["loss"])
                                           and np.isfinite(line["grad_norm"])):
        raise RuntimeError(f"stage 2 from the stage-1 exports: {len(unequal)} tensors differ "
                           f"({unequal[:5]}), step {state2.step}, {line}")
    del state2, resumed, straight, exports
    shutil.rmtree(root)
    torch.cuda.empty_cache()
    return dict(counts=counts, first_s=first_s, resume_s=resume_s, straight_s=straight_s,
                stage2_s=stage2_s, ckpt_bytes=ckpt_bytes, **times)


def write_pretrained(dev) -> tuple:
    """The synthetic `pretrained_models/` files (the inventories' keys and
    shapes, fp16 values from a seed per file) that the stage-1 trainer and
    the CLI read, written once; `CLI_KEEP`'s values kept for the checks."""
    root = os.path.join(_build.BUILD_DIR, "cli", "pretrained_models")
    t0 = time.perf_counter()
    paths, kept = synthetic.write_pretrained_layout(root, device=dev, keep=CLI_KEEP)
    write_s = time.perf_counter() - t0
    sizes = {name: os.path.getsize(p) for name, p in paths.items()}
    log(f"synthetic pretrained_models/ (fp16): {sum(sizes.values()) / 1e9:.3f} GB written in "
        f"{write_s:.1f} s: " + ", ".join(f"{k} {v / 1e9:.3f} GB" for k, v in sizes.items()))
    return root, paths, kept, write_s


def phase_card_checks() -> None:
    """`CARD_CHECKS`, run by pytest in a process of its own (it loads the
    kernels built above); fails unless all of them pass."""
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "tests/test_torch_kernels.py", "-m", "gpu", "-q",
         "--noconftest", "-p", "no:cacheprovider", "-k", CARD_CHECKS],
        cwd=REPO, capture_output=True, text=True)
    tail = (out.stdout + out.stderr).strip().splitlines()[-8:]
    for line in tail:
        log(f"  {line}")
    passed = [line for line in tail if f"{CARD_CHECK_COUNT} passed" in line]
    if out.returncode != 0 or not passed:
        raise RuntimeError(f"card checks (tests/test_torch_kernels.py -k '{CARD_CHECKS}'): "
                           f"rc {out.returncode}, want {CARD_CHECK_COUNT} passed")
    log(f"card checks: {CARD_CHECK_COUNT} passed in {time.perf_counter() - t0:.1f} s "
        "(one pytest process)")


def _seconds_per_call(fn, n: int) -> float:
    fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n


@contextlib.contextmanager
def tf32_fault():
    """The planted precision fault: TF32 on for cuDNN and cuBLAS, and the
    ONNX executor's `fp32_only` made a no-op, while the block runs."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
             onnx_torch.fp32_only)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    onnx_torch.fp32_only = contextlib.nullcontext
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
         onnx_torch.fp32_only) = saved


def phase_onnx(dev) -> dict:
    """The port's ONNX executor on the card against itself on the CPU in
    fp32, on graphs of the four models' published architectures at their
    published depths and widths with seeded weights, written with
    `onnx_io.save_onnx` (`convert/synthetic.py`): SCRFD-10G at det size 640,
    IResNet-100 at 112x112, the MediaPipe face mesh at 192x192 and the
    TFC-TDF U-Net at Kim_Vocal_2's (3072, 256), on 1.jpg and a seeded
    spectrogram; planted faults (a conv weight x1.01, TF32) must fail. Then
    the face analyzer with the three face files and the separator with the
    U-Net on the card, and the identity MDX graph giving back 1.wav."""
    import cv2

    root = os.path.join(_build.BUILD_DIR, "onnx")
    models_dir = os.path.join(root, "face_analysis", "models")
    sizes = {name: {} for name in ("scrfd", "arcface", "mesh", "mdx")}
    paths = dict(
        scrfd=synthetic.scrfd_graph(os.path.join(models_dir, "scrfd_10g_bnkps.onnx"),
                                    stats=sizes["scrfd"]),
        arcface=synthetic.arcface_graph(os.path.join(models_dir, "glintr100.onnx"),
                                        stats=sizes["arcface"]),
        mesh=synthetic.face_mesh_graph(os.path.join(models_dir, "face_landmark_468.onnx"),
                                       stats=sizes["mesh"]),
        mdx=synthetic.mdx_graph(os.path.join(root, "Kim_Vocal_2.onnx"), stats=sizes["mdx"]),
    )
    img = load_image_rgb(IMAGE)
    det_card = ScrfdTorch(paths["scrfd"], device=dev)
    det_cpu = ScrfdTorch(paths["scrfd"], device="cpu")
    boxes, kps = det_card.detect(img)
    want_boxes, want_kps = det_cpu.detect(img)
    log(f"SCRFD-10G at 640 on 1.jpg: {len(boxes)} detections on the card, "
        f"{len(want_boxes)} on the CPU")
    if len(boxes) < 1 or boxes.shape != want_boxes.shape or not (
            np.allclose(boxes[:, :4], want_boxes[:, :4], atol=DETECTION_ATOL, rtol=0)
            and np.allclose(kps, want_kps, atol=DETECTION_ATOL, rtol=0)):
        raise RuntimeError("detections on the card differ from the CPU's")

    # graph inputs: the detector's letterboxed blob, the aligned crop of the
    # top detection, the mesh's 192x192 crop, one spectrogram segment
    scale = min(640 / img.shape[1], 640 / img.shape[0])
    canvas = np.zeros((640, 640, 3), np.uint8)
    nw, nh = int(round(img.shape[1] * scale)), int(round(img.shape[0] * scale))
    canvas[:nh, :nw] = cv2.resize(img, (nw, nh))
    crop = norm_crop(img, want_kps[0])
    rng = np.random.default_rng(0)
    feeds = dict(
        scrfd=((canvas.astype(np.float32) - 127.5) / 128.0).transpose(2, 0, 1)[None],
        arcface=((crop.astype(np.float32) - 127.5) / 127.5).transpose(2, 0, 1)[None],
        mesh=(cv2.resize(img, (192, 192)).astype(np.float32) / 255.0).transpose(2, 0, 1)[None],
        mdx=rng.normal(size=(1, 4) + synthetic.KIM_VOCAL_2_DIMS).astype(np.float32),
    )
    out = dict(seconds={}, sizes=sizes)
    for name, path in paths.items():
        card, cpu = OnnxExecutor(path, device=dev), OnnxExecutor(path, device="cpu")
        feed = {card.input_names[0]: feeds[name]}
        got, want = card(feed), cpu(feed)

        def err_of(outs):
            return max(rel_err(outs[k].cpu().numpy(), want[k].numpy()) for k in want)

        err = err_of(got)
        card_s = _seconds_per_call(lambda: card(feed), 10)
        t0 = time.perf_counter()
        cpu(feed)
        cpu_s = time.perf_counter() - t0
        with tf32_fault():
            tf32_err = err_of(card(feed))
            tf32_s = _seconds_per_call(lambda: card(feed), 10)
        out["seconds"][name] = card_s
        log(f"onnx {name}: {len(card.graph.nodes)} nodes, {sizes[name]['params'] / 1e6:.3f} M "
            f"parameters, {sizes[name]['macs'] / 1e9:.3f} G multiply-adds, {len(want)} outputs, "
            f"rel_err {err:.3e} (rtol {ONNX_RTOL}), card {card_s * 1e3:.3f} ms a call "
            f"(fp32), CPU {cpu_s * 1e3:.1f} ms; with TF32: rel_err {tf32_err:.3e}, "
            f"{tf32_s * 1e3:.3f} ms a call")
        if not err <= ONNX_RTOL:
            raise RuntimeError(f"onnx {name}: the card disagrees with the CPU ({err})")
        if name in ONNX_TF32_MUST_FAIL and not tf32_err > ONNX_RTOL:
            raise RuntimeError(f"onnx {name}: the check misses a TF32 run ({tf32_err})")
        if name == "arcface":  # the planted fault, on the card's side only
            w = card.graph.nodes[0].inputs[1]
            faulty = dict(card.params, **{w: card.params[w] * ONNX_FAULT_SCALE})
            fault = err_of(card.run(faulty, feed))
            log(f"  planted fault, the first conv's weight x {ONNX_FAULT_SCALE} on the card: "
                f"rel_err {fault:.3e}")
            if not fault > ONNX_RTOL:
                raise RuntimeError(f"the onnx check misses a conv weight off by 1% ({fault})")
        del card, cpu
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    analyzer = FaceAnalyzer(os.path.join(root, "face_analysis"), device=dev)
    face_mask, lip_mask, face = analyzer.face_and_lip_masks(img, 1.2)
    torch.cuda.synchronize()
    log(f"FaceAnalyzer on the card: backend {analyzer.backend}, landmarks "
        f"{None if face.landmarks is None else face.landmarks.shape}, face mask "
        f"{int((face_mask > 0).sum())} px, lip mask {int((lip_mask > 0).sum())} px, "
        f"{time.perf_counter() - t0:.3f} s with the load")
    if analyzer.backend != "onnx-torch" or face.landmarks is None or not lip_mask.any():
        raise RuntimeError("the face analyzer did not take the three ONNX files")

    data, sr = load_wav(WAV)
    sep = MdxSeparator(paths["mdx"], device=dev)
    vocals = sep.separate(data, sr)
    runs = sep.calls
    sep_s = _seconds_per_call(lambda: sep.separate(data, sr), 3)
    want = MdxSeparator(paths["mdx"], device="cpu").separate(data, sr)
    err = rel_err(vocals, want)
    with tf32_fault():
        tf32_err = rel_err(sep.separate(data, sr), want)
    log(f"MDX U-Net separator on 1.wav ({len(data) / sr:.2f} s): {runs} graph runs a call, "
        f"rel_err {err:.3e} against the CPU (rtol {SEPARATOR_RTOL}; with TF32 "
        f"{tf32_err:.3e}), {sep_s:.3f} s a call on the card")
    if vocals.shape != want.shape or not err <= SEPARATOR_RTOL:
        raise RuntimeError(f"the separator on the card disagrees with the CPU ({err})")
    if not tf32_err > SEPARATOR_RTOL:
        raise RuntimeError(f"the separator check misses a TF32 run ({tf32_err})")
    out["seconds"]["separate_1wav"] = sep_s

    sep = MdxSeparator(synthetic.identity_mdx_graph(os.path.join(root, "identity.onnx")),
                       device=dev)
    vocals = sep.separate(data, sr)
    n = min(len(vocals), len(data))
    err = rel_err(vocals[:n], data[:n])
    log(f"identity MDX at {synthetic.KIM_VOCAL_2_DIMS} on 1.wav: {len(vocals)} samples back, "
        f"rel_err {err:.3e} against 1.wav (rtol {SEPARATOR_ROUND_TRIP_RTOL})")
    if abs(len(vocals) - len(data)) > 4 or not err <= SEPARATOR_ROUND_TRIP_RTOL:
        raise RuntimeError(f"the identity separator did not give back 1.wav ({err})")
    shutil.rmtree(root)
    return out


def phase_cli(dev, pretrained: tuple) -> dict:
    """The product's entry point, `hallo_tpu_torch.inference.inference_process`
    (python -m hallo_tpu_torch.inference), at full width on 1.jpg and 1.wav
    with `--profile turbo`, bf16, 512^2 and without `--allow-partial`, over
    synthetic checkpoint files in the reference's `pretrained_models/` layout
    (`write_pretrained`'s, which the stage-1 trainer read before) with the
    TFC-TDF U-Net at Kim_Vocal_2's dims as the vocal separator. Then the planted
    fault: a VAE file with its keys renamed must make the CLI raise before
    generation. The files are removed afterwards."""
    import yaml

    pm, paths, kept, write_s = pretrained  # `write_pretrained`'s files
    root = os.path.dirname(pm)
    keep = CLI_KEEP
    separator = synthetic.mdx_graph(os.path.join(pm, "audio_separator", "Kim_Vocal_2.onnx"))
    config = json.loads(json.dumps(load_yaml(DEFAULT_YAML)))
    config.update(base_model_path=os.path.join(pm, "stable-diffusion-v1-5"),
                  motion_module_path=paths["animatediff_mm"],
                  audio_ckpt_dir=os.path.dirname(paths["net_pth"]),
                  source_image=IMAGE, driving_audio=WAV)
    config["vae"]["model_path"] = os.path.join(pm, "sd-vae-ft-mse")
    config["wav2vec"]["model_path"] = os.path.dirname(paths["wav2vec2"])
    config["audio_separator"]["model_path"] = separator
    config["face_analysis"]["model_path"] = os.path.join(pm, "face_analysis")  # absent
    config_path = os.path.join(root, "inference.yaml")
    with open(config_path, "w") as fh:
        yaml.safe_dump(config, fh)
    out_path, timing_path = os.path.join(root, "out.mp4"), os.path.join(root, "timing.json")
    args = inference.build_parser().parse_args(
        ["-c", config_path, "--profile", "turbo", "--output", out_path,
         "--timing_json", timing_path])

    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run = inference.inference_process(args)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    counts = launch_counts()
    with open(timing_path) as fh:
        timing = json.load(fh)
    log(f"CLI (turbo, bf16, 512^2, 1.wav): {cli_s:.3f} s, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; timing.json {json.dumps(timing)}")
    log(f"kernel launches in the CLI run: {counts}")

    loaded = run.loaded
    for name, report in loaded.reports.items():
        n = len(getattr(loaded.models, name).state_dict())
        log(f"  load {name}: loaded {len(report['loaded'])}/{n}, mismatched "
            f"{len(report['shape_mismatch'])}, unused {len(report['unused_ckpt'])}, "
            f"unmapped {len(report['unmapped_ckpt_keys'])}")
        if len(report["loaded"]) != n or report["shape_mismatch"]:
            raise RuntimeError(f"CLI: {name} did not load 100% of its tensors")
    if sorted(loaded.reports) != sorted(MODULE_NAMES) or len(
            loaded.wav2vec_report["loaded"]) != 211:
        raise RuntimeError(f"CLI: loaded {sorted(loaded.reports)} and "
                           f"{len(loaded.wav2vec_report['loaded'])} wav2vec2 tensors")
    # each module's named tensors hold the last writer's values in bf16
    checks = [
        ("vae", "encoder.conv_in.weight", "sd_vae_ft_mse", "encoder.conv_in.weight", None),
        ("vae", "decoder.conv_out.bias", "sd_vae_ft_mse", "decoder.conv_out.bias", None),
        ("reference_net", "conv_in.weight", "net_pth", "reference_unet.conv_in.weight",
         ("sd15_unet", "conv_in.weight")),
        ("denoising_net", "conv_in.weight", "net_pth", "denoising_unet.conv_in.weight",
         ("sd15_unet", "conv_in.weight")),
        ("denoising_net", CLI_MOTION_KEY, "net_pth", "denoising_unet." + CLI_MOTION_KEY,
         ("animatediff_mm", CLI_MOTION_KEY)),
        ("face_locator", "conv_in.weight", "net_pth", "face_locator.conv_in.weight", None),
        ("image_proj", "proj.weight", "net_pth", "imageproj.proj.weight", None),
        ("audio_proj", "proj1.weight", "net_pth", "audioproj.proj1.weight", None),
    ]
    for module, key, file, file_key, overwritten in checks:
        got = getattr(loaded.models, module).state_dict()[key].cpu()
        want = kept[file][file_key].to(got.dtype)
        if not torch.equal(got, want):
            raise RuntimeError(f"CLI: {module}.{key} is not {file}'s {file_key} in {got.dtype}")
        if overwritten is not None and torch.equal(got, kept[overwritten[0]][
                overwritten[1]].to(got.dtype)):
            raise RuntimeError(f"CLI: {module}.{key} equals {overwritten[0]}'s: no merge shown")
    w2v_key = keep["wav2vec2"][0]
    if not torch.equal(loaded.audio_proc.model.state_dict()[w2v_key].cpu(),
                       kept["wav2vec2"][w2v_key].float()):
        raise RuntimeError("CLI: wav2vec2's tensors are not the file's")
    log(f"  {len(checks) + 1} named tensors equal the last writer's values bit for bit "
        "(net.pth over SD-1.5 and AnimateDiff)")
    if loaded.audio_proc.separator is None or loaded.audio_proc.separator.calls < 1:
        raise RuntimeError("CLI: the vocal separator did not run")

    frames = np.stack(read_frames(out_path))
    motion = float(frames.astype(np.float32).std(axis=0).mean())
    log(f"  {out_path}: {frames.shape} uint8, mean std over time {motion:.2f} (uint8 units), "
        f"separator runs {loaded.audio_proc.separator.calls}")
    size = config["data"]["source_image"]["width"], config["data"]["source_image"]["height"]
    if frames.shape != (75, size[1], size[0], 3) or not motion > 0.5:
        raise RuntimeError(f"CLI: the video is {frames.shape} with std {motion} over time")
    stages = {"image_preprocess", "init_params", "load_weights", "audio_preprocess",
              "generate", "write_video"}
    if set(timing["stages_s"]) != stages or not timing["seconds_per_1s_output"] > 0 or (
            timing["sampler"], timing["steps"], timing["frames"]) != ("unipc", 8, 75):
        raise RuntimeError(f"CLI: timing.json {timing}")
    for name in ("flash_fwd_packed", "temporal_attn", "flash_fwd_t", "flash_fwd"):
        if counts[name] <= 0:
            raise RuntimeError(f"kernel {name} was not launched by the CLI")
    del run, loaded
    torch.cuda.empty_cache()

    # the planted fault: the VAE's keys renamed
    vae_path = paths["sd_vae_ft_mse"]
    save_file({"encoder_v2." + k: v for k, v in load_file(vae_path).items()}, vae_path)
    os.remove(out_path)
    reset_counts()
    try:
        inference.inference_process(args)
    except RuntimeError as exc:
        if "vae: loaded 0/" not in str(exc):
            raise
        log(f"planted fault, the VAE's keys renamed: RuntimeError before generation "
            f"({str(exc).splitlines()[1].strip()})")
    else:
        raise RuntimeError("CLI: a VAE file with renamed keys did not raise")
    if launch_counts()["temporal_attn"] or os.path.exists(out_path):
        raise RuntimeError("CLI: the renamed VAE raised only after generation began")
    shutil.rmtree(root)
    torch.cuda.empty_cache()
    return dict(counts=counts, timing=timing, seconds=cli_s, write_s=write_s)


# --- the parallel phase ----------------------------------------------------


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def recorded_clip(pipe: FaceAnimatePipeline, inputs: dict) -> dict:
    """One clip through `pipe`: the video, the latents its VAE decoder got
    (this rank's frames), seconds and peak memory."""
    vae, seen = pipe.models.vae, []
    decode = vae.decode

    def recording(z):
        seen.append(z.unflatten(0, (1, -1)).clone())
        return decode(z)

    vae.decode = recording
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        video = pipe(**inputs, seed=0)
    finally:
        del vae.decode
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return dict(video=video, latents=seen[0], seconds=seconds,
                peak=torch.cuda.max_memory_allocated())


def captured_step(models: HalloModels, trainable: dict, mesh, batch: dict,
                  steps: int = 2, tp=None, profiled: bool = False) -> dict:
    """`steps` stage-2 steps (phase 6's: AdamW at lr 1e-5, a one-step
    warm-up, TrainConfig's dropouts drawn from the step generator) from the
    models' weights, through ZeRO with a mesh: the first step's loss and
    whole gradient (fp32, captured for the check), the masters after the
    last step (the warm-up's first update moves no weight), both moved to
    the host so that they hold no device memory in the next run, each
    step's seconds, and the peak memory and the launches a step of each
    kernel and collective of the steps after the first (nothing captured
    there).
    `tp`: the tensor-parallel plan the models
    were sharded by (gradients and masters gathered whole). With
    `profiled`, one more step after those under torch.profiler: its wall
    and device busy ms, and the device ms and launches of NCCL's kernels."""
    opt = AdamW(OptimizerConfig(learning_rate=1e-5, lr_warmup_steps=1))
    captured = {}
    if mesh is None:
        state = TrainState.create(trainable, opt)
        update = opt.update

        def capture(grads, opt_state, params, **kw):
            if "grads" not in captured:  # the first step's alone
                captured["grads"] = {k: g.float().cpu() for k, g in grads.items()}
            update(grads, opt_state, params, **kw)

        opt.update = capture
    else:
        zero = Zero(mesh, trainable, opt, tp=tp)
        state = zero.create(trainable)
        update = zero.update

        def capture(state_, shard):
            if "grads" not in captured:
                captured["grads"] = {k: g.cpu() for k, g in zero.gather_leaves(shard).items()}
            update(state_, shard)

        zero.update = capture
    step = make_train_step(models, trainable, opt, TrainConfig(), mesh=mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    seconds, first = [], None
    def counts():
        return dict(launch_counts(), **{f"collective {k}": v
                                        for k, v in collectives.LAUNCHES.items()})

    for i in range(steps):
        t0 = time.perf_counter()
        state, m = step(state, batch, step_generator(0, i, models.device))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        if m["skipped"]:
            raise RuntimeError(f"parallel phase: step {i} skipped ({m})")
        if i == 0:
            first = dict(loss=m["loss"], grad_norm=m["grad_norm"], grads=captured["grads"])
            torch.cuda.reset_peak_memory_stats()
            before = counts()
    peak = torch.cuda.max_memory_allocated()
    launches = {k: (v - before[k]) / max(1, steps - 1) for k, v in counts().items()
                if v > before[k]}
    masters = state.state_dict()["params"] if mesh is not None else state.params
    out = dict(first, masters={k: v.to("cpu", copy=True) for k, v in masters.items()},
               seconds=seconds, peak=peak, launches=launches)
    if profiled:
        from torch.profiler import ProfilerActivity, profile

        # the host's activity too: with the device's alone NCCL's kernels went
        # unseen; the CPU's alone on a rehearsal
        activities = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if models.device.type == "cuda" else [])
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            step(state, batch, step_generator(0, steps, models.device))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows = [(getattr(e, "self_device_time_total", None) or e.self_cuda_time_total, e.count,
                 e.key) for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
        nccl = [r for r in rows if "nccl" in r[2].lower()]
        out["profile"] = dict(wall_ms=wall * 1e3, busy_ms=sum(r[0] for r in rows) / 1e3,
                              nccl_ms=sum(r[0] for r in nccl) / 1e3,
                              nccl_launches=sum(r[1] for r in nccl))
    return out


def rows_and_frames(batch: dict, mesh) -> dict:
    """This rank's rows of a global stage-2 batch and its frames of them."""
    n, d = batch["face_emb"].shape[0] // mesh.n_data, mesh.data_index
    f = batch["pixel_values"].shape[1] // mesh.n_seq
    frames = slice(mesh.seq_index * f, (mesh.seq_index + 1) * f)
    out = {}
    for k, v in batch.items():
        if k == "masks":
            out[k] = tuple(tuple(x[d * n:(d + 1) * n] for x in lvl) for lvl in v)
        elif k in ("pixel_values", "audio_windows"):
            out[k] = v[d * n:(d + 1) * n, frames]
        else:
            out[k] = v[d * n:(d + 1) * n]
    return out


def step_errors(got: dict, want: dict) -> tuple:
    """(loss, gradient, masters) relative errors of two `captured_step`s:
    each the relative L2 error over every trainable leaf, its sums taken
    leaf by leaf on the host (no whole flat copy)."""
    names = list(want["grads"])

    def rel(part: str) -> float:
        num = den = 0.0
        for k in names:
            w = want[part][k].float()
            num += (got[part][k].float() - w).square().sum().item()
            den += w.square().sum().item()
        return math.sqrt(num / den)

    return (abs(got["loss"] - want["loss"]) / abs(want["loss"]), rel("grads"), rel("masters"))


# The parallel phase's sizes: the full-width models, phase 4's clip and
# phase 6's step, and the smaller size of the comparisons at 2 cards or more
PARALLEL_SHAPES = dict(scale="full", clip=16, size=512, train_frames=14, small_size=256)


def parallel_checks(rank: int, world: int, dev, inputs: dict, steps: int,
                    shapes: dict) -> dict:
    """The parallel phase's work in one rank (see `phase_parallel`); rank 0
    logs the seconds at which each part ended."""
    out = dict(world=world, backend=dist.get_backend())
    t0 = time.monotonic()

    def progress(part: str) -> None:
        if rank == 0:
            log(f"parallel phase, rank 0: {part} at {time.monotonic() - t0:.1f} s")

    models = build_models(shapes["scale"], device=dev, dtype=torch.bfloat16, seed=0,
                          remat=True)
    seq_mesh = make_mesh(n_data=1, n_seq=world)
    data_mesh = seq_mesh if world == 1 else make_mesh(n_data=world, n_seq=1)
    kw = dict(num_inference_steps=steps, clip_length=shapes["clip"], n_motion_frames=2)

    # the clip: the plain pipeline (phase 4's), then the seq path (at one
    # rank forced: its collectives at group size 1)
    plain_pipe = FaceAnimatePipeline(models, **kw)
    seq_pipe = FaceAnimatePipeline(models, mesh=seq_mesh, **kw)
    seq_pipe.seq_group = seq_mesh.seq_group
    plain = recorded_clip(plain_pipe, inputs)
    collectives_before = dict(collectives.LAUNCHES)
    seq = recorded_clip(seq_pipe, inputs)
    out["clip_collectives"] = {k: v - collectives_before[k]
                               for k, v in collectives.LAUNCHES.items()}
    seq["latents"] = collectives.all_gather(seq["latents"], seq_mesh.seq_group, dim=1)
    if world == 1:
        same = torch.equal(seq["latents"], plain["latents"]) and np.array_equal(
            seq["video"], plain["video"])
        if not same:
            raise RuntimeError("parallel phase: the seq path's clip at one rank is not the "
                               "plain clip bit for bit")
        out["clip_err"] = 0.0
    else:
        out["clip_err"] = rel_err(seq["latents"], plain["latents"])
        if not out["clip_err"] <= PROFILE_RTOL:
            raise RuntimeError(f"parallel phase: the clip at seq {world} disagrees "
                               f"({out['clip_err']})")
        real = layers.all_reduce_sum
        layers.all_reduce_sum = lambda x, group: x  # the planted fault
        try:
            fault = recorded_clip(seq_pipe, inputs)["latents"]
        finally:
            layers.all_reduce_sum = real
        fault = collectives.all_gather(fault, seq_mesh.seq_group, dim=1)
        out["clip_fault_err"] = rel_err(fault, plain["latents"])
        if not out["clip_fault_err"] > PROFILE_RTOL:
            raise RuntimeError(f"parallel phase: the check misses GroupNorm moments not "
                               f"all-reduced ({out['clip_fault_err']})")
    # timed again, warm, in turns
    seconds = dict(plain=[plain["seconds"]], seq=[seq["seconds"]])
    for name in ("seq", "plain", "plain", "seq"):
        seconds[name].append(recorded_clip(seq_pipe if name == "seq" else plain_pipe,
                                           inputs)["seconds"])
    out["clip_seconds"] = seconds
    out["clip_peak"] = dict(plain=plain["peak"], seq=seq["peak"])
    del plain, seq
    progress("the clips")

    # the step: phase 6's batch (B 1, 14 + 2 frames at 512^2, per-block
    # checkpointing), plain and through ZeRO from the same weights
    trainable = unfreeze(models.modules(), stage2_trainable)
    init = {k: p.detach().clone() for k, p in trainable.items()}

    def restore():
        with torch.no_grad():
            torch._foreach_copy_(list(trainable.values()), [init[k] for k in trainable])

    # (at 2 cards or more, each rank's B 1 is its row of a global batch of
    # B = world, the plain step its row alone: timed, not compared)
    batch = synthetic_batch(models, world, shapes["size"], shapes["train_frames"], 2, seed=0,
                            fixed=False)
    batch = rows_and_frames(batch, data_mesh)
    plain_step = captured_step(models, trainable, None, batch, steps=3)
    restore()
    before = dict(collectives.LAUNCHES)
    zero_step = captured_step(models, trainable, data_mesh, batch, steps=3)
    out["step_collectives"] = {k: (v - before[k]) / 3 for k, v in collectives.LAUNCHES.items()}
    restore()
    errs = step_errors(zero_step, plain_step)
    same = zero_step["loss"] == plain_step["loss"] and all(
        torch.equal(zero_step[part][k], plain_step[part][k])
        for part in ("grads", "masters") for k in plain_step[part])
    if world == 1 and not same:
        raise RuntimeError(f"parallel phase: the ZeRO step at one rank is not the plain step "
                           f"bit for bit (loss, gradient, masters {errs})")
    out.update(step_errs=errs if world == 1 else None,
               step_seconds=dict(plain=plain_step["seconds"], zero=zero_step["seconds"]),
               step_peak=dict(plain=plain_step["peak"], zero=zero_step["peak"]))
    del zero_step
    progress("the plain and ZeRO steps")
    refs = {}
    if world > 1:
        # data = world and seq = world against the plain step on the same
        # global batch, at 256^2 (the plain step at B = world fits one card);
        # the global batches of the tensor-parallel checks' meshes too
        for b in sorted({world, 1} | ({2} if world == 4 else set())):
            small = synthetic_batch(models, b, shapes["small_size"], shapes["clip"], 2, seed=1,
                                    fixed=False)
            refs[b] = (small, captured_step(models, trainable, None, small))
            restore()
        for axis, mesh, b in (("data", data_mesh, world), ("seq", seq_mesh, 1)):
            small, want = refs[b]
            got = captured_step(models, trainable, mesh, rows_and_frames(small, mesh))
            restore()
            out[f"step_errs_{axis}"] = step_errors(got, want)
            if not max(out[f"step_errs_{axis}"][:2]) <= TRAIN_RTOL:
                raise RuntimeError(f"parallel phase: the step at {axis} = {world} disagrees "
                                   f"({out[f'step_errs_{axis}']})")
        progress("the steps at data and seq = world at 256^2")
    # tensor parallelism on the phase's models, back at their initial
    # weights; at one rank on the plain step's batch, with more on one B 1
    # batch that every model rank takes whole (timed, not compared)
    del plain_pipe, seq_pipe
    tp_batch = batch if world == 1 else synthetic_batch(
        models, 1, shapes["size"], shapes["train_frames"], 2, seed=0, fixed=False)
    out.update(tp_checks(world, models, init, tp_batch, plain_step, refs, progress))
    return out


def resharded(models: HalloModels, init: dict, tp, mesh):
    """`models` at their initial weights (`init`, whole), sharded over
    `mesh`'s model group by `parallel/tp.py`'s plan; `tp`, the record of an
    earlier sharding, is undone first (its weights gathered, then
    overwritten)."""
    if tp is not None:
        tp.unshard()
    with torch.no_grad():
        for k, p in unfreeze(models.modules(), stage2_trainable).items():
            p.copy_(init[k])
    return shard_modules(models.modules(), tp_plan(models.modules(), mesh.n_model), mesh)


def tp_step(models: HalloModels, tp, batch: dict, steps: int = 2,
            profiled: bool = False) -> dict:
    """`captured_step` on `models` as `tp` (`resharded`) sharded them, over
    its mesh."""
    trainable = unfreeze(models.modules(), stage2_trainable)
    return dict(captured_step(models, trainable, tp.mesh, batch, steps, tp=tp.plan,
                              profiled=profiled), sharded=count_sharded(tp.plan))


def tp_checks(world: int, models: HalloModels, init: dict, batch: dict, plain_step: dict,
              refs: dict, progress) -> dict:
    """Tensor parallelism in the parallel phase, on the phase's `models`
    (at their initial weights `init` before each run, `resharded`): the
    step at model = world (data 1) on a 512^2 batch (B 1, 14 + 2 frames),
    timed (seconds, peak, each kernel's launches and the collectives' a
    step); at one rank (every sharded layer's collectives at group size 1)
    on the plain step's batch, the plain step bit for bit: loss, gradient,
    masters, and a fourth step under torch.profiler (NCCL's device time).
    With 2 cards or more, at 256^2 against the plain step on the same
    global batch (`refs`) within TRAIN_RTOL, at model = world and, on 4
    cards, at data 2 x model 2; and the planted fault (`all_reduce_sum`,
    whose backward sums the cotangents over the group, in place of g) must
    miss that limit. `progress(part)` logs each part's end."""
    out = {}
    mesh = make_mesh(n_data=1, n_model=world)
    tp = resharded(models, init, None, mesh)
    got = tp_step(models, tp, batch, steps=3, profiled=world == 1)
    progress(f"the tensor-parallel step at model {world}")
    out.update(tp_sharded=got["sharded"], tp_seconds=got["seconds"], tp_peak=got["peak"],
               tp_profile=got.get("profile"), tp_launches=got["launches"])
    if world == 1:
        errs = step_errors(got, plain_step)
        same = got["loss"] == plain_step["loss"] and all(
            torch.equal(got[part][k], plain_step[part][k])
            for part in ("grads", "masters") for k in plain_step[part])
        if not same:
            raise RuntimeError(f"parallel phase: the tensor-parallel step at group size 1 is "
                               f"not the plain step bit for bit (loss, gradient, masters {errs})")
        out["tp_errs"] = errs
        return out
    del got
    meshes = [("model", mesh, 1)]
    if world == 4:
        meshes.append(("data2_model2", make_mesh(n_data=2, n_model=2), 2))
    for name, m, b in meshes:
        small, want = refs[b]
        local = rows_and_frames(small, m)
        tp = resharded(models, init, tp, m)
        out[f"tp_errs_{name}"] = step_errors(tp_step(models, tp, local), want)
        progress(f"the tensor-parallel check {name} at 256^2")
        if not max(out[f"tp_errs_{name}"][:2]) <= TRAIN_RTOL:
            raise RuntimeError(f"parallel phase: the tensor-parallel step at {name} disagrees "
                               f"({out[f'tp_errs_{name}']})")
        if name == "model":
            tp = resharded(models, init, tp, m)
            real = tp_module.reduce_from_group
            tp_module.reduce_from_group = collectives.all_reduce_sum  # the planted fault
            try:
                out["tp_fault_errs"] = step_errors(tp_step(models, tp, local, steps=1), want)
            finally:
                tp_module.reduce_from_group = real
            progress("the planted fault")
            if not out["tp_fault_errs"][1] > TRAIN_RTOL:
                raise RuntimeError(f"parallel phase: the check misses g's backward summed "
                                   f"over the group ({out['tp_fault_errs']})")
    return out


def parallel_rank(rank: int, world: int, port: int, inputs: dict, steps: int,
                  result_path: str, shapes: dict, device_type: str) -> None:
    """One rank of the parallel phase, in a process of its own on card
    `rank` (NCCL over tcp://localhost:`port`), or on the CPU with gloo for a
    rehearsal (`device_type` "cpu")."""
    logging.basicConfig(level=logging.INFO, format="%(name)s: %(message)s")
    dev = torch.device(device_type, rank) if device_type == "cuda" else torch.device("cpu")
    if device_type == "cuda":
        torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the host's cores shared between the ranks (the comparisons run on it)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    faulthandler.dump_traceback_later(PARALLEL_TIMEOUT_S - 60)
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=300))
    try:
        out = parallel_checks(rank, world, dev, inputs, steps, shapes)
        if rank == 0:
            with open(result_path, "w") as fh:
                json.dump(out, fh)
    finally:
        faulthandler.cancel_dump_traceback_later()
        dist.destroy_process_group()


def phase_parallel(inputs: dict, steps: int, shapes: dict = PARALLEL_SHAPES,
                   world: int = 0, device_type: str = "cuda") -> dict:
    """Data and clip parallelism: `max(1, device_count)` ranks, one a card,
    NCCL (`parallel_checks`). At every world size: one full-width clip
    (512^2, 16 + 2 frames, bf16, `steps` DDIM steps) through the seq path
    against the plain clip, and one full-width stage-2 step (phase 6's: B 1,
    14 + 2 frames, per-block checkpointing, AdamW) through ZeRO against the
    plain step; at one rank bit for bit (every collective still runs, at
    group size 1). Seconds, peak memory and the collectives' launches of
    each. With 2 cards or more: the clip at seq = world within PROFILE_RTOL
    and a planted fault (the inflated GroupNorms' moments not all-reduced)
    that must exceed it; the step at data = world and at seq = world against
    the plain step on the same global batch at 256^2 within TRAIN_RTOL.
    Then tensor parallelism (`tp_checks`). `shapes`, `world` and
    `device_type` serve a rehearsal on the CPU."""
    world = world or max(1, torch.cuda.device_count())
    log(f"parallel phase: world size {world}, backend "
        f"{'nccl' if device_type == 'cuda' else 'gloo'}, one rank a card")
    gc.collect()
    torch.cuda.empty_cache()
    os.makedirs(PARALLEL_DIR, exist_ok=True)
    result_path = os.path.join(PARALLEL_DIR, "result.json")
    if os.path.exists(result_path):
        os.remove(result_path)
    ctx = torch.multiprocessing.start_processes(
        parallel_rank, args=(world, free_port(), inputs, steps, result_path, shapes,
                             device_type), nprocs=world,
        join=False, start_method="spawn")
    deadline = time.monotonic() + PARALLEL_TIMEOUT_S
    try:
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise RuntimeError(f"parallel phase: ranks alive after {PARALLEL_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=30)
    with open(result_path) as fh:
        out = json.load(fh)
    gib = 2**30
    size, clip, frames = shapes["size"], shapes["clip"], shapes["train_frames"]
    log(f"parallel clip at seq {world} ({size}^2, {clip} + 2 frames, {steps} DDIM steps): "
        f"relative error {out['clip_err']:.3e} (0 = bit for bit); seconds (the first cold, "
        f"then in turns seq, plain, plain, seq) plain "
        f"{[round(x, 4) for x in out['clip_seconds']['plain']]}, seq "
        f"{[round(x, 4) for x in out['clip_seconds']['seq']]}; peak plain "
        f"{out['clip_peak']['plain'] / gib:.3f} GiB, seq {out['clip_peak']['seq'] / gib:.3f} "
        f"GiB; collectives a clip {out['clip_collectives']}")
    log(f"parallel step at data {world} (ZeRO-2, {size}^2, B 1 a rank, {frames} + 2 frames): "
        f"loss, gradient, masters after 3 steps relative errors {out['step_errs']} (0 = bit for "
        f"bit; None: not compared at 2 cards or more); seconds plain "
        f"{[round(x, 4) for x in out['step_seconds']['plain']]}, ZeRO "
        f"{[round(x, 4) for x in out['step_seconds']['zero']]}; peak of steps 2-3 plain "
        f"{out['step_peak']['plain'] / gib:.3f} GiB, ZeRO {out['step_peak']['zero'] / gib:.3f} "
        f"GiB; collectives a step {out['step_collectives']}")
    for key in ("clip_fault_err", "step_errs_data", "step_errs_seq"):
        if key in out:
            log(f"parallel {key}: {out[key]}")
    log(f"parallel tensor-parallel step at model {world} (data 1, {size}^2, B 1, {frames} + 2 "
        f"frames, {out['tp_sharded']} parameters sharded): seconds "
        f"{[round(x, 4) for x in out['tp_seconds']]}, peak of steps 2-3 "
        f"{out['tp_peak'] / gib:.3f} GiB (plain {out['step_peak']['plain'] / gib:.3f} GiB); "
        f"launches a step {out['tp_launches']}; the profiled fourth step (one card only) "
        f"{out['tp_profile']}")
    for key in ("tp_errs", "tp_errs_model", "tp_errs_data2_model2", "tp_fault_errs"):
        if key in out:
            log(f"parallel {key} (loss, gradient, masters; 0 = bit for bit): {out[key]}")
    return out


def profile_call(what: str, fn, out_path: str) -> list:
    """`fn` under torch.profiler: device time by kernel (top rows here, all
    rows to `out_path`) and the device's busy share of the wall time.
    Returns the rows (ms, count, kernel name) and the wall ms."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue
        us = getattr(e, "self_device_time_total", None)
        us = e.self_cuda_time_total if us is None else us
        if us > 0:
            rows.append((us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    host = sorted(((e.self_cpu_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
                   if not str(e.device_type).endswith("CUDA") and e.self_cpu_time_total > 0),
                  reverse=True)
    lines = [f"profiled {what}: wall {wall * 1e3:.1f} ms (profiler on), device busy "
             f"{busy:.1f} ms ({100 * busy / (wall * 1e3):.1f}% of wall)"]
    lines += [f"{ms:10.3f} ms {100 * ms / busy:5.1f}% x{n:<6d} {name[:110]}"
              for ms, n, name in rows]
    lines += [f"host: self CPU time by op, {sum(r[0] for r in host):.1f} ms in all"]
    lines += [f"{ms:10.3f} ms x{n:<6d} {name[:110]}" for ms, n, name in host[:40]]
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    for line in lines[:31]:
        log(line)
    return rows, wall * 1e3


def phase_profile(pipe: FaceAnimatePipeline, inputs: dict, out_path: str) -> None:
    """One clip under torch.profiler (`profile_call`)."""
    one = dict(inputs, audio_windows=inputs["audio_windows"][:pipe.clip_length])
    profile_call("clip", lambda: pipe(**one, seed=1), out_path)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=4, help="DDIM steps per clip")
    ap.add_argument("--profile-out", metavar="PATH",
                    help="also profile one clip, one stage-2 and one stage-1 train step and "
                         "one static image; write every kernel's device time to PATH and to "
                         "PATH with _train, _stage1 and _static before its suffix")
    args = ap.parse_args()
    logging.basicConfig(level=logging.INFO, format="%(name)s: %(message)s")

    t_start = last = time.perf_counter()

    def mark(phase: str) -> None:
        """Log the seconds since the previous mark (the phase's own)."""
        nonlocal last
        torch.cuda.synchronize()
        now = time.perf_counter()
        log(f"phase {phase}: {now - last:.1f} s ({now - t_start:.1f} s in all)")
        last = now

    preflight()
    dev = torch.device("cuda", 0)
    mark("preflight and the build")
    table = phase_kernels(dev)
    log_k1_host_cost(dev)
    log_small_call_host_costs(dev)
    mark("kernels")
    phase_card_checks()
    mark("card checks")
    audio = phase_audio(dev, os.path.join(_build.BUILD_DIR, "audio"))
    mark("audio")
    slice_ = phase_slice(dev, args.steps, audio["emb"], audio["audio_length"])
    if args.profile_out:
        phase_profile(slice_["pipe"], slice_["inputs"], args.profile_out)
    mark("slice")
    cpu = on_cpu_fp32(slice_["models"], "full")
    phase_reference(slice_["models"], cpu, dev)
    mark("reference")
    phase_profiles(slice_["models"], cpu, slice_)
    mark("profiles")
    del cpu
    train_profile = static_profile = stage1_profile = ""
    if args.profile_out:
        root, ext = os.path.splitext(args.profile_out)
        train_profile, static_profile, stage1_profile = (
            f"{root}_{name}{ext}" for name in ("train", "static", "stage1"))
    phase_batch2(slice_["models"], args.steps)
    mark("B 2 clip")
    train = phase_train(slice_["models"], dev, profile_out=train_profile)
    phase_remat_inner(slice_["models"], dev, train)
    mark("train")
    launches = {"slice": slice_["counts"], "audio": audio["counts"], "train": train["counts"]}
    one_clip = dict(slice_["inputs"], audio_windows=slice_["inputs"]["audio_windows"][:16])
    del slice_  # the trainer and the parallel ranks build their own models
    gc.collect()
    torch.cuda.empty_cache()
    phase_parallel(one_clip, args.steps)
    mark("parallel")
    dataset = phase_dataset(dev)
    mark("dataset")
    phase_trainer(dev, dataset["meta"])
    shutil.rmtree(dataset["root"])
    mark("trainer")
    phase_static(dev, profile_out=static_profile)
    mark("static")
    stage1 = phase_stage1(dev, profile_out=stage1_profile)
    mark("stage 1")
    pretrained = write_pretrained(dev)
    phase_trainer1(dev, pretrained[0], stage1["batch"], stage1["remat"])
    mark("stage-1 trainer, the files included")
    phase_onnx(dev)
    mark("onnx")
    phase_cli(dev, pretrained)
    mark("cli")

    rows = []
    for name, info in KERNELS.items():
        stats = dict(table[name])
        phase_launches = stats.pop("phase_launches")
        by = info["launched_by"]
        n = phase_launches if by == "kernel phase" else launches[by][name]
        rows.append(dict(name=name, **info, launches=n, **stats))
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
