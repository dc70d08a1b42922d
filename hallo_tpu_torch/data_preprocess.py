"""Two-pass dataset builder on PyTorch (counterpart of
scripts/data_preprocess.py; reference scripts/data_preprocess.py:33-191):

    python -m hallo_tpu_torch.data_preprocess -i videos/ -o data/clips -s 1
    python -m hallo_tpu_torch.data_preprocess -i videos/ -o data/clips -s 2

Step 1 (host) decodes each video's frames, extracts its audio track into
`<name>.wav` (this needs an ffmpeg binary: without one the clip's
`audio_path` stays unset and step 2 gives it no audio embedding), and
computes the face region and the union face and lip masks at the four
latent depths. Step 2 computes the identity embedding (the face
analyzer) and the wav2vec2 audio embedding (`AudioProcessor`) on the card
unless `--device cpu` is given, then writes `dataset_stage2_r{rank}.json`
beside the output directory. Each clip is one compressed .npz, the format
`data/datasets.py` reads; `-p`/`-r` shard the sorted video list modulo the
process count, and a video that fails is skipped with a warning. Without a
wav2vec2 weights file the encoder takes random weights (smoke mode, with a
warning); a file that exists but does not load raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
from pathlib import Path
from typing import Dict, Optional

import cv2
import numpy as np
import torch

from hallo_tpu_torch.config import Wav2Vec2Config
from hallo_tpu_torch.convert.load_pretrained import load_wav2vec_state_dict
from hallo_tpu_torch.data.audio_processor import AudioProcessor
from hallo_tpu_torch.data.image_processor import ImageProcessorForDataProcessing
from hallo_tpu_torch.models.wav2vec import Wav2Vec2
from hallo_tpu_torch.utils import masks as mk
from hallo_tpu_torch.utils.video import extract_audio, read_frames

logger = logging.getLogger("hallo_tpu_torch.data_preprocess")

VIDEO_SUFFIXES = (".mp4", ".avi", ".mov", ".mkv")
# The latent depths' downscales of the mask pyramid (levels 0-3).
MASK_SCALES = (8, 16, 32, 64)
# The encoder's architecture (wav2vec2-base); the tests swap in a small one.
WAV2VEC_CONFIG = Wav2Vec2Config()


@dataclasses.dataclass
class Tools:
    """What the steps run, built once for all videos: the face analysis, and
    for step 2 the audio processor."""

    images: ImageProcessorForDataProcessing
    audio: Optional[AudioProcessor] = None


def wav2vec_state_dict(model_path: str, seed: int = 0) -> Dict[str, torch.Tensor]:
    """wav2vec2's weights file under `model_path` over a random initial
    model of `WAV2VEC_CONFIG` from `seed` (made on the CPU, so that a seed
    gives the same weights on every device); without a file, the random
    model alone (smoke mode, as scripts/data_preprocess.py:82-89)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        init = Wav2Vec2(WAV2VEC_CONFIG).state_dict()
    try:
        sd, _ = load_wav2vec_state_dict(model_path, init)
    except FileNotFoundError:
        logger.warning("wav2vec weights missing under %r; using random init (smoke mode)",
                       model_path)
        sd = init
    return sd


def make_tools(step: int, args) -> Tools:
    device = torch.device(args.device)
    images = ImageProcessorForDataProcessing(args.face_analysis_model_path, step=step,
                                             device=device)
    if step != 2:
        return Tools(images)
    audio = AudioProcessor(wav2vec_state_dict=wav2vec_state_dict(args.wav2vec_model_path),
                           wav2vec_config=WAV2VEC_CONFIG, device=device)
    return Tools(images, audio)


def process_single_video(video_path: str, out_dir: str, step: int, args,
                         tools: Tools) -> dict:
    """Run `step` on one video, adding to `out_dir/<name>.npz` what the
    step computes; returns its meta entry."""
    name = Path(video_path).stem
    npz_path = os.path.join(out_dir, f"{name}.npz")
    partial = dict(np.load(npz_path)) if os.path.exists(npz_path) else {}

    if step == 1:
        frames = read_frames(video_path)
        face_union, full_m, sep_face_m, sep_lip_m = tools.images.union_masks(frames)
        partial["frames"] = np.stack(
            [cv2.resize(f, (args.size, args.size)) for f in frames]).astype(np.uint8)
        region = cv2.resize(face_union, (args.size, args.size))
        partial["face_region"] = np.repeat(
            (region.astype(np.float32) / 255.0)[..., None], 3, axis=-1)
        for level, scale in enumerate(MASK_SCALES):
            for kind, mask in (("full", full_m), ("face", sep_face_m), ("lip", sep_lip_m)):
                partial[f"{kind}_mask_{level}"] = mk.mask_pyramid(mask, args.size, (scale,))[0]
        try:
            wav = os.path.join(out_dir, f"{name}.wav")
            extract_audio(video_path, wav, 16000)
            partial["audio_path"] = np.asarray(wav)
        except Exception as e:  # no ffmpeg, or no audio track (JAX's :62-63)
            logger.warning("audio extraction failed for %s: %s", name, e)

    if step == 2:
        partial["face_emb"] = tools.images.face_embedding(list(partial["frames"]))
        wav = str(partial.get("audio_path", ""))
        if wav and os.path.exists(wav):
            partial["audio_emb"], _ = tools.audio.preprocess(wav)

    np.savez_compressed(npz_path, **partial)
    return {"clip_path": npz_path}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("-i", "--input_dir", required=True)
    parser.add_argument("-o", "--output_dir", default="./data/clips")
    parser.add_argument("-s", "--step", type=int, default=1, choices=(1, 2))
    parser.add_argument("-p", type=int, default=1, help="parallelism degree")
    parser.add_argument("-r", type=int, default=0, help="rank for modulo sharding")
    parser.add_argument("--size", type=int, default=512)
    parser.add_argument("--face_analysis_model_path",
                        default="./pretrained_models/face_analysis")
    parser.add_argument("--wav2vec_model_path",
                        default="./pretrained_models/wav2vec/wav2vec2-base-960h")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser


def main(argv=None) -> list:
    """The builder's run; returns the meta entries of the videos done."""
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device here; pass --device cpu for the CPU")
    # wav2vec2 runs in fp32: no TF32 in its convolutions and products, as
    # the inference CLI runs it
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    os.makedirs(args.output_dir, exist_ok=True)
    videos = sorted(str(p) for p in Path(args.input_dir).glob("**/*")
                    if p.suffix.lower() in VIDEO_SUFFIXES)
    videos = [v for i, v in enumerate(videos) if i % args.p == args.r]
    logger.info("processing %d videos (step %d)", len(videos), args.step)

    tools = make_tools(args.step, args)
    meta = []
    for video in videos:
        try:
            meta.append(process_single_video(video, args.output_dir, args.step, args, tools))
        except Exception as e:  # skip failed videos (reference :112-113)
            logger.warning("failed %s: %s", video, e)

    if args.step == 2:
        meta_path = os.path.join(os.path.dirname(args.output_dir) or ".",
                                 f"dataset_stage2_r{args.r}.json")
        with open(meta_path, "w") as f:
            json.dump(meta, f, indent=1)
        logger.info("wrote %s (%d clips)", meta_path, len(meta))
    return meta


if __name__ == "__main__":
    main()
