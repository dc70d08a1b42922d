"""hallo_tpu_torch imports torch and never the JAX package, jax or triton:
in a fresh interpreter, importing every module of the package and running
the tiny slice, the tiny audio path, one tiny stage-2 train step, the host
preprocessing, the ONNX executor with the vocal separator, the checkpoint
loader and the preflight on the CPU leave none of them in sys.modules, and
no source line of the port or of chip_smoke.py imports hallo_tpu. Also: the
port's tiny widths are the JAX factory's, and its entry points default to
the card."""

import dataclasses
import inspect
import os
import re
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAV = os.path.join(REPO, "examples", "driving_audios", "1.wav")
IMAGE = os.path.join(REPO, "examples", "reference_images", "1.jpg")
YAML = os.path.join(REPO, "configs", "inference", "default.yaml")

PROGRAM = r"""
import pkgutil, sys
import numpy as np
import hallo_tpu_torch
for mod in pkgutil.walk_packages(hallo_tpu_torch.__path__, "hallo_tpu_torch."):
    __import__(mod.name)
from hallo_tpu_torch.data.audio_processor import AudioProcessor
from hallo_tpu_torch.pipelines.face_animate import FaceAnimatePipeline
from hallo_tpu_torch.utils.factory import (
    WAV2VEC_CONFIGS, build_models, build_wav2vec, dummy_clip_inputs)
models = build_models("tiny", device="cpu")
pipe = FaceAnimatePipeline(models, num_inference_steps=1, clip_length=4, n_motion_frames=2)
video = pipe(**dummy_clip_inputs(models, 64, 64, 4))
assert video.shape == (1, 4, 64, 64, 3) and np.isfinite(video).all()
w2v = build_wav2vec("tiny_slice", device="cpu")
proc = AudioProcessor(wav2vec_state_dict=w2v.state_dict(),
                      wav2vec_config=WAV2VEC_CONFIGS["tiny_slice"], device="cpu")
emb, length = proc.preprocess(sys.argv[1], clip_length=4)
assert emb.shape == (76, 2, 4) and length == 75 and np.isfinite(emb).all()
from hallo_tpu_torch.train.state import AdamW, OptimizerConfig, TrainState, stage2_trainable, unfreeze
from hallo_tpu_torch.train.step import make_train_step, step_generator
trainable = unfreeze(models.modules(), stage2_trainable)
opt = AdamW(OptimizerConfig())
step = make_train_step(models, trainable, opt)
rng = np.random.default_rng(0)
batch = dict(
    pixel_values=rng.uniform(-1, 1, (1, 2, 64, 64, 3)), ref_pixels=rng.uniform(-1, 1, (1, 64, 64, 3)),
    motion_pixels=rng.uniform(-1, 1, (1, 2, 64, 64, 3)), audio_windows=rng.normal(size=(1, 2, 3, 2, 4)),
    face_emb=rng.normal(size=(1, 16)), face_region=np.ones((1, 64, 64, 3)),
    masks=tuple(tuple(np.ones((1, (8 >> d) ** 2)) for _ in range(3)) for d in range(4)))
state, metrics = step(TrainState.create(trainable, opt), batch, step_generator(0, 0, "cpu"))
assert state.step == 1 and np.isfinite(metrics["loss"])
import os, tempfile
from hallo_tpu_torch.convert.onnx_io import OnnxNode, save_onnx
from hallo_tpu_torch.convert.load_pretrained import load_pretrained
from hallo_tpu_torch.data.image_processor import ImageProcessor
from hallo_tpu_torch.data.mdx_separator import MdxSeparator
from hallo_tpu_torch.inference import build_parser, resolve_settings
from hallo_tpu_torch.config import load_yaml
from hallo_tpu_torch import preflight_weights
from hallo_tpu_torch.utils.video import StreamingVideoWriter, read_frames
tmp = tempfile.mkdtemp()
img = ImageProcessor((64, 64), "", device="cpu").preprocess(sys.argv[2])
assert img.pixel_values.shape == (64, 64, 3) and len(img.lip_masks) == 4
save_onnx(os.path.join(tmp, "id.onnx"), [OnnxNode("Identity", ["x"], ["y"], {})], {},
          {"x": [1, 4, 64, 32]}, {"y": [1, 4, 64, 32]})
sep = MdxSeparator(os.path.join(tmp, "id.onnx"), hop=40, device="cpu")
assert sep.separate(np.zeros(8000, np.float32), 16000).shape[0] > 7000
assert load_pretrained(models, base_model_path=tmp, vae_model_path=tmp) == {}
assert preflight_weights.main(["--root", tmp]) == 0
writer = StreamingVideoWriter(os.path.join(tmp, "v.mp4"), fps=25)
writer.append(np.zeros((2, 16, 16, 3), np.uint8))
writer.close()
assert len(read_frames(os.path.join(tmp, "v.mp4"))) == 2
s = resolve_settings(load_yaml(sys.argv[3]), build_parser().parse_args(["--profile", "turbo"]))
assert (s["sampler"], s["inference_steps"]) == ("unipc", 8)
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "triton", "flax", "hallo_tpu")))
"""

_IMPORT_JAX_PACKAGE = re.compile(r"^\s*(import hallo_tpu\b(?!_torch)|from hallo_tpu\b(?!_torch))")


def test_port_never_imports_jax_triton_or_the_jax_package():
    out = subprocess.run(
        [sys.executable, "-c", PROGRAM, WAV, IMAGE, YAML], cwd=REPO, capture_output=True, text=True,
        timeout=300, env={**os.environ, "PYTHONPATH": REPO},
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_source_line_imports_the_jax_package():
    sources = [os.path.join(REPO, "chip_smoke.py")]
    for root, dirs, files in os.walk(os.path.join(REPO, "hallo_tpu_torch")):
        dirs[:] = [d for d in dirs if d != "_build"]  # build output, not sources
        sources += [os.path.join(root, f) for f in files if f.endswith(".py")]
    bad = []
    for path in sources:
        with open(path) as fh:
            bad += [f"{path}:{i}" for i, line in enumerate(fh, 1)
                    if _IMPORT_JAX_PACKAGE.match(line)]
    assert len(sources) > 20 and bad == []


def test_tiny_widths_match_jax_factory():
    """The configs are instances of two packages' classes: compared field by
    field."""
    from hallo_tpu.utils import factory as jax_factory
    from hallo_tpu_torch.utils import factory

    def fields(kw):
        return {k: dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v
                for k, v in kw.items()}

    assert fields(factory.TINY_UNET_KW) == fields(jax_factory.TINY_UNET_KW)
    assert fields(factory.TINY_AUX) == fields(jax_factory.TINY_AUX)


# JAX-package config fields the port does not implement (at their defaults,
# which are the reference's inference settings).
NOT_PORTED = {
    "UNetConfig": {"remat_inner": False,
                   "use_linear_projection": False, "upcast_attention": False},
    "SchedulerConfig": {"clip_sample": False},
}


def test_config_copies_match_jax_package():
    """Each copied dataclass has the JAX package's fields and defaults, less
    the few the port does not implement, and the UNet helpers make the same
    configurations."""
    from hallo_tpu import config as jc
    from hallo_tpu_torch import config as tc

    for name in ("MotionModuleConfig", "UNetConfig", "VAEConfig", "Wav2Vec2Config",
                 "SchedulerConfig", "AudioProjConfig", "ImageProjConfig",
                 "FaceLocatorConfig"):
        ours = dataclasses.asdict(getattr(tc, name)())
        assert {**ours, **NOT_PORTED.get(name, {})} == dataclasses.asdict(
            getattr(jc, name)()), name
    for helper in ("reference_unet_config", "denoising_unet_config"):
        got = getattr(tc, helper)(block_out_channels=(8, 16), norm_num_groups=4)
        want = getattr(jc, helper)(block_out_channels=(8, 16), norm_num_groups=4)
        assert {**dataclasses.asdict(got), **NOT_PORTED["UNetConfig"]} == dataclasses.asdict(
            want), helper


def test_entry_points_default_to_the_card():
    from hallo_tpu_torch import inference
    from hallo_tpu_torch.convert.onnx_torch import OnnxExecutor
    from hallo_tpu_torch.data.audio_processor import AudioProcessor
    from hallo_tpu_torch.data.face_analysis import FaceAnalyzer
    from hallo_tpu_torch.data.image_processor import (
        ImageProcessor, ImageProcessorForDataProcessing)
    from hallo_tpu_torch.data.insight_torch import ArcFaceTorch, InsightTorchApp, ScrfdTorch
    from hallo_tpu_torch.data.landmark_torch import TorchFaceLandmarker
    from hallo_tpu_torch.data.mdx_separator import MdxSeparator
    from hallo_tpu_torch.pipelines.face_animate import HalloModels
    from hallo_tpu_torch.utils.factory import build_models, build_wav2vec

    for fn in (build_models, build_wav2vec, HalloModels.create, AudioProcessor.__init__,
               OnnxExecutor.__init__, FaceAnalyzer.__init__, ImageProcessor.__init__,
               ImageProcessorForDataProcessing.__init__, ScrfdTorch.__init__,
               ArcFaceTorch.__init__, InsightTorchApp.__init__, TorchFaceLandmarker.__init__,
               MdxSeparator.__init__):
        assert inspect.signature(fn).parameters["device"].default == torch.device("cuda"), fn
    assert inference.build_parser().get_default("device") == "cuda"
