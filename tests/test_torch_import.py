"""hallo_tpu_torch imports torch and never jax (or triton): in a fresh
interpreter, importing every module of the package and running the tiny
slice on the CPU leave both out of sys.modules. Also: the port's tiny
widths are the JAX factory's."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROGRAM = r"""
import pkgutil, sys
import numpy as np
import hallo_tpu_torch
for mod in pkgutil.walk_packages(hallo_tpu_torch.__path__, "hallo_tpu_torch."):
    __import__(mod.name)
from hallo_tpu_torch.pipelines.face_animate import FaceAnimatePipeline
from hallo_tpu_torch.utils.factory import build_models, dummy_clip_inputs
models = build_models("tiny")
pipe = FaceAnimatePipeline(models, num_inference_steps=1, clip_length=4, n_motion_frames=2)
video = pipe(**dummy_clip_inputs(models, 64, 64, 4))
assert video.shape == (1, 4, 64, 64, 3) and np.isfinite(video).all()
print(sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "triton", "flax")))
"""


def test_port_never_imports_jax_or_triton():
    out = subprocess.run(
        [sys.executable, "-c", PROGRAM], cwd=REPO, capture_output=True, text=True,
        timeout=300, env={**os.environ, "PYTHONPATH": REPO},
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_tiny_widths_match_jax_factory():
    from hallo_tpu.utils import factory as jax_factory
    from hallo_tpu_torch.utils import factory

    assert factory.TINY_UNET_KW == jax_factory.TINY_UNET_KW
    assert factory.TINY_AUX == jax_factory.TINY_AUX
