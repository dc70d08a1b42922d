"""hallo_tpu_torch -- the PyTorch/CUDA port of hallo_tpu for NVIDIA Hopper.

The same models, pipeline and stage-2 trainer as `hallo_tpu` (which stays
the reference the port is held against), as `torch.nn.Module`s with the
reference checkpoints' state_dict key names. The attention kernels of
`hallo_tpu/ops/` (Pallas, TPU) are CUDA kernels written for sm_90a in
`csrc/`, built with nvcc at first use and bound with ctypes
(`ops/_build.py`). On the CPU every kernel
wrapper takes its plain PyTorch version; on a CUDA tensor it launches the
kernel or raises.

This package imports torch and never jax.
"""

__version__ = "0.1.0"
