"""Data and clip parallelism over `torch.distributed` process groups
(counterpart of hallo_tpu/parallel/): the ("data", "seq") mesh from
configs/parallel.yaml, the ZeRO partition plan (`mesh.py`) and the
differentiable collectives the clip-parallel denoiser runs
(`collectives.py`)."""
