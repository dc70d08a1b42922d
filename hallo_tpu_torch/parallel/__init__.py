"""Data, clip and tensor parallelism over `torch.distributed` process
groups (counterpart of hallo_tpu/parallel/): the ("data", "seq", "model")
mesh from configs/parallel.yaml, the ZeRO partition plan (`mesh.py`), the
differentiable collectives the clip-parallel denoiser and the sharded
denses run (`collectives.py`) and tensor parallelism's plan and sharded
layers (`tp.py`)."""
