"""Seconds to read a checkpoint file into the card, as the CLI's
`load_weights` stage does it.

    python -m hallo_tpu_torch.convert.bench_load [--rounds 3] [--dir DIR]

It writes the SD-1.5 UNet's inventory (`convert/weight_inventory.py`) as a
.safetensors file in fp16 from a seed (1.72 GB, the largest safetensors
file of the reference's layout) under `hallo_tpu_torch/_build/bench_load/`
unless `--dir` names another directory, then, in turns, reads it two ways
and copies every tensor into a bf16 tensor on the card:

- "mapped": `checkpoint_io.load_any`, the safetensors library's
  memory-mapped read, which the loader uses (pages are read as the copies
  touch them; no second copy of the file is made);
- "in_memory": the whole file read into one bytes object, then
  `safetensors.torch.load` of it (two host copies of the file at once).

The file was just written, so both read from the page cache. It prints the
card's name and power limit, then one JSON line, and removes the file.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import time

import safetensors.torch
import torch

from hallo_tpu_torch.convert import weight_inventory as wi
from hallo_tpu_torch.convert.checkpoint_io import load_any
from hallo_tpu_torch.convert.synthetic import synthetic_state_dict

BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "_build", "bench_load")


def _read_in_memory(path: str):
    with open(path, "rb") as fh:
        return safetensors.torch.load(fh.read())


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--dir", default=BUILD_DIR)
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    os.makedirs(args.dir, exist_ok=True)
    path = os.path.join(args.dir, "diffusion_pytorch_model.safetensors")
    sd = synthetic_state_dict(wi.sd15_unet_inventory(), 11, dev)
    dst = {k: torch.empty(v.shape, dtype=torch.bfloat16, device=dev) for k, v in sd.items()}
    t0 = time.perf_counter()
    safetensors.torch.save_file(sd, path)
    write_s = time.perf_counter() - t0
    del sd
    readers = {"mapped": load_any, "in_memory": _read_in_memory}
    seconds = {name: [] for name in readers}
    for _ in range(args.rounds):
        for name, read in readers.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for k, v in read(path).items():
                dst[k].copy_(v)
            torch.cuda.synchronize()
            seconds[name].append(round(time.perf_counter() - t0, 4))
    print(json.dumps({"file_gb": round(os.path.getsize(path) / 1e9, 3), "tensors": len(dst),
                      "write_s": round(write_s, 4), "seconds": seconds}), flush=True)
    shutil.rmtree(args.dir)


if __name__ == "__main__":
    main()
