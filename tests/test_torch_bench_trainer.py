"""`hallo_tpu_torch.train.bench_trainer`'s watch on the CPU: the max |x|
records of kernel outputs and gradients, and how a non-finite run is held
against a finite one (the trainer itself runs on the card only)."""

import math

import torch

from hallo_tpu_torch.ops import flash, temporal
from hallo_tpu_torch.train import bench_trainer, step


def test_watch_places_the_first_departures(monkeypatch):
    # the watch wraps these; the test's end restores them
    for attr in ("flash_forward_packed", "flash_bwd_dkv", "flash_bwd_dq", "flash_attention"):
        monkeypatch.setattr(flash, attr, getattr(flash, attr))
    monkeypatch.setattr(temporal, "_temporal_kernel", temporal._temporal_kernel)
    monkeypatch.setattr(step, "global_norm", step.global_norm)
    watch = bench_trainer.Watch()
    watch.install()
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(1, 2, 8, 128, generator=gen)
    runs = []
    for scale in (1.0, 1e30):
        flash.flash_attention(q, q, q * scale)
        flash.flash_attention(q, q, q)
        grads = {"a": torch.ones(3), "b": torch.tensor([scale])}
        step.global_norm(grads.values())
        runs.append(watch.read())
    good, bad = runs
    assert [(name, s) for name, s, _, _ in good] == [("K3/K4", 0), ("K3/K4", 0), ("grads", 0)]
    assert good[2][3] == ["a", "b"] and good[2][2] == [1.0, 1.0]
    found = bench_trainer.first_departures(bad, good)
    assert [k[:4] for k in found["kernels"]] == [(0, "K3/K4", 0, 0)]
    assert [g[:2] for g in found["grads"]] == [(0, "b")]
    assert watch.read() == [] and watch.step == 0


def test_departs():
    assert not bench_trainer._departs(1.0, 7.9)
    assert bench_trainer._departs(1.0, 8.1)
    assert bench_trainer._departs(math.inf, 1.0) and bench_trainer._departs(math.nan, 1.0)
    assert not bench_trainer._departs(math.inf, math.inf)
    assert not bench_trainer._departs(0.0, 1e-4)
