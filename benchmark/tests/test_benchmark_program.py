"""The readers of the program's own spans and counters (`benchmark/program.py`
and the metrics that use it) on hand-made slices."""

from __future__ import annotations

import types

import pytest
import torch

from benchmark import harness, program
from benchmark import trace as tr
from test_benchmark_harness import _Ev


class _Untyped:
    """An event of a profiler that gives no activity type (PyTorch 2.11's)."""

    def __init__(self, name, start, dur, cuda=False, corr=0):
        self.n, self.s, self.d, self.cuda, self.c = name, start, dur, cuda, corr

    def name(self):
        return self.n

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self.cuda else torch.autograd.DeviceType.CPU

    def start_ns(self):
        return self.s

    def duration_ns(self):
        return self.d

    def correlation_id(self):
        return self.c


def clip_events(ev=_Ev, typed=True):
    """A 100-ns slice: a kernel [0, 20), idle [20, 40) opened inside
    `hallo.step.denoise`, a kernel [40, 60), idle [60, 90) opened inside
    `hallo.wait.timestep`, a kernel [90, 100). The program's ranges are
    host operations' ranges."""
    ann = (lambda n, s, d: ev("cpu_op", n, s, d)) if typed else \
        (lambda n, s, d: ev(n, s, d))
    kern = (lambda n, s, d, c: ev("kernel", n, s, d, corr=c)) if typed else \
        (lambda n, s, d, c: ev(n, s, d, cuda=True, corr=c))
    run = (lambda s, c: ev("cuda_runtime", "cudaLaunchKernel", s, 1, corr=c)) if typed else \
        (lambda s, c: ev("cudaLaunchKernel", s, 1, corr=c))
    slice_ = ev("user_annotation", tr.SLICE, 0, 100) if typed else ev(tr.SLICE, 0, 100)
    return [slice_, ann("hallo.step", 0, 100), ann("hallo.step.denoise", 5, 50),
            ann("hallo.wait.timestep", 55, 30), run(6, 1), run(10, 2), run(86, 3),
            kern("elementwise_kernel", 0, 20, 1), kern("gemm_kernel", 40, 20, 2),
            kern("elementwise_kernel", 90, 10, 3)]


@pytest.mark.parametrize("typed", [True, False])
def test_sync_idle_counts_gaps_that_open_inside_a_wait(typed):
    sl = tr.Slice(clip_events() if typed else clip_events(_Untyped, typed=False))
    assert 100.0 * (1 - sl.busy_ns() / sl.wall_ns) == pytest.approx(50.0)
    # [60, 90) opens inside the wait and counts; [20, 40) opens inside the
    # denoiser's dispatch and does not
    assert program.sync_idle_pct(sl) == pytest.approx(30.0)


def test_device_ms_per_span_reads_the_kernels_launched_inside():
    sl = tr.Slice(clip_events())
    assert program.device_ms_per_span(sl, "hallo.step.denoise") == pytest.approx(40 / 1e6)
    # a span inside which nothing was launched reads 0 ms
    assert program.device_ms_per_span(sl, "hallo.wait.timestep") == 0.0
    assert program.device_ms_per_span(sl, "hallo.train.optimizer") is None


def test_a_slice_without_program_spans_reads_none():
    evs = [e for e in clip_events() if not e.name().startswith("hallo.")]
    sl = tr.Slice(evs)
    assert program.sync_idle_pct(sl) is None
    ctx = types.SimpleNamespace(kind="train", slice=sl)
    for name in ("sync_idle_pct.train", "optimizer_ms_per_step.train",
                 "backward_ms_per_step.train"):
        assert harness.reader(name)(ctx) is None, name


def test_waits_per_sums_every_site():
    counts = {"wait.timestep": 40, "wait.inputs": 18, "wait.frames": 1,
              "denoiser.eval.full": 40, "launch.flash_fwd_packed": 7}
    assert program.waits_per(counts, "denoiser.eval.full", "denoiser.eval.cond") == \
        pytest.approx(59 / 40)
    assert program.waits_per(counts, "train.step") is None
    assert program.waits_per(None, "train.step") is None


def test_counter_readers_read_the_program(monkeypatch):
    from hallo_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "_COUNTS", profiling.collections.Counter(
        {"train.step": 4, "wait.batch": 72, "wait.loss": 4, "wait.grad_norm": 8}))
    read = harness.reader("host_waits_per_step.train")
    assert read(types.SimpleNamespace(kind="train")) == pytest.approx(21.0)
    assert read(types.SimpleNamespace(kind="infer")) is None
    assert harness.reader("host_waits_per_eval.infer")(
        types.SimpleNamespace(kind="infer")) is None  # no evaluation counted
