"""The harness on the CPU: the manifest's rules, discovery by file name,
the result line, the window rule, the trace reductions, the bounds and the
FLOP count, and what the harness imports."""

from __future__ import annotations

import copy
import importlib
import os
import subprocess
import sys

import pytest
import torch
import torch.nn as nn

from benchmark import harness, inputs
from benchmark import trace as tr
from benchmark.drivers import common
from benchmark.reference import nn as ref_nn

from conftest import ROOT, tiny_cell

H100 = {"bf16_flops": 9.89e14, "hbm_bytes_per_s": 3.35e12}


def test_manifest_is_valid():
    assert harness.validate(harness.manifest(ROOT)) == []


@pytest.mark.parametrize("section,key,value", [
    ("workloads", "name", "has space"),
    ("workloads", "name", "a,b"),
    ("workloads", "name", "x" * 65),
    ("end_to_end", "unit", "frames per s"),
    ("end_to_end", "unit", "x" * 17),
    ("end_to_end", "unit", "µs"),
    ("end_to_end", "better", "up"),
    ("end_to_end", "bound", 0.3),
    ("end_to_end", "source", "program_span"),
    ("per_layer", "moves", "no_such_metric"),
    ("workloads", "chips", 2),
    ("configs", "why", "two\nlines"),
])
def test_manifest_rules_refuse(section, key, value):
    man = copy.deepcopy(harness.manifest(ROOT))
    man[section][0][key] = value
    assert harness.validate(man)


def test_manifest_refuses_extra_keys_and_duplicates():
    man = copy.deepcopy(harness.manifest(ROOT))
    man["per_layer"][0]["why"] = "no such key"
    assert harness.validate(man)
    man = copy.deepcopy(harness.manifest(ROOT))
    man["workloads"].append(dict(man["workloads"][0]))
    assert harness.validate(man)


def test_discovery_by_name():
    man = harness.manifest(ROOT)
    for c in man["configs"]:
        cfg = harness.load_json(os.path.join(ROOT, c["file"]))
        assert cfg["name"] == c["name"]
        assert c["file"].startswith("benchmark/configs/")
    for w in man["workloads"]:
        work = harness.load_json(os.path.join(harness.HERE, "workloads", f"{w['name']}.json"))
        assert (work["config"], work["traffic"], work["chips"]) == (
            w["config"], w["traffic"], w["chips"])
        traffic = harness.load_json(os.path.join(harness.HERE, "traffic",
                                                 f"{w['traffic']}.json"))
        assert os.path.exists(os.path.join(harness.HERE, "drivers", f"{traffic['kind']}.py"))
        assert harness.metrics_for(man, "per_layer", w["name"])
    for m in man["per_layer"]:
        assert callable(harness.reader(m["name"]))
    ks = harness.kernels()
    assert {"flash_fwd_sm90", "flash_bwd_sm90"} <= set(ks)


def test_kernel_symbols_are_the_port_categories():
    from benchmark.trace import category

    for k in harness.kernels().values():
        for p in k["passes"]:
            assert category(p["symbol"]) == k["category"]


@pytest.mark.parametrize("workload", ["infer-exact", "train-stage2-b4"])
def test_window_ends_at_the_first_completion_at_or_after_seconds(workload):
    import types

    from benchmark import run

    ov = tiny_cell(workload)
    args = types.SimpleNamespace(workload=workload, seed=5, seconds=0.5, trace=0)
    _, got = run.load(ov["manifest"], workload, ov)
    ctx = types.SimpleNamespace(args=args, cfg=got["cfg"], traffic=got["traffic"],
                                work=got["work"], device=torch.device("cpu"), t0=0.0,
                                log=print)
    driver = importlib.import_module(f"benchmark.drivers.{got['traffic']['kind']}")
    times = driver.run(ctx)["completions"]
    assert times[-1] >= args.seconds
    assert len(times) == 1 or times[-2] < args.seconds or workload.startswith("infer")


def test_union_and_gaps():
    iv = [(0, 10), (5, 15), (20, 30), (25, 26)]
    assert tr.union_ns(iv) == 25
    assert tr.gaps(iv, 0, 40) == [(15, 20), (30, 40)]


class _Ev:
    def __init__(self, kind, name, start, dur, corr=0):
        self.k, self.n, self.s, self.d, self.c = kind, name, start, dur, corr

    def activity_type(self):
        return self.k

    def name(self):
        return self.n

    def start_ns(self):
        return self.s

    def duration_ns(self):
        return self.d

    def correlation_id(self):
        return self.c


def test_slice_idle_share_counts_overlap_once():
    evs = [
        _Ev("user_annotation", tr.SLICE, 0, 100),
        _Ev("user_annotation", "denoising_net", 0, 50),
        _Ev("cuda_runtime", "cudaLaunchKernel", 1, 1, corr=1),
        _Ev("cuda_runtime", "cudaLaunchKernel", 2, 1, corr=2),
        _Ev("cuda_runtime", "cudaLaunchKernel", 60, 1, corr=3),
        _Ev("kernel", "void flash_fwd_sm90_kernel<1>(int)", 10, 30, corr=1),
        _Ev("gpu_memcpy", "Memcpy DtoH", 20, 30, corr=2),  # overlaps, another stream
        _Ev("kernel", "elementwise_kernel", 70, 10, corr=3),
    ]
    sl = tr.Slice(evs)
    assert sl.wall_ns == 100
    assert sl.busy_ns() == 50  # [10, 50) and [70, 80)
    assert sl.span_count("denoising_net") == 1
    assert sl.span_device_ns("denoising_net") == 60  # kernels launched inside it
    assert len(sl.launches) == 3
    assert sl.kernel_ns("flash_fwd_sm90_kernel") == (30, 1)
    gaps = sl.idle_gaps()
    assert [round(g[1] * 1e9) for g in gaps] == [20, 20, 10]
    bd = sl.breakdown()
    assert len(bd["device_ops"]) <= 10 and len(bd["idle_gaps"]) <= 10


def test_roofline_bounds_match_the_kernel_table():
    ks = harness.kernels()
    k1 = ks["flash_fwd_sm90"]["passes"][0]
    assert harness.bound_s(k1, dict(N=2, Lq=4096, Lk=8192, C=320), H100) * 1e3 == \
        pytest.approx(0.0869, abs=5e-5)
    dkv, dq = ks["flash_bwd_sm90"]["passes"]
    call = dict(N=14, Lq=4096, Lk=8192, C=320)
    assert harness.bound_s(dkv, call, H100) * 1e3 == pytest.approx(1.2160, abs=5e-5)
    assert harness.bound_s(dq, call, H100) * 1e3 == pytest.approx(0.9120, abs=5e-5)


def test_flop_count_against_a_hand_count():
    lin = ref_nn.Linear(16, 24, device="meta")
    conv = ref_nn.Conv2d(3, 8, 3, padding=1, device="meta")
    x = torch.empty(5, 16, device="meta")
    img = torch.empty(2, 3, 10, 10, device="meta")
    q = torch.empty(4, 32, 16, device="meta")
    k = torch.empty(4, 48, 16, device="meta")

    def work():
        lin(x)
        conv(img)
        ref_nn.attention(q, k, k, heads=2)

    flops, calls = common.count(work)
    hand = 2 * 5 * 16 * 24 + 2 * 2 * 8 * 100 * 3 * 9 + 4 * 4 * 32 * 48 * 16
    assert flops == hand
    assert calls == [("packed", 4, 32, 48, 16, 2, False)]


def test_inputs_are_the_seeds():
    cfg = {"height": 64, "clip_length": 4, "audio_proj": {"seq_len": 5, "blocks": 2,
                                                           "channels": 4},
           "image_proj": {"clip_embeddings_dim": 16}, "n_motion_frames": 2}
    a = inputs.clip_request(2 ** 33 + 5, 1, cfg, 1, 2)
    b = inputs.clip_request(2 ** 33 + 5, 1, cfg, 1, 2)
    c = inputs.clip_request(2 ** 33 + 6, 1, cfg, 1, 2)
    assert (a["audio_windows"] == b["audio_windows"]).all()
    assert not (a["audio_windows"] == c["audio_windows"]).all()
    for m in a["masks"][0]:
        assert 0 < m.mean() < 1  # masks are not all ones
    assert 0 < a["face_region"].mean() < 1
    t = inputs.train_batch(7, 0, cfg, 2)
    assert t["pixel_values"].shape == (2, 4, 64, 64, 3)


@pytest.mark.parametrize("workload", ["infer-exact", "train-stage2-b4"])
def test_result_line(cell_runner, workload):
    out = cell_runner(workload)
    assert list(out)[:3] == ["correct", "attempted", "failed"]
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(out)
    assert list(out)[-1] == "checks"
    assert out["correct"] is True and out["attempted"] > 0 and out["failed"] == 0
    man = harness.manifest(ROOT)
    assert set(out["metrics"]) == {m["name"] for m in harness.metrics_for(
        man, "end_to_end", workload)}
    for v in out["metrics"].values():
        assert v["value"] > 0 or v["unit"] == "GiB"


def test_import_closure_has_no_jax():
    code = ("import sys, benchmark.run, benchmark.calibrate, benchmark.drivers.infer, "
            "benchmark.drivers.train, benchmark.reference.train;"
            "from benchmark import harness;"
            "[harness.reader(m['name']) for m in harness.manifest('.')['per_layer']];"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True).stdout
    tops = set(eval(out.strip().splitlines()[-1]))  # noqa: S307
    assert not tops & {"jax", "jaxlib", "flax", "hallo_tpu"}


def test_weights_spec_covers_the_port(tmp_path):
    from benchmark import weights
    from conftest import load
    from hallo_tpu_torch.utils.factory import build_models

    cfg = load("tiny.json")
    models = build_models("tiny", device="cpu")
    state = weights.make(cfg, 11, "cpu", torch.float32)
    weights.load(models.modules(), state)  # strict: every key both ways
    for top, sd in state.items():
        for name, t in sd.items():
            assert t.abs().max() > 0, (top, name)  # no zero-initialised head


def test_a_cell_on_more_cards_is_refused(capsys):
    from benchmark import run

    ov = copy.deepcopy(tiny_cell("infer-exact"))
    for w in ov["manifest"]["workloads"]:
        if w["name"] == "infer-exact":
            w["chips"] = 4
    ov["work"]["chips"] = 4
    rc = run.main(["--workload", "infer-exact", "--seed", "1", "--seconds", "1"],
                  device=torch.device("cpu"), overrides=ov)
    assert rc != 0 and capsys.readouterr().out == ""


def test_mfu_infer_counts_the_work_dispatched_in_the_window():
    import types

    plan = {"conditioning": (10, []), "eval": (100, []), "decode": (20, [])}
    out = dict(window_s=2.0, clips=1, work=dict(clips=2, evals=7, decodes=1))
    ctx = types.SimpleNamespace(kind="infer", peak={"bf16_flops": 1000.0}, plan=plan, out=out)
    read = harness.reader("mfu.infer")
    assert read(ctx) == pytest.approx(100.0 * (2 * 10 + 7 * 100 + 20) / (2.0 * 1000.0))
    assert read(types.SimpleNamespace(**dict(vars(ctx), out=dict(out, work={})))) is None
