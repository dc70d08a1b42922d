"""Shared set-up of the benchmark's own tests: the checkout's root on the
path, and a one-process run of a cell at the test widths on the CPU."""

from __future__ import annotations

import io
import json
import os
import sys
from contextlib import redirect_stdout

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def load(name: str) -> dict:
    with open(os.path.join(DATA, name)) as fh:
        return json.load(fh)


def load_work(workload: str) -> dict:
    """`benchmark/workloads/<workload>.json`."""
    with open(os.path.join(ROOT, "benchmark", "workloads", f"{workload}.json")) as fh:
        return json.load(fh)


def tiny_cell(workload: str) -> dict:
    """The overrides that run `workload` at the test widths: the tiny
    configuration, one identity, three steps, short requests."""
    from benchmark import harness

    man = harness.manifest(ROOT)
    w = harness.cell(man, workload)
    work = harness.load_json(os.path.join(harness.HERE, "workloads", f"{workload}.json"))
    traffic = harness.load_json(os.path.join(harness.HERE, "traffic", f"{w['traffic']}.json"))
    if traffic["kind"] == "infer":
        cfg = load("tiny.json")
        traffic = dict(traffic, steps=3, clips_per_request=3)
    else:
        cfg = load("tiny_train.json")
        traffic = dict(traffic, batch=2)
    return dict(manifest=man, cfg=cfg, traffic=traffic, work=work)


def run_cell(workload: str, seconds: float = 1.0, trace: int = 0, seed: int = 3000000001,
             overrides=None) -> dict:
    """One run of the harness on the CPU; its last stdout line, parsed."""
    from benchmark import run

    ov = overrides or tiny_cell(workload)
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = run.main(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
                       "--trace", str(trace)], device=torch.device("cpu"), overrides=ov)
    assert rc == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.fixture
def cell_runner():
    return run_cell
