"""The training cells: stage-2 steps through `train.step.make_train_step`,
one after another, on batches drawn from the seed and cycled from host
memory, as the trainer hands them over.

Set-up builds the step, its model and its optimizer state once, and drives
that same object through its first `check.steps` steps on batches that
all differ (they also warm every shape). From the program's state it reads
the leaf norms of the first gradient as the optimizer got it
(Adam's first moment after one step over 1 - beta1) and, after the last of
those steps, the leaf norms of each trainable parameter's change. The
window then runs the same object: it opens at the next step and ends at
the first step completed at or after `--seconds`; `train_samples_per_s`
is the samples of the steps completed in it over its length. Before each
step that may be the window's last (one that starts within twice the
longest step so far of `--seconds`) the card is synchronised, the clock
stops, and the trainable state (fp32 masters, Adam's moments and count) is
copied to host memory (`Snapshot`); then the clock runs on. From the last
step's snapshot and the state that step left, the program's readings of
that step: its loss, and the leaf norms of its clipped gradient ((mu after
- beta1 mu before) / (1 - beta1)) and of its change.

After the window the program is freed and the frozen reference (fp32, TF32
off) takes the set-up steps from the same weights, batches and generators,
and the window's last step from its snapshot, at the masters rounded to
the served dtype (the weights the program computes with), its AdamW update
made to the fp32 masters:

- `loss_rel`: each set-up step's loss against the reference's;
- `grad_rel`: the worst leaf's gap between the program's and the
  reference's first clipped gradient norms, over the larger of that leaf's
  reference norm and the median leaf's;
- `update_rel`: the same for the norms of the parameters' change;
- `window_loss_rel`, `window_grad_rel`, `window_update_rel`: the same of
  the window's last step.

Leaves whose reference gradient is under a thousandth of the median leaf's
are left out of the leaf numbers (they move by round-off alone).

With `--trace 1` the window's second step is profiled.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import inputs, trace as tr
from benchmark.drivers import common
from benchmark.reference import models as ref_models
from benchmark.reference import nn as ref_nn
from benchmark.reference.train import Stage2, leaf_norms


def _program(cfg: dict, seed: int, device):
    from hallo_tpu_torch.config import SchedulerConfig
    from hallo_tpu_torch.train.state import (
        AdamW, OptimizerConfig, TrainState, stage2_trainable, unfreeze)
    from hallo_tpu_torch.train.step import TrainConfig, make_train_step

    tc = cfg["train"]
    models = common.build_program(cfg, seed, device, remat=tc["gradient_checkpointing"],
                                  remat_inner=tc["gradient_checkpointing_inner"])
    trainable = unfreeze(models.modules(), stage2_trainable)
    opt = AdamW(OptimizerConfig(**cfg["optimizer"]))
    state = TrainState.create(trainable, opt)
    tcfg = TrainConfig(stage=2, scheduler=SchedulerConfig(**cfg["scheduler"]),
                       **{k: tc[k] for k in ("uncond_img_ratio", "uncond_audio_ratio",
                                             "uncond_ia_ratio", "start_ratio",
                                             "noise_offset", "snr_gamma")})
    return models, state, make_train_step(models, trainable, opt, tcfg)


def generator(seed: int, step: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) * 1_000_003 + int(step))


def _on(device, batch: dict) -> dict:
    def put(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)

    out = {k: put(v) for k, v in batch.items() if k != "masks"}
    out["masks"] = tuple(tuple(put(x) for x in lvl) for lvl in batch["masks"])
    return out


def gap(prog: torch.Tensor, ref: torch.Tensor, keep: torch.Tensor) -> float:
    """The worst kept leaf's |prog - ref| / max(ref, median ref)."""
    prog, ref = prog.double().cpu(), ref.double().cpu()
    med = ref[keep].median()
    d = (prog - ref).abs() / torch.maximum(ref, med)
    return float(d[keep].max())


class Snapshot:
    """Host copies of the trainable state before one step: the fp32
    masters, Adam's moments and its count."""

    def __init__(self, state):
        self.names = list(state.params)
        host = lambda t: torch.empty(t.shape, dtype=t.dtype)  # noqa: E731
        self.params = {k: host(v) for k, v in state.params.items()}
        self.mu = {k: host(state.opt_state["mu"][k]) for k in self.names}
        self.nu = {k: host(state.opt_state["nu"][k]) for k in self.names}
        self.index = self.count = None

    def take(self, state, index: int) -> None:
        for k in self.names:
            self.params[k].copy_(state.params[k])
            self.mu[k].copy_(state.opt_state["mu"][k])
            self.nu[k].copy_(state.opt_state["nu"][k])
        self.index, self.count = index, state.opt_state["count"]


def window_readings(state, snap: Snapshot, loss: float, beta1: float) -> dict:
    """The program's readings of the one step that took `snap` to `state`."""
    g, d = [], []
    for k in snap.names:
        mu = state.opt_state["mu"][k]
        g.append(((mu - beta1 * snap.mu[k].to(mu.device)) / (1.0 - beta1)).norm())
        d.append((state.params[k] - snap.params[k].to(mu.device)).norm())
    return dict(losses=[loss], grad_norms=torch.stack(g), change_norms=torch.stack(d),
                names=snap.names)


def _reference_window(st: Stage2, cfg: dict, seed: int, snap: Snapshot, batch: dict,
                      device) -> dict:
    """The reference's step from `snap`: loss and gradient at the masters
    rounded to the served dtype, the update made to the fp32 masters."""
    served = common.DTYPES[cfg["dtype"]]
    masters = {}
    with torch.no_grad():
        for k, p in st.params.items():
            masters[k] = snap.params[k].to(device, copy=True)
            p.copy_(masters[k].to(served))
            st.mu[k].copy_(snap.mu[k])
            st.nu[k].copy_(snap.nu[k])
    st.count = snap.count
    r = st.step(_on(device, batch), generator(seed, snap.index, device), masters=masters)
    names = list(st.params)
    change = torch.stack([(masters[k] - snap.params[k].to(device)).norm() for k in names])
    return dict(losses=[r["loss"]], grad_norms=r["grad_norms"], change_norms=change,
                names=names)


def reference_readings(cfg, seed, batches, steps, device, control=False,
                       window=None) -> dict:
    """The reference's losses, first clipped gradient's leaf norms and
    leaf norms of the change after `steps` steps; `control`: in fp8.
    `window` (a `Snapshot` and its step's batch): also the readings of that
    step from the snapshot, under "window"."""
    mods = common.build_reference(cfg, seed, device)
    with ref_nn.fp8() if control else contextlib.nullcontext():
        st = Stage2(mods, cfg, device)
        init = {k: p.detach().clone() for k, p in st.params.items()}
        losses, g1 = [], None
        for i in range(steps):
            r = st.step(_on(device, batches[i]), generator(seed, i, device))
            losses.append(r["loss"])
            if i == 0:
                g1 = r["grad_norms"]
        delta = leaf_norms([(p.detach() - init[k]) for k, p in st.params.items()])
        out = dict(losses=losses, grad_norms=g1, change_norms=delta, names=list(st.params))
        del init
        if window is not None:
            out["window"] = _reference_window(st, cfg, seed, *window, device)
    del mods, st
    common.free()
    return out


def compare(prog: dict, ref: dict) -> Dict[str, float]:
    if sorted(ref["names"]) != sorted(prog["names"]):
        raise RuntimeError("the program's trainable leaves are not the reference's")
    order = [prog["names"].index(n) for n in ref["names"]]
    prog = dict(prog, grad_norms=prog["grad_norms"][order],
                change_norms=prog["change_norms"][order])
    rels = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])]
    g = ref["grad_norms"].double().cpu()
    keep = g >= 1e-3 * g.median()
    return dict(loss_rel=max(rels), loss_rel_steps=rels,
                grad_rel=gap(prog["grad_norms"], ref["grad_norms"], keep),
                update_rel=gap(prog["change_norms"], ref["change_norms"], keep),
                worst=worst(prog, ref, keep))


def worst(prog: dict, ref: dict, keep: torch.Tensor, n: int = 3) -> dict:
    """The `n` worst leaves of each leaf comparison, with both norms (the
    readings' detail)."""
    out = {}
    for key in ("grad_norms", "change_norms"):
        p, r = prog[key].double().cpu(), ref[key].double().cpu()
        d = ((p - r).abs() / torch.maximum(r, r[keep].median())).masked_fill(~keep, -1)
        idx = d.argsort(descending=True)[:n].tolist()
        out[key] = [(ref["names"][i], float(p[i]), float(r[i])) for i in idx]
    out["losses"] = (prog["losses"], ref["losses"])
    return out


def setup_steps(cfg, seed, models, state, step, batches, n, device):
    """Drive the step through its first `n` steps; the program's readings."""
    beta1 = cfg["optimizer"]["beta1"]
    init = {k: v.clone() for k, v in state.params.items()}
    losses, g1 = [], None
    for i in range(n):
        t0 = time.perf_counter()
        state, met = step(state, batches[i], generator(seed, i, device))
        losses.append(met["loss"])
        if i == 0:
            g1 = leaf_norms([state.opt_state["mu"][k] / (1.0 - beta1) for k in state.params])
    step_s = time.perf_counter() - t0
    names = list(state.params)
    delta = leaf_norms([state.params[k] - init[k] for k in names])
    del init
    return state, dict(losses=losses, grad_norms=g1, change_norms=delta, names=names,
                       step_s=step_s)


def window_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    return {f"window_{k}": v for k, v in compare(prog, ref).items()}


def work_plan(cfg: dict, batch: int) -> dict:
    """FLOPs and attention calls of one step (forward and backward, without
    the checkpoints' replays) from the reference on meta tensors."""
    mods = ref_models.build(cfg, "meta")
    st = Stage2(mods, cfg, "meta")
    mods["denoising_net"].checkpoint = False
    h, f, m = cfg["height"], cfg["clip_length"], cfg["n_motion_frames"]
    ap, ip = cfg["audio_proj"], cfg["image_proj"]
    e = lambda *s: torch.empty(*s, device="meta")  # noqa: E731
    b = dict(pixel_values=e(batch, f, h, h, 3), ref_pixels=e(batch, h, h, 3),
             motion_pixels=e(batch, m, h, h, 3),
             audio_windows=e(batch, f, ap["seq_len"], ap["blocks"], ap["channels"]),
             face_emb=e(batch, ip["clip_embeddings_dim"]), face_region=e(batch, h, h, 3),
             masks=tuple(tuple(e(batch, (h // 8 // 2 ** d) ** 2) for _ in range(3))
                         for d in range(4)))

    def fwd_bwd():
        loss = st.loss(b, meta=True)
        torch.autograd.grad(loss, list(st.params.values()), allow_unused=True)

    out = {"step": common.count(fwd_bwd), "stage_spans": {"step": "train_step"}}
    out["step_flops"] = out["step"][0]
    return out


def run(ctx) -> dict:
    cfg, traffic, work, args = ctx.cfg, ctx.traffic, ctx.work, ctx.args
    dev = ctx.device
    check = work["check"]
    n = check["steps"]
    bsz = traffic["batch"]
    batches = [inputs.train_batch(args.seed, i, cfg, bsz) for i in range(traffic["batches"])]
    models, state, step = _program(cfg, args.seed, dev)
    state, prog = setup_steps(cfg, args.seed, models, state, step, batches, n, dev)
    snap = Snapshot(state)
    common.sync()

    tracer = tr.Tracer(["train_step"]) if args.trace else None
    times: List[float] = []
    losses: List[float] = []
    longest = prog["step_s"]
    attempted = failed = 0
    common.reset_peak()
    t_start = time.perf_counter()
    setup_s = t_start - ctx.t0
    i = n
    while True:
        if time.perf_counter() - t_start + 2 * longest >= args.seconds:
            # this step may be the window's last: its state, off the clock
            common.sync()
            paused = time.perf_counter()
            snap.take(state, i)
            t_start += time.perf_counter() - paused
        traced = tracer is not None and len(times) == 1
        if traced:
            tracer.start()
            rf = torch.autograd.profiler.record_function("train_step")
            rf.__enter__()
        attempted += 1
        t_step = time.perf_counter()
        try:
            state, met = step(state, batches[i % len(batches)], generator(args.seed, i, dev))
            losses.append(met["loss"])
            failed += int(not np.isfinite(met["loss"]))
        except Exception as exc:  # a step that raises counts as failed
            losses.append(float("nan"))
            failed += 1
            ctx.log(f"step {i} failed: {type(exc).__name__}: {exc}")
        if traced:
            rf.__exit__(None, None, None)
            tracer.stop()
        else:
            longest = max(longest, time.perf_counter() - t_step)
        times.append(time.perf_counter() - t_start)
        i += 1
        if times[-1] >= args.seconds:
            break
    common.sync()
    window_s = times[-1]
    peak = common.peak_bytes()
    win = None
    if snap.index == i - 1:
        win = window_readings(state, snap, losses[-1], cfg["optimizer"]["beta1"])
    else:
        ctx.log(f"the window's last step ({i - 1}) has no snapshot ({snap.index})")
    del models, state, step
    common.free()
    ref = reference_readings(cfg, args.seed, batches, n, dev,
                             window=(snap, batches[(i - 1) % len(batches)]) if win else None)
    numbers = compare(prog, ref)
    if win:
        numbers.update(window_numbers(win, ref["window"]))
    ctx.log(f"readings {numbers}")
    out = dict(attempted=attempted, failed=failed, window_s=window_s, setup_s=setup_s,
               peak=peak, steps=len(times), completions=times)
    out["correct"], out["checks"] = common.judged(numbers, check["limits"])
    out["end_to_end"] = {
        "train_samples_per_s": (len(times) * bsz / window_s, "samples/s"),
        "peak_gib": (peak / 2 ** 30, "GiB"),
        "setup_s": (setup_s, "s"),
    }
    if tracer is not None and tracer.slice is not None:
        out["slice"] = tracer.slice
        out["plan"] = work_plan(cfg, bsz)
    return out


def readings(ctx, seeds) -> list:
    """The program's, its faults' and the control's numbers on each seed
    (no window): the readings the limits are set from. The program's step
    `ctx.window_step` (by default the one after the set-up steps; the
    window's last is about step 16 at 51 s), reached as the window reaches
    it, on the batches cycled, stands for the window's last step, judged
    from its snapshot. Faults, planted in the program's batch: `half_batch`
    (the loss over the first half of the batch alone). With
    `ctx.window_only` the set-up steps are not judged (nor the faults)."""
    cfg, traffic, check = ctx.cfg, ctx.traffic, ctx.work["check"]
    n, bsz = check["steps"], traffic["batch"]
    beta1 = cfg["optimizer"]["beta1"]
    window_only = getattr(ctx, "window_only", False)
    last = max(n, getattr(ctx, "window_step", None) or n)
    rows = []
    for k, seed in enumerate(seeds):
        batches = [inputs.train_batch(seed, i, cfg, bsz)
                   for i in range(max(n + 1, traffic["batches"]))]
        row = {"seed": seed, "window_step": last}
        runs = {"program": batches}
        if k < ctx.faults and not window_only:
            half = [{k: (v[:bsz // 2] if k != "masks" else
                         tuple(tuple(x[:bsz // 2] for x in lvl) for lvl in v))
                     for k, v in bt.items()} for bt in batches]
            runs["half_batch"] = half
        progs = {}
        for name, bts in runs.items():
            models, state, step = _program(cfg, seed, ctx.device)
            t0 = time.perf_counter()
            state, progs[name] = setup_steps(cfg, seed, models, state, step, bts, n, ctx.device)
            row[f"{name}_s"] = time.perf_counter() - t0
            if name == "program":
                for j in range(n, last):
                    state, _ = step(state, bts[j % len(bts)], generator(seed, j, ctx.device))
                snap = Snapshot(state)
                snap.take(state, last)
                state, met = step(state, bts[last % len(bts)],
                                  generator(seed, last, ctx.device))
                win = window_readings(state, snap, met["loss"], beta1)
            del models, state, step
            common.free()
        window = (snap, batches[last % len(batches)])
        t0 = time.perf_counter()
        ref = reference_readings(cfg, seed, batches, 0 if window_only else n, ctx.device,
                                 window=window)
        row["reference_s"] = time.perf_counter() - t0
        row["program_window"] = window_numbers(win, ref["window"])
        if not window_only:
            for name, prog in progs.items():
                row[name] = compare(prog, ref)
        if k < ctx.control:
            ctl = reference_readings(cfg, seed, batches, 0 if window_only else n, ctx.device,
                                     control=True, window=window)
            row["control_window"] = window_numbers(ctl["window"], ref["window"])
            if not window_only:
                ctl["names"] = ref["names"]
                row["control"] = compare(ctl, ref)
        ctx.log(str(row))
        rows.append(row)
    return rows
