"""Tensor parallelism (`hallo_tpu_torch/parallel/tp.py`) on the CPU: the
plan against hallo_tpu's `tp_param_specs` on the tiny trees and at full
width (shapes only), and the stage-2 trainer at world 2 with `model: 2`
(gloo ranks from tests/torch_parallel_ranks.py). The sharded layers and
the sharded steps are in tests/test_torch_parallel_step.py, beside the JAX
step they share."""

import os
import shutil

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from hallo_tpu.parallel.tp import DEFAULT_MIN_DIM as JAX_MIN_DIM
from hallo_tpu.parallel.tp import count_sharded as jax_count_sharded
from hallo_tpu.parallel.tp import tp_param_specs
from hallo_tpu.utils.factory import build_models as jax_build_models
from hallo_tpu_torch.convert.from_jax import MAPPERS
from hallo_tpu_torch.parallel import tp
from hallo_tpu_torch.train.stage2 import train_stage2_process
from hallo_tpu_torch.utils import checkpoint as ckpt
from hallo_tpu_torch.utils.factory import build_models

from tests.test_torch_parallel import assert_same_tree
from tests.test_torch_train import _trainer_cfg, _write_dataset
from tests.torch_parallel_ranks import spawn


def jax_sharded(params: dict, n: int, min_dim: int) -> set:
    """(module, JAX path, axis) of every leaf `tp_param_specs` shards."""
    out = set()
    for top, tree in params.items():
        specs = tp_param_specs(tree, n, min_dim)
        leaves = jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda x: isinstance(x, P))[0]
        for path, spec in leaves:
            if any(a is not None for a in spec):
                out.add((top, tuple(k.key for k in path), list(spec).index("model")))
    return out


def port_sharded(plan: dict) -> set:
    """The port's plan in JAX's terms: each sharded parameter's JAX path
    (through the key maps) and the axis of JAX's layout (a weight's rows
    are JAX's kernel's columns)."""
    out = set()
    for name, shard in plan.items():
        if shard is None:
            continue
        top, key = name.split(".", 1)
        path, transform = MAPPERS[top](key)
        axis = shard.dim if transform is None else 1 - shard.dim
        assert transform is None or transform.__name__ in ("t_linear", "t_conv1x1_to_dense")
        out.add((top, ("params",) + tuple(path), axis))
    return out


@pytest.fixture(scope="module")
def tiny_trees():
    jm = jax_build_models("tiny", init_key=jax.random.PRNGKey(0), height=128, width=128,
                          clip_length=4, n_motion_frames=2)
    return jm.params, build_models("tiny", device="cpu").modules()


@pytest.mark.parametrize("n,min_dim", [(2, 16), (2, 32), (4, 16), (4, 32)])
def test_plan_matches_jax_on_the_tiny_trees(tiny_trees, n, min_dim):
    """`tp_plan` shards exactly the leaves `tp_param_specs` shards, on the
    same axis, over every tiny module (the VAE included: nothing of it
    reaches min_dim), with the GEGLU projections' value / gate halves
    (`Shard.parts` 2) the only permuted layout."""
    params, modules = tiny_trees
    plan = tp.tp_plan(modules, n, min_dim)
    want = jax_sharded(params, n, min_dim)
    assert port_sharded(plan) == want and tp.count_sharded(plan) == len(want) > 0
    assert not any(s.parts != 1 for k, s in plan.items() if s and "ff.net.0.proj" not in k)
    assert not any(k.startswith("vae.") for k, s in plan.items() if s)


def test_plan_matches_jax_at_full_width():
    """At full width (shapes only: JAX's `eval_shape`, the port on the meta
    device) over 8 model ranks at the default min_dim (1280): the same
    leaves on the same axes; at least 100 of the denoiser's and 50 of the
    ReferenceNet's (tests/test_tensor_parallel.py's counts); none of the
    VAE's; image_proj.proj (512 -> 3072) column-parallel, audio_proj.proj1
    (46080 -> 512) row-parallel and proj3 (512 -> 24576) column-parallel;
    a 1280 -> 1280 to_out column-parallel (a tie goes column), a resnet's
    1280 -> 320 time_emb_proj row-parallel."""
    assert tp.DEFAULT_MIN_DIM == JAX_MIN_DIM == 1280
    jm = jax_build_models("full")
    shapes = jax.eval_shape(lambda key: jm.init_params(key, height=512, width=512),
                            jax.random.PRNGKey(0))
    modules = build_models("full", device="meta").modules()
    plan = tp.tp_plan(modules, 8)
    want = jax_sharded(shapes, 8, 1280)
    assert port_sharded(plan) == want
    for top, at_least in (("denoising_net", 100), ("reference_net", 50)):
        n = sum(1 for k, s in plan.items() if s and k.startswith(top + "."))
        assert n == jax_count_sharded(tp_param_specs(shapes[top], 8)) >= at_least
    assert not any(k.startswith("vae.") for k, s in plan.items() if s)
    assert plan["image_proj.proj.weight"] == tp.Shard(0)
    assert plan["audio_proj.proj1.weight"] == tp.Shard(1) and plan["audio_proj.proj1.bias"] is None
    assert plan["audio_proj.proj3.weight"] == tp.Shard(0)
    mid = "denoising_net.mid_block.attentions.0.transformer_blocks.0."
    assert plan[mid + "attn1.to_out.0.weight"] == tp.Shard(0)
    assert plan[mid + "ff.net.0.proj.weight"] == tp.Shard(0, parts=2)
    assert plan[mid + "ff.net.2.weight"] == tp.Shard(1)
    assert plan["denoising_net.up_blocks.3.resnets.0.time_emb_proj.weight"] == tp.Shard(1)


def test_trainer_at_model_2_resumes_bitwise_and_loads_on_one_process(tmp_path):
    """`train_stage2_process` in 2 gloo ranks with `model: 2` (the tiny
    models sharded at min_dim 16, the 8-bit AdamW stepping the sharded
    leaves whole, a checkpoint every step): 2 steps, resumed to step 3, give
    bit for bit the gathered state of an unbroken 3-step run. The
    single-process trainer then loads that run's checkpoint-3 (no step left
    to take): its state is the gathered one bit for bit, and its final_net
    export holds the world-2 run's (written from the weights gathered over
    the model group) bit for bit."""
    root = str(tmp_path)
    meta = _write_dataset(root)
    parallel = os.path.join(root, "parallel.yaml")
    with open(parallel, "w") as fh:
        fh.write("mesh:\n  data: 1\n  seq: 1\n  model: 2\nzero_optimizer_sharding: true\n")

    def cfg(name, steps, **extra):
        c = _trainer_cfg(root, meta, name, steps)
        c.solver.use_8bit_adam = True
        c.update({"parallel_config": parallel, "checkpointing_steps": 1, **extra})
        return c

    runs = spawn("trainer", 2, os.path.join(root, "run"), timeout=240, tp_min_dim=16,
                 cfgs=[cfg("resumed", 2), cfg("resumed", 3), cfg("straight", 3)])[0]
    resumed, straight = runs[1], runs[2]
    assert resumed["step"] == straight["step"] == 3
    assert_same_tree(resumed["params"], straight["params"])
    assert_same_tree(resumed["opt_state"], straight["opt_state"])

    exp = os.path.join(root, "exp")
    shutil.copytree(os.path.join(exp, "straight"), os.path.join(exp, "single"),
                    ignore=shutil.ignore_patterns("final_net", "metrics.jsonl"))
    state = train_stage2_process(cfg("single", 3, parallel_config=""), device="cpu")
    assert state.step == 3
    assert_same_tree(state.state_dict(), straight)
    for name in ("denoising_net", "audio_proj"):
        got, want = (torch.load(os.path.join(exp, run, "final_net", f"{name}.pt"))
                     for run in ("straight", "single"))
        assert_same_tree(got, want)
    assert ckpt.latest_step(os.path.join(exp, "single")) == 3
