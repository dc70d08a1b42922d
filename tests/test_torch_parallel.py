"""The port's data and clip parallelism on the CPU: gloo ranks spawned by
`tests/torch_parallel_ranks.py` (torch.multiprocessing, one thread a rank, a
FileStore under the test's tmp_path, a timeout on every spawn), held against
hallo_tpu under `shard_map` on the conftest's virtual CPU devices, or against
the port on one process, in fp32 at the tiny widths.

(a) the motion module, (b) the inflated GroupNorm, (c) the denoiser,
(e) ZeRO, (f) the pipeline's clip, (g) the mesh and settings of
configs/parallel.yaml, (h) the trainer's checkpoint and resume; (d), the
stage-2 step, is in tests/test_torch_parallel_step.py (a file of its own,
so that a test run's workers share the two).
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh, PartitionSpec as P

try:
    from jax import shard_map
except ImportError:  # jax < 0.8
    from jax.experimental.shard_map import shard_map

from hallo_tpu.config import MotionModuleConfig as JaxMotionConfig
from hallo_tpu.models import layers as jax_layers
from hallo_tpu.models.motion import MotionModule as JaxMotionModule
from hallo_tpu.parallel import mesh as jax_mesh
from hallo_tpu.utils.factory import build_models as jax_build_models
from hallo_tpu_torch.config import MotionModuleConfig
from hallo_tpu_torch.convert import keymaps
from hallo_tpu_torch.convert.from_jax import MAPPERS, state_dict_from_jax
from hallo_tpu_torch.models.motion import MotionModule
from hallo_tpu_torch.parallel import mesh as tmesh
from hallo_tpu_torch.train import state as tstate
from hallo_tpu_torch.train.stage2 import train_stage2_process
from hallo_tpu_torch.train.state import global_norm
from hallo_tpu_torch.utils.factory import build_models, dummy_clip_inputs

from tests.test_torch_train import _trainer_cfg, _write_dataset, perturb_all
from tests.torch_parallel_ranks import run_pipeline, spawn


def jax_seq_mesh(n: int) -> JaxMesh:
    return JaxMesh(np.asarray(jax.devices()[:n]), ("seq",))


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# --- (a) the motion module ---------------------------------------------------

MOTION_CFG = dict(num_attention_heads=2, temporal_position_encoding_max_len=16,
                  norm_num_groups=4)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("with_motion", [True, False])
def test_motion_module_clip_parallel(tmp_path, world, with_motion):
    """The port's motion module over `world` gloo ranks against hallo_tpu's
    under shard_map (tests/test_clip_parallel.py's setup, every leaf
    perturbed so that proj_out is not zero) at atol/rtol 2e-5; and the
    gradients summed over the ranks against the unsharded module's (the
    all_to_all's backward and the motion-frame slice), relative L2 1e-5."""
    b, f, h, w, c, m = 2, 8, 2, 4, 8, 2
    rng = np.random.default_rng(0)
    x = rng.standard_normal((b, f, h, w, c)).astype(np.float32)
    mf = rng.standard_normal((b, m, h * w, c)).astype(np.float32) if with_motion else None
    gy = rng.standard_normal((b, f, c, h, w)).astype(np.float32)
    mod = JaxMotionModule(JaxMotionConfig(**MOTION_CFG))
    args = (jnp.asarray(x),) + ((jnp.asarray(mf),) if with_motion else ())
    params = perturb_all(mod.init(jax.random.PRNGKey(0), *args), seed=1)
    fn = shard_map(
        lambda p_, x_, *mf_: mod.apply(p_, x_, mf_[0] if mf_ else None, seq_axis="seq"),
        mesh=jax_seq_mesh(world),
        in_specs=(P(), P(None, "seq")) + ((P(),) if with_motion else ()),
        out_specs=P(None, "seq"))
    want = np.asarray(jax.jit(fn)(params, *args))

    port = MotionModule(c, MotionModuleConfig(**MOTION_CFG))
    state = state_dict_from_jax(port, np_tree(params),
                                lambda k: keymaps._map_motion_module(k, ()))
    ranks = spawn("motion", world, str(tmp_path / "run"), cfg=MOTION_CFG,
                  state={k: v.numpy() for k, v in state.items()},
                  x=x.transpose(0, 1, 4, 2, 3).copy(), mf=mf, gy=gy)
    got = torch.cat([r["out"] for r in ranks], dim=1).permute(0, 1, 3, 4, 2).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    for k, g in ranks[0]["plain"].items():
        assert rel_l2(ranks[0]["grads"][k], g) < 1e-5, k
        assert torch.equal(ranks[-1]["grads"][k], ranks[0]["grads"][k]), k


# --- (b) the inflated GroupNorm ------------------------------------------------


@pytest.mark.parametrize("world", [2, 4])
def test_group_norm_over_seq_group(tmp_path, world):
    """`group_norm(..., group=)` against JAX's `axis_name` form under
    shard_map: relative L2 1e-6, and every element within 1e-5 (the
    unsharded port and JAX differ by up to 6.4e-6 on these inputs: mean 2
    and unit variance, summed in another order). The same norm without the
    group (each rank's moments alone) must miss by more than 1e-2."""
    rng = np.random.default_rng(4)
    x = (2.0 + rng.normal(size=(2, 8, 5, 4, 8))).astype(np.float32)  # (B, F, H, W, C)
    scale = (1 + 0.3 * rng.normal(size=8)).astype(np.float32)
    bias = rng.normal(size=8).astype(np.float32)
    fn = shard_map(
        lambda x_: jax_layers.group_norm(x_, jnp.asarray(scale), jnp.asarray(bias), 4, 1e-6,
                                         axis_name="seq"),
        mesh=jax_seq_mesh(world), in_specs=(P(None, "seq"),), out_specs=P(None, "seq"))
    want = np.asarray(jax.jit(fn)(jnp.asarray(x)))
    ranks = spawn("group_norm", world, str(tmp_path / "run"),
                  x=x.transpose(0, 1, 4, 2, 3).copy(), weight=scale, bias=bias, groups=4,
                  eps=1e-6)
    got, fault = (torch.cat([r[k] for r in ranks], dim=1).permute(0, 1, 3, 4, 2).numpy()
                  for k in ("out", "fault"))
    assert rel_l2(got, want) < 1e-6
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert rel_l2(fault, want) > 1e-2


# --- (c) the denoiser ----------------------------------------------------------


def denoiser_inputs(seed, b=2, f=4, m=2, hw=16):
    """Inputs of the tiny denoiser at 128x128 (latents 16x16: the deepest
    level's 4 sites split over 2 and 4 ranks)."""
    rng = np.random.default_rng(seed)

    def r(*shape):
        return rng.normal(size=shape).astype(np.float32)

    dims = {"down_0": [(256, 8)], "down_1": [(64, 16)], "down_2": [(16, 16)],
            "mid": [(4, 16)], "up_1": [(16, 16)] * 2, "up_2": [(64, 16)] * 2,
            "up_3": [(256, 8)] * 2}
    return dict(
        x=r(b, f, hw, hw, 4), t=np.array([3.0, 11.0], np.float32), ctx=r(b, 4, 12),
        audio=r(b, f, 3, 6), face=0.1 * r(b, f, hw, hw, 8),
        masks=tuple(tuple((rng.uniform(size=(b * f, n)) > 0.3).astype(np.float32)
                          for _ in range(3)) for n in (256, 64, 16, 4)),
        scale=np.array([1.3, 0.7, 0.4], np.float32), uncond=np.array([1.0, 0.0], np.float32),
        ref={k: [r(b, n, c) for n, c in v] for k, v in dims.items()},
        mot={k: [r(b, m, n, c) for n, c in v] for k, v in dims.items()},
    )


def test_denoiser_clip_parallel(tmp_path):
    """The tiny denoiser at seq 2 (gloo) against JAX's unsharded denoiser:
    relative L2 1e-4. Weights from `convert/from_jax.py`, every bias
    perturbed; motion frames fused at every block (`train`)."""
    jm = jax_build_models("tiny", init_key=jax.random.PRNGKey(0), height=128, width=128,
                          clip_length=4, n_motion_frames=2)
    params = perturb_all(jm.params["denoising_net"], seed=3)
    d = denoiser_inputs(5)
    want = np.asarray(jax.jit(lambda p: jm.denoising_net.apply(
        p, jnp.asarray(d["x"]), jnp.asarray(d["t"]), jnp.asarray(d["ctx"]),
        jax.tree.map(jnp.asarray, d["ref"]), jax.tree.map(jnp.asarray, d["mot"]),
        jnp.asarray(d["audio"]), jnp.asarray(d["face"]), jax.tree.map(jnp.asarray, d["masks"]),
        jnp.asarray(d["scale"]), jnp.asarray(d["uncond"]), train=True))(params))
    den = build_models("tiny", device="cpu").denoising_net
    state = state_dict_from_jax(den, np_tree(params), MAPPERS["denoising_net"])
    ranks = spawn("denoiser", 2, str(tmp_path / "run"),
                  state={k: v.numpy() for k, v in state.items()}, inputs=d)
    got = torch.cat(ranks, dim=1).movedim(2, -1).numpy()
    assert rel_l2(got, want) < 1e-4


# --- (e) ZeRO ---------------------------------------------------------------------

# leaves of one block and less, of several blocks, and one that ends in a
# partial block: 13 rows of 256, split inside leaves at world 2 and 4
ZERO_SHAPES = {"a": (3, 100), "b": (10,), "c": (600,), "d": (17, 31), "e": (1000,)}


def dyadic(rng, shape):
    """Multiples of 2^-10 with |k| <= 15: sums of up to 65536 squares are
    exact in fp32, and so are the means over 2 and 4 identical copies, in
    any order."""
    return (rng.integers(-15, 16, size=shape) * 2.0**-10).astype(np.float32)


def assert_same_tree(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_same_tree(got[k], want[k], f"{path}.{k}")
    elif torch.is_tensor(want):
        assert got.dtype == want.dtype and torch.equal(got, want), path
    else:
        assert got == want, path


ZERO_VARIANTS = [(False, 1), (True, 1), (False, 2), (True, 2)]


def zero_variant(world, eight_bit, accumulate):
    """(init, grads, opt_kw, resume_grads) of one case."""
    rng = np.random.default_rng(world * 10 + accumulate + 100 * eight_bit)
    init = {k: rng.normal(size=s).astype(np.float32) for k, s in ZERO_SHAPES.items()}
    calls = [{k: dyadic(rng, s) for k, s in ZERO_SHAPES.items()} for _ in range(3 * accumulate)]
    more = [{k: dyadic(rng, s) for k, s in ZERO_SHAPES.items()} for _ in range(accumulate)]
    opt_kw = dict(learning_rate=1e-2, max_grad_norm=1e3, lr_warmup_steps=1,
                  use_8bit_adam=eight_bit, gradient_accumulation_steps=accumulate)
    return init, calls, opt_kw, more


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def zero_runs(request, tmp_path_factory):
    """Every ZERO_VARIANTS case over ZeRO at data = world, in one spawn."""
    world = request.param
    root = str(tmp_path_factory.mktemp(f"zero{world}") / "run")
    variants = [zero_variant(world, *v) for v in ZERO_VARIANTS]
    return world, variants, spawn("zero_optimizer", world, root, variants=variants)[0]


@pytest.mark.parametrize("eight_bit,accumulate", ZERO_VARIANTS)
def test_zero_matches_unsharded_optimizer(zero_runs, eight_bit, accumulate):
    """ZeRO-2 at data = world on identical gradients, through the
    reduce-scatter, bit for bit against the unsharded optimizer: AdamW's
    masters and moments, the 8-bit AdamW's codes and scales (each shard made
    of whole 256-blocks), the accumulator, the parameters all-gathered into
    the model; then a resume from the gathered single-card state. The clip
    is inactive there (max_grad_norm 1e3); the sharded norm that the clip
    takes equals `global_norm` to 1e-6."""
    world, variants, runs = zero_runs
    i = ZERO_VARIANTS.index((eight_bit, accumulate))
    (init, calls, opt_kw, more), got = variants[i], runs[i]
    trainable = {k: torch.nn.Parameter(torch.from_numpy(v)) for k, v in init.items()}
    opt = tstate.make_optimizer(tstate.OptimizerConfig(**opt_kw))
    state = tstate.TrainState.create(trainable, opt)
    for g in calls:
        opt.update({k: torch.from_numpy(v) for k, v in g.items()}, state.opt_state, state.params)
    assert_same_tree(got["state"], state.state_dict())
    assert_same_tree(got["written"], state.params)
    for g in more:
        opt.update({k: torch.from_numpy(v) for k, v in g.items()}, state.opt_state, state.params)
    assert_same_tree(got["resumed"], state.state_dict())
    assert got["rows"] == -(-13 // world)
    np.testing.assert_allclose(
        got["norm"], float(global_norm([torch.from_numpy(v) for v in calls[0].values()])),
        rtol=1e-6)


# --- (f) the pipeline ------------------------------------------------------------

PIPE_VARIANTS = [
    dict(num_inference_steps=3, clip_length=4, n_motion_frames=2),
    # the CFG cache with its tail, and the dynamic step cache (the threshold
    # sits between its scores: some steps reuse, some recompute)
    dict(num_inference_steps=12, clip_length=4, n_motion_frames=2, sampler="unipc",
         cfg_cache_stride=2, cfg_tail=1, step_cache="dynamic", step_cache_threshold=0.15),
]


def test_pipeline_clip_parallel(tmp_path):
    """Two clips of the tiny pipeline at 128x128 at seq 2 (gloo) against the
    port's unsharded pipeline: the latents each VAE decode receives at
    relative L2 1e-5, the videos within one uint8 step, the same steps taken
    (full, cond-only, reuse) and the same dynamic-cache scores to 1e-5, for
    plain DDIM and for UniPC with the CFG cache, its tail and the dynamic
    step cache. Every weight is perturbed (the zero-initialised motion
    proj_out would make the motion modules the identity)."""
    models = build_models("tiny", device="cpu")
    gen = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for module in models.modules().values():
            for p in module.parameters():
                p.add_(0.05 * torch.randn(p.shape, generator=gen))
    states = {k: {n: v.numpy() for n, v in mod.state_dict().items()}
              for k, mod in models.modules().items()}
    inputs = dummy_clip_inputs(models, 128, 128, 8, seed=3)
    rng = np.random.default_rng(4)
    inputs["masks"] = tuple(tuple((rng.uniform(size=x.shape) > 0.3).astype(np.float32)
                                  for x in lvl) for lvl in inputs["masks"])
    ranks = spawn("pipeline_clip", 2, str(tmp_path / "run"), states=states, inputs=inputs,
                  variants=PIPE_VARIANTS)
    for v, kw in enumerate(PIPE_VARIANTS):
        want = run_pipeline(models, None, inputs, kw)
        got = [r[v] for r in ranks]
        assert len(set(want["kinds"])) == (1 if v == 0 else 3), want["kinds"]
        assert all(abs(x - kw.get("step_cache_threshold", 1)) > 1e-3 for x in want["scores"])
        for r in got:
            assert r["kinds"] == want["kinds"]
            np.testing.assert_allclose(r["scores"], want["scores"], rtol=1e-5)
            assert np.abs(r["video"] - want["video"]).max() <= 1.0 / 255 + 1e-6
        for c, lat in enumerate(want["latents"]):
            assert rel_l2(torch.cat([r["latents"][c] for r in got], dim=1), lat) < 1e-5, c


# --- (h) the trainer ------------------------------------------------------------


def test_trainer_resume_at_world_2_is_bitwise(tmp_path):
    """`train_stage2_process` in 2 gloo ranks (data 2 from a parallel YAML,
    ZeRO-2, the 8-bit AdamW): 2 steps that write checkpoint-2 (rank 0, the
    single-card format), resumed to step 3, give bit for bit the state of an
    unbroken 3-step run. The checkpoint then resumes in the single-process
    trainer at the same global batch (train_bs 4): its step-2 loss is the
    world-2 run's to 1e-5, and rank 0 alone wrote metrics.jsonl."""
    root = str(tmp_path)
    meta = _write_dataset(root)
    parallel = os.path.join(root, "parallel.yaml")
    with open(parallel, "w") as fh:
        fh.write("mesh:\n  data: 2\n  seq: 1\n  model: 1\nzero_optimizer_sharding: true\n")

    def cfg(name, steps, bs=2, **extra):
        c = _trainer_cfg(root, meta, name, steps)
        c.data.train_bs = bs
        c.solver.use_8bit_adam = True
        c.update({"parallel_config": parallel, **extra})
        return c

    runs = spawn("trainer", 2, os.path.join(root, "run"), timeout=240,
                 cfgs=[cfg("resumed", 2), cfg("resumed", 3), cfg("straight", 3)])[0]
    resumed, straight = runs[1], runs[2]
    assert resumed["step"] == straight["step"] == 3
    assert_same_tree(resumed["params"], straight["params"])
    assert_same_tree(resumed["opt_state"], straight["opt_state"])
    exp = os.path.join(root, "exp")
    lines = [json.loads(line) for line in open(os.path.join(exp, "resumed", "metrics.jsonl"))]
    assert [r["step"] for r in lines] == [0, 1, 2]

    shutil.copytree(os.path.join(exp, "resumed"), os.path.join(exp, "single"))
    os.remove(os.path.join(exp, "single", "metrics.jsonl"))
    state = train_stage2_process(cfg("single", 3, bs=4, parallel_config=""), device="cpu")
    assert state.step == 3 and type(state) is tstate.TrainState
    single = json.loads(open(os.path.join(exp, "single", "metrics.jsonl")).readline())
    assert single["step"] == 2
    np.testing.assert_allclose(single["loss"], lines[2]["loss"], rtol=1e-5)


# --- (g) the mesh and settings of configs/parallel.yaml -----------------------------

PARALLEL_YAMLS = {
    "default": None,
    "seq2": "mesh:\n  data: -1\n  seq: 2\n",
    "data4_seq2": "mesh:\n  data: 4\n  seq: 2\n  model: 1\nmixed_precision: fp16\n",
    "data0": "mesh:\n  data: 0\n  seq: 8\nzero_optimizer_sharding: false\n",
    "seq_neg": "mesh:\n  seq: -1\n",
    "settings_only": "mixed_precision: NO\n",
    "data2_model4": "mesh:\n  data: 2\n  model: 4\n",
}


@pytest.mark.parametrize("name", sorted(PARALLEL_YAMLS))
def test_mesh_and_settings_match_jax(tmp_path, name):
    """`mesh_spec` + `mesh_shape` over 8 ranks give JAX's `mesh_from_config`
    axis sizes over its 8 virtual devices (-1 and 0 take the remaining
    ranks, seq and model at least 1; a model axis of 4), and
    `parallel_settings` JAX's dict; the repo's configs/parallel.yaml is the
    "default" case."""
    text = PARALLEL_YAMLS[name]
    path = os.path.join(os.path.dirname(os.path.dirname(__file__)), "configs",
                        "parallel.yaml")
    if text is not None:
        path = str(tmp_path / "parallel.yaml")
        with open(path, "w") as fh:
            fh.write(text)
    want = jax_mesh.mesh_from_config(path).shape
    n_data, n_model, n_seq = tmesh.mesh_spec(path)
    assert tmesh.mesh_shape(n_data, n_model, n_seq, 8) == (want["data"], want["seq"],
                                                           want["model"])
    assert want["model"] == n_model == (4 if name == "data2_model4" else 1)
    assert tmesh.parallel_settings(path) == jax_mesh.parallel_settings(path)


def test_mesh_config_divergences_and_missing_path(tmp_path):
    """A missing path raises in both packages; a `model: 2` config gives
    JAX's axis sizes (data 4 x model 2 over 8); a mesh that does not cover
    the world raises in the port only (JAX builds one on the first devices
    of a larger set)."""
    missing = str(tmp_path / "nope.yaml")
    for fn in (jax_mesh.mesh_from_config, jax_mesh.parallel_settings, tmesh.mesh_spec,
               tmesh.parallel_settings):
        with pytest.raises(FileNotFoundError):
            fn(missing)
    path = str(tmp_path / "tp.yaml")
    with open(path, "w") as fh:
        fh.write("mesh:\n  data: 4\n  model: 2\n")
    want = jax_mesh.mesh_from_config(path).shape
    assert want["model"] == 2
    assert tmesh.mesh_shape(*tmesh.mesh_spec(path), 8) == (want["data"], want["seq"],
                                                           want["model"]) == (4, 1, 2)
    assert jax_mesh.make_mesh(n_data=2, n_seq=2).shape["data"] == 2  # 4 of 8 devices
    with pytest.raises(ValueError):
        tmesh.mesh_shape(2, 1, 2, 8)


def test_mesh_groups_at_world_4(tmp_path):
    """configs of data 2 x seq 2 in 4 gloo ranks: rank = data x 2 + seq (seq
    the inner axis), each rank's data and seq groups (its model group: itself
    alone); the mesh of data 2 x model 2: rank = data x 2 + model (model the
    innermost axis, as JAX's), its data and model groups (its seq group:
    itself); and the meshes that must raise (a data or seq size that does not
    divide the world, seq 2 x model 4 over 4 ranks)."""
    path = str(tmp_path / "parallel.yaml")
    with open(path, "w") as fh:
        fh.write("mesh:\n  data: 2\n  seq: 2\n")
    ranks = spawn("mesh_groups", 4, str(tmp_path / "run"), path=path)
    for r, got in enumerate(ranks):
        d, i = divmod(r, 2)
        assert got["config"] == dict(shape={"data": 2, "seq": 2, "model": 1}, index=(d, i, 0),
                                     data_ranks=[i, 2 + i], seq_ranks=[2 * d, 2 * d + 1],
                                     model_ranks=[r])
        assert got["model2"] == dict(shape={"data": 2, "seq": 1, "model": 2}, index=(d, 0, i),
                                     data_ranks=[i, 2 + i], seq_ranks=[r],
                                     model_ranks=[2 * d, 2 * d + 1])
        assert got["errors"] == ["ValueError"] * 3
