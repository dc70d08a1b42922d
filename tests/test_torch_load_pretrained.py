"""The port's checkpoint loader against hallo_tpu's, on the CPU in fp32.

Tiny files in the reference's five layouts (`pretrained_models/`: SD-1.5's
UNet as safetensors, sd-vae-ft-mse as safetensors, AnimateDiff's .ckpt,
hallo's net.pth, wav2vec2-base-960h's HF file) are written from a tiny port
model's state dicts with seeded values, one seed per file so that the merge
order shows. They go through `hallo_tpu.convert.load_pretrained` (onto the
same initial values, as JAX trees) and through the port's
`convert.load_pretrained`: the port's modules must equal `state_dict_from_jax`
of JAX's trees exactly, and the reports must agree. Also: a shape mismatch
is reported by both, renamed keys raise in both, the full-width
inventories load 100% on the meta device (the only keys skipped are the
AnimateDiff `pos_encoder.pe` buffers), and the preflight flags a drifted
key as scripts/preflight_weights.py does.
"""

import os

import numpy as np
import pytest
import torch

from hallo_tpu.convert import load_pretrained as jax_lp
from hallo_tpu.convert import torch_to_jax as tj
from hallo_tpu_torch.convert import load_pretrained as lp
from hallo_tpu_torch.convert import weight_inventory as wi
from safetensors.torch import save_file

from hallo_tpu_torch.convert.checkpoint_io import split_net_pth
from hallo_tpu_torch.convert.from_jax import MAPPERS, state_dict_from_jax
from hallo_tpu_torch.utils.factory import build_models

NET_PARTS = {"reference_unet": "reference_net", "denoising_unet": "denoising_net",
             "face_locator": "face_locator", "imageproj": "image_proj",
             "audioproj": "audio_proj"}


def _seeded(sd, seed):
    gen = torch.Generator().manual_seed(seed)
    return {k: torch.randn(v.shape, generator=gen) for k, v in sd.items()}


def _nest(entries):
    tree = {}
    for path, arr in entries.items():
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = np.asarray(arr)
    return {"params": tree}


def _jax_init(models):
    """The port's initial values as hallo_tpu trees (the JAX loader's
    `init_params`)."""
    out = {}
    for name, module in models.modules().items():
        entries, unmapped = tj.convert_state_dict(module.state_dict(), MAPPERS[name])
        assert unmapped == []
        out[name] = _nest(entries)
    return out


def write_layout(root, models, net_extra=None, vae_rename=False):
    """The five layouts under `root`, from `models`' state dicts: SD-1.5 =
    the ReferenceNet's keys (seed 1), AnimateDiff = the denoiser's motion
    modules plus their `pos_encoder.pe` buffers (seed 2), net.pth = every
    module under its `Net` prefix plus one key no map knows (seed 3), the
    VAE (seed 4). Returns the paths as the CLI's config names them."""
    sd15 = _seeded(models.reference_net.state_dict(), 1)
    den = models.denoising_net.state_dict()
    mm = _seeded({k: v for k, v in den.items() if ".motion_modules." in k}, 2)
    for k in list(mm):
        if k.endswith("attention_blocks.0.to_q.weight"):
            mm[k.replace("to_q.weight", "pos_encoder.pe")] = torch.zeros(1, 8, 4)
    net = {}
    for prefix, name in NET_PARTS.items():
        for k, v in _seeded(getattr(models, name).state_dict(), 3).items():
            net[f"{prefix}.{k}"] = v
    net["denoising_unet.no_such_block.weight"] = torch.zeros(3)
    net.update(net_extra or {})
    vae = _seeded(models.vae.state_dict(), 4)
    if vae_rename:
        vae = {"encoder_v2." + k: v for k, v in vae.items()}
    paths = dict(base=os.path.join(root, "stable-diffusion-v1-5"),
                 motion=os.path.join(root, "motion_module", "mm_sd_v15_v2.ckpt"),
                 vae=os.path.join(root, "sd-vae-ft-mse"),
                 net=os.path.join(root, "hallo", "net.pth"))
    for d in (os.path.join(paths["base"], "unet"), os.path.dirname(paths["motion"]),
              paths["vae"], os.path.dirname(paths["net"])):
        os.makedirs(d, exist_ok=True)
    save_file(sd15, os.path.join(paths["base"], "unet", "diffusion_pytorch_model.safetensors"))
    save_file(vae, os.path.join(paths["vae"], "diffusion_pytorch_model.safetensors"))
    torch.save(mm, paths["motion"])
    torch.save(net, paths["net"])
    return paths, dict(sd15=sd15, mm=mm, net=net, vae=vae)


def load_both(paths, min_loaded_fraction=0.0, seed=0):
    models = build_models("tiny", device="cpu", seed=seed)
    init = _jax_init(models)
    kw = dict(base_model_path=paths["base"], motion_module_path=paths["motion"],
              vae_model_path=paths["vae"], net_pth_path=paths["net"],
              min_loaded_fraction=min_loaded_fraction)
    reports = lp.load_pretrained(models, **kw)
    jax_params = jax_lp.load_pretrained_params(init, **kw)
    return models, reports, jax_params


def test_tiny_layouts_load_as_jax_does(tmp_path):
    paths, files = write_layout(str(tmp_path), build_models("tiny", device="cpu"))
    models, reports, jax_params = load_both(paths, min_loaded_fraction=0.99)
    assert sorted(reports) == sorted(MAPPERS)
    for name, module in models.modules().items():
        want = state_dict_from_jax(module, jax_params[name], MAPPERS[name])
        got = module.state_dict()
        assert sorted(got) == sorted(want), name
        for key in want:
            assert torch.equal(got[key], want[key]), (name, key)
        report = reports[name]
        assert len(report["loaded"]) == len(got) and not report["shape_mismatch"], name
    # the merge order: net.pth (seed 3) wins over SD-1.5 (seed 1) and
    # AnimateDiff (seed 2); the map-less key is reported, the buffers skipped
    sd = models.denoising_net.state_dict()
    key = "conv_in.weight"
    assert torch.equal(sd[key], files["net"][f"denoising_unet.{key}"])
    assert not torch.equal(sd[key], files["sd15"][key])
    mkey = next(k for k in files["mm"] if k.endswith("to_q.weight"))
    assert torch.equal(sd[mkey], files["net"][f"denoising_unet.{mkey}"])
    assert reports["denoising_net"]["unmapped_ckpt_keys"] == ["no_such_block.weight"]
    assert torch.equal(models.reference_net.state_dict()[key],
                       files["net"][f"reference_unet.{key}"])


def test_later_file_wins_when_net_pth_lacks_the_key(tmp_path):
    """A key that only SD-1.5 and AnimateDiff hold takes AnimateDiff's (the
    later file), and one only SD-1.5 holds takes SD-1.5's, in both."""
    models = build_models("tiny", device="cpu")
    paths, files = write_layout(str(tmp_path), models)
    net = {k: v for k, v in files["net"].items()
           if not (k.startswith("denoising_unet.") and (
               ".motion_modules." in k or k.startswith("denoising_unet.conv_in.")))}
    torch.save(net, paths["net"])
    models, reports, jax_params = load_both(paths)
    sd = models.denoising_net.state_dict()
    mkey = next(k for k in files["mm"] if k.endswith("to_q.weight"))
    assert torch.equal(sd[mkey], files["mm"][mkey])
    assert torch.equal(sd["conv_in.weight"], files["sd15"]["conv_in.weight"])
    want = state_dict_from_jax(models.denoising_net, jax_params["denoising_net"],
                               MAPPERS["denoising_net"])
    assert all(torch.equal(sd[k], want[k]) for k in want)


def test_shape_mismatch_is_reported_by_both(tmp_path):
    models = build_models("tiny", device="cpu")
    key = "denoising_unet.conv_out.bias"
    paths, _ = write_layout(str(tmp_path), models, net_extra={key: torch.ones(7)})
    models, reports, jax_params = load_both(paths)
    assert reports["denoising_net"]["shape_mismatch"] == ["conv_out.bias"]
    initial = build_models("tiny", device="cpu").denoising_net.state_dict()["conv_out.bias"]
    assert torch.equal(models.denoising_net.state_dict()["conv_out.bias"], initial)
    path, _ = MAPPERS["denoising_net"]("conv_out.bias")
    jax_report = tj.overlay_params(
        _jax_init(build_models("tiny", device="cpu"))["denoising_net"],
        tj.convert_state_dict({"conv_out.bias": torch.ones(7)}, MAPPERS["denoising_net"])[0],
    )[1]
    assert jax_report["shape_mismatch"] == ["/".join(path)]
    node = jax_params["denoising_net"]["params"]
    for part in path:
        node = node[part]
    np.testing.assert_array_equal(np.asarray(node), initial.numpy())


def test_renamed_vae_keys_raise_in_both(tmp_path):
    paths, _ = write_layout(str(tmp_path), build_models("tiny", device="cpu"), vae_rename=True)
    models = build_models("tiny", device="cpu")
    kw = dict(base_model_path=paths["base"], motion_module_path=paths["motion"],
              vae_model_path=paths["vae"], net_pth_path=paths["net"], min_loaded_fraction=0.99)
    with pytest.raises(RuntimeError, match="vae: loaded 0/"):
        lp.load_pretrained(models, **kw)
    with pytest.raises(RuntimeError, match="vae: loaded 0/"):
        jax_lp.load_pretrained_params(_jax_init(models), **kw)


def test_wav2vec_file_loads_as_jax_does(tmp_path):
    """An HF ForCTC-style file (`wav2vec2.` prefix, the parametrised weight
    norm, a CTC head) at the tiny config: the same keys load in both, and
    the positional conv's effective weight g * v / ||v|| is JAX's folded
    kernel. `masked_spec_embed` (unused at inference) has no JAX parameter:
    the port loads the file's, `wav2vec_state_dict_from_jax` gives 0."""
    from hallo_tpu_torch.convert.from_jax import wav2vec_state_dict_from_jax
    from hallo_tpu_torch.utils.factory import build_wav2vec

    from tests.test_torch_audio import jax_params

    _, init_tree = jax_params("tiny")
    model = build_wav2vec("tiny", device="cpu")
    init = wav2vec_state_dict_from_jax(model, init_tree)
    ckpt = {}
    for k, v in _seeded(init, 5).items():
        k = k.replace("pos_conv_embed.conv.weight_g",
                      "pos_conv_embed.conv.parametrizations.weight.original0")
        k = k.replace("pos_conv_embed.conv.weight_v",
                      "pos_conv_embed.conv.parametrizations.weight.original1")
        ckpt["wav2vec2." + k] = v
    ckpt["lm_head.weight"] = torch.zeros(4, 16)
    root = tmp_path / "wav2vec2-base-960h"
    root.mkdir()
    save_file(ckpt, str(root / "model.safetensors"))
    got, report = lp.load_wav2vec_state_dict(str(root), init)
    want = wav2vec_state_dict_from_jax(model, jax_lp.load_wav2vec_params(str(root), init_tree))
    assert report["unmapped_ckpt_keys"] == ["lm_head.weight"]
    assert len(report["loaded"]) == len(init) and not report["missing_in_ckpt"]
    conv = "encoder.pos_conv_embed.conv."
    for key in want:
        if key.startswith(conv + "weight_") or key == "masked_spec_embed":
            continue
        assert torch.equal(got[key], want[key]), key
    g, v = got[conv + "weight_g"], got[conv + "weight_v"]
    effective = g * v / v.norm(dim=(0, 1), keepdim=True)
    np.testing.assert_allclose(effective.numpy(), want[conv + "weight_v"].numpy(),
                               rtol=1e-5, atol=1e-6)
    with pytest.raises(FileNotFoundError):
        lp.load_wav2vec_state_dict(str(tmp_path / "absent"), init)


def _meta(inventory):
    return {k: torch.empty(v, device="meta") for k, v in inventory.items()}


@pytest.mark.parametrize("name", sorted(MAPPERS))
def test_full_width_inventories_load_completely(name):
    """On the meta device (no memory): each full-width module takes 100% of
    its tensors from the inventories in the merge order, with no mismatch,
    and every inventory key is loaded or skipped, the skips being only the
    AnimateDiff positional-encoding buffers."""
    models = build_models("full", device=torch.device("meta"))
    sd15 = _meta(wi.sd15_unet_inventory())
    net = split_net_pth(_meta(wi.net_pth_inventory()))
    sources = {
        "vae": [_meta(wi.sd_vae_inventory())],
        "reference_net": [sd15, net["reference_unet"]],
        "denoising_net": [sd15, _meta(wi.animatediff_mm_inventory()), net["denoising_unet"]],
        "face_locator": [net["face_locator"]], "image_proj": [net["imageproj"]],
        "audio_proj": [net["audioproj"]],
    }[name]
    report = lp.load_module(getattr(models, name), sources, MAPPERS[name])
    module_keys = set(getattr(models, name).state_dict())
    assert set(report["loaded"]) == module_keys
    assert not (report["missing_in_ckpt"] or report["shape_mismatch"]
                or report["unused_ckpt"] or report["unmapped_ckpt_keys"])
    skipped = {k for sd in sources for k in sd if k not in module_keys}
    assert all(k.endswith("pos_encoder.pe") for k in skipped)
    assert bool(skipped) == (name == "denoising_net")


def test_full_width_wav2vec_inventory_overlays_completely():
    from hallo_tpu_torch.utils.factory import build_wav2vec

    init = build_wav2vec("full", device=torch.device("meta")).state_dict()
    _, report = lp.overlay_wav2vec(_meta(wi.wav2vec2_inventory()), init)
    assert len(report["loaded"]) == len(init) == 211
    assert not (report["missing_in_ckpt"] or report["unused_ckpt"]
                or report["unmapped_ckpt_keys"])


def test_inventories_copy_matches_jax():
    from hallo_tpu.convert import weight_inventory as jax_wi

    assert sorted(wi.ALL_INVENTORIES) == sorted(jax_wi.ALL_INVENTORIES)
    for name, fn in wi.ALL_INVENTORIES.items():
        assert fn() == jax_wi.ALL_INVENTORIES[name](), name


def test_preflight_flags_a_drifted_key(tmp_path, monkeypatch, capsys):
    """A small stand-in contract for sd-vae-ft-mse: a drifted shape, a
    missing and an unexpected key are named (the same issues as
    scripts/preflight_weights.py's `check`), and the run exits 1; the
    other files are missing, which is no failure."""
    import sys

    from hallo_tpu_torch import preflight_weights as pw

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from scripts.preflight_weights import check as jax_check

    contract = {"encoder.conv_in.weight": (8, 3, 3, 3), "encoder.conv_in.bias": (8,),
                "decoder.conv_out.bias": (3,)}
    monkeypatch.setattr(wi, "sd_vae_inventory", lambda: contract)
    vae_dir = tmp_path / "sd-vae-ft-mse"
    vae_dir.mkdir()
    sd = {"encoder.conv_in.weight": torch.zeros(8, 3, 3, 3), "encoder.conv_in.bias": torch.zeros(9),
          "decoder.conv_out.biass": torch.zeros(3)}
    save_file(sd, str(vae_dir / "diffusion_pytorch_model.safetensors"))
    assert pw.check(contract, sd) == jax_check(contract, sd)
    assert len(pw.check(contract, sd)) == 3
    assert pw.main(["--root", str(tmp_path)]) == 1
    out = capsys.readouterr().out
    assert "shape drift at encoder.conv_in.bias" in out
    assert '"sd15_unet": {\n   "status": "missing"' in out
    sd["encoder.conv_in.bias"] = torch.zeros(8)
    sd["decoder.conv_out.bias"] = sd.pop("decoder.conv_out.biass")
    save_file(sd, str(vae_dir / "diffusion_pytorch_model.safetensors"))
    assert pw.main(["--root", str(tmp_path)]) == 0
    assert pw.preflight(str(tmp_path))["sd_vae_ft_mse"]["status"] == "ok"


def test_safetensors_io_matches_the_library(tmp_path):
    """`checkpoint_io.load_any` reads a file the safetensors library wrote
    back in its dtypes and values, and a torch file likewise."""
    from hallo_tpu_torch.convert.checkpoint_io import load_any

    tensors = {"a": torch.randn(3, 4).half(), "b": torch.randn(5).bfloat16(),
               "c": torch.arange(6).reshape(2, 3), "d": torch.zeros(0, 2)}
    save_file(tensors, str(tmp_path / "lib.safetensors"))
    torch.save(tensors, str(tmp_path / "lib.ckpt"))
    for name in ("lib.safetensors", "lib.ckpt"):
        back = load_any(str(tmp_path / name))
        assert sorted(back) == sorted(tensors)
        for k, t in tensors.items():
            assert back[k].dtype == t.dtype and torch.equal(back[k], t)


def test_synthetic_layout_loads_completely(tmp_path):
    """`convert.synthetic.write_pretrained_layout` (chip_smoke.py's cli phase
    writes it from the full-width inventories) with stand-in inventories of
    the tiny models: every module loads 100%, and a tensor that SD-1.5 and
    net.pth both hold is net.pth's value, as it
    was written."""
    from hallo_tpu_torch.convert import synthetic
    from hallo_tpu_torch.utils.factory import build_wav2vec

    models = build_models("tiny", device="cpu")

    def shapes(sd, prefix=""):
        return {prefix + k: tuple(v.shape) for k, v in sd.items()}

    den = models.denoising_net.state_dict()
    net = {}
    for prefix, name in NET_PARTS.items():
        net.update(shapes(getattr(models, name).state_dict(), prefix + "."))
    inventories = {
        "sd15_unet": lambda: shapes(models.reference_net.state_dict()),
        "sd_vae_ft_mse": lambda: shapes(models.vae.state_dict()),
        "animatediff_mm": lambda: {k: v for k, v in shapes(den).items()
                                   if ".motion_modules." in k},
        "net_pth": lambda: net,
        "wav2vec2": lambda: shapes(build_wav2vec("tiny", device="cpu").state_dict()),
    }
    key = "conv_in.weight"
    paths, kept = synthetic.write_pretrained_layout(
        str(tmp_path), inventories, keep={"net_pth": ["denoising_unet." + key],
                                          "sd15_unet": [key]})
    assert sorted(paths) == sorted(synthetic.PRETRAINED_FILES)
    reports = lp.load_pretrained(
        models, base_model_path=str(tmp_path / "stable-diffusion-v1-5"),
        motion_module_path=paths["animatediff_mm"], vae_model_path=str(tmp_path / "sd-vae-ft-mse"),
        net_pth_path=paths["net_pth"], min_loaded_fraction=1.0)
    assert all(not r["shape_mismatch"] for r in reports.values()) and len(reports) == 6
    want = kept["net_pth"]["denoising_unet." + key]
    assert want.dtype == torch.float16
    assert torch.equal(models.denoising_net.state_dict()[key], want.float())
    assert not torch.equal(want, kept["sd15_unet"][key])
    w2v_init = build_wav2vec("tiny", device="cpu").state_dict()
    _, report = lp.load_wav2vec_state_dict(os.path.dirname(paths["wav2vec2"]), w2v_init)
    assert len(report["loaded"]) == len(w2v_init)
