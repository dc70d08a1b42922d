"""Weight-key contract of hallo_tpu_torch against the reference checkpoints'
inventories (hallo_tpu/convert/weight_inventory.py), and the
torch -> jax -> torch round trip through torch_to_jax and from_jax.

The full-width port is built on the meta device (no memory, no init). For
each part of net.pth (the prefixes of torch_to_jax.split_net_pth) and for
sd-vae-ft-mse: every inventory key that the part's `map_*_key` does not
skip names a port parameter of the same shape, and every port parameter is
one such key -- so the reference's state_dicts load into the port as they
are.
"""

import numpy as np
import pytest
import torch

from hallo_tpu.convert import torch_to_jax as tj
from hallo_tpu.convert import weight_inventory as wi
from hallo_tpu_torch.convert.from_jax import MAPPERS, state_dict_from_jax
from hallo_tpu_torch.utils.factory import build_models

PARTS = {  # net.pth prefix -> HalloModels attribute
    "reference_unet": "reference_net",
    "denoising_unet": "denoising_net",
    "face_locator": "face_locator",
    "imageproj": "image_proj",
    "audioproj": "audio_proj",
}


@pytest.fixture(scope="module")
def full_on_meta():
    return build_models("full", device=torch.device("meta"))


def _inventory(part):
    if part == "sd_vae_ft_mse":
        return wi.ALL_INVENTORIES["sd_vae_ft_mse"](), "vae"
    net = wi.ALL_INVENTORIES["net_pth"]()
    return tj.split_net_pth(net)[part], PARTS[part]


@pytest.mark.parametrize("part", list(PARTS) + ["sd_vae_ft_mse"])
def test_port_state_dict_matches_inventory(full_on_meta, part):
    inventory, attr = _inventory(part)
    mapper = MAPPERS[attr]
    wanted = {k: tuple(v) for k, v in inventory.items() if mapper(k) != "skip"}
    ported = {k: tuple(v.shape) for k, v in getattr(full_on_meta, attr).state_dict().items()}
    assert len(wanted) > 0
    assert sorted(set(wanted) - set(ported)) == []  # every checkpoint key has a home
    assert sorted(set(ported) - set(wanted)) == []  # every port parameter is sourced
    bad = {k: (wanted[k], ported[k]) for k in wanted if wanted[k] != ported[k]}
    assert bad == {}


def test_skipped_keys_are_only_the_pe_tables():
    inventory, _ = _inventory("denoising_unet")
    skipped = [k for k in inventory if MAPPERS["denoising_net"](k) == "skip"]
    assert skipped and all(k.endswith("pos_encoder.pe") for k in skipped)


def _nest(entries):
    tree = {}
    for path, arr in entries.items():
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = arr
    return {"params": tree}


@pytest.mark.parametrize("attr", sorted(MAPPERS))
def test_round_trip_torch_jax_torch(attr):
    """state_dict -> torch_to_jax's map + transforms -> from_jax: identical."""
    models = build_models("tiny", device="cpu", seed=3)
    module = getattr(models, attr)
    gen = torch.Generator().manual_seed(0)
    sd = {k: torch.randn(v.shape, generator=gen) for k, v in module.state_dict().items()}
    entries, unmapped = tj.convert_state_dict(sd, MAPPERS[attr])
    assert unmapped == []
    back = state_dict_from_jax(module, _nest(entries), MAPPERS[attr])
    assert sorted(back) == sorted(sd)
    for key in sd:
        np.testing.assert_array_equal(back[key].numpy(), sd[key].numpy(), err_msg=key)


def _by_name(result):
    """A mapper's result with its transform named (the two packages' copies
    of the transforms are different function objects)."""
    if isinstance(result, tuple):
        path, transform = result
        return path, None if transform is None else transform.__name__
    return result


@pytest.mark.parametrize("inventory", ["net_pth", "sd_vae_ft_mse", "wav2vec2_base_960h"])
def test_keymaps_copy_matches_torch_to_jax(inventory):
    """The port's copy of the per-key maps (`convert/keymaps.py`) sends every
    key of the reference checkpoints where hallo_tpu's torch_to_jax does."""
    from hallo_tpu_torch.convert import keymaps as km

    keys = list(wi.ALL_INVENTORIES[inventory]())
    if inventory == "wav2vec2_base_960h":
        pairs = [(km.map_wav2vec_key, lambda k: tj.map_wav2vec_key(k, {}))]
    elif inventory == "sd_vae_ft_mse":
        pairs = [(km.map_vae_key, tj.map_vae_key)]
    else:
        pairs = [(lambda k, f=f: km.map_unet_key(k, f), lambda k, f=f: tj.map_unet_key(k, f))
                 for f in ("reference", "denoise")]
        pairs += [(getattr(km, n), getattr(tj, n)) for n in (
            "map_face_locator_key", "map_image_proj_key", "map_audio_proj_key")]
    for ours, theirs in pairs:
        for key in keys:
            assert _by_name(ours(key)) == _by_name(theirs(key)), key
