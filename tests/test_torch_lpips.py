"""The port's LPIPS (`hallo_tpu_torch/utils/lpips.py`) against JAX's
(`hallo_tpu/utils/lpips.py`) on the CPU, fp32, on one random lpips-alex
state dict built with tests/test_lpips.py's `_TorchLPIPSAlex`:

- `lpips_distance` and `lpips_from_uint8` within 1e-5 relative (the two
  packages' convolutions sum in different orders);
- `load_lpips`: JAX's skip reason without a file, `$HALLO_LPIPS_WEIGHTS`,
  the KeyError of a file that lacks a key; a corrupt file raises in the port
  where JAX returns (None, reason): a named divergence;
- the port's own random state dict has the inventory's shapes, and
  `lpips_from_uint8` raises without a card unless it is asked for the CPU.
"""

import pickle

import numpy as np
import pytest
import torch

from hallo_tpu.utils import lpips as jlp
from hallo_tpu_torch.utils import lpips as plp

from tests.test_lpips import _TorchLPIPSAlex

RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for the port's CPU runs here: the suite runs
    these files beside five other workers, where torch's default of one
    thread a core oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def state_dict():
    torch.manual_seed(0)
    with torch.no_grad():
        net = _TorchLPIPSAlex().eval()
    return {k: v.detach().clone() for k, v in net.lpips_state_dict().items()}


def test_constants_match_jax():
    assert plp.CONV_INDICES == jlp._CONV_INDICES
    assert plp.TAP_CHANNELS == jlp._TAP_CHANNELS
    assert plp.CONV_STRIDE == jlp._CONV_STRIDE and plp.CONV_PAD == jlp._CONV_PAD
    assert plp.POOL_BEFORE == jlp._POOL_BEFORE
    np.testing.assert_array_equal(np.float32(plp.SHIFT), jlp._SHIFT)
    np.testing.assert_array_equal(np.float32(plp.SCALE), jlp._SCALE)
    assert plp.DEFAULT_WEIGHTS == jlp.DEFAULT_WEIGHTS


@pytest.mark.parametrize("size", [64, 96])
def test_lpips_distance_matches_jax(state_dict, size):
    rng = np.random.default_rng(size)
    a = rng.uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    b = rng.uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    want = np.asarray(jlp.lpips_distance(jlp.convert_lpips_state_dict(state_dict), a, b))
    params = plp.convert_lpips_state_dict(state_dict)
    got = plp.lpips_distance(params, torch.from_numpy(a).permute(0, 3, 1, 2),
                             torch.from_numpy(b).permute(0, 3, 1, 2)).numpy()
    assert got.shape == want.shape == (2,)
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_lpips_from_uint8_matches_jax(state_dict):
    rng = np.random.default_rng(1)
    # (clips, frames, H, W, 3): more frames than one batch of the port's
    a = rng.integers(0, 256, (2, 9, 64, 64, 3), dtype=np.uint8)
    b = np.clip(a.astype(np.int16) + rng.integers(-40, 41, a.shape), 0, 255).astype(np.uint8)
    want = jlp.lpips_from_uint8(jlp.convert_lpips_state_dict(state_dict), a, b)
    params = plp.convert_lpips_state_dict(state_dict)
    got = plp.lpips_from_uint8(params, a, b, device="cpu")
    assert got == pytest.approx(want, rel=RTOL)
    assert plp.lpips_from_uint8(params, a, a, device="cpu") == pytest.approx(0.0, abs=1e-6)
    assert plp.lpips_from_uint8(params, a, 255 - a, device="cpu") > 1e-3


def test_lpips_from_uint8_needs_a_card_unless_asked_for_the_cpu(state_dict):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    params = plp.convert_lpips_state_dict(state_dict)
    a = np.zeros((1, 64, 64, 3), np.uint8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        plp.lpips_from_uint8(params, a, a)


def test_converter_keeps_oihw_and_rejects_wrong_file(state_dict):
    params = plp.convert_lpips_state_dict(state_dict)
    jparams = jlp.convert_lpips_state_dict(state_dict)
    for conv, jconv in zip(params["convs"], jparams["convs"]):
        np.testing.assert_array_equal(conv["weight"].numpy(),
                                      np.asarray(jconv["kernel"]).transpose(3, 2, 0, 1))
    bad = dict(state_dict)
    bad.pop("lin3.model.1.weight")
    bad.pop("net.slice2.3.bias")
    for convert in (plp.convert_lpips_state_dict, jlp.convert_lpips_state_dict):
        with pytest.raises(KeyError, match=r"lin3.*") as info:
            convert(bad)
        assert "net.slice2.3.weight" in str(info.value)


def test_random_state_dict_is_structurally_exact(state_dict):
    sd = plp.random_state_dict(3)
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in state_dict.items()}
    assert all(torch.equal(sd[k], v) for k, v in plp.random_state_dict(3).items())
    plp.convert_lpips_state_dict(sd)


def test_load_lpips_skips_with_jax_reason(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # no pretrained_models/ here
    monkeypatch.delenv("HALLO_LPIPS_WEIGHTS", raising=False)
    params, reason = plp.load_lpips()
    jparams, jreason = jlp.load_lpips()
    assert params is None and jparams is None
    assert reason == jreason and "skipped" in reason


def test_load_lpips_reads_env_path(tmp_path, monkeypatch, state_dict):
    path = tmp_path / "alex.pth"
    torch.save(state_dict, str(path))
    monkeypatch.setenv("HALLO_LPIPS_WEIGHTS", str(path))
    params, reason = plp.load_lpips()
    assert reason == f"loaded {path}" == jlp.load_lpips()[1]
    assert len(params["convs"]) == 5 and len(params["lins"]) == 5
    assert torch.equal(params["lins"][2], state_dict["lin2.model.1.weight"].reshape(-1))
    # an explicit path wins over the environment
    other = tmp_path / "other.pth"
    torch.save(plp.random_state_dict(1), str(other))
    assert plp.load_lpips(str(other))[1] == f"loaded {other}"


def test_load_lpips_raises_on_a_corrupt_file(tmp_path, monkeypatch):
    """Named divergence: JAX returns (None, "... failed to load ...") for a
    file that exists but does not load; the port raises."""
    path = tmp_path / "lpips_alex.pth"
    path.write_bytes(b"not a torch file")
    monkeypatch.setenv("HALLO_LPIPS_WEIGHTS", str(path))
    jparams, jreason = jlp.load_lpips()
    assert jparams is None and "failed to load" in jreason
    with pytest.raises(pickle.UnpicklingError):
        plp.load_lpips()
