"""The port's driving-audio path against hallo_tpu's, on the CPU in fp32.

JAX `Wav2Vec2` trees are initialised at the tiny configs, every bias and
norm scale is perturbed (zero biases hide mapping bugs), and the trees are
bridged into the port with `from_jax.wav2vec_state_dict_from_jax`. Inputs
are made from numpy seeds and go through both packages:

- the encoder along each of JAX's three attention routes: XLA (short
  input), K3 (`_attention_kernel_t`, >= 256 frames with the "pallas"
  backend, Pallas interpret mode) and K6 (`_attention_kernel_t_q8`, >= 1024
  frames under HALLO_INT8_ATTN=1), where the port takes its plain versions;
- `int8_reference` against `_flash_forward_t_q8` itself;
- `AudioProcessor` on the example WAVs and on a seeded 44.1 kHz WAV;
- a WAV through the whole tiny path to two video clips;
- the full-width key contract against the wav2vec2-base-960h inventory.

Tolerances: fp32 on both sides, so the XLA and K3 routes differ by summation
order only (atol 1e-4 on the O(1) post-LayerNorm states) -- with one more
source: the resampling positions of jnp.linspace and torch.linspace can be
one fp32 ulp apart, which moves a resampled feature by that ulp times the
slope between neighbouring features. The encoder tests keep T - 1 small
(ulp <= 8e-6) or the resample the identity; `test_linear_resample_matches_jax`
holds the positions to the ulp bound, and the WAV tests, where T - 1 runs
to 12000 (ulp 1e-3), to `WAV_ATOL`. The int8 route is bounded separately
(see `test_wav2vec_int8_route_matches_jax`).
"""

import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
from scipy.io import wavfile

from hallo_tpu.config import SchedulerConfig, Wav2Vec2Config as JaxWav2Vec2Config
from hallo_tpu.convert import torch_to_jax as tj
from hallo_tpu.convert.weight_inventory import wav2vec2_inventory
from hallo_tpu.data.audio_processor import AudioProcessor as JaxAudioProcessor
from hallo_tpu.models.wav2vec import Wav2Vec2 as JaxWav2Vec2
from hallo_tpu.ops import attention as jax_attention
from hallo_tpu.ops.pallas_flash import _flash_forward_t_q8
from hallo_tpu.pipelines.face_animate import FaceAnimatePipeline as JaxPipeline
from hallo_tpu.pipelines.face_animate import window_audio_embeddings as jax_windows
from hallo_tpu.utils.factory import build_models as jax_build_models
from hallo_tpu_torch.config import Wav2Vec2Config
from hallo_tpu_torch.convert.from_jax import wav2vec_state_dict_from_jax
from hallo_tpu_torch.data.audio_processor import AudioProcessor, load_wav
from hallo_tpu_torch.models.wav2vec import Wav2Vec2, linear_resample
from hallo_tpu_torch.ops import flash
from hallo_tpu_torch.pipelines.face_animate import window_audio_embeddings
from hallo_tpu_torch.utils.factory import WAV2VEC_CONFIGS, build_wav2vec

from tests.test_torch_modules import perturb as perturb_modules
from tests.test_torch_slice import F, H, M, inputs, jax_noise, port_pipeline

ATOL = 1e-4
# WAVs of seconds: resampling positions up to ~12000 carry an ulp of up to
# 1e-3, a few 1e-4 on the resampled features, carried on by the encoder.
WAV_ATOL = 1e-3
WAVS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "examples", "driving_audios")


def jax_config(scale):
    import dataclasses

    return JaxWav2Vec2Config(**dataclasses.asdict(WAV2VEC_CONFIGS[scale]))


def perturb(tree, seed=0):
    """Every bias -> N(0, 0.5); every norm scale -> 1 + N(0, 0.2), including
    the feature encoder's gn0_bias / gn0_scale."""
    rng = np.random.default_rng(seed)

    def f(path, leaf):
        name = getattr(path[-1], "key", "")
        if name.endswith("bias"):
            return jnp.asarray(rng.normal(0, 0.5, leaf.shape).astype(np.float32))
        if name.endswith("scale"):
            return jnp.asarray(1 + rng.normal(0, 0.2, leaf.shape).astype(np.float32))
        return leaf

    return jax.tree_util.tree_map_with_path(f, tree)


def jax_params(scale, seed=0):
    net = JaxWav2Vec2(jax_config(scale))
    params = net.init(jax.random.PRNGKey(seed), jnp.zeros((1, 400)), 4)
    return net, perturb(params, seed)


def port_model(scale, params):
    model = build_wav2vec(scale, device="cpu")
    model.load_state_dict(wav2vec_state_dict_from_jax(model, params), strict=True)
    return model


def samples_for(features):
    """The input length whose tiny conv features (k 3, s 2, twice) number
    `features`: the resample to as many frames is then the identity."""
    return 4 * features + 3


def encode_both(scale, frames, samples):
    net, params = jax_params(scale)
    wave = np.random.default_rng(frames).normal(size=(2, samples)).astype(np.float32)
    want = jax.jit(net.apply, static_argnums=2)(params, jnp.asarray(wave), frames)
    with torch.inference_mode():
        got = port_model(scale, params)(torch.from_numpy(wave), frames)
    assert got.shape == want.shape == (2, frames, 2, 16)
    return got.numpy(), np.asarray(want)


def test_wav2vec_xla_route_matches_jax():
    """400 samples -> 99 conv features, resampled down to 40 frames."""
    got, want = encode_both("tiny", 40, 400)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_wav2vec_k3_route_matches_jax():
    """>= 256 frames with the pallas backend: JAX takes K3 (interpret mode)."""
    saved = jax_attention._DEFAULT_BACKEND
    jax_attention.set_default_attention_backend("pallas")
    try:
        with pltpu.force_tpu_interpret_mode():
            got, want = encode_both("tiny", 256, samples_for(256))
    finally:
        jax_attention.set_default_attention_backend(saved)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_wav2vec_int8_route_matches_jax(monkeypatch):
    """>= 1024 frames under HALLO_INT8_ATTN=1: JAX takes K6 (interpret mode),
    the port `int8_reference`. Both quantise the same fp32 q and k, but the
    key means and the q/s quotients are summed and divided in another order:
    where round(q / s) sits within an ulp of a .5 tie, one int8 step can flip
    on one side (about one element per call at this size). One step moves a
    score by s_q * s_k, ~1/127 of one product term, and the softmax over 1024
    keys spreads it thin: the bound is 1e-3 on the O(1) states."""
    monkeypatch.setenv("HALLO_INT8_ATTN", "1")
    saved = jax_attention._DEFAULT_BACKEND
    jax_attention.set_default_attention_backend("pallas")
    try:
        with pltpu.force_tpu_interpret_mode():
            got, want = encode_both("tiny", 1024, samples_for(1024))
    finally:
        jax_attention.set_default_attention_backend(saved)
    np.testing.assert_allclose(got, want, atol=1e-3)


@pytest.mark.parametrize("case", ["plain", "half_masked", "ragged_lk"])
def test_int8_reference_matches_pallas_q8(case):
    """The cases of tests/test_pallas_flash.py's int8 tests, and a ragged Lk
    that JAX pads with MASK_VALUE keys; fp32 in, the same quantisation on
    both sides, so the tolerance is summation order plus an occasional
    rounding tie (see above): atol 1e-4 on O(1) outputs."""
    rng = np.random.default_rng(11)
    b, h, lq, d = 2, 2, 256, 40
    lk = {"plain": 1024, "half_masked": 512, "ragged_lk": 1000}[case]
    q, k, v = (rng.normal(size=(b, h, n, d)).astype(np.float32) for n in (lq, lk, lk))
    bias = None
    if case == "half_masked":
        bias = np.where(np.arange(lk)[None, :] >= lk // 2, -1e9, 0.0).astype(np.float32)
        bias = np.broadcast_to(bias, (b, lk)).copy()
    scale = d ** -0.5
    with pltpu.force_tpu_interpret_mode():
        want = _flash_forward_t_q8(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   None if bias is None else jnp.asarray(bias),
                                   scale, 128, 256)
    got = flash.int8_reference(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                               None if bias is None else torch.from_numpy(bias), scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    # the dispatch on the CPU takes the same plain version
    via = flash.flash_attention_int8(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v),
                                     bias=None if bias is None else torch.from_numpy(bias))
    np.testing.assert_array_equal(via.numpy(), got.numpy())


def test_int8_gate_mirrors_jax(monkeypatch):
    """The int8 gate opens only with HALLO_INT8_ATTN=1, Lq >= 256, Lk >= 1024,
    d % 128 != 0 and a per-key bias or none."""
    from hallo_tpu_torch.ops.attention import int8_gate

    def gate(lq, lk, d, bias=None):
        return int8_gate(torch.empty(1, 2, lq, d), torch.empty(1, 2, lk, d), bias)

    assert not gate(256, 1024, 64)
    monkeypatch.setenv("HALLO_INT8_ATTN", "1")
    assert gate(256, 1024, 64) and gate(256, 1024, 40, torch.zeros(1, 1, 1, 1024))
    assert not gate(255, 1024, 64)
    assert not gate(256, 1023, 64)
    assert not gate(256, 1024, 128)
    assert not gate(256, 1024, 64, torch.zeros(1, 2, 256, 1024))


def test_hf_state_dict_through_jax_converter():
    """The other direction: the port's state_dict (HF keys, as the
    reference's checkpoint) through torch_to_jax.convert_wav2vec gives a JAX
    encoder that matches the port."""
    model = build_wav2vec("tiny", device="cpu", seed=5)
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias") or name.endswith("layer_norm.weight"):
                p.add_(0.3 * torch.randn(p.shape, generator=gen))
    net, init = jax_params("tiny")
    params, report = tj.convert_wav2vec(model.state_dict(), init, strict=True)
    assert not report["missing_in_ckpt"] and not report["shape_mismatch"]
    wave = np.random.default_rng(4).normal(size=(1, samples_for(20))).astype(np.float32)
    want = np.asarray(net.apply(params, jnp.asarray(wave), 20))
    with torch.inference_mode():
        got = model(torch.from_numpy(wave), 20).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("t,out_len", [(13, 7), (13, 13), (999, 1024), (12000, 80)])
def test_linear_resample_matches_jax(t, out_len):
    """The interpolation is continuous: jnp.linspace and torch.linspace may
    put a position one ulp apart, which moves the result by at most one ulp
    of T - 1 times the largest step between neighbouring features."""
    from hallo_tpu.models.wav2vec import linear_resample as jax_resample

    x = np.random.default_rng(t).normal(size=(2, t, 3)).astype(np.float32)
    got = linear_resample(torch.from_numpy(x), out_len).numpy()
    bound = np.spacing(np.float32(t - 1)) * np.abs(np.diff(x, axis=1)).max() + 1e-6
    np.testing.assert_allclose(got, np.asarray(jax_resample(jnp.asarray(x), out_len)),
                               atol=bound)


def _wav_44k(tmp_path):
    path = str(tmp_path / "seeded_44k.wav")
    rng = np.random.default_rng(44)
    wave = (np.sin(np.arange(22050) * 0.05) * 0.3 + rng.normal(0, 0.05, 22050))
    wavfile.write(path, 44100, (wave * 32767).astype(np.int16))
    return path


@pytest.mark.parametrize("wav,clip,last", [
    ("1.wav", 16, False), ("2_mix.wav", 16, True), ("44k", 4, False),
])
def test_audio_processor_matches_jax(tmp_path, wav, clip, last):
    """1.wav (16 kHz PCM, 3.0 s), 2_mix.wav (16 kHz IEEE float, 1.2 s) and a
    seeded 0.5-s 44.1 kHz WAV that takes the resampler: the frame count,
    the padding to a clip multiple and `only_last_features` agree."""
    path = _wav_44k(tmp_path) if wav == "44k" else f"{WAVS}/{wav}"
    net, params = jax_params("tiny")
    cfg = WAV2VEC_CONFIGS["tiny"]
    jp = JaxAudioProcessor(wav2vec_params=params, wav2vec_config=jax_config("tiny"),
                           only_last_features=last)
    want, want_len = jp.preprocess(path, clip_length=clip)
    model = build_wav2vec("tiny", device="cpu")
    proc = AudioProcessor(wav2vec_state_dict=wav2vec_state_dict_from_jax(model, params),
                          wav2vec_config=cfg, device="cpu", only_last_features=last)
    got, got_len = proc.preprocess(path, clip_length=clip)
    frames = {"1.wav": 75, "2_mix.wav": 30, "44k": 13}[wav]
    padded = -(-frames // clip) * clip
    assert got_len == want_len == frames
    assert got.shape == want.shape == ((padded, 16) if last else (padded, 2, 16))
    np.testing.assert_allclose(got, np.asarray(want), atol=WAV_ATOL)


def test_load_wav_reads_float_and_pcm():
    pcm, sr = load_wav(f"{WAVS}/1.wav")
    flt, sr2 = load_wav(f"{WAVS}/2_mix.wav")
    assert (sr, sr2) == (16000, 16000) and pcm.dtype == flt.dtype == np.float32
    assert pcm.shape == (48000,) and flt.shape == (19200,)
    assert np.abs(pcm).max() <= 1.0 and np.abs(flt).max() <= 1.0


@pytest.mark.parametrize("exists", [False, True])
def test_separator_path_raises(tmp_path, exists):
    """A separator path naming a missing file proceeds without separation,
    as JAX's AudioProcessor does (configs/inference/default.yaml names one
    that is not in the repo): it builds and processes a WAV. An existing
    file raises, since the ONNX executor is not ported."""
    sd = build_wav2vec("tiny", device="cpu").state_dict()
    path = tmp_path / "Kim_Vocal_2.onnx"
    if exists:
        path.write_bytes(b"onnx")
        with pytest.raises(NotImplementedError):
            AudioProcessor(wav2vec_state_dict=sd, wav2vec_config=WAV2VEC_CONFIGS["tiny"],
                           device="cpu", audio_separator_model_path=str(path))
        return
    proc = AudioProcessor(wav2vec_state_dict=sd, wav2vec_config=WAV2VEC_CONFIGS["tiny"],
                          device="cpu", audio_separator_model_path=str(path))
    emb, length = proc.preprocess(f"{WAVS}/1.wav", clip_length=16)
    assert length == 75 and emb.shape[0] == 80 and np.isfinite(emb).all()


def test_wav_to_two_clips_matches_jax(tmp_path):
    """A seeded 0.32-s WAV -> wav2vec2 ("tiny_slice", whose layers and width
    feed the tiny AudioProj) -> windows -> 2 clips of the tiny pipeline,
    JAX against the port on the same bridged weights and noise. As in
    test_torch_slice.py, a uint8 value may round the other way on one side:
    2/255 per pixel at most, 1e-3 on the mean absolute difference."""
    path = str(tmp_path / "voice.wav")
    wave = np.random.default_rng(8).normal(0, 0.2, 5120)
    wavfile.write(path, 16000, (wave * 32767).astype(np.int16))

    _, w2v_params = jax_params("tiny_slice", seed=2)
    jproc = JaxAudioProcessor(wav2vec_params=w2v_params,
                              wav2vec_config=jax_config("tiny_slice"))
    jemb, jlen = jproc.preprocess(path, clip_length=F)
    model = build_wav2vec("tiny_slice", device="cpu")
    proc = AudioProcessor(wav2vec_state_dict=wav2vec_state_dict_from_jax(model, w2v_params),
                          wav2vec_config=WAV2VEC_CONFIGS["tiny_slice"], device="cpu")
    emb, length = proc.preprocess(path, clip_length=F)
    assert emb.shape == (2 * F, 2, 4) and length == jlen == 8

    jm = jax_build_models("tiny", init_key=jax.random.PRNGKey(0), height=H, width=H,
                          clip_length=F, n_motion_frames=M)
    params = {k: perturb_modules(v, seed=i) for i, (k, v) in enumerate(sorted(jm.params.items()))}
    jm.params = params
    jpipe = JaxPipeline(jm, SchedulerConfig(), num_inference_steps=2, guidance_scale=3.5,
                        clip_length=F, n_motion_frames=M)
    clip_inputs = dict(inputs(2), audio_windows=jax_windows(np.asarray(jemb), margin=1))
    want = jpipe(**clip_inputs, seed=5, audio_length=jlen)
    port_inputs = dict(inputs(2), audio_windows=window_audio_embeddings(emb, margin=1))
    got = port_pipeline(params)(**port_inputs, latents=jax_noise(5, 2), audio_length=length)
    assert got.shape == want.shape == (1, 2 * F, H, H, 3)
    diff = np.abs(got - want)
    assert diff.max() <= 2 / 255 + 1e-6, diff.max()
    assert diff.mean() <= 1e-3, diff.mean()


def test_full_width_state_dict_is_the_inventory():
    """wav2vec2-base at full width on the meta device: its state_dict is the
    211 keys of facebook/wav2vec2-base-960h with their shapes, so that
    checkpoint loads strictly."""
    with torch.device("meta"):
        model = Wav2Vec2(Wav2Vec2Config())
    ported = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert len(ported) == 211
    assert ported == dict(wav2vec2_inventory())


def test_default_device_raises_without_a_card():
    """No fallback: asked for the card where there is none, the factories
    raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises((RuntimeError, AssertionError)):
        build_wav2vec("tiny")
