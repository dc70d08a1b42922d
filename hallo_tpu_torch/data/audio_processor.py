"""Driving-audio preprocessing: load a WAV, resample, wav2vec2-embed
(counterpart of hallo_tpu/data/audio_processor.py; reference
hallo/datasets/audio_processor.py:22-177).

WAV loading and resampling are numpy/scipy on the host (polyphase
resampling in place of the reference's ffmpeg). The wav2vec2 encoder
(`models.wav2vec.Wav2Vec2`, fp32) runs on the processor's device, the card
unless the caller asks for the CPU. The reference's optional MDX-Net vocal
separation needs an ONNX executor that the port does not have yet: asking
for it raises.
"""

from __future__ import annotations

import math
import os
import wave
from fractions import Fraction
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from hallo_tpu_torch.config import Wav2Vec2Config
from hallo_tpu_torch.models.wav2vec import Wav2Vec2, normalize_waveform


def load_wav(path: str) -> Tuple[np.ndarray, int]:
    """A WAV file as float32 mono in [-1, 1], and its sample rate. scipy
    reads PCM and IEEE-float files; the stdlib `wave` module (16-bit PCM)
    takes what scipy refuses."""
    from scipy.io import wavfile

    try:
        sr, data = wavfile.read(path)
    except ValueError:
        with wave.open(path, "rb") as f:
            sr = f.getframerate()
            channels = f.getnchannels()
            raw = f.readframes(f.getnframes())
        data = np.frombuffer(raw, dtype=np.int16).astype(np.float32) / 32768.0
        if channels == 2:
            data = data.reshape(-1, 2).mean(axis=1)
        return data, int(sr)
    data = np.asarray(data)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim == 2:
        data = data.mean(axis=1)
    return data, int(sr)


def resample(wave_data: np.ndarray, sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling (replaces the reference's ffmpeg call,
    util.py:668-674)."""
    if sr == target_sr:
        return wave_data
    from scipy.signal import resample_poly

    frac = Fraction(target_sr, sr).limit_denominator(1000)
    return resample_poly(wave_data, frac.numerator, frac.denominator).astype(np.float32)


class AudioProcessor:
    """WAV file -> per-video-frame wav2vec2 embeddings (T, layers, hidden).

    `wav2vec_state_dict` carries HF Wav2Vec2Model keys (the reference's
    wav2vec2-base-960h checkpoint loads as it is, strictly) for a model of
    `wav2vec_config` (wav2vec2-base by default), built on `device`.
    `audio_separator_model_path` naming a file that does not exist means no
    vocal separation; an existing file raises NotImplementedError."""

    def __init__(
        self,
        sample_rate: int = 16000,
        fps: int = 25,
        wav2vec_state_dict: Optional[Mapping[str, torch.Tensor]] = None,
        wav2vec_config: Optional[Wav2Vec2Config] = None,
        device: torch.device = torch.device("cuda"),
        audio_separator_model_path: Optional[str] = None,
        only_last_features: bool = False,
    ):
        if audio_separator_model_path and os.path.isfile(audio_separator_model_path):
            # an absent separator file means no separation, as in
            # hallo_tpu/data/audio_processor.py:85-112; an existing one
            # needs the ONNX executor, which the port does not have yet
            raise NotImplementedError(
                "vocal separation needs the ONNX executor, which the port does not have yet"
            )
        if wav2vec_state_dict is None:
            raise ValueError("wav2vec_state_dict (HF Wav2Vec2Model keys) required")
        self.sample_rate = sample_rate
        self.fps = fps
        self.only_last_features = only_last_features
        self.device = torch.device(device)
        with torch.device("meta"):
            model = Wav2Vec2(wav2vec_config or Wav2Vec2Config())
        model.to_empty(device=self.device).load_state_dict(wav2vec_state_dict, strict=True)
        self.model = model.eval().requires_grad_(False)

    @torch.inference_mode()
    def preprocess(self, wav_path: str, clip_length: int = -1) -> Tuple[np.ndarray, int]:
        """Returns (audio_emb (T, layers, hidden), or (T, hidden) with
        `only_last_features`; the true frame count). T is padded up to a
        multiple of `clip_length` with `sample_rate // fps` zero samples per
        missing frame (reference audio_processor.py:76-129)."""
        data, sr = load_wav(wav_path)
        data = resample(data, sr, self.sample_rate)
        wave_t = normalize_waveform(torch.from_numpy(np.ascontiguousarray(data))[None])[0]

        seq_len = math.ceil(len(data) / self.sample_rate * self.fps)
        audio_length = seq_len
        if clip_length > 0 and seq_len % clip_length != 0:
            pad_frames = clip_length - seq_len % clip_length
            wave_t = torch.nn.functional.pad(
                wave_t, (0, pad_frames * (self.sample_rate // self.fps))
            )
            seq_len += pad_frames

        emb = self.model(wave_t[None].to(self.device), seq_len)[0]
        if self.only_last_features:
            emb = emb[:, -1]
        return emb.cpu().numpy(), audio_length
