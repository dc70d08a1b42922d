"""MDX-Net vocal separation through the torch ONNX executor (counterpart of
hallo_tpu/data/mdx_separator.py).

The reference optionally strips background music from the driving audio
with an MDX-Net model (`Kim_Vocal_2.onnx`) via the `audio-separator`
package (onnxruntime), audio_processor.py:56-70. This module runs the same
.onnx file through `hallo_tpu_torch.convert.onnx_torch.OnnxExecutor`, with
the JAX package's spectrogram pipeline around it, on the separator's device
(the card unless the caller asks for another):

  waveform -> stereo 44.1 kHz (host, polyphase) -> STFT (hann, centered,
  float64) -> stack [Re_L, Re_R, Im_L, Im_R] -> (1, 4, dim_f, dim_t)
  segments -> the graph (fp32) -> masked spectrogram -> iSTFT ->
  overlap-add -> vocals (host, resampled to `output_sr`)

The geometry (dim_f, dim_t) is read from the graph's input shape
(Kim_Vocal_2: `KIM_VOCAL_2_DIMS`); the FFT size follows the public MDX
convention n_fft = 2.5 * dim_f (Kim_Vocal_2: 7680, hop 1024). Segments
overlap by half with a triangular crossfade.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from hallo_tpu_torch.convert.onnx_torch import OnnxExecutor

logger = logging.getLogger(__name__)

# Kim_Vocal_2's input (1, 4, dim_f, dim_t)
KIM_VOCAL_2_DIMS = (3072, 256)


def _hann(n: int, device: torch.device) -> torch.Tensor:
    """Periodic hann (torch.hann_window's default) in float64."""
    return 0.5 - 0.5 * torch.cos(
        2.0 * np.pi * torch.arange(n, dtype=torch.float64, device=device) / n)


def stft(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """(C, T) float64 -> complex (C, n_fft//2+1, frames); centered,
    reflect-padded."""
    pad = n_fft // 2
    x = F.pad(x[None], (pad, pad), mode="reflect")[0]
    frames = x.unfold(-1, n_fft, hop) * _hann(n_fft, x.device)  # (C, frames, n_fft)
    return torch.fft.rfft(frames, dim=-1).transpose(1, 2)


def istft(spec: torch.Tensor, n_fft: int, hop: int, length: int) -> torch.Tensor:
    """complex (C, n_fft//2+1, frames) -> (C, length) float64;
    least-squares overlap-add inverse with the hann synthesis window."""
    win = _hann(n_fft, spec.device)
    frames = torch.fft.irfft(spec.transpose(1, 2), n=n_fft, dim=-1) * win
    c, n_frames = frames.shape[0], frames.shape[1]
    total = n_fft + hop * (n_frames - 1)
    idx = (torch.arange(n_fft, device=spec.device)[None, :]
           + hop * torch.arange(n_frames, device=spec.device)[:, None]).reshape(-1)
    out = torch.zeros((c, total), dtype=torch.float64, device=spec.device)
    out.index_add_(1, idx, frames.reshape(c, -1))
    norm = torch.zeros(total, dtype=torch.float64, device=spec.device)
    norm.index_add_(0, idx, (win**2).repeat(n_frames))
    out = out / torch.clamp_min(norm, 1e-8)
    pad = n_fft // 2
    return out[:, pad: pad + length]


class MdxSeparator:
    """Run an MDX-Net stem-separation ONNX model with the torch executor.

    `separate(waveform, sr)` -> vocals, float32 (T,) mono at `output_sr`.
    The input may be mono or stereo at any rate."""

    MODEL_SR = 44100  # MDX models are trained at 44.1 kHz stereo

    def __init__(
        self,
        model_path: str,
        n_fft: Optional[int] = None,
        hop: int = 1024,
        output_sr: int = 16000,
        device: torch.device = torch.device("cuda"),
    ):
        self.exec = OnnxExecutor(model_path, device=device)
        self.device = self.exec.device
        self.input_name = self.exec.input_names[0]
        shape = dict(self.exec.graph.inputs)[self.input_name]
        if shape is None or len(shape) != 4:
            raise ValueError(f"unexpected MDX input shape {shape}")
        self.dim_f = int(shape[2])
        self.dim_t = int(shape[3])
        self.n_fft = int(n_fft or round(2.5 * self.dim_f))
        self.hop = hop
        self.output_sr = output_sr
        self.calls = 0  # graph runs, for the callers' checks

    # -- spectrogram <-> model tensor ----------------------------------
    def _to_model(self, spec: torch.Tensor) -> torch.Tensor:
        """complex (2, bins, frames) -> float32 (1, 4, dim_f, frames)."""
        s = spec[:, : self.dim_f]
        return torch.cat([s.real, s.imag], dim=0)[None].float()

    def _from_model(self, x: torch.Tensor, bins: int) -> torch.Tensor:
        """(1, 4, dim_f, frames) -> complex (2, bins, frames), zero above
        dim_f (MDX models predict only the kept band)."""
        x = x[0].double()
        spec = torch.complex(x[:2], x[2:])
        return F.pad(spec, (0, 0, 0, bins - self.dim_f))

    # -- main -----------------------------------------------------------
    @torch.inference_mode()
    def separate(self, waveform: np.ndarray, sr: int) -> np.ndarray:
        from hallo_tpu_torch.data.audio_processor import resample

        wav = np.asarray(waveform, np.float32)
        if wav.ndim == 1:
            wav = np.stack([wav, wav])
        else:
            wav = wav.T if wav.shape[0] > 2 else wav
        wav = np.stack([resample(w, sr, self.MODEL_SR) for w in wav])

        length = wav.shape[1]
        spec = stft(torch.as_tensor(wav, dtype=torch.float64, device=self.device),
                    self.n_fft, self.hop)  # (2, bins, frames)
        bins, frames = spec.shape[1], spec.shape[2]

        seg = self.dim_t
        hop_seg = max(1, seg // 2)  # 50% overlap
        if frames < seg:
            spec = F.pad(spec, (0, seg - frames))
        else:
            spec = F.pad(spec, (0, (-(frames - seg)) % hop_seg))
        frames_p = spec.shape[2]

        out = torch.zeros_like(spec)
        weight = torch.zeros(frames_p, dtype=torch.float64, device=self.device)
        xfade = torch.as_tensor(np.bartlett(seg + 2)[1:-1] + 1e-3, device=self.device)
        for start in range(0, frames_p - seg + 1, hop_seg):
            chunk = spec[:, :, start: start + seg]
            pred = self.exec({self.input_name: self._to_model(chunk)})
            self.calls += 1
            out[:, :, start: start + seg] += self._from_model(next(iter(pred.values())), bins) * xfade
            weight[start: start + seg] += xfade
        out = out / torch.clamp_min(weight, 1e-8)

        vocals = istft(out[:, :, :frames], self.n_fft, self.hop, length)
        mono = vocals.mean(dim=0).float().cpu().numpy()
        return resample(mono, self.MODEL_SR, self.output_sr)
