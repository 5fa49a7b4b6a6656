"""STFT magnitude and log-mel frontend (port of `torch_tts_tpu/audio/mel.py`).

Same numbers as the JAX version (and the reference's mel_processing.py):
reflect padding of (n_fft - hop) / 2 on each side, no centring, a periodic
Hann window, magnitude sqrt(re^2 + im^2 + 1e-6), a slaney-scale and
slaney-normalised mel basis, and log(clamp(mel, 1e-5)). Channels-last like
the JAX functions: [B, L] waveforms -> [B, T, F] or [B, T, n_mels].

Differentiable: the train step takes the mel loss through
`mel_spectrogram` of the generated audio. The filterbank and window are
numpy, computed once per configuration.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(win_length: int) -> np.ndarray:
    """Periodic Hann window, as torch.hann_window(win_length)."""
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float32)


_F_SP = 200.0 / 3.0
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = math.log(6.4) / 27.0


def hz_to_mel(f):
    f = np.asarray(f, dtype=np.float64)
    mel = f / _F_SP
    return np.where(f >= _MIN_LOG_HZ,
                    _MIN_LOG_MEL + np.log(np.maximum(f, 1e-10) / _MIN_LOG_HZ) / _LOGSTEP, mel)


def mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    f = m * _F_SP
    return np.where(m >= _MIN_LOG_MEL, _MIN_LOG_HZ * np.exp(_LOGSTEP * (m - _MIN_LOG_MEL)), f)


@functools.lru_cache(maxsize=16)
def mel_filterbank(sampling_rate: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                   fmax: Optional[float] = None) -> np.ndarray:
    """[n_mels, n_fft//2+1] triangular slaney-scale filterbank (librosa's
    `filters.mel` with htk=False, norm="slaney")."""
    if fmax is None:
        fmax = sampling_rate / 2.0
    n_freqs = n_fft // 2 + 1
    fftfreqs = np.linspace(0.0, sampling_rate / 2.0, n_freqs)
    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    weights *= (2.0 / (hz_pts[2:n_mels + 2] - hz_pts[:n_mels]))[:, None]
    return weights.astype(np.float32)


def spectrogram(y: torch.Tensor, n_fft: int, hop_length: int, win_length: int) -> torch.Tensor:
    """[B, L] waveform -> [B, T, n_fft//2+1] magnitudes."""
    if win_length != n_fft:
        raise ValueError("the reference always uses win_length == n_fft")
    pad = int((n_fft - hop_length) / 2)
    y = F.pad(y[:, None], (pad, pad), mode="reflect")[:, 0]
    window = torch.from_numpy(hann_window(win_length)).to(device=y.device, dtype=y.dtype)
    spec = torch.stft(y, n_fft, hop_length=hop_length, win_length=win_length, window=window,
                      center=False, return_complex=True)  # [B, F, T]
    return torch.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-6).transpose(1, 2)


def spec_to_mel(spec: torch.Tensor, n_fft: int, n_mels: int, sampling_rate: int,
                fmin: float = 0.0, fmax: Optional[float] = None) -> torch.Tensor:
    """[..., T, F] magnitudes -> [..., T, n_mels] log-mel."""
    basis = torch.from_numpy(mel_filterbank(sampling_rate, n_fft, n_mels, fmin, fmax))
    mel = torch.matmul(spec, basis.to(device=spec.device, dtype=spec.dtype).t())
    return torch.log(torch.clamp(mel, min=1e-5))


def mel_spectrogram(y: torch.Tensor, n_fft: int, n_mels: int, sampling_rate: int,
                    hop_length: int, win_length: int, fmin: float = 0.0,
                    fmax: Optional[float] = None) -> torch.Tensor:
    """[B, L] waveform -> [B, T, n_mels] log-mel."""
    spec = spectrogram(y, n_fft, hop_length, win_length)
    return spec_to_mel(spec, n_fft, n_mels, sampling_rate, fmin, fmax)
