"""Numpy spectrogram and log-mel features for the host-side data loader
(port of `torch_tts_tpu/data/audio_np.py`), and a PCM WAV reader (scipy).

The same numpy operations as the JAX package's, on the window and mel
basis of this package's `audio/mel.py` (numpy, equal to the JAX
package's), so the features are equal bit for bit and a `.mel.npy` /
`.spec.npy` cache written by either package serves the other.
"""

from __future__ import annotations

import numpy as np

from torch_tts_tpu_torch.audio.mel import hann_window, mel_filterbank


def load_wav(path: str):
    """Read a PCM wav -> (float32 waveform in [-1, 1], sample_rate)."""
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        wav = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        wav = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        wav = (data.astype(np.float32) - 128.0) / 128.0
    else:
        wav = data.astype(np.float32)
    if wav.ndim > 1:
        wav = wav.mean(axis=1)
    return wav, sr


def spectrogram_np(y: np.ndarray, n_fft: int, hop: int, win: int) -> np.ndarray:
    """[L] -> [T, n_fft//2+1] magnitudes; the conventions of audio/mel.py."""
    pad = int((n_fft - hop) / 2)
    y = np.pad(y, (pad, pad), mode="reflect")
    n_frames = 1 + (len(y) - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = y[idx] * hann_window(win)
    spec = np.fft.rfft(frames, n=n_fft, axis=-1)
    return np.sqrt(spec.real**2 + spec.imag**2 + 1e-6).astype(np.float32)


def mel_spectrogram_np(y: np.ndarray, n_fft: int, n_mels: int, sampling_rate: int, hop: int,
                       win: int, fmin: float = 0.0, fmax: float | None = None) -> np.ndarray:
    """[L] -> [T, n_mels] log-mel."""
    spec = spectrogram_np(y, n_fft, hop, win)
    basis = mel_filterbank(sampling_rate, n_fft, n_mels, fmin, fmax)
    mel = spec @ basis.T
    return np.log(np.clip(mel, 1e-5, None)).astype(np.float32)
