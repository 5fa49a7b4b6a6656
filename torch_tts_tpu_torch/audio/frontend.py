"""Tacotron audio frontend, decode side (port of
`torch_tts_tpu/audio/frontend.py`).

`amplitude_to_db`, `db_to_amplitude`, the mel normalisation pair
`m_fwd`/`m_rev` = clip((x + 100) / 100) and its inverse, and
`AudioFrontend` with `mel_inv` (the Tikhonov-regularised pseudo-inverse of
the slaney mel filterbank, computed in numpy as the JAX package does),
`_stft_power_complex` (centre-padded, reflect), `_istft` (windowed
overlap-add normalised by the summed squared window, the JAX package's own,
not torch.istft), `griffin_lim` (momentum 0.99) and `decode`; the encode
side: `_stft_power` (the window-normalised power STFT, centre-padded,
reflect), `encode` (peak-normalise, power STFT, slaney mel, dB) and
`resample_poly` (scipy, on the host). FFTs are torch.fft, as the JAX
package computes them outside any kernel. Griffin-Lim's initial phases
are injected, or drawn from a generator.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from torch_tts_tpu_torch.audio.mel import hann_window, mel_filterbank
from torch_tts_tpu_torch.core.config import TacotronAudioConfig


def amplitude_to_db(x, multiplier: float = 10.0, amin: float = 1e-12, db_multiplier: float = 0.0):
    """torchaudio.functional.amplitude_to_DB (power in, dB out)."""
    return multiplier * torch.log10(torch.clamp(x, min=amin)) - multiplier * db_multiplier


def db_to_amplitude(x, ref: float = 1.0, power: float = 1.0):
    return ref * torch.pow(torch.pow(torch.tensor(10.0, dtype=x.dtype, device=x.device), 0.1 * x), power)


def m_fwd(mel_db):
    """dB mel -> [0, 1] network domain."""
    return torch.clamp((mel_db + 100.0) / 100.0, 0.0, 1.0)


def m_rev(mel_net):
    return mel_net * 100.0 - 100.0


def resample_poly(wav: np.ndarray, orig_sr: int, new_sr: int) -> np.ndarray:
    """Polyphase resampling on the host (scipy), float32."""
    from scipy.signal import resample_poly as _rp

    g = math.gcd(orig_sr, new_sr)
    return _rp(wav, new_sr // g, orig_sr // g).astype(np.float32)


class AudioFrontend:
    """Bound to a TacotronAudioConfig; tensors on `device` (the card unless
    the caller says otherwise)."""

    def __init__(self, config: TacotronAudioConfig, device="cuda"):
        self.config = config
        self.device = torch.device(device)
        self.n_fft = config.win_length
        self.hop = config.hop_length
        window = hann_window(self.n_fft)
        self._window = torch.from_numpy(window).to(self.device)
        self._win_norm = float(np.sqrt(np.sum(window ** 2)))
        fb = mel_filterbank(config.sample_rate, self.n_fft, config.num_mels, config.fmin, config.fmax)
        self._mel_fb = torch.from_numpy(fb).to(self.device)  # [M, F]
        pinv = np.linalg.solve(fb @ fb.T + 1e-8 * np.eye(fb.shape[0]), fb).T
        self._mel_pinv = torch.from_numpy(np.ascontiguousarray(pinv, dtype=np.float32)).to(self.device)

    def _frame_index(self, n_frames: int) -> torch.Tensor:
        idx = np.arange(self.n_fft)[None, :] + self.hop * np.arange(n_frames)[:, None]
        return torch.from_numpy(idx).to(self.device)

    def _istft(self, spec: torch.Tensor, length: Optional[int] = None) -> torch.Tensor:
        """[T, F] complex -> [L] waveform via windowed overlap-add."""
        frames = torch.fft.irfft(spec, n=self.n_fft, dim=-1) * self._window  # [T, n_fft]
        T = frames.shape[0]
        out_len = self.n_fft + (T - 1) * self.hop
        idx = self._frame_index(T).reshape(-1)
        wav = torch.zeros(out_len, device=frames.device).index_add_(0, idx, frames.reshape(-1))
        wsq = torch.zeros(out_len, device=frames.device).index_add_(
            0, idx, (self._window ** 2).repeat(T))
        wav = wav / torch.clamp(wsq, min=1e-8)
        pad = self.n_fft // 2
        wav = wav[pad: out_len - pad]
        return wav if length is None else wav[:length]

    def _stft_power(self, wave: torch.Tensor) -> torch.Tensor:
        """[L] or [B, L] -> [.., T, F] power spectrogram, centre-padded
        (reflect), divided by the window's squared norm; differentiable."""
        squeeze = wave.ndim == 1
        if squeeze:
            wave = wave[None]
        pad = self.n_fft // 2
        y = torch.nn.functional.pad(wave[:, None], (pad, pad), mode="reflect")[:, 0]
        n_frames = 1 + (y.shape[-1] - self.n_fft) // self.hop
        frames = y[:, self._frame_index(n_frames)] * self._window
        spec = torch.fft.rfft(frames, n=self.n_fft, dim=-1)
        power = (spec.real ** 2 + spec.imag ** 2) / (self._win_norm ** 2)
        return power[0] if squeeze else power

    def _stft_power_complex(self, wave: torch.Tensor) -> torch.Tensor:
        """[L] -> [T, F] complex STFT, centre-padded (reflect), Hann window."""
        pad = self.n_fft // 2
        y = torch.nn.functional.pad(wave[None, None], (pad, pad), mode="reflect")[0, 0]
        n_frames = 1 + (y.shape[-1] - self.n_fft) // self.hop
        frames = y[self._frame_index(n_frames)] * self._window
        return torch.fft.rfft(frames, n=self.n_fft, dim=-1)

    def griffin_lim(self, power_spec: torch.Tensor, n_iter: int = 32, momentum: float = 0.99,
                    phases: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """[T, F] power spectrogram -> waveform. `phases` [T, F] in [0, 2 pi)
        are the initial angles; else uniform from `generator`."""
        mag = torch.sqrt(torch.clamp(power_spec, min=0.0)) * self._win_norm
        if phases is None:
            phases = torch.rand(mag.shape, generator=generator, device=mag.device) * (2 * math.pi)
        angles = torch.exp(1j * phases.to(mag.device, torch.float32))
        prev = torch.zeros_like(angles)
        full_mag = mag.to(torch.complex64)
        for _ in range(n_iter):
            wav = self._istft(full_mag * angles)
            rebuilt = self._stft_power_complex(wav)
            update = rebuilt - momentum * prev
            angles = update / torch.clamp(update.abs(), min=1e-16)
            prev = rebuilt
        return self._istft(full_mag * angles)

    def decode(self, D_db: torch.Tensor, n_iter: int = 32, phases: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """[T, F] dB spectrogram -> waveform via Griffin-Lim."""
        return self.griffin_lim(db_to_amplitude(D_db), n_iter=n_iter, phases=phases, generator=generator)

    def encode(self, wave, sr: Optional[int] = None):
        """wave [L] (numpy or tensor) -> (D_db [T, F], M_db [T, M]) on this
        frontend's device; `sr` other than the config's resamples first."""
        if sr is not None and sr != self.config.sample_rate:
            wave = resample_poly(np.asarray(wave), sr, self.config.sample_rate)
        wave = torch.as_tensor(wave, dtype=torch.float32, device=self.device)
        wave = wave / torch.clamp(wave.abs().max(), min=1e-8)
        D = self._stft_power(wave)  # [T, F]
        return amplitude_to_db(D), amplitude_to_db(D @ self._mel_fb.t())

    def mel_inv(self, M_db: torch.Tensor) -> torch.Tensor:
        """[T, M] dB mel -> [T, F] dB linear via the regularised pseudo-inverse."""
        M = db_to_amplitude(M_db)
        return amplitude_to_db(torch.clamp(M @ self._mel_pinv.t(), min=0.0))
