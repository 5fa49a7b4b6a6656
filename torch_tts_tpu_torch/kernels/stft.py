"""Fused STFT + log-mel frontend.

Replaces the TPU kernel `torch_tts_tpu/kernels/stft.py`
(`mel_spectrogram_fused` -> `_stft_mel_kernel`) with the CUDA kernel
`torch_tts_tpu_torch/csrc/stft_mel.cu`, keeping its formulation: reflect
padding of (n_fft - hop) // 2 on each side, frames `idx = n + hop * t`, a
periodic Hann window, the real DFT as two products (`frame @ cos`,
`frame @ sin`, fp32 cos/sin of float64 angles), magnitude
sqrt(re^2 + im^2 + 1e-6), the mel product and log(clamp(mel, 1e-5)). A
[B, L] waveform gives [B, T, n_mels] with T = 1 + (L + 2 pad - n_fft) // hop
for every length (a [L] waveform gives [T, n_mels]); the JAX kernel pads the
frame axis to a block multiple and slices, which leaves T unchanged.

Reflect padding needs L > pad, as `torch.nn.functional.pad` requires: a
shorter waveform raises.

On the H100, at 8 clips of 10 s (6,888 frames of 1,024 samples, 513 bins,
80 mels), the function's least work (a real FFT and the mel product) is
about 0.70 GFLOP, 0.010 ms at the fp32 peak; the kernel's formulation, the
DFT as two products, does 15.0 GFLOP, 0.22 ms at that peak. The kernel
runs one CTA per block of frames, reads the frames straight from the padded
waveform at stride hop and keeps spectra and mel sums on chip (see the
header of the .cu file).

Dispatch: a CPU tensor takes `mel_spectrogram_plain`; a CUDA tensor
launches the kernel or raises. The kernel has no backward, as the TPU
kernel has no VJP: with a waveform that requires a gradient it raises
instead of dropping it. `mel_spectrogram_fused.launches` counts launches.
`mel_spectrogram_auto` applies the JAX package's dispatch rule with CUDA in
place of the TPU: the kernel at >= 2048 frames on the card, otherwise the
differentiable `audio/mel.py:mel_spectrogram` (torch.stft).
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from torch_tts_tpu_torch.audio import mel as melmod
from torch_tts_tpu_torch.kernels import build

AUTO_MIN_FRAMES = 2048  # the JAX package's threshold (a TPU measurement)
FREQ_TILE = 64  # bins per tile (stft_mel.cu kFreqs)
N_FFT_MULTIPLE = 2 * FREQ_TILE  # the kernel's n_fft: n_fft / 2 whole tiles
MAX_MELS = 128  # stft_mel.cu kMelsPerThread * 16


@functools.lru_cache(maxsize=8)
def _dft_matrices(n_fft: int):
    """Real-DFT basis: frame @ C -> Re, frame @ S -> Im, each [n_fft, F]."""
    F_ = n_fft // 2 + 1
    n = np.arange(n_fft)[:, None]
    k = np.arange(F_)[None, :]
    ang = -2.0 * np.pi * n * k / n_fft
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def _reflect_pad(y: torch.Tensor, n_fft: int, hop_length: int) -> torch.Tensor:
    pad = int((n_fft - hop_length) / 2)
    return F.pad(y[:, None], (pad, pad), mode="reflect")[:, 0]


def _log_mel_plain(y: torch.Tensor, n_fft: int, hop_length: int,
                   basis_t: torch.Tensor) -> torch.Tensor:
    """[B, L] -> [B, T, M] log-mel through the basis transposed [F, M]."""
    dev = y.device
    frames = _reflect_pad(y, n_fft, hop_length).unfold(-1, n_fft, hop_length).float()
    cos_m, sin_m = (torch.from_numpy(m).to(dev) for m in _dft_matrices(n_fft))
    window = torch.from_numpy(melmod.hann_window(n_fft)).to(dev)
    w = frames * window
    re, im = w @ cos_m, w @ sin_m
    mag = torch.sqrt(re * re + im * im + 1e-6)
    return torch.log(torch.clamp(mag @ basis_t.to(dev), min=1e-5))


def mel_spectrogram_plain(y: torch.Tensor, n_fft: int, n_mels: int, sampling_rate: int,
                          hop_length: int, win_length: int, fmin: float = 0.0,
                          fmax: Optional[float] = None) -> torch.Tensor:
    """The kernel's plain version, in its formulation: [B, L] -> [B, T,
    n_mels] (or [L] -> [T, n_mels]), fp32."""
    if win_length != n_fft:
        raise ValueError("mel_spectrogram: win_length must equal n_fft")
    basis = torch.from_numpy(melmod.mel_filterbank(sampling_rate, n_fft, n_mels, fmin, fmax))
    out = _log_mel_plain(y[None] if y.dim() == 1 else y, n_fft, hop_length, basis.t())
    return out[0] if y.dim() == 1 else out


@functools.lru_cache(maxsize=8)
def _kernel_constants(n_fft: int, sampling_rate: int, n_mels: int, fmin: float,
                      fmax: Optional[float], device: torch.device):
    """(window [n_fft], packed DFT [n_fft / 128, n_fft, 128], mel basis
    transposed [F, n_mels]) on the device. Tile j of the packed DFT holds the
    cos columns of bins 64 j .. 64 j + 63, then their sin columns; tile 0's
    first sin column (bin 0's, zero) holds the Nyquist bin's cos column
    instead, whose sin column is zero to within 1e-13."""
    cos_m, sin_m = _dft_matrices(n_fft)
    half = n_fft // 2
    tiles = np.concatenate([cos_m[:, :half].reshape(n_fft, -1, FREQ_TILE),
                            sin_m[:, :half].reshape(n_fft, -1, FREQ_TILE)], axis=2)
    tiles = np.ascontiguousarray(tiles.transpose(1, 0, 2))  # [half / 64, n_fft, 128]
    tiles[0, :, FREQ_TILE] = cos_m[:, half]
    basis_t = melmod.mel_filterbank(sampling_rate, n_fft, n_mels, fmin, fmax).T
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (melmod.hann_window(n_fft), tiles, basis_t))


def check_no_grad(y: torch.Tensor):
    """Raise when autograd would need the kernel's missing backward."""
    if torch.is_grad_enabled() and y.requires_grad:
        raise RuntimeError("mel_spectrogram_fused: the CUDA kernel has no backward; take "
                           "audio/mel.py:mel_spectrogram for a differentiable mel")


def _launch(y: torch.Tensor, n_fft: int, hop_length: int, window: torch.Tensor,
            dft: torch.Tensor, basis_t: torch.Tensor) -> torch.Tensor:
    """The kernel on a fp32 [B, L] waveform with the constants of
    `_kernel_constants` (any [n_fft / 2 + 1, M] basis) -> [B, T, M]."""
    yp = _reflect_pad(y, n_fft, hop_length).contiguous()
    B, Lp = yp.shape
    if Lp < n_fft or B * Lp >= 2 ** 31:
        raise ValueError(f"mel_spectrogram_fused: padded length {Lp} outside [n_fft, 2^31 / B)")
    T = 1 + (Lp - n_fft) // hop_length
    out = y.new_empty(B, T, basis_t.shape[1])
    lib = build.load_library()
    with torch.cuda.device(y.device):
        code = lib.tts_stft_mel_forward(
            yp.data_ptr(), window.data_ptr(), dft.data_ptr(), basis_t.data_ptr(), out.data_ptr(),
            B, Lp, T, n_fft, hop_length, basis_t.shape[1], torch.cuda.current_stream(y.device).cuda_stream)
    build.check_cuda_error(code, "mel_spectrogram_fused")
    mel_spectrogram_fused.launches += 1
    return out


def mel_spectrogram_fused(y: torch.Tensor, n_fft: int, n_mels: int, sampling_rate: int,
                          hop_length: int, win_length: int, fmin: float = 0.0,
                          fmax: Optional[float] = None, block_frames: int = 128) -> torch.Tensor:
    """[B, L] waveform -> [B, T, n_mels] log-mel through the fused kernel.
    `block_frames` is the JAX kernel's frame tile; the result does not
    depend on it, and the CUDA kernel takes its own tile of 32 frames."""
    if win_length != n_fft:
        raise ValueError("mel_spectrogram_fused: win_length must equal n_fft")
    if y.device.type == "cpu":
        return mel_spectrogram_plain(y, n_fft, n_mels, sampling_rate, hop_length, win_length,
                                     fmin, fmax)
    if y.device.type != "cuda":
        raise ValueError(f"mel_spectrogram_fused: unsupported device {y.device}")
    check_no_grad(y)
    if y.dtype != torch.float32 or y.dim() not in (1, 2):
        raise ValueError("mel_spectrogram_fused: the kernel takes a fp32 [B, L] or [L] waveform")
    if n_fft % N_FFT_MULTIPLE or hop_length < 1 or not 1 <= n_mels <= MAX_MELS:
        raise ValueError(f"mel_spectrogram_fused: the kernel takes n_fft a multiple of "
                         f"{N_FFT_MULTIPLE}, hop >= 1 and 1 to {MAX_MELS} mels")
    consts = _kernel_constants(n_fft, sampling_rate, n_mels, fmin, fmax, y.device)
    out = _launch(y[None] if y.dim() == 1 else y, n_fft, hop_length, *consts)
    return out[0] if y.dim() == 1 else out


mel_spectrogram_fused.launches = 0


def mel_spectrogram_auto(y: torch.Tensor, n_fft: int, n_mels: int, sampling_rate: int,
                         hop_length: int, win_length: int, fmin: float = 0.0,
                         fmax: Optional[float] = None) -> torch.Tensor:
    """Shape-aware dispatch, the JAX package's rule: the fused kernel on the
    card at >= AUTO_MIN_FRAMES frames (estimated as B * (1 + L // hop)),
    else the torch.stft mel of `audio/mel.py`."""
    B = 1 if y.dim() == 1 else y.shape[0]
    n_frames = B * (1 + y.shape[-1] // hop_length)
    if y.device.type == "cuda" and n_frames >= AUTO_MIN_FRAMES:
        return mel_spectrogram_fused(y, n_fft, n_mels, sampling_rate, hop_length, win_length,
                                     fmin, fmax)
    out = melmod.mel_spectrogram(y[None] if y.dim() == 1 else y, n_fft, n_mels, sampling_rate,
                                 hop_length, win_length, fmin, fmax)
    return out[0] if y.dim() == 1 else out
