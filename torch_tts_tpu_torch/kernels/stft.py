"""Fused STFT + log-mel frontend.

Replaces the TPU kernel `torch_tts_tpu/kernels/stft.py`
(`mel_spectrogram_fused` -> `_stft_mel_kernel`) with the CUDA kernel
`torch_tts_tpu_torch/csrc/stft_mel.cu`. Both compute reflect padding of
(n_fft - hop) // 2 on each side, frames `idx = n + hop * t`, a periodic Hann
window, the magnitude sqrt(re^2 + im^2 + 1e-6) of the real DFT, the mel
product and log(clamp(mel, 1e-5)). A [B, L] waveform gives [B, T, n_mels]
with T = 1 + (L + 2 pad - n_fft) // hop for every length (a [L] waveform
gives [T, n_mels]); the JAX kernel pads the frame axis to a block multiple
and slices, which leaves T unchanged.

The TPU kernel computes the DFT as two dense products; the plain version
here, `mel_spectrogram_plain`, keeps that formulation. The CUDA kernel
computes the same function with the least work instead: an n_fft / 2 point
complex FFT of the even and odd samples packed as z = x[2j] + i x[2j+1]
(Stockham, radix-4 stages and one radix-2 stage when log2(n_fft / 2) is
odd, `fft_radices`), the two-for-one split into bins 0 .. n_fft / 2, and the
mel product over each mel's nonzero bin range (`_mel_ranges`). Twiddles come
from an fp32 table computed in float64 (`_kernel_constants`). It takes n_fft
a power of two from 256 to 2048 and at most 128 mels.

On the H100, at 8 clips of 10 s (6,888 frames of 1,024 samples, 513 bins,
80 mels), the function's least work (a real FFT and the mel product) is
about 0.70 GFLOP, 0.010 ms at the fp32 peak, against 13 MB of traffic
(0.004 ms); see the header of the .cu file for the design.

Reflect padding needs L > pad, as `torch.nn.functional.pad` requires: a
shorter waveform raises.

Dispatch: a CPU tensor takes `mel_spectrogram_plain`; a CUDA tensor
launches the kernel or raises. A waveform of another real dtype (bf16,
fp16, fp64, integers) is cast to fp32 first, as the JAX kernel casts its
frames and the plain version does. The kernel has no backward, as the TPU
kernel has no VJP: with a waveform that requires a gradient it raises
instead of dropping it. `mel_spectrogram_fused.launches` counts launches.
`mel_spectrogram_auto` applies the JAX package's dispatch rule with CUDA in
place of the TPU and the threshold measured on the H100 (`AUTO_MIN_FRAMES`):
the kernel on the card at or above it, otherwise the differentiable
`audio/mel.py:mel_spectrogram` (torch.stft).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from torch_tts_tpu_torch.audio import mel as melmod
from torch_tts_tpu_torch.kernels import build

# mel_spectrogram_auto's threshold, measured on an NVIDIA H100 80GB HBM3 at
# 700 W (chip_smoke.py's mel auto sweep, 8 clips, n_fft 1024, hop 256, 80
# mels): the kernel against the torch.stft mel, device busy per call
# 0.0146 / 0.0292 ms at 2048 samples, 0.0150 / 0.0318 at 8192, 0.0166 /
# 0.0430 at 32768, 0.0611 / 0.1439 at 220500, and per call with the host
# 0.127 / 0.738, 0.118 / 0.711, 0.077 / 0.519, 0.161 / 0.811 ms. The kernel
# wins at every size, so every call on the card takes it (the JAX package's
# 2048 frames was a TPU result).
AUTO_MIN_FRAMES = 0
N_FFT_RANGE = (256, 2048)  # the kernel's n_fft: a power of two in this range
MAX_MELS = 128  # four mels a lane in stft_mel.cu


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


def fft_radices(n_fft: int) -> Tuple[int, ...]:
    """Radices of the kernel's n_fft / 2 point complex FFT, in stage order:
    radix 4 while four or more points remain, then radix 2."""
    n, out = n_fft // 2, []
    while n > 1:
        r = 4 if n >= 4 else 2
        out.append(r)
        n //= r
    return tuple(out)


def _mel_ranges(basis: np.ndarray) -> np.ndarray:
    """[M, 2] int32: per mel row of `basis` [M, F], the half-open range of
    its nonzero bins ([0, 0) for a row of zeros)."""
    nz = basis != 0
    lo = np.argmax(nz, axis=1)
    hi = basis.shape[1] - np.argmax(nz[:, ::-1], axis=1)
    empty = ~nz.any(axis=1)
    lo[empty], hi[empty] = 0, 0
    return np.stack([lo, hi], axis=1).astype(np.int32)


def _twiddles(n_fft: int) -> np.ndarray:
    """[n_fft, 2] fp32 (re, im) of exp(-2 pi i k / n_fft), from float64."""
    ang = -2.0 * np.pi * np.arange(n_fft) / n_fft
    return np.stack([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _kernel_constants(n_fft: int, sampling_rate: int, n_mels: int, fmin: float,
                      fmax: Optional[float], device: torch.device):
    """(window [n_fft], twiddles [n_fft, 2], mel basis [n_mels, F], its bin
    ranges [n_mels, 2] int32) on the device, as stft_mel.cu reads them."""
    basis = melmod.mel_filterbank(sampling_rate, n_fft, n_mels, fmin, fmax).astype(np.float32)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in (
        melmod.hann_window(n_fft), _twiddles(n_fft), basis, _mel_ranges(basis)))


def check_no_grad(y: torch.Tensor):
    """Raise when autograd would need the kernel's missing backward."""
    if torch.is_grad_enabled() and y.requires_grad:
        raise RuntimeError("mel_spectrogram_fused: the CUDA kernel has no backward; take "
                           "audio/mel.py:mel_spectrogram for a differentiable mel")


def kernel_input(y: torch.Tensor, n_fft: int, hop_length: int, n_mels: int) -> torch.Tensor:
    """The kernel's checks on its arguments, then the waveform it takes: y
    cast to a contiguous fp32 [B, L] or [L] (any real dtype, as the JAX
    kernel casts); raises ValueError on what the kernel does not take."""
    if y.is_complex() or y.dtype == torch.bool or y.dim() not in (1, 2):
        raise ValueError("mel_spectrogram_fused: the kernel takes a real [B, L] or [L] waveform")
    lo, hi = N_FFT_RANGE
    if (not lo <= n_fft <= hi or n_fft & (n_fft - 1) or hop_length < 1
            or not 1 <= n_mels <= MAX_MELS):
        raise ValueError(f"mel_spectrogram_fused: the kernel takes n_fft a power of two from "
                         f"{lo} to {hi}, hop >= 1 and 1 to {MAX_MELS} mels")
    return y.to(torch.float32).contiguous()


def _launch(y: torch.Tensor, n_fft: int, hop_length: int, window: torch.Tensor,
            twiddles: torch.Tensor, basis: torch.Tensor, ranges: torch.Tensor) -> torch.Tensor:
    """The kernel on a fp32 [B, L] waveform with the constants of
    `_kernel_constants` (any [M, n_fft / 2 + 1] basis with its
    `_mel_ranges`) -> [B, T, M]."""
    yp = _reflect_pad(y, n_fft, hop_length).contiguous()
    B, Lp = yp.shape
    if Lp < n_fft or B * Lp >= 2 ** 31:
        raise ValueError(f"mel_spectrogram_fused: padded length {Lp} outside [n_fft, 2^31 / B)")
    T = 1 + (Lp - n_fft) // hop_length
    out = y.new_empty(B, T, basis.shape[0])
    lib = build.load_library()
    with torch.cuda.device(y.device):
        code = lib.tts_stft_mel_forward(
            yp.data_ptr(), window.data_ptr(), twiddles.data_ptr(), basis.data_ptr(),
            ranges.data_ptr(), out.data_ptr(), B, Lp, T, n_fft, hop_length, basis.shape[0],
            torch.cuda.current_stream(y.device).cuda_stream)
    build.check_cuda_error(code, "mel_spectrogram_fused")
    build.count_launch(mel_spectrogram_fused)
    return out


def mel_spectrogram_fused(y: torch.Tensor, n_fft: int, n_mels: int, sampling_rate: int,
                          hop_length: int, win_length: int, fmin: float = 0.0,
                          fmax: Optional[float] = None, block_frames: int = 128) -> torch.Tensor:
    """[B, L] waveform -> [B, T, n_mels] log-mel through the fused kernel.
    `block_frames` is the JAX kernel's frame tile; the result does not
    depend on it, and the CUDA kernel takes a frame per warp."""
    if win_length != n_fft:
        raise ValueError("mel_spectrogram_fused: win_length must equal n_fft")
    if y.device.type == "cpu":
        return mel_spectrogram_plain(y, n_fft, n_mels, sampling_rate, hop_length, win_length,
                                     fmin, fmax)
    if y.device.type != "cuda":
        raise ValueError(f"mel_spectrogram_fused: unsupported device {y.device}")
    check_no_grad(y)
    y = kernel_input(y, n_fft, hop_length, n_mels)
    consts = _kernel_constants(n_fft, sampling_rate, n_mels, fmin, fmax, y.device)
    out = _launch(y[None] if y.dim() == 1 else y, n_fft, hop_length, *consts)
    return out[0] if y.dim() == 1 else out


mel_spectrogram_fused.launches = 0


def mel_spectrogram_auto(y: torch.Tensor, n_fft: int, n_mels: int, sampling_rate: int,
                         hop_length: int, win_length: int, fmin: float = 0.0,
                         fmax: Optional[float] = None) -> torch.Tensor:
    """Shape-aware dispatch, the JAX package's rule with the H100's
    threshold: the fused kernel on the card at >= AUTO_MIN_FRAMES frames
    (estimated as B * (1 + L // hop); 0, so every call on the card), else
    the torch.stft mel of `audio/mel.py`.

    Gradients: on the card every call takes the kernel, which has no
    backward, so a waveform that requires a gradient raises there (it is
    never dropped). For a gradient on the card call
    `audio/mel.py:mel_spectrogram` directly, as the train step does for
    y_hat. On the CPU the torch.stft mel is differentiable."""
    B = 1 if y.dim() == 1 else y.shape[0]
    n_frames = B * (1 + y.shape[-1] // hop_length)
    if y.device.type == "cuda" and n_frames >= AUTO_MIN_FRAMES:
        return mel_spectrogram_fused(y, n_fft, n_mels, sampling_rate, hop_length, win_length,
                                     fmin, fmax)
    out = melmod.mel_spectrogram(y[None] if y.dim() == 1 else y, n_fft, n_mels, sampling_rate,
                                 hop_length, win_length, fmin, fmax)
    return out[0] if y.dim() == 1 else out
