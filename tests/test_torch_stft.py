"""Fused STFT + log-mel: the port (torch_tts_tpu_torch/kernels/stft.py)
against the JAX package, at the JAX kernel test's size ([2, 4096] waveforms,
n_fft 256, hop 64, 20 mels, 8 kHz).

- `mel_spectrogram_plain` (the plain version beside the CUDA kernel, in the
  kernel's formulation) against the JAX `mel_spectrogram_fused` run in
  interpret mode: within 1e-4 abs (fp32, the same products summed in
  another order);
- the same against the JAX rfft mel `audio.mel.mel_spectrogram` within JAX's
  own test tolerance for the kernel (rtol 2e-3, atol 2e-4);
- `mel_spectrogram_auto` on the CPU (the torch.stft mel) against the JAX
  `mel_spectrogram_auto` off the TPU (the rfft mel), within 1e-4 abs;
- a 1-D input, a length that is not a hop multiple, and fmin/fmax set, each
  with the frame count 1 + (L + 2 pad - n_fft) // hop;
- the CUDA kernel's packed DFT constants, used as the kernel uses them
  (bins in tiles of 64, the Nyquist bin in tile 0's spare column), give the
  plain version's log-mel within 1e-4 abs at n_fft 256, 512 and 1024, and
  with a basis that weights bin 0 and the Nyquist bin too.

The kernel itself runs on a card: tests/test_torch_cuda_kernels.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_tts_tpu.audio import mel as jmel
from torch_tts_tpu.kernels import stft as jstft
from torch_tts_tpu_torch.kernels import stft

N_FFT, N_MELS, SR, HOP = 256, 20, 8000, 64
PLAIN_ATOL = 1e-4  # plain version vs the Pallas kernel in interpret mode
RFFT_RTOL, RFFT_ATOL = 2e-3, 2e-4  # tests/test_kernels.py's kernel vs rfft tolerance


@pytest.fixture(scope="module")
def wave():
    return (np.random.default_rng(0).standard_normal((2, 4096)) * 0.3).astype(np.float32)


# the JAX functions under jax.jit: one compile a call instead of one per op
def _jax_fused(y, fmin=0.0, fmax=None):
    return np.asarray(jax.jit(lambda v: jstft.mel_spectrogram_fused(
        v, N_FFT, N_MELS, SR, HOP, N_FFT, fmin, fmax, block_frames=32, interpret=True))(
            jnp.asarray(y)))


def _jax_auto(y, fmin=0.0, fmax=None):
    return np.asarray(jax.jit(lambda v: jstft.mel_spectrogram_auto(
        v, N_FFT, N_MELS, SR, HOP, N_FFT, fmin, fmax))(jnp.asarray(y)))


def test_plain_matches_the_pallas_kernel_and_the_rfft_mel(wave):
    got = stft.mel_spectrogram_plain(torch.from_numpy(wave), N_FFT, N_MELS, SR, HOP, N_FFT).numpy()
    assert got.shape == (2, 64, N_MELS)
    np.testing.assert_allclose(got, _jax_fused(wave), rtol=0, atol=PLAIN_ATOL)
    rfft = np.asarray(jax.jit(lambda v: jmel.mel_spectrogram(v, N_FFT, N_MELS, SR, HOP, N_FFT))(
        jnp.asarray(wave)))
    np.testing.assert_allclose(got, rfft, rtol=RFFT_RTOL, atol=RFFT_ATOL)


def test_auto_on_cpu_matches_jax_auto_off_tpu(wave):
    before = stft.mel_spectrogram_fused.launches
    got = stft.mel_spectrogram_auto(torch.from_numpy(wave), N_FFT, N_MELS, SR, HOP, N_FFT).numpy()
    want = _jax_auto(wave)
    np.testing.assert_allclose(got, want, rtol=0, atol=PLAIN_ATOL)
    # the CPU wrapper takes the plain version and launches nothing
    fused = stft.mel_spectrogram_fused(torch.from_numpy(wave), N_FFT, N_MELS, SR, HOP, N_FFT,
                                       block_frames=32).numpy()
    np.testing.assert_array_equal(fused, stft.mel_spectrogram_plain(
        torch.from_numpy(wave), N_FFT, N_MELS, SR, HOP, N_FFT).numpy())
    assert stft.mel_spectrogram_fused.launches == before


CASES = {
    "1-D": dict(length=4096, one_d=True),
    "ragged length": dict(length=4096 - 37),
    "fmin/fmax": dict(length=4096, fmin=125.0, fmax=3500.0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_and_auto_cases(wave, case):
    kw = CASES[case]
    y = wave[:, :kw["length"]]
    if kw.get("one_d"):
        y = y[0]
    fmin, fmax = kw.get("fmin", 0.0), kw.get("fmax")
    yt = torch.from_numpy(np.ascontiguousarray(y))
    got = stft.mel_spectrogram_plain(yt, N_FFT, N_MELS, SR, HOP, N_FFT, fmin, fmax).numpy()
    pad = (N_FFT - HOP) // 2
    frames = 1 + (kw["length"] + 2 * pad - N_FFT) // HOP
    assert got.shape == ((frames, N_MELS) if kw.get("one_d") else (2, frames, N_MELS))
    want = _jax_fused(y, fmin=fmin, fmax=fmax)
    np.testing.assert_allclose(got, want, rtol=0, atol=PLAIN_ATOL)
    auto = stft.mel_spectrogram_auto(yt, N_FFT, N_MELS, SR, HOP, N_FFT, fmin, fmax).numpy()
    np.testing.assert_allclose(auto, _jax_auto(y, fmin, fmax), rtol=0, atol=PLAIN_ATOL)


def _as_the_kernel_computes(y, n_fft, hop, window, dft, basis_t):
    """The packed constants combined tile by tile as stft_mel.cu combines them."""
    frames = stft._reflect_pad(y, n_fft, hop).unfold(-1, n_fft, hop) * window
    mel = 0.0
    for j in range(dft.shape[0]):
        re, im = frames @ dft[j, :, :64], frames @ dft[j, :, 64:]
        mag = torch.sqrt(re * re + im * im + 1e-6)
        if j == 0:  # bin 0 has no sin column; its slot holds the Nyquist bin
            mag[..., 0] = torch.sqrt(re[..., 0] ** 2 + 1e-6)
            mel = mel + torch.sqrt(im[..., :1] ** 2 + 1e-6) * basis_t[n_fft // 2]
        mel = mel + mag @ basis_t[64 * j:64 * (j + 1)]
    return torch.log(torch.clamp(mel, min=1e-5))


def _wave(n_fft):
    return torch.from_numpy((np.random.default_rng(n_fft).standard_normal((2, 5001)) * 0.3)
                            .astype(np.float32))


@pytest.mark.parametrize("n_fft,hop,n_mels,sr", [(256, 64, 20, 8000), (512, 128, 40, 16000),
                                                 (1024, 256, 80, 22050)])
def test_kernel_constants_reproduce_the_plain_mel(n_fft, hop, n_mels, sr):
    """The packed DFT, window and transposed basis the CUDA kernel reads."""
    y = _wave(n_fft)
    window, dft, basis_t = stft._kernel_constants(n_fft, sr, n_mels, 0.0, None,
                                                  torch.device("cpu"))
    assert dft.shape == (n_fft // 128, n_fft, 128) and basis_t.shape == (n_fft // 2 + 1, n_mels)
    got = _as_the_kernel_computes(y, n_fft, hop, window, dft, basis_t)
    want = stft.mel_spectrogram_plain(y, n_fft, n_mels, sr, hop, n_fft)
    torch.testing.assert_close(got, want, rtol=0, atol=PLAIN_ATOL)


@pytest.mark.parametrize("n_fft,hop", [(256, 64), (1024, 256)])
def test_kernel_packing_carries_bin_0_and_nyquist(n_fft, hop):
    """A mel basis gives bin 0 and the Nyquist bin no weight, so a basis of
    U(0, 1) weights on every bin holds the packing of those two bins (tile
    0's cos and spare columns) against the plain product, within 1e-4 abs."""
    y = _wave(n_fft)
    window, dft, _ = stft._kernel_constants(n_fft, 8000, 20, 0.0, None, torch.device("cpu"))
    basis_t = torch.from_numpy(np.random.default_rng(1).uniform(size=(n_fft // 2 + 1, 20))
                               .astype(np.float32))
    got = _as_the_kernel_computes(y, n_fft, hop, window, dft, basis_t)
    torch.testing.assert_close(got, stft._log_mel_plain(y, n_fft, hop, basis_t), rtol=0,
                               atol=PLAIN_ATOL)


def test_fused_refuses_a_gradient_and_other_devices():
    y = torch.zeros(1, 4096, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        stft.check_no_grad(y)
    with torch.no_grad():
        stft.check_no_grad(y)
    stft.check_no_grad(y.detach())
    with pytest.raises(ValueError, match="unsupported device"):
        stft.mel_spectrogram_fused(torch.zeros(1, 4096, device="meta"), N_FFT, N_MELS, SR, HOP,
                                   N_FFT)
