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
- a numpy emulation of the CUDA kernel's arithmetic (its twiddle table,
  the Stockham stages' index maps, the two-for-one split, the mel product
  over each mel's bin range) gives the plain version's log-mel within 1e-4
  abs at n_fft 256, 512 and 1024, and with a dense U(0, 1) basis that
  weights every bin, bin 0 and the Nyquist bin included.

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


def _as_the_kernel_computes(y, n_fft, hop, window, twiddles, basis, ranges):
    """stft_mel.cu's arithmetic in numpy float32: z[j] = x[2j] + i x[2j+1]
    of the windowed frame, the Stockham stages of `stft.fft_radices` with
    the kernel's index maps and twiddle table (W_N^e = twiddle[2e]), the
    two-for-one split into bins 0 .. n_fft / 2, and the mel product over
    each mel's range."""
    frames = (stft._reflect_pad(y, n_fft, hop).unfold(-1, n_fft, hop) * window).numpy()
    tw = (twiddles[:, 0] + 1j * twiddles[:, 1]).numpy().astype(np.complex64)
    N = n_fft // 2
    x = (frames[..., 0::2] + 1j * frames[..., 1::2]).astype(np.complex64)
    n, s = N, 1
    for r in stft.fft_radices(n_fft):
        m = n // r
        p, q = np.arange(m)[:, None], np.arange(s)[None, :]
        v = [x[..., (q + s * (p + j * m)).ravel()] for j in range(r)]
        if r == 4:
            apc, amc, bpd, jbmd = v[0] + v[2], v[0] - v[2], v[1] + v[3], 1j * (v[1] - v[3])
            outs = (apc + bpd, amc - jbmd, apc - bpd, amc + jbmd)
        else:
            outs = (v[0] + v[1], v[0] - v[1])
        out = np.empty_like(x)
        for j, o in enumerate(outs):
            out[..., (q + s * (r * p + j)).ravel()] = o * tw[(2 * j * p * s + 0 * q).ravel()]
        x, n, s = out, m, s * r
    k = np.arange(N + 1)
    zk, zc = x[..., k % N], np.conj(x[..., (N - k) % N])
    X = 0.5 * (zk + zc) - 0.5j * tw[k] * (zk - zc)
    mag = np.sqrt(X.real ** 2 + X.imag ** 2 + np.float32(1e-6)).astype(np.float32)
    basis, ranges = basis.numpy(), ranges.numpy()
    mel = np.zeros(mag.shape[:-1] + (basis.shape[0],), np.float32)
    for mi, (lo, hi) in enumerate(ranges):
        mel[..., mi] = mag[..., lo:hi] @ basis[mi, lo:hi]
    return torch.from_numpy(np.log(np.maximum(mel, np.float32(1e-5))))


def _wave(n_fft):
    return torch.from_numpy((np.random.default_rng(n_fft).standard_normal((2, 5001)) * 0.3)
                            .astype(np.float32))


@pytest.mark.parametrize("n_fft,hop,n_mels,sr", [(256, 64, 20, 8000), (512, 128, 40, 16000),
                                                 (1024, 256, 80, 22050)])
def test_kernel_fft_emulation_reproduces_the_plain_mel(n_fft, hop, n_mels, sr):
    """The window, twiddle table, mel basis and bin ranges the CUDA kernel
    reads, combined as it combines them; the ranges of a triangular basis
    are narrow."""
    y = _wave(n_fft)
    window, twiddles, basis, ranges = stft._kernel_constants(n_fft, sr, n_mels, 0.0, None,
                                                             torch.device("cpu"))
    F = n_fft // 2 + 1
    assert twiddles.shape == (n_fft, 2) and basis.shape == (n_mels, F)
    assert ranges.dtype == torch.int32 and int((ranges[:, 1] - ranges[:, 0]).sum()) < 3 * F
    got = _as_the_kernel_computes(y, n_fft, hop, window, twiddles, basis, ranges)
    want = stft.mel_spectrogram_plain(y, n_fft, n_mels, sr, hop, n_fft)
    torch.testing.assert_close(got, want, rtol=0, atol=PLAIN_ATOL)


@pytest.mark.parametrize("n_fft,hop", [(256, 64), (1024, 256)])
def test_kernel_fft_emulation_dense_basis(n_fft, hop):
    """A mel basis gives bin 0 and the Nyquist bin no weight, so a basis of
    U(0, 1) weights on every bin (full ranges) holds the split's two edge
    bins, both from Z[0], against the plain product, within 1e-4 abs."""
    y = _wave(n_fft)
    window, twiddles, _, _ = stft._kernel_constants(n_fft, 8000, 20, 0.0, None,
                                                    torch.device("cpu"))
    basis = np.random.default_rng(1).uniform(size=(20, n_fft // 2 + 1)).astype(np.float32)
    ranges = stft._mel_ranges(basis)
    assert (ranges == [0, n_fft // 2 + 1]).all()
    got = _as_the_kernel_computes(y, n_fft, hop, window, twiddles, torch.from_numpy(basis),
                                  torch.from_numpy(ranges))
    torch.testing.assert_close(got, stft._log_mel_plain(y, n_fft, hop, torch.from_numpy(basis).t()),
                               rtol=0, atol=PLAIN_ATOL)


@pytest.mark.parametrize("n_fft,radices", [(256, (4, 4, 4, 2)), (512, (4, 4, 4, 4)),
                                           (2048, (4, 4, 4, 4, 4))])
def test_fft_radices_and_mel_ranges(n_fft, radices):
    """The stage plan multiplies out to n_fft / 2; the ranges of a basis with
    a zero row, an interior zero and an edge weight."""
    assert stft.fft_radices(n_fft) == radices and np.prod(radices) == n_fft // 2
    basis = np.zeros((3, 9), np.float32)
    basis[1, [2, 4, 5]] = 1.0
    basis[2, 8] = 0.5
    assert stft._mel_ranges(basis).tolist() == [[0, 0], [2, 6], [8, 9]]


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


def test_kernel_input_casts_like_the_jax_kernel():
    """The kernel's input rule, checked on the CPU: any real waveform is
    cast to fp32 (the JAX kernel casts its frames) before the launch;
    complex input, other ranks and an n_fft the kernel lacks raise."""
    y = torch.from_numpy(np.random.default_rng(9).standard_normal((2, 5000)).astype(np.float32))
    for dt in (torch.bfloat16, torch.float16, torch.float64, torch.int16):
        got = stft.kernel_input(y.to(dt), N_FFT, HOP, N_MELS)
        assert got.dtype == torch.float32 and got.is_contiguous()
        assert torch.equal(got, y.to(dt).float())
    assert stft.kernel_input(y, N_FFT, HOP, N_MELS).data_ptr() == y.data_ptr()
    for bad in (y.to(torch.complex64), y[None], torch.zeros(())):
        with pytest.raises(ValueError, match="real"):
            stft.kernel_input(bad, N_FFT, HOP, N_MELS)
    with pytest.raises(ValueError, match="power of two"):
        stft.kernel_input(y, 768, HOP, N_MELS)
    # the CPU path computes the same function of the cast waveform
    half = y.to(torch.bfloat16)
    torch.testing.assert_close(stft.mel_spectrogram_fused(half, N_FFT, N_MELS, SR, HOP, N_FFT),
                               stft.mel_spectrogram_plain(half.float(), N_FFT, N_MELS, SR, HOP,
                                                          N_FFT), rtol=0, atol=0)
