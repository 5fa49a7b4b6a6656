"""The STFT+mel kernel's arithmetic emulated in numpy on the CPU (its
constants from `stft._kernel_constants`: window, twiddles, mel basis and
ranges; the Stockham stages of `stft.fft_radices`, the two-for-one split,
the ranged mel product) against the plain version, with a mel basis and a
dense one (the JAX parity of the plain version and of
`mel_spectrogram_auto`: tests/test_torch_stft.py).
"""

import numpy as np
import pytest
import torch

from test_torch_stft import PLAIN_ATOL
from torch_tts_tpu_torch.kernels import stft


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while this module runs: under pytest-xdist a thread
    per core in every worker oversubscribes the cores, which slowed the
    port's tests about twofold and took CPU from the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
