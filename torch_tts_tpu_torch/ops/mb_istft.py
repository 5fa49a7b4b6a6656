"""Multi-band iSTFT generator (port of `torch_tts_tpu/ops/mb_istft.py`),
[B, C, T] layout.

The MB-iSTFT-VITS decoder (arXiv:2210.15975): the HiFi-GAN conv trunk stops
at prod(upsample_rates); a 7-tap `conv_post` predicts each sub-band's
log-magnitude and phase frames, a WOLA inverse STFT (hann, center-style)
synthesizes each sub-band, and a fixed PQMF bank merges the sub-bands. For
the LJSpeech hop of 256: frames -(x4)-(x4)-> iSTFT(x4) -> PQMF(x4) ->
samples. The output has no tanh.

The head is plain torch (`torch.fft.irfft`, `F.fold` for the overlap-add,
`F.conv_transpose1d` for the PQMF synthesis); the trunk's ResBlock1 banks
take `kernels/mrf_fused.py` under the same rule as the HiFi-GAN decoder's
(`ops/hifigan.run_bank`).

Two orientation rules carry the JAX functions over:
- `jax.lax.conv_transpose` without `transpose_kernel` correlates the
  stride-dilated input with the kernel as given, which is torch's
  `conv_transpose1d` with the kernel reversed in time. So the PQMF
  synthesis reverses G, and the overlap-add's reversed identity becomes a
  plain one (here a `fold`, which sums the frames without products).
- `conv_post` predicts a phase for every bin, so bins 0 and n_fft/2 carry
  imaginary parts. The inverse real FFT of the JAX package (and torch's on
  the CPU) ignores them; cuFFT's C2R transform is not promised to, so they
  are zeroed before `irfft`, which gives the JAX function on every device.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from torch_tts_tpu_torch.ops.hifigan import make_bank, run_bank
from torch_tts_tpu_torch.ops.layers import Conv1d, ConvTranspose1d, leaky_relu


@functools.lru_cache(maxsize=8)
def _pqmf_filters(subbands: int, taps: int, cutoff: float, beta: float):
    """Analysis and synthesis banks H, G [taps + 1, S]: a Kaiser prototype
    from scipy's `firwin`, cosine-modulated, in float64, then cast to fp32."""
    from scipy.signal import firwin

    h = firwin(taps + 1, cutoff, window=("kaiser", beta))
    n = np.arange(taps + 1)
    H = np.zeros((taps + 1, subbands))
    G = np.zeros((taps + 1, subbands))
    for k in range(subbands):
        arg = (2 * k + 1) * np.pi / (2 * subbands) * (n - taps / 2)
        phi = (-1) ** k * np.pi / 4
        H[:, k] = 2 * h * np.cos(arg + phi)
        G[:, k] = 2 * h * np.cos(arg - phi)
    return H.astype(np.float32), G.astype(np.float32)


class PQMF(nn.Module):
    """S-band cosine-modulated filterbank with fixed filters (buffers, not
    parameters, and not in the state dict).

    analysis:  [B, 1, L] -> [B, S, L / S]   (filter + decimate)
    synthesis: [B, S, L / S] -> [B, 1, L]   (interpolate + filter + sum)
    """

    def __init__(self, subbands: int = 4, taps: int = 62, cutoff: float = 0.142,
                 beta: float = 9.0):
        super().__init__()
        self.subbands = subbands
        self.taps = taps
        H, G = _pqmf_filters(subbands, taps, cutoff, beta)
        # conv1d weight [S, 1, K]: H as a correlation, as the JAX analysis
        self.register_buffer("analysis_weight", torch.from_numpy(H.T.copy())[:, None, :],
                             persistent=False)
        # conv_transpose1d weight [S, 1, K]: G * S reversed in time
        g = np.ascontiguousarray((G * subbands).T[:, ::-1])
        self.register_buffer("synthesis_weight", torch.from_numpy(g)[:, None, :],
                             persistent=False)

    def analysis(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv1d(x, self.analysis_weight.to(x.dtype), stride=self.subbands,
                        padding=self.taps // 2)

    def synthesis(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv_transpose1d(x, self.synthesis_weight.to(x.dtype), stride=self.subbands)
        # (L/S - 1) * S + taps + 1 samples; trim the filter's group delay
        off = self.taps // 2
        return y[:, :, off:off + x.shape[2] * self.subbands]


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """[N, T, n] frames -> [N, (T - 1) * hop + n] with y[t * hop + k] +=
    frames[t, k] (the JAX `overlap_add`)."""
    N, T, n = frames.shape
    y = F.fold(frames.transpose(1, 2), output_size=(1, (T - 1) * hop + n),
               kernel_size=(1, n), stride=(1, hop))
    return y.reshape(N, -1)


@functools.lru_cache(maxsize=8)
def _hann(n_fft: int) -> np.ndarray:
    return np.hanning(n_fft + 1)[:-1].astype(np.float32)


def inverse_stft(mag: torch.Tensor, phase: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """[N, T, n_fft // 2 + 1] magnitude and phase -> [N, T * hop] waveform
    (the JAX `inverse_stft`): torch.istft's semantics with a hann window
    and center=True, the frames overlap-added and divided by the window's
    squared envelope, n_fft // 2 samples trimmed at each end. The imaginary
    parts of bins 0 and n_fft / 2 are zeroed first (see the module notes)."""
    ph = phase.to(mag.dtype)
    imag = mag * torch.sin(ph)
    edge = torch.ones(imag.shape[-1], dtype=imag.dtype, device=imag.device)
    edge[0] = 0
    if n_fft % 2 == 0:
        edge[-1] = 0
    spec = torch.complex(mag * torch.cos(ph), imag * edge)
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1).to(mag.dtype)
    win = torch.from_numpy(_hann(n_fft)).to(device=mag.device, dtype=mag.dtype)
    y = overlap_add(frames * win, hop)
    T = frames.shape[1]
    env = overlap_add((win * win).expand(1, T, n_fft), hop)
    y = y / torch.clamp(env, min=1e-9)
    half = n_fft // 2
    return y[:, half:half + T * hop]


class MultiBandISTFTGenerator(nn.Module):
    """The MB-iSTFT decoder, a drop-in for `ops/hifigan.Generator`:
    x [B, C_in, T] -> [B, 1, T * prod(upsample_rates) * istft_hop *
    subbands]. The same parameter names as the JAX exporter gives it
    (`conv_pre`, `ups`, `resblocks`, `conv_post` with a bias, `cond`).

    A given x_mask is threaded through the trunk like HiFi-GAN's, and the
    output is multiplied by it at sample rate; the PQMF's 63 taps still
    reach about 31 samples across an item's end, so a padded decode equals
    an exact-length one away from that edge, as in the JAX package.

    `quant_int8`: the JAX int8 trunk (W8A8, inference only, `ops/quant.py`):
    conv_pre, every transposed conv and every resblock conv are int8;
    `cond`, conv_post and the iSTFT / PQMF head stay fp.
    """

    def __init__(self, initial_channel: int, resblock: str = "1",
                 resblock_kernel_sizes: Sequence[int] = (3, 7, 11),
                 resblock_dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5),) * 3,
                 upsample_rates: Sequence[int] = (4, 4),
                 upsample_initial_channel: int = 512,
                 upsample_kernel_sizes: Sequence[int] = (16, 16),
                 subbands: int = 4, istft_n_fft: int = 16, istft_hop: int = 4,
                 fuse_mrf: bool = False, gin_channels: int = 0, quant_int8: bool = False):
        super().__init__()
        if istft_n_fft - istft_hop < istft_n_fft // 2:
            raise ValueError("the iSTFT's center trim needs n_fft - hop >= n_fft // 2")
        self.num_kernels = len(resblock_kernel_sizes)
        self.upsample_rates = tuple(upsample_rates)
        self.subbands, self.istft_n_fft, self.istft_hop = subbands, istft_n_fft, istft_hop
        self.fuse_mrf = fuse_mrf
        self.max_taps = max(resblock_kernel_sizes)
        q8 = "int8" if quant_int8 else None
        self.conv_pre = Conv1d(initial_channel, upsample_initial_channel, 7, padding=3, quant=q8)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        ch = upsample_initial_channel
        for i, (u, k) in enumerate(zip(upsample_rates, upsample_kernel_sizes)):
            ch = upsample_initial_channel // (2 ** (i + 1))
            self.ups.append(ConvTranspose1d(2 * ch, ch, k, stride=u, padding=(k - u) // 2,
                                            quant=q8))
            self.resblocks.extend(make_bank(resblock, ch, resblock_kernel_sizes,
                                            resblock_dilation_sizes, quant=q8))
        self.fbins = istft_n_fft // 2 + 1
        self.conv_post = Conv1d(ch, subbands * 2 * self.fbins, 7, padding=3)
        if gin_channels > 0:
            self.cond = Conv1d(gin_channels, upsample_initial_channel, 1)
        self.pqmf = PQMF(subbands)

    def forward(self, x: torch.Tensor, x_mask: Optional[torch.Tensor] = None,
                g: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, C_in, T] latent frames, x_mask [B, 1, T] or None, g [B, gin,
        1] or None -> [B, 1, T * hop]."""
        mask = x_mask
        if mask is not None:
            x = x * mask
        x = self.conv_pre(x)
        if g is not None:
            x = x + self.cond(g)
        nk = self.num_kernels
        for i, (up, u) in enumerate(zip(self.ups, self.upsample_rates)):
            x = leaky_relu(x)
            if mask is not None:
                x = x * mask
            x = up(x)
            if mask is not None:
                mask = torch.repeat_interleave(mask, u, dim=2)
                x = x * mask
            x = run_bank(self.resblocks[i * nk:(i + 1) * nk], x, mask, self.fuse_mrf,
                         self.max_taps)
        x = leaky_relu(x, 0.01)
        if mask is not None:
            x = x * mask
        out = self.head(self.conv_post(x))
        if x_mask is not None:
            out = out * torch.repeat_interleave(mask, self.istft_hop * self.subbands, dim=2)
        return out

    def head(self, h: torch.Tensor) -> torch.Tensor:
        """conv_post's output [B, S * 2F, T'] (per sub-band F log-magnitudes,
        then F phases) -> [B, 1, T' * istft_hop * S]: each sub-band's
        inverse STFT, merged by the PQMF bank."""
        B, _, T = h.shape
        S, Fb = self.subbands, self.fbins
        h = h.reshape(B * S, 2 * Fb, T).transpose(1, 2)  # [B * S, T', 2F]
        mag = torch.exp(torch.clamp(h[..., :Fb], -12.0, 6.0))
        wav = inverse_stft(mag, h[..., Fb:], self.istft_n_fft, self.istft_hop)
        return self.pqmf.synthesis(wav.reshape(B, S, -1))

