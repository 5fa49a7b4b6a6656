"""The VAE style encoder (port of `torch_tts_tpu/ops/style.py`):
`ReferenceEncoder` and `VAE`, which `Tacotron` builds when
`style_dim_vae` is set.

- `ReferenceEncoder`: six Conv2d(3x3, stride 2, padding 1) layers over the
  mel [B, T, M] as one input channel, each -> BatchNorm (over B, T and M,
  padded frames included, as flax reduces every axis but the last) ->
  ReLU; then the [B, T', M', C] activations (flax's channel-last order)
  flattened to [B, T', M' C] into an LSTM of dim_out units. With lengths,
  the output is the LSTM's output at step clip(length // 64, 1, T') - 1
  (a floor, where the convolutions' T' is a ceiling); without, its last h.
- `VAE`: z = eps * exp(logvar / 2) + mean from the reference embedding,
  kl = -(1 + logvar - mean^2 - exp(logvar)) / 2 per element, and the style
  tanh(fc_out(z)) as [B, 1, dim_emb]. eps [B, dim_vae] is a standard
  normal draw that the caller gives: the JAX module draws it from its
  "noise" stream in training and at inference alike.

`GST`, `STL` and `GST_VAE`, which no model of the JAX package builds, are
not ported yet.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from torch_tts_tpu_torch.ops.layers import _uniform_
from torch_tts_tpu_torch.ops.rnn import UnidirLSTM
from torch_tts_tpu_torch.ops.tacotron_blocks import BatchNorm, Linear

REF_ENC_FILTERS = (32, 32, 64, 64, 128, 128)


class Conv2d(nn.Module):
    """A plain 2-D conv over [B, C, H, W] (`weight` [out, in, kh, kw],
    `bias`), torch's default uniform init."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: Tuple[int, int],
                 stride: Tuple[int, int] = (1, 1), padding: Tuple[int, int] = (0, 0)):
        super().__init__()
        self.stride, self.padding = tuple(stride), tuple(padding)
        self.weight = nn.Parameter(torch.zeros(out_channels, in_channels, *kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def reset_parameters_(self, generator: torch.Generator):
        bound = 1.0 / math.sqrt(self.weight[0].numel())
        _uniform_(self.weight, bound, generator)
        _uniform_(self.bias, bound, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight, self.bias, self.stride, self.padding)


class ReferenceEncoder(nn.Module):
    """Modules `conv_{i}`, `bn_{i}` and `rnn` (a `UnidirLSTM`), the JAX
    module's names."""

    def __init__(self, num_mels: int, dim_out: int = 128,
                 filters: Tuple[int, ...] = REF_ENC_FILTERS):
        super().__init__()
        self.n_layers = len(filters)
        m = num_mels
        for i, (a, b) in enumerate(zip((1,) + tuple(filters[:-1]), filters)):
            self.add_module(f"conv_{i}", Conv2d(a, b, (3, 3), (2, 2), (1, 1)))
            self.add_module(f"bn_{i}", BatchNorm(b))
            m = (m - 1) // 2 + 1
        self.dim_out = dim_out
        self.rnn = UnidirLSTM(m * filters[-1], dim_out)

    def forward(self, mels: torch.Tensor, input_lengths: Optional[torch.Tensor] = None,
                batch_stats: bool = False) -> torch.Tensor:
        """mels [B, T, M], lengths [B] or None -> [B, dim_out]; batch_stats:
        the BNs in training mode."""
        x = mels[:, None]  # [B, 1, T, M]
        for i in range(self.n_layers):
            x = getattr(self, f"conv_{i}")(x)
            x = F.relu(getattr(self, f"bn_{i}")(x.permute(0, 2, 3, 1), batch_stats))
            x = x.permute(0, 3, 1, 2)
        B, C, T, M = x.shape
        x = x.permute(0, 2, 3, 1).reshape(B, T, M * C)
        h0 = torch.zeros(B, self.dim_out, device=x.device, dtype=x.dtype)
        ys, (h_n, _) = self.rnn(x, h0, h0)
        if input_lengths is None:
            return h_n
        idx = torch.clamp(input_lengths.to(x.device) // (2 ** self.n_layers), 1, T) - 1
        return ys[torch.arange(B, device=x.device), idx]


class VAE(nn.Module):
    """`encoder` (a ReferenceEncoder of dim_enc), `mean_linear`,
    `logvar_linear` and `fc_out` (no bias), the JAX module's names."""

    def __init__(self, num_mels: int, dim_emb: int = 256, dim_enc: int = 128, dim_vae: int = 16):
        super().__init__()
        self.dim_vae = dim_vae
        self.encoder = ReferenceEncoder(num_mels, dim_enc)
        self.mean_linear = Linear(dim_enc, dim_vae)
        self.logvar_linear = Linear(dim_enc, dim_vae)
        self.fc_out = Linear(dim_vae, dim_emb, bias=False)

    def forward(self, mels: torch.Tensor, input_lengths: Optional[torch.Tensor], eps: torch.Tensor,
                batch_stats: bool = False):
        """mels [B, T, M], lengths [B] or None, eps [B, dim_vae] -> (style
        [B, 1, dim_emb], {"kl": [B, dim_vae]})."""
        enc = self.encoder(mels, input_lengths, batch_stats)
        mean, logvar = self.mean_linear(enc), self.logvar_linear(enc)
        z = eps * torch.exp(0.5 * logvar) + mean
        kl = -(1 + logvar - mean ** 2 - torch.exp(logvar)) / 2
        return torch.tanh(self.fc_out(z))[:, None, :], {"kl": kl}
