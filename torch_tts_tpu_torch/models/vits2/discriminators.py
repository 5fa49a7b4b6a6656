"""GAN discriminators for VITS2 training (port of `DiscriminatorP`,
`DiscriminatorS` and `MultiPeriodDiscriminator`,
`torch_tts_tpu/models/vits2/discriminators.py`), torch layout: waveforms
[B, 1, L]; a period discriminator folds them into [B, 1, L/p, p] images.

Parameter names are the reference's (`discriminators.{i}.convs.{j}`,
`discriminators.{i}.conv_post`, weight-normed), as the JAX package's
`export_mpd_torch_state_dict` emits them. `use_spectral_norm=True`
raises (it is False in every shipped config). The duration discriminators
are not ported yet.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from torch_tts_tpu_torch.ops.layers import Conv1d, Conv2d, leaky_relu


def _get_padding(k: int, d: int = 1) -> int:
    return (k * d - d) // 2


class DiscriminatorP(nn.Module):
    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3):
        super().__init__()
        self.period = period
        chans = (1, 32, 128, 512, 1024, 1024)
        self.convs = nn.ModuleList(
            Conv2d(cin, cout, (kernel_size, 1), (stride if i < 4 else 1, 1),
                   (_get_padding(kernel_size), 0))
            for i, (cin, cout) in enumerate(zip(chans[:-1], chans[1:])))
        self.conv_post = Conv2d(1024, 1, (3, 1), (1, 1), (1, 0))

    def forward(self, x: torch.Tensor):
        """x [B, 1, L] -> (logits [B, N], feature maps)."""
        b, c, t = x.shape
        if t % self.period:
            n_pad = self.period - t % self.period
            x = F.pad(x, (0, n_pad), mode="reflect")
            t += n_pad
        x = x.reshape(b, c, t // self.period, self.period)
        fmap = []
        for conv in self.convs:
            x = leaky_relu(conv(x))
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.flatten(1), fmap


class DiscriminatorS(nn.Module):
    # (out channels, kernel, stride, padding, groups) per conv
    SPECS = ((16, 15, 1, 7, 1), (64, 41, 4, 20, 4), (256, 41, 4, 20, 16),
             (1024, 41, 4, 20, 64), (1024, 41, 4, 20, 256), (1024, 5, 1, 2, 1))

    def __init__(self):
        super().__init__()
        cins = (1,) + tuple(s[0] for s in self.SPECS[:-1])
        self.convs = nn.ModuleList(
            Conv1d(cin, ch, k, padding=p, groups=g, stride=s, weight_norm=True)
            for cin, (ch, k, s, p, g) in zip(cins, self.SPECS))
        self.conv_post = Conv1d(1024, 1, 3, padding=1, weight_norm=True)

    def forward(self, x: torch.Tensor):
        fmap = []
        for conv in self.convs:
            x = leaky_relu(conv(x))
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.flatten(1), fmap


class MultiPeriodDiscriminator(nn.Module):
    def __init__(self, use_spectral_norm: bool = False,
                 periods: Sequence[int] = (2, 3, 5, 7, 11)):
        super().__init__()
        if use_spectral_norm:
            raise NotImplementedError("spectral norm is not ported (no shipped config uses it)")
        self.discriminators = nn.ModuleList(
            [DiscriminatorS()] + [DiscriminatorP(p) for p in periods])

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor):
        """Every sub-discriminator on real and generated audio [B, 1, L] ->
        (y_d_rs, y_d_gs, fmap_rs, fmap_gs), as the reference."""
        y_d_rs, y_d_gs, fmap_rs, fmap_gs = [], [], [], []
        for d in self.discriminators:
            out_r, fm_r = d(y)
            out_g, fm_g = d(y_hat)
            y_d_rs.append(out_r)
            y_d_gs.append(out_g)
            fmap_rs.append(fm_r)
            fmap_gs.append(fm_g)
        return y_d_rs, y_d_gs, fmap_rs, fmap_gs
