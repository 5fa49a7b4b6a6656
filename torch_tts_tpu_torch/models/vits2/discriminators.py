"""GAN discriminators for VITS2 training (port of `DiscriminatorP`,
`DiscriminatorS` and `MultiPeriodDiscriminator`,
`torch_tts_tpu/models/vits2/discriminators.py`), torch layout: waveforms
[B, 1, L]; a period discriminator folds them into [B, 1, L/p, p] images.

Parameter names are the reference's (`discriminators.{i}.convs.{j}`,
`discriminators.{i}.conv_post`, weight-normed), as the JAX package's
`export_mpd_torch_state_dict` emits them. `use_spectral_norm=True`
raises (it is False in every shipped config).

`DurationDiscriminatorV1` and `V2` (`torch_tts_tpu/models/vits2/
discriminators.py:125,158`) take the text encoder's hidden states, the
mask and two log-durations in [B, C, T] and return [prob_r, prob_g],
each [B, T, 1]. Their names are the reference's
torch names (`output_layer.0.*` of an `nn.Sequential(Linear, Sigmoid)`);
V1 also holds the reference's `pre_out_norm_1/2`, which its forward never
uses (`trained_parameters` leaves them out of the optimizer). For a
multi-speaker model they take no speaker embedding: the JAX modules
declare `gin_channels` and take no g (`torch_tts_tpu/models/vits2/
discriminators.py:132,150,164`), where the kgoba reference adds a `cond`
of g; the port follows the JAX package.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from torch_tts_tpu_torch.ops.layers import Conv1d, Conv2d, LayerNorm, Linear, leaky_relu


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
        self.conv_post = Conv1d(self.SPECS[-1][0], 1, 3, padding=1, weight_norm=True)

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


class _DurationDiscriminator(nn.Module):
    """The layers both versions share; `normed` adds V2's ReLU + LayerNorm
    after each conv."""

    normed = False

    def __init__(self, in_channels: int, filter_channels: int, kernel_size: int = 3):
        super().__init__()
        k, f = kernel_size, filter_channels
        self.conv_1 = Conv1d(in_channels, f, k, padding=k // 2)
        self.norm_1 = LayerNorm(f)
        self.conv_2 = Conv1d(f, f, k, padding=k // 2)
        self.norm_2 = LayerNorm(f)
        self.dur_proj = Conv1d(1, f, 1)
        self.pre_out_conv_1 = Conv1d(2 * f, f, k, padding=k // 2)
        self.pre_out_norm_1 = LayerNorm(f)
        self.pre_out_conv_2 = Conv1d(f, f, k, padding=k // 2)
        self.pre_out_norm_2 = LayerNorm(f)
        self.output_layer = nn.Sequential(Linear(f, 1), nn.Sigmoid())

    def _act(self, y: torch.Tensor, norm: str) -> torch.Tensor:
        return getattr(self, norm)(torch.relu(y)) if self.normed else y

    def _prob(self, x, x_mask, dur):
        y = torch.cat([x, self.dur_proj(dur)], dim=1)
        y = self._act(self.pre_out_conv_1(y * x_mask), "pre_out_norm_1")
        y = self._act(self.pre_out_conv_2(y * x_mask), "pre_out_norm_2")
        return self.output_layer((y * x_mask).transpose(1, 2))

    def forward(self, x, x_mask, dur_r, dur_hat) -> List[torch.Tensor]:
        """x [B, in, T] (detached here, as the JAX stop_gradient), x_mask
        [B, 1, T], dur_r and dur_hat [B, 1, T] -> [prob_r, prob_g] [B, T, 1]."""
        x = x.detach()
        x = self._act(self.conv_1(x * x_mask), "norm_1")
        x = self._act(self.conv_2(x * x_mask), "norm_2")
        return [self._prob(x, x_mask, d) for d in (dur_r, dur_hat)]

    def trained_parameters(self) -> List[nn.Parameter]:
        return list(self.parameters())


class DurationDiscriminatorV1(_DurationDiscriminator):
    """VITS2 duration discriminator v1: convs without norms. The reference
    declares the LayerNorms but its forward skips them; they are kept for
    its state dict, and left out of training."""

    def __init__(self, in_channels: int, filter_channels: int, kernel_size: int = 3):
        super().__init__(in_channels, filter_channels, kernel_size)
        del self.norm_1, self.norm_2

    def trained_parameters(self) -> List[nn.Parameter]:
        return [p for n, p in self.named_parameters() if not n.startswith("pre_out_norm_")]


class DurationDiscriminatorV2(_DurationDiscriminator):
    """VITS2 duration discriminator v2: ReLU + LayerNorm after every conv."""

    normed = True


def build_duration_discriminator(kind: str, hidden_channels: int) -> _DurationDiscriminator:
    """`duration_discriminator_type` "dur_disc_1" -> V1, anything else -> V2
    (the JAX `build_models`), filter channels = in channels = hidden."""
    cls = DurationDiscriminatorV1 if kind == "dur_disc_1" else DurationDiscriminatorV2
    return cls(hidden_channels, hidden_channels)
