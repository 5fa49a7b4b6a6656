"""Flow building blocks (port of `Log`, `Flip`, `ElementwiseAffine`,
`ResidualCouplingLayer` and `ConvFlow` from `torch_tts_tpu/ops/flows.py`),
[B, C, T] layout.

`forward(x, x_mask, g=None, reverse=False)` returns (y, logdet) in the
forward direction and y alone in reverse, so flow stacks compose as in the
reference.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from torch_tts_tpu_torch.ops.convs import DDSConv
from torch_tts_tpu_torch.ops.layers import Conv1d
from torch_tts_tpu_torch.ops.splines import piecewise_rational_quadratic_transform
from torch_tts_tpu_torch.ops.wavenet import WN


class Log(nn.Module):
    def forward(self, x, x_mask, g=None, reverse: bool = False):
        if not reverse:
            y = torch.log(torch.clamp(x, min=1e-5)) * x_mask
            return y, torch.sum(-y, dim=(1, 2))
        return torch.exp(x) * x_mask


class Flip(nn.Module):
    def forward(self, x, x_mask=None, g=None, reverse: bool = False):
        y = torch.flip(x, [1])
        if not reverse:
            return y, torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        return y


class ElementwiseAffine(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.m = nn.Parameter(torch.zeros(channels, 1))
        self.logs = nn.Parameter(torch.zeros(channels, 1))

    def reset_parameters_(self, generator: torch.Generator):
        with torch.no_grad():
            self.m.zero_()
            self.logs.zero_()

    def forward(self, x, x_mask, g=None, reverse: bool = False):
        if not reverse:
            y = (self.m + torch.exp(self.logs) * x) * x_mask
            return y, torch.sum(self.logs * x_mask, dim=(1, 2))
        return (x - self.m) * torch.exp(-self.logs) * x_mask


class ResidualCouplingLayer(nn.Module):
    """Affine coupling with a WN conditioner on the first half (the plain
    VITS1 coupling); `mean_only` shifts x1 and leaves its scale at 1. The
    WN goes through `kernels/wn_stack.py` where its gate allows."""

    def __init__(self, channels: int, hidden_channels: int, kernel_size: int,
                 dilation_rate: int, n_layers: int, p_dropout: float = 0.0,
                 gin_channels: int = 0, mean_only: bool = False):
        super().__init__()
        self.half = channels // 2
        self.mean_only = mean_only
        self.pre = Conv1d(self.half, hidden_channels, 1)
        self.enc = WN(hidden_channels, kernel_size, dilation_rate, n_layers,
                      gin_channels=gin_channels, p_dropout=p_dropout)
        self.post = Conv1d(hidden_channels, self.half * (2 - mean_only), 1, zero_init=True)

    def forward(self, x, x_mask, g=None, reverse: bool = False):
        x0, x1 = x[:, :self.half], x[:, self.half:]
        h = self.enc(self.pre(x0) * x_mask, x_mask, g=g)
        stats = self.post(h) * x_mask
        if self.mean_only:
            m, logs = stats, torch.zeros_like(stats)
        else:
            m, logs = stats[:, :self.half], stats[:, self.half:]
        if not reverse:
            x1 = (m + x1 * torch.exp(logs)) * x_mask
            return torch.cat([x0, x1], dim=1), torch.sum(logs, dim=(1, 2))
        return torch.cat([x0, (x1 - m) * torch.exp(-logs) * x_mask], dim=1)


class ConvFlow(nn.Module):
    """Rational-quadratic spline coupling conditioned through a DDSConv."""

    def __init__(self, in_channels: int, filter_channels: int, kernel_size: int,
                 n_layers: int, num_bins: int = 10, tail_bound: float = 5.0):
        super().__init__()
        self.half = in_channels // 2
        self.filter_channels = filter_channels
        self.num_bins = num_bins
        self.tail_bound = tail_bound
        self.pre = Conv1d(self.half, filter_channels, 1)
        self.convs = DDSConv(filter_channels, kernel_size, n_layers)
        self.proj = Conv1d(filter_channels, self.half * (num_bins * 3 - 1), 1, zero_init=True)

    def forward(self, x, x_mask, g=None, reverse: bool = False):
        x0, x1 = x[:, :self.half], x[:, self.half:]
        h = self.convs(self.pre(x0), x_mask, g=g)
        h = self.proj(h) * x_mask
        b, c, t = x0.shape
        h = h.reshape(b, c, -1, t).permute(0, 1, 3, 2)  # [B, half, T, 3K-1]
        scale = math.sqrt(self.filter_channels)
        k = self.num_bins
        x1, logabsdet = piecewise_rational_quadratic_transform(
            x1, h[..., :k] / scale, h[..., k:2 * k] / scale, h[..., 2 * k:],
            inverse=reverse, tails="linear", tail_bound=self.tail_bound,
        )
        y = torch.cat([x0, x1], dim=1) * x_mask
        if not reverse:
            return y, torch.sum(logabsdet * x_mask, dim=(1, 2))
        return y
