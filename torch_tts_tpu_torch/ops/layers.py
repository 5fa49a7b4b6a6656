"""Primitive layers, [B, C, T] layout (port of `torch_tts_tpu/ops/layers.py`).

Parameter names follow the kgoba reference's torch modules, which is what
`export_torch_state_dict` emits: `weight`/`bias`, or `weight_g`/`weight_v`
for weight-normed convs (torch.nn.utils.weight_norm with dim=0), and
`gamma`/`beta` for the channel LayerNorm.

Every layer that owns parameters has `reset_parameters_(generator)`; the
model-level `init_params_` calls them in module order, so one seeded
`torch.Generator` fixes all initial weights. `Dropout` draws its masks
from an explicit generator too (`set_dropout_generator`).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn


def _uniform_(t: torch.Tensor, bound: float, generator: torch.Generator):
    with torch.no_grad():
        t.copy_(torch.rand(t.shape, generator=generator) * (2 * bound) - bound)


def _norm_keep0(v: torch.Tensor) -> torch.Tensor:
    """L2 norm over every dim but 0, kept as [n, 1, 1] (weight_norm dim=0)."""
    return torch.sqrt(torch.sum(v * v, dim=tuple(range(1, v.dim())), keepdim=True))


def _weight_normed(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return v * (g / torch.clamp(_norm_keep0(v), min=1e-12))


class Conv1d(nn.Module):
    """1-D conv. `padding` is a symmetric count or a (left, right) pair;
    `weight_norm` stores (weight_g, weight_v); `zero_init` starts at zero as
    the reference's projection convs do."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int,
        padding: Union[int, Tuple[int, int]] = 0,
        dilation: int = 1,
        groups: int = 1,
        bias: bool = True,
        weight_norm: bool = False,
        zero_init: bool = False,
        stride: int = 1,
    ):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = (padding, padding) if isinstance(padding, int) else tuple(padding)
        self.dilation = dilation
        self.groups = groups
        self.zero_init = zero_init
        self.fan_in = (in_channels // groups) * kernel_size
        shape = (out_channels, in_channels // groups, kernel_size)
        if weight_norm:
            self.weight_g = nn.Parameter(torch.ones(out_channels, 1, 1))
            self.weight_v = nn.Parameter(torch.zeros(shape))
        else:
            self.weight = nn.Parameter(torch.zeros(shape))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def reset_parameters_(self, generator: torch.Generator):
        bound = 1.0 / math.sqrt(self.fan_in)
        w = self.weight_v if hasattr(self, "weight_v") else self.weight
        if self.zero_init:
            with torch.no_grad():
                w.zero_()
        else:
            _uniform_(w, bound, generator)
        if hasattr(self, "weight_g"):
            with torch.no_grad():
                self.weight_g.copy_(_norm_keep0(self.weight_v))
        if self.bias is not None:
            if self.zero_init:
                with torch.no_grad():
                    self.bias.zero_()
            else:
                _uniform_(self.bias, bound, generator)

    def effective_weight(self) -> torch.Tensor:
        """[out, in/groups, k] weight, weight norm applied."""
        if hasattr(self, "weight_v"):
            return _weight_normed(self.weight_g, self.weight_v)
        return self.weight

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lo, hi = self.padding
        if lo == hi:
            return F.conv1d(x, self.effective_weight(), self.bias, stride=self.stride,
                            padding=lo, dilation=self.dilation, groups=self.groups)
        return F.conv1d(F.pad(x, (lo, hi)), self.effective_weight(), self.bias,
                        stride=self.stride, dilation=self.dilation, groups=self.groups)


class Conv2d(nn.Module):
    """Weight-normed 2-D conv over [B, C, H, W] (the period
    discriminators' [k, 1] kernels): weight_g [out, 1, 1, 1], weight_v
    [out, in, kh, kw], norm over all dims but 0."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: Tuple[int, int],
                 stride: Tuple[int, int] = (1, 1), padding: Tuple[int, int] = (0, 0)):
        super().__init__()
        self.stride = tuple(stride)
        self.padding = tuple(padding)
        self.fan_in = in_channels * kernel_size[0] * kernel_size[1]
        self.weight_g = nn.Parameter(torch.ones(out_channels, 1, 1, 1))
        self.weight_v = nn.Parameter(torch.zeros(out_channels, in_channels, *kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def reset_parameters_(self, generator: torch.Generator):
        bound = 1.0 / math.sqrt(self.fan_in)
        _uniform_(self.weight_v, bound, generator)
        with torch.no_grad():
            self.weight_g.copy_(_norm_keep0(self.weight_v))
        _uniform_(self.bias, bound, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = _weight_normed(self.weight_g, self.weight_v)
        return F.conv2d(x, w, self.bias, stride=self.stride, padding=self.padding)


class Dropout(nn.Module):
    """Dropout whose masks come from `self.generator` (an explicit
    torch.Generator on the input's device), as the JAX `Dropout` draws from
    its 'dropout' stream: in training mode with p > 0, keep each element
    with probability 1 - p and scale it by 1 / (1 - p); otherwise the
    identity. Training with p > 0 and no generator raises."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if self.generator is None:
            raise ValueError("Dropout in training mode needs a generator (set_dropout_generator)")
        keep = 1.0 - self.p
        mask = torch.rand(x.shape, generator=self.generator, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def set_dropout_generator(module: nn.Module, generator: Optional[torch.Generator]) -> nn.Module:
    """Point every Dropout under `module` at `generator`."""
    for m in module.modules():
        if isinstance(m, Dropout):
            m.generator = generator
    return module


class ConvTranspose1d(nn.Module):
    """Weight-normed transposed conv, torch output size
    (T - 1) * stride - 2 * padding + kernel_size. weight_v is [in, out, k]
    and the norm is taken per input channel, as torch's weight_norm does."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0):
        super().__init__()
        self.stride = stride
        self.padding = padding
        self.fan_in = out_channels * kernel_size
        self.weight_g = nn.Parameter(torch.ones(in_channels, 1, 1))
        self.weight_v = nn.Parameter(torch.zeros(in_channels, out_channels, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def reset_parameters_(self, generator: torch.Generator):
        bound = 1.0 / math.sqrt(self.fan_in)
        _uniform_(self.weight_v, bound, generator)
        with torch.no_grad():
            self.weight_g.copy_(_norm_keep0(self.weight_v))
        _uniform_(self.bias, bound, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = _weight_normed(self.weight_g, self.weight_v)
        return F.conv_transpose1d(x, w, self.bias, stride=self.stride, padding=self.padding)


class LayerNorm(nn.Module):
    """LayerNorm over the channel dim of [B, C, T] (eps 1e-5)."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def reset_parameters_(self, generator: torch.Generator):
        with torch.no_grad():
            self.gamma.fill_(1.0)
            self.beta.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=1, keepdim=True)
        var = ((x - mean) ** 2).mean(dim=1, keepdim=True)
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return y * self.gamma[None, :, None] + self.beta[None, :, None]


class Embed(nn.Module):
    """Embedding table `weight` [n, features], normal(0, init_std) init."""

    def __init__(self, num_embeddings: int, features: int, init_std: float = 1.0):
        super().__init__()
        self.init_std = init_std
        self.weight = nn.Parameter(torch.zeros(num_embeddings, features))

    def reset_parameters_(self, generator: torch.Generator):
        with torch.no_grad():
            self.weight.copy_(torch.randn(self.weight.shape, generator=generator) * self.init_std)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight)


def init_params_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise every parameter of `module` from `generator`, in module order."""
    for m in module.modules():
        reset = getattr(m, "reset_parameters_", None)
        if reset is not None:
            reset(generator)
    return module


def leaky_relu(x: torch.Tensor, slope: float = 0.1) -> torch.Tensor:
    """Default slope 0.1 is the reference's LRELU_SLOPE."""
    return F.leaky_relu(x, slope)


def fused_add_tanh_sigmoid_multiply(a: torch.Tensor, b: torch.Tensor, n_channels: int):
    """tanh(s[:, :n]) * sigmoid(s[:, n:]) with s = a + b, on [B, 2n, T]."""
    s = a + b
    return torch.tanh(s[:, :n_channels]) * torch.sigmoid(s[:, n_channels:])
