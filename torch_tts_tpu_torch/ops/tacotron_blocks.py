"""Tacotron building blocks, channels-last [B, T, C] (port of
`torch_tts_tpu/ops/tacotron_blocks.py`).

`isru`, `isrlu`, `isru_sigmoid`; `Linear` (torch names `weight` [out, in],
`bias`); `BatchNorm` over (batch, time), on its running statistics or, in
training, on the batch's (flax's `nn.BatchNorm(momentum=0.9, epsilon=1e-5)`);
`dropout_with_mask`, the JAX `Dropout` given its keep mask; `PreNet`, whose
dropout stays on at inference in the Taco2Prod decoder and takes its keep
masks from the caller; `MelPostnet` (in training: batch statistics and
`Dropout(0.1)` after each ISRU, its masks from the caller). `CBHG`,
`MelPostnet2`, `Taco1PostNet` and `Upsampler` are not ported yet.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from torch_tts_tpu_torch.ops.layers import Conv1d, _uniform_


def isru(x: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    return x / torch.sqrt(1.0 + alpha * (x * x))


def isrlu(x: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    return torch.where(x >= 0, x, x / torch.sqrt(1.0 + alpha * (x * x)))


def isru_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return (1.0 + isru(x / 2.0, 1.0)) / 2.0


class Linear(nn.Module):
    """Dense layer over the last axis; torch-default uniform init."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def reset_parameters_(self, generator: torch.Generator):
        bound = 1.0 / math.sqrt(self.weight.shape[1])
        _uniform_(self.weight, bound, generator)
        if self.bias is not None:
            _uniform_(self.bias, bound, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


class BatchNorm(nn.Module):
    """BatchNorm over the last axis; `affine=False` has no weight/bias (the
    encoder's third BN). Buffers carry torch.nn.BatchNorm1d's names,
    `num_batches_tracked` included.

    batch_stats=True is flax's training mode: the statistics of every axis
    but the last, padding frames included (the JAX model passes no mask),
    var = max(0, E[x^2] - E[x]^2) (biased; flax's fast variance), the
    output through them with their gradient, and the running statistics
    updated to MOMENTUM * running + (1 - MOMENTUM) * batch. (torch's
    F.batch_norm would update running_var with the unbiased variance.)"""

    MOMENTUM = 0.9

    def __init__(self, num_features: int, affine: bool = True, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        if affine:
            self.weight = nn.Parameter(torch.ones(num_features))
            self.bias = nn.Parameter(torch.zeros(num_features))
        else:
            self.weight = self.bias = None
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.int64))

    def forward(self, x: torch.Tensor, batch_stats: bool = False) -> torch.Tensor:
        if not batch_stats:
            y = (x - self.running_mean) * torch.rsqrt(self.running_var + self.eps)
            if self.weight is not None:
                y = y * self.weight + self.bias
            return y
        dims = tuple(range(x.dim() - 1))
        mean = x.mean(dims)
        var = torch.clamp(torch.square(x).mean(dims) - torch.square(mean), min=0.0)
        with torch.no_grad():
            m = self.MOMENTUM
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)
            self.num_batches_tracked += 1
        mul = torch.rsqrt(var + self.eps)
        if self.weight is not None:
            mul = mul * self.weight
        y = (x - mean) * mul
        return y + self.bias if self.bias is not None else y


def dropout_with_mask(x: torch.Tensor, keep_mask: Optional[torch.Tensor], p: float) -> torch.Tensor:
    """The JAX `Dropout` given its mask: where(mask, x / keep, 0); None is
    the identity."""
    if keep_mask is None:
        return x
    keep = 1.0 - p
    return torch.where(keep_mask.bool(), x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class PreNet(nn.Module):
    """FC-ReLU-Dropout x2. `masks` is None (no dropout) or a pair of keep
    masks [B, dim_hidden] and [B, dim_output] for the two layers."""

    def __init__(self, dim_input: int, dim_output: int, dim_hidden: int = 256, p_dropout: float = 0.5):
        super().__init__()
        self.p_dropout = p_dropout
        self.layers = nn.ModuleList([Linear(dim_input, dim_hidden), Linear(dim_hidden, dim_output)])

    def forward(self, x: torch.Tensor, masks: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = dropout_with_mask(F.relu(layer(x)), None if masks is None else masks[i],
                                  self.p_dropout)
        return x


class MelPostnet(nn.Module):
    """Tacotron-2 conv postnet with ISRU activations and a residual output:
    x + fc_out(isru(bn(conv(...)))), `conv.{i}.0` the conv, `conv.{i}.1` the BN.
    In training, `Dropout(P_DROPOUT)` after each ISRU with the caller's keep
    masks, one [B, T, dim_hidden] per layer."""

    P_DROPOUT = 0.1

    def __init__(self, dim_mel: int, dim_hidden: int = 512, kernel_size: int = 5, num_layers: int = 3):
        super().__init__()
        pad = (kernel_size - 1) // 2
        self.conv = nn.ModuleList(
            nn.ModuleList([Conv1d(dim_mel if i == 0 else dim_hidden, dim_hidden, kernel_size,
                                  padding=pad, bias=False), BatchNorm(dim_hidden)])
            for i in range(num_layers))
        self.fc_out = Linear(dim_hidden, dim_mel, bias=False)

    def forward(self, x: torch.Tensor, batch_stats: bool = False,
                dropout_masks: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """x [B, T, dim_mel] -> [B, T, dim_mel]; batch_stats: BN in training
        mode; dropout_masks: None (no dropout) or one keep mask a layer."""
        y = x
        for i, (conv, bn) in enumerate(self.conv):
            y = isru(bn(conv(y.transpose(1, 2)).transpose(1, 2), batch_stats))
            if dropout_masks is not None:
                y = dropout_with_mask(y, dropout_masks[i], self.P_DROPOUT)
        return x + self.fc_out(y)
