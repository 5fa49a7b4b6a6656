"""Dilated depth-separable conv stack (port of `DDSConv`,
`torch_tts_tpu/ops/convs.py`), [B, C, T] layout, with the JAX dropout after
each layer's second GELU in training mode."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from torch_tts_tpu_torch.ops.layers import Conv1d, Dropout, LayerNorm


class DDSConv(nn.Module):
    """Per layer: depthwise dilated conv -> LN -> GELU -> 1x1 -> LN -> GELU,
    added residually; dilation kernel_size**i."""

    def __init__(self, channels: int, kernel_size: int, n_layers: int, p_dropout: float = 0.0):
        super().__init__()
        self.drop = Dropout(p_dropout)
        self.convs_sep = nn.ModuleList()
        self.convs_1x1 = nn.ModuleList()
        self.norms_1 = nn.ModuleList()
        self.norms_2 = nn.ModuleList()
        for i in range(n_layers):
            dilation = kernel_size ** i
            padding = (kernel_size * dilation - dilation) // 2
            self.convs_sep.append(Conv1d(channels, channels, kernel_size, padding=padding,
                                         dilation=dilation, groups=channels))
            self.convs_1x1.append(Conv1d(channels, channels, 1))
            self.norms_1.append(LayerNorm(channels))
            self.norms_2.append(LayerNorm(channels))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                g: Optional[torch.Tensor] = None) -> torch.Tensor:
        if g is not None:
            x = x + g
        for sep, pw, n1, n2 in zip(self.convs_sep, self.convs_1x1, self.norms_1, self.norms_2):
            y = F.gelu(n1(sep(x * x_mask)))
            y = self.drop(F.gelu(n2(pw(y))))
            x = x + y
        return x * x_mask
