"""Relative-position transformer encoder, [B, C, T] layout.

Port of `MultiHeadAttention`, `FFN` and `Encoder` from
`torch_tts_tpu/ops/transformer.py`: windowed relative-position attention
(window 4 in the text encoder; `window_size=None` in the flows'
pre_transformer) with the pad/reshape skew between relative and absolute
positions, a conv FFN, and post-LN residual blocks. Dropout, in training
mode, at the JAX sites: attention probabilities, the FFN's hidden
activation, and each residual branch (masks from the modules' explicit
generator, `ops/layers.py:set_dropout_generator`).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from torch_tts_tpu_torch.ops.layers import Conv1d, Dropout, LayerNorm


def _rel_to_abs(x: torch.Tensor) -> torch.Tensor:
    """[B, H, L, 2L-1] relative logits -> [B, H, L, L] absolute."""
    b, h, l, _ = x.shape
    x = F.pad(x, (0, 1))
    x_flat = F.pad(x.reshape(b, h, l * 2 * l), (0, l - 1))
    return x_flat.reshape(b, h, l + 1, 2 * l - 1)[:, :, :l, l - 1:]


def _abs_to_rel(x: torch.Tensor) -> torch.Tensor:
    """[B, H, L, L] absolute weights -> [B, H, L, 2L-1] relative."""
    b, h, l, _ = x.shape
    x = F.pad(x, (0, l - 1))
    x_flat = F.pad(x.reshape(b, h, l * l + l * (l - 1)), (l, 0))
    return x_flat.reshape(b, h, l, 2 * l)[..., 1:]


class MultiHeadAttention(nn.Module):
    def __init__(self, channels: int, out_channels: int, n_heads: int,
                 window_size: Optional[int] = None, p_dropout: float = 0.0):
        super().__init__()
        assert channels % n_heads == 0
        self.drop = Dropout(p_dropout)
        self.n_heads = n_heads
        self.k_channels = channels // n_heads
        self.window_size = window_size
        self.conv_q = Conv1d(channels, channels, 1)
        self.conv_k = Conv1d(channels, channels, 1)
        self.conv_v = Conv1d(channels, channels, 1)
        self.conv_o = Conv1d(channels, out_channels, 1)
        if window_size is not None:
            shape = (1, 2 * window_size + 1, self.k_channels)
            self.emb_rel_k = nn.Parameter(torch.zeros(shape))
            self.emb_rel_v = nn.Parameter(torch.zeros(shape))

    def reset_parameters_(self, generator: torch.Generator):
        if self.window_size is not None:
            std = self.k_channels ** -0.5
            with torch.no_grad():
                for p in (self.emb_rel_k, self.emb_rel_v):
                    p.copy_(torch.randn(p.shape, generator=generator) * std)

    def _relative_embeddings(self, emb: torch.Tensor, length: int) -> torch.Tensor:
        """[1, 2w+1, d] window embeddings -> [1, 2*length-1, d]."""
        w = self.window_size
        pad_len = max(length - (w + 1), 0)
        start = max((w + 1) - length, 0)
        if pad_len > 0:
            emb = F.pad(emb, (0, 0, pad_len, pad_len))
        return emb[:, start:start + 2 * length - 1]

    def forward(self, x: torch.Tensor, c: torch.Tensor, attn_mask: torch.Tensor):
        """x: queries [B, C, Tt]; c: keys/values [B, C, Ts];
        attn_mask [B, 1, Tt, Ts] (1 = attend)."""
        q, k, v = self.conv_q(x), self.conv_k(c), self.conv_v(c)
        b, d, t_s = k.shape
        t_t = q.shape[2]
        h, dk = self.n_heads, self.k_channels
        q = q.reshape(b, h, dk, t_t).transpose(2, 3) / math.sqrt(dk)
        k = k.reshape(b, h, dk, t_s).transpose(2, 3)
        v = v.reshape(b, h, dk, t_s).transpose(2, 3)

        scores = torch.matmul(q, k.transpose(-2, -1))
        if self.window_size is not None:
            assert t_s == t_t, "relative attention requires self-attention"
            rel_k = self._relative_embeddings(self.emb_rel_k, t_s)
            scores = scores + _rel_to_abs(torch.matmul(q, rel_k.transpose(-2, -1)[None]))
        scores = scores.masked_fill(attn_mask == 0, -1e4)
        p_attn = self.drop(torch.softmax(scores, dim=-1))
        out = torch.matmul(p_attn, v)
        if self.window_size is not None:
            rel_v = self._relative_embeddings(self.emb_rel_v, t_s)
            out = out + torch.matmul(_abs_to_rel(p_attn), rel_v[None])
        out = out.transpose(2, 3).reshape(b, d, t_t)
        return self.conv_o(out)


class FFN(nn.Module):
    """Two 'same'-padded convs with ReLU, masked before each conv."""

    def __init__(self, in_channels: int, out_channels: int, filter_channels: int,
                 kernel_size: int, p_dropout: float = 0.0):
        super().__init__()
        self.drop = Dropout(p_dropout)
        self.pad = ((kernel_size - 1) // 2, kernel_size // 2)
        self.conv_1 = Conv1d(in_channels, filter_channels, kernel_size)
        self.conv_2 = Conv1d(filter_channels, out_channels, kernel_size)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor) -> torch.Tensor:
        y = self.drop(torch.relu(self.conv_1(F.pad(x * x_mask, self.pad))))
        y = self.conv_2(F.pad(y * x_mask, self.pad))
        return y * x_mask


class Encoder(nn.Module):
    """Self-attention encoder stack of post-LN residual blocks."""

    def __init__(self, hidden_channels: int, filter_channels: int, n_heads: int,
                 n_layers: int, kernel_size: int = 1, window_size: Optional[int] = 4,
                 p_dropout: float = 0.0):
        super().__init__()
        self.drop = Dropout(p_dropout)
        self.attn_layers = nn.ModuleList()
        self.norm_layers_1 = nn.ModuleList()
        self.ffn_layers = nn.ModuleList()
        self.norm_layers_2 = nn.ModuleList()
        for _ in range(n_layers):
            self.attn_layers.append(MultiHeadAttention(
                hidden_channels, hidden_channels, n_heads, window_size=window_size,
                p_dropout=p_dropout))
            self.norm_layers_1.append(LayerNorm(hidden_channels))
            self.ffn_layers.append(FFN(hidden_channels, hidden_channels, filter_channels,
                                       kernel_size, p_dropout=p_dropout))
            self.norm_layers_2.append(LayerNorm(hidden_channels))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor) -> torch.Tensor:
        """x [B, C, T]; x_mask [B, 1, T]."""
        attn_mask = x_mask.unsqueeze(2) * x_mask.unsqueeze(-1)
        x = x * x_mask
        for attn, norm1, ffn, norm2 in zip(self.attn_layers, self.norm_layers_1,
                                           self.ffn_layers, self.norm_layers_2):
            x = norm1(x + self.drop(attn(x, x, attn_mask)))
            x = norm2(x + self.drop(ffn(x, x_mask)))
        return x * x_mask
