"""Relative-position transformer encoder and the causal FFT block, [B, C, T]
layout.

Port of `MultiHeadAttention`, `FFN`, `Encoder` and `FFT` from
`torch_tts_tpu/ops/transformer.py`: windowed relative-position attention
(window 4 in the text encoder and the `pre_conv2` flow; `window_size=None`
in the other flows' transformers) with the pad/reshape skew between
relative and absolute positions, a conv FFN ('same' or causal padding),
post-LN residual blocks, and the `fft` flow's block: causal self-attention
under a bare `tril` mask, a causal FFN, and with a speaker embedding a
gated tanh-sigmoid input from one shared `cond_pre` and a weight-normed
`cond_layer`. Dropout, in training mode, at the JAX sites: attention
probabilities, the FFN's hidden activation, and each residual branch
(masks from the modules' explicit generator,
`ops/layers.py:set_dropout_generator`).

In bf16 (`train.use_bf16`) the attention logits and their softmax are fp32,
as in the JAX attention, whose logit products ask for an fp32 result: the
probabilities' products with bf16 values then promote to fp32, and so does
everything after them.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from torch_tts_tpu_torch.ops.layers import (Conv1d, Dropout, LayerNorm, Linear,
                                            fused_add_tanh_sigmoid_multiply)


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


def _matmul_promoted(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in the promoted dtype of the two, as jnp.einsum computes it."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(dt), b.to(dt))


class MultiHeadAttention(nn.Module):
    """With `proximal_init`, conv_k starts as a copy of conv_q (its
    initialiser copies conv_q's, which `init_params_` visits first)."""

    def __init__(self, channels: int, out_channels: int, n_heads: int,
                 window_size: Optional[int] = None, p_dropout: float = 0.0,
                 proximal_init: bool = False):
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
        if proximal_init:
            self.conv_k.reset_parameters_ = self._copy_q_into_k
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

    def _copy_q_into_k(self, generator: torch.Generator):
        with torch.no_grad():
            self.conv_k.weight.copy_(self.conv_q.weight)
            self.conv_k.bias.copy_(self.conv_q.bias)

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

        # the logits in fp32 whatever q's dtype (JAX: preferred_element_type=float32)
        qf = q.float()
        scores = torch.matmul(qf, k.transpose(-2, -1).float())
        if self.window_size is not None:
            assert t_s == t_t, "relative attention requires self-attention"
            rel_k = self._relative_embeddings(self.emb_rel_k, t_s)
            scores = scores + _rel_to_abs(torch.matmul(qf, rel_k.transpose(-2, -1)[None].float()))
        scores = scores.masked_fill(attn_mask == 0, -1e4)
        p_attn = self.drop(torch.softmax(scores, dim=-1))
        out = _matmul_promoted(p_attn, v)
        if self.window_size is not None:
            rel_v = self._relative_embeddings(self.emb_rel_v, t_s)
            out = out + _matmul_promoted(_abs_to_rel(p_attn), rel_v[None])
        out = out.transpose(2, 3).reshape(b, d, t_t)
        return self.conv_o(out)


class FFN(nn.Module):
    """Two 'same'-padded (or with `causal`, left-padded) convs with ReLU,
    masked before each conv."""

    def __init__(self, in_channels: int, out_channels: int, filter_channels: int,
                 kernel_size: int, p_dropout: float = 0.0, causal: bool = False):
        super().__init__()
        self.drop = Dropout(p_dropout)
        self.pad = (kernel_size - 1, 0) if causal else ((kernel_size - 1) // 2, kernel_size // 2)
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
                 p_dropout: float = 0.0, gin_channels: int = 0, cond_layer_idx: int = 2):
        super().__init__()
        self.drop = Dropout(p_dropout)
        self.cond_layer_idx = cond_layer_idx if gin_channels > 0 else n_layers
        if gin_channels > 0:
            self.spk_emb_linear = Linear(gin_channels, hidden_channels)
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

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                g: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, C, T]; x_mask [B, 1, T]; g [B, gin, 1] or None."""
        attn_mask = x_mask.unsqueeze(2) * x_mask.unsqueeze(-1)
        x = x * x_mask
        for i, (attn, norm1, ffn, norm2) in enumerate(zip(
                self.attn_layers, self.norm_layers_1, self.ffn_layers, self.norm_layers_2)):
            if i == self.cond_layer_idx and g is not None:
                x = (x + self.spk_emb_linear(g.transpose(1, 2)).transpose(1, 2)) * x_mask
            x = norm1(x + self.drop(attn(x, x, attn_mask)))
            x = norm2(x + self.drop(ffn(x, x_mask)))
        return x * x_mask


class FFT(nn.Module):
    """Causal self-attention blocks (the JAX `FFT`, the `fft` flow's
    conditioner): per layer, with a speaker embedding g, x becomes
    tanh * sigmoid of cond_pre(x) + that layer's slice of cond_layer(g);
    then causal self-attention (a bare `tril` mask, no window) and a causal
    FFN, each added residually under a LayerNorm."""

    def __init__(self, hidden_channels: int, filter_channels: int, n_heads: int,
                 n_layers: int = 1, kernel_size: int = 1, p_dropout: float = 0.0,
                 proximal_init: bool = True, gin_channels: int = 0):
        super().__init__()
        self.hidden_channels = hidden_channels
        self.drop = Dropout(p_dropout)
        if gin_channels > 0:
            self.cond_layer = Conv1d(gin_channels, 2 * hidden_channels * n_layers, 1,
                                     weight_norm=True)
            # one cond_pre shared by every layer, as the reference's
            self.cond_pre = Conv1d(hidden_channels, 2 * hidden_channels, 1)
        self.self_attn_layers = nn.ModuleList()
        self.norm_layers_0 = nn.ModuleList()
        self.ffn_layers = nn.ModuleList()
        self.norm_layers_1 = nn.ModuleList()
        for _ in range(n_layers):
            self.self_attn_layers.append(MultiHeadAttention(
                hidden_channels, hidden_channels, n_heads, p_dropout=p_dropout,
                proximal_init=proximal_init))
            self.norm_layers_0.append(LayerNorm(hidden_channels))
            self.ffn_layers.append(FFN(hidden_channels, hidden_channels, filter_channels,
                                       kernel_size, p_dropout=p_dropout, causal=True))
            self.norm_layers_1.append(LayerNorm(hidden_channels))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                g: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, H, T]; x_mask [B, 1, T]; g [B, gin, 1] or None."""
        h = self.hidden_channels
        cond = g is not None and hasattr(self, "cond_layer")
        g_all = self.cond_layer(g) if cond else None
        t = x.shape[2]
        causal = torch.tril(torch.ones(t, t, dtype=x.dtype, device=x.device))[None, None]
        x = x * x_mask
        for i, (attn, norm0, ffn, norm1) in enumerate(zip(
                self.self_attn_layers, self.norm_layers_0, self.ffn_layers, self.norm_layers_1)):
            if cond:
                x = fused_add_tanh_sigmoid_multiply(
                    self.cond_pre(x), g_all[:, i * 2 * h:(i + 1) * 2 * h], h)
            x = norm0(x + self.drop(attn(x, x, causal)))
            x = norm1(x + self.drop(ffn(x, x_mask)))
        return x * x_mask
