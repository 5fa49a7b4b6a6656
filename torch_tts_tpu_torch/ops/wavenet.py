"""WaveNet-style gated conv stack (port of `WN`, `torch_tts_tpu/ops/wavenet.py`).

n_layers of [dilated conv -> tanh * sigmoid gate (+ conditioning) -> 1x1
res/skip], all convs weight-normed, [B, C, T] layout. Two paths over the
same parameters: layer by layer with `F.conv1d`, or the whole stack through
`kernels/wn_stack.py` (fused). `fused=None` takes `fused_wn_default` at
call time: `TTS_FUSED_WN=1` or `0` when set, else fused on a CUDA device
(the H100 measured the fused group faster than the layerwise path; the JAX
package's env default of 0 is a TPU verdict) and layerwise on the CPU. The
fused path needs dilation 1, a width, kernel and dtype the kernels take
(`wn_stack.supports`: H = 192, k odd and at most 15, x fp32 or bf16),
inactive dropout and time-broadcast conditioning; otherwise the layerwise
path runs.

Under bf16 training the parameters are bf16 and the stack computes in x's
dtype, as the JAX WN does on either path (its convs cast their kernels to
x's dtype; `wn_stack` casts the weights): bf16 where x is bf16 (the
posterior encoder), fp32 where the fp32 attention has promoted x (the
transformer flows).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
from torch import nn

from torch_tts_tpu_torch.kernels import wn_stack as wn_kernel
from torch_tts_tpu_torch.kernels.wn_stack import wn_stack
from torch_tts_tpu_torch.ops.layers import Conv1d, fused_add_tanh_sigmoid_multiply


def fused_wn_default(device: torch.device) -> bool:
    """Default of WN.fused for a tensor on `device`: env TTS_FUSED_WN (1 or
    0) when set, else True on a CUDA device."""
    env = os.environ.get("TTS_FUSED_WN")
    if env is not None:
        return env == "1"
    return device.type == "cuda"


class WN(nn.Module):
    def __init__(self, hidden_channels: int, kernel_size: int, dilation_rate: int,
                 n_layers: int, gin_channels: int = 0, p_dropout: float = 0.0,
                 fused: Optional[bool] = None):
        super().__init__()
        h = hidden_channels
        self.hidden_channels = h
        self.kernel_size = kernel_size
        self.dilation_rate = dilation_rate
        self.n_layers = n_layers
        self.p_dropout = p_dropout
        self.fused = fused
        if gin_channels > 0:
            self.cond_layer = Conv1d(gin_channels, 2 * h * n_layers, 1, weight_norm=True)
        self.in_layers = nn.ModuleList()
        self.res_skip_layers = nn.ModuleList()
        for i in range(n_layers):
            dilation = dilation_rate ** i
            padding = (kernel_size * dilation - dilation) // 2
            self.in_layers.append(Conv1d(h, 2 * h, kernel_size, padding=padding,
                                         dilation=dilation, weight_norm=True))
            rs_ch = 2 * h if i < n_layers - 1 else h
            self.res_skip_layers.append(Conv1d(h, rs_ch, 1, weight_norm=True))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                g: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, H, T]; x_mask [B, 1, T]; g [B, gin, 1] or [B, gin, T]."""
        h = self.hidden_channels
        g_all = self.cond_layer(g) if g is not None else None
        fused = fused_wn_default(x.device) if self.fused is None else self.fused
        if (fused and self.dilation_rate == 1
                and wn_kernel.supports(self.hidden_channels, self.kernel_size, x.dtype)
                and (self.p_dropout == 0.0 or not self.training)
                and (g is None or g.shape[-1] == 1)):
            return self._fused(x, x_mask, g_all)

        output = torch.zeros_like(x)
        for i, (in_layer, rs_layer) in enumerate(zip(self.in_layers, self.res_skip_layers)):
            x_in = in_layer(x)
            g_l = g_all[:, i * 2 * h:(i + 1) * 2 * h] if g_all is not None else torch.zeros_like(x_in)
            res_skip = rs_layer(fused_add_tanh_sigmoid_multiply(x_in, g_l, h))
            if i < self.n_layers - 1:
                x = (x + res_skip[:, :h]) * x_mask
                output = output + res_skip[:, h:]
            else:
                output = output + res_skip
        return output * x_mask

    def fused_weights(self):
        """(w_in [L, k, H, 2H], b_in [L, 2H], w_rs [L, H, 2H], b_rs [L, 2H]) in
        the kernel's layout; the final layer's residual half is zero, so the
        generic layer update leaves x unchanged there, as the reference does."""
        h = self.hidden_channels
        w_in = torch.stack([m.effective_weight().permute(2, 1, 0) for m in self.in_layers])
        b_in = torch.stack([m.bias for m in self.in_layers])
        w_rs, b_rs = [], []
        for i, m in enumerate(self.res_skip_layers):
            w = m.effective_weight()[:, :, 0].t()  # [H, rs_ch]
            b = m.bias
            if i == self.n_layers - 1:
                w = torch.cat([torch.zeros_like(w), w], dim=1)
                b = torch.cat([torch.zeros_like(b), b])
            w_rs.append(w)
            b_rs.append(b)
        return (w_in.contiguous(), b_in.contiguous(),
                torch.stack(w_rs).contiguous(), torch.stack(b_rs).contiguous())

    def _fused(self, x, x_mask, g_all):
        w_in, b_in, w_rs, b_rs = self.fused_weights()
        gl = None
        if g_all is not None:
            gl = g_all[:, :, 0].reshape(g_all.shape[0], self.n_layers, 2 * self.hidden_channels)
        skip = wn_stack(x.transpose(1, 2).contiguous(), x_mask.transpose(1, 2).contiguous(),
                        gl, w_in, b_in, w_rs, b_rs)
        return skip.transpose(1, 2)
