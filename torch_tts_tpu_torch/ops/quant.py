"""Int8 W8A8 inference ops (port of `torch_tts_tpu/ops/quant.py`), [B, C, T]
layout.

The scheme of the JAX package's `quantize_decoder`, an approximate mode
for inference only:
- weights: int8, one symmetric scale per output channel,
  s_w = max(max |w| over all but the output axis, 1e-12) / 127 (as XLA
  computes it under jit: times the fp32 reciprocal of 127);
- activations: int8, one symmetric scale per tensor (batch and padding
  included), computed on the fly;
- accumulation in int32, dequantized as acc * (s_x * s_w[c]), then + bias.
Rounding is half to even after an IEEE division, as `jnp.round` of
`x / s`, so on the same fp32 inputs both quantizers give JAX's bits.

`quantize_weight_per_channel` and `quantize_act_dynamic` are the JAX
module's functions in torch ops. A decoder layer quantizes its weights once
(`ops/layers.py` caches them per parameter state, as JAX constant-folds
them under jit) and calls `int8_conv1d_quantized`, which runs the kernels
of `kernels/int8_conv.py`: their plain versions on a CPU tensor; on the
card the activation quantizer (which applies the decoder's leaky ReLU and
mask as it reads), then the int8 conv (any C_in: both write their rows
padded to a 32-channel granule; a resblock's residual added in its
epilogue), which raises on a shape that `int8_conv.supports` does not
take.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from torch_tts_tpu_torch.kernels import int8_conv
from torch_tts_tpu_torch.kernels.int8_conv import round_clip, symmetric_scale


def quantize_weight_per_channel(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """w [out, ...] fp -> (int8 of w's shape, fp32 scales [out]): one scale
    per output channel, dim 0 here (the JAX kernel's last axis)."""
    s_w = symmetric_scale(w.abs().amax(dim=tuple(range(1, w.dim()))))
    return round_clip(w / s_w.reshape(-1, *(1,) * (w.dim() - 1))), s_w.to(torch.float32)


def quantize_act_dynamic(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp activations, 3-D -> (int8 of x's shape, 0-d fp32 scale),
    symmetric, one scale for the whole tensor: the activation quantizer's
    plain version without its channels-last transpose."""
    return int8_conv.quantize_act_plain(x.transpose(1, 2))


def conv_weights(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A conv weight [N, C_in, k] -> the int8 conv's (w_q [N, k, C_in], s_w
    [N]). w_q's rows are `int8_conv.padded_channels(C_in)` apart, zero past
    C_in (a view of the padded buffer the card's kernel reads in place;
    contiguous when C_in is a multiple of 32)."""
    w_q, s_w = quantize_weight_per_channel(weight)
    N, C_in, k = w_q.shape
    packed = w_q.new_zeros(N, k, int8_conv.padded_channels(C_in))
    packed[..., :C_in] = w_q.permute(0, 2, 1)
    return packed[..., :C_in], s_w


def int8_conv1d_quantized(x: torch.Tensor, w_q: torch.Tensor, s_w: torch.Tensor,
                          bias: Optional[torch.Tensor], padding: Tuple[int, int],
                          dilation: int = 1, phases: int = 1, slope: Optional[float] = None,
                          mask: Optional[torch.Tensor] = None,
                          residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [B, C_in, T] fp32 through the int8 conv of quantized weights (w_q
    [N, k, C_in], s_w [N]; `kernels/int8_conv.py`'s contract) ->
    [B, N / phases, T_out * phases] fp32. The conv's input is
    leaky_relu(x, slope) * mask (each only when given), formed by the
    quantizer as it reads x; `residual` is added to the output by the
    conv. On the card a shape that `int8_conv.supports` does not take
    raises."""
    x_q, s_x = int8_conv.quantize_act(x.contiguous(), slope, mask)
    return int8_conv.int8_conv1d(x_q, s_x, w_q, s_w, bias, padding, dilation, phases,
                                 residual=residual)


def int8_conv1d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None, *,
                stride: int = 1, padding: Tuple[int, int] = (0, 0),
                dilation: int = 1) -> torch.Tensor:
    """Quantized 1-D conv (JAX `int8_conv1d`): x [B, C_in, T] fp, weight
    [C_out, C_in, k] fp (quantized here), bias [C_out] or None -> fp32
    [B, C_out, T_out]. Stride 1 only (no caller of the JAX function passes
    another)."""
    if stride != 1:
        raise ValueError(f"int8_conv1d: stride {stride}; the int8 conv takes stride 1 only")
    w_q, s_w = conv_weights(weight)
    return int8_conv1d_quantized(x, w_q, s_w, bias, padding, dilation)
