"""Primitive layers, [B, C, T] layout (port of `torch_tts_tpu/ops/layers.py`).

Parameter names follow the kgoba reference's torch modules, which is what
`export_torch_state_dict` emits: `weight`/`bias`, or `weight_g`/`weight_v`
for weight-normed convs (torch.nn.utils.weight_norm with dim=0), and
`gamma`/`beta` for the channel LayerNorm.

Every layer that owns parameters has `reset_parameters_(generator)`; the
model-level `init_params_` calls them in module order, so one seeded
`torch.Generator` fixes all initial weights. `Dropout` draws its masks
from an explicit generator too (`set_dropout_generator`).

Dtypes follow the JAX layers' (bf16 training, `train.use_bf16`): a conv
casts its weight and bias to the input's dtype, as the JAX convs' `kernel.
astype(x.dtype)` do; `Linear` and `LayerNorm` compute in the promoted
dtype of input and parameters (JAX's promotion: bf16 with fp32 gives
fp32), which `F.linear` does not do on its own; `Embed` and `Dropout` keep
their table's and their input's dtype.

`Conv1d` and `ConvTranspose1d` take `quant="int8"`: W8A8 inference through
`ops/quant.py` (the transposed conv on its subpixel route only). Their
parameters and state dict are the same as without it; the int8 weights and
scales are made once per parameter state and cached on the module. Their
forwards take the decoder's pre-activation (a leaky ReLU slope and a mask)
and, for `Conv1d`, a residual: the int8 route folds them into its two
kernels, the fp route applies them in torch ops.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from torch_tts_tpu_torch.kernels.int8_conv import pre_activation
from torch_tts_tpu_torch.ops import quant as quant_ops


def _uniform_(t: torch.Tensor, bound: float, generator: torch.Generator):
    with torch.no_grad():
        t.copy_(torch.rand(t.shape, generator=generator) * (2 * bound) - bound)


def _norm_keep0(v: torch.Tensor) -> torch.Tensor:
    """L2 norm over every dim but 0, kept as [n, 1, 1] (weight_norm dim=0)."""
    return torch.sqrt(torch.sum(v * v, dim=tuple(range(1, v.dim())), keepdim=True))


def _weight_normed(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return v * (g / torch.clamp(_norm_keep0(v), min=1e-12))


def _cast_to(x: torch.Tensor, *ts: Optional[torch.Tensor]):
    """`ts` (a conv's weight and bias, None kept) in x's dtype."""
    return tuple(None if t is None else t.to(x.dtype) for t in ts)


def _conv(fn, x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], **kw):
    """fn(x, weight, bias, **kw) in x's dtype, the weight and bias cast to
    it. A bf16 conv on the CPU runs in fp32 and rounds its output once,
    which is what a bf16 conv with fp32 accumulation gives: PyTorch's CPU
    bf16 convolutions return a wrong input gradient for the decoder's
    stride-8 transposed conv (about 97% of its norm off) and non-finite
    weight gradients, now and then, for the scale discriminator's grouped
    convs on a frame or two. On the card the conv runs in bf16 (cuDNN)."""
    weight, bias = _cast_to(x, weight, bias)
    if x.dtype == torch.bfloat16 and x.device.type == "cpu":
        f32 = None if bias is None else bias.float()
        return fn(x.float(), weight.float(), f32, **kw).to(x.dtype)
    return fn(x, weight, bias, **kw)


def _check_quant(quant: Optional[str]) -> Optional[str]:
    if quant not in (None, "int8"):
        raise ValueError(f"unknown quant {quant!r} (None or 'int8')")
    return quant


class _Int8Cache:
    """The int8 weights and scales of a module (`make()` under no_grad),
    made at first use and again when a weight parameter has changed: new
    storage or device (`.to()`), an in-place update (its version), or
    `load_state_dict` (which drops them). JAX folds them into constants
    under jit. Under `torch.export` they are made in the traced graph, which
    then quantizes the weights each call."""

    _q8 = None

    def _weight_params(self):
        return (self.weight_g, self.weight_v) if hasattr(self, "weight_v") else (self.weight,)

    def int8_weights(self, make):
        if torch.compiler.is_exporting():
            # traced into the exported program, which runs under no_grad (the
            # export splits a no_grad block of its own out of the graph, one
            # pass over the whole graph a block)
            return make()
        key = tuple((p.device, p.data_ptr(), None if p.is_inference() else p._version)
                    for p in self._weight_params())
        if self._q8 is None or self._q8[0] != key:
            with torch.no_grad():
                self._q8 = (key, *make())
        return self._q8[1:]

    def _load_from_state_dict(self, *args, **kwargs):
        self._q8 = None
        super()._load_from_state_dict(*args, **kwargs)


class Conv1d(_Int8Cache, nn.Module):
    """1-D conv. `padding` is a symmetric count or a (left, right) pair;
    `weight_norm` stores (weight_g, weight_v); `zero_init` starts at zero as
    the reference's projection convs do. `quant="int8"`: W8A8 inference
    (`ops/quant.py`, JAX `Conv1d(quant="int8")`), ungrouped, stride 1."""

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
        quant: Optional[str] = None,
    ):
        super().__init__()
        self.quant = _check_quant(quant)
        if quant is not None and (groups != 1 or stride != 1):
            raise ValueError("the int8 conv has no grouped or strided form")
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

    def forward(self, x: torch.Tensor, slope: Optional[float] = None,
                mask: Optional[torch.Tensor] = None,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        """conv(leaky_relu(x, slope) * mask) + residual, each of the three
        only when given. The int8 route forms the conv's input in its
        quantizer and adds the residual in the conv's epilogue (no tensor
        in between); the fp route applies them in torch ops."""
        lo, hi = self.padding
        if self.quant is not None:
            w_q, s_w = self.int8_weights(lambda: quant_ops.conv_weights(self.effective_weight()))
            return quant_ops.int8_conv1d_quantized(x, w_q, s_w, self.bias, self.padding,
                                                   self.dilation, slope=slope, mask=mask,
                                                   residual=residual)
        x = pre_activation(x, slope, mask)
        kw = dict(stride=self.stride, dilation=self.dilation, groups=self.groups)
        if lo == hi:
            y = _conv(F.conv1d, x, self.effective_weight(), self.bias, padding=lo, **kw)
        else:
            y = _conv(F.conv1d, F.pad(x, (lo, hi)), self.effective_weight(), self.bias, **kw)
        return y + residual if residual is not None else y


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
        return _conv(F.conv2d, x, _weight_normed(self.weight_g, self.weight_v), self.bias,
                     stride=self.stride, padding=self.padding)


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


class ConvTranspose1d(_Int8Cache, nn.Module):
    """Weight-normed transposed conv, torch output size
    (T - 1) * stride - 2 * padding + kernel_size. weight_v is [in, out, k]
    and the norm is taken per input channel, as torch's weight_norm does.

    `quant="int8"` takes effect on the subpixel geometry only (stride > 1
    and kernel_size - stride - 2 * padding == 0, JAX's auto rule): the
    transposed conv is a dense stride-1 conv with stride * out columns, one
    per (output channel, phase), quantized with a scale per column, whose
    phases interleave into the output (JAX `_subpixel`). Other geometries,
    and the fp route, run `F.conv_transpose1d`."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, quant: Optional[str] = None):
        super().__init__()
        self.stride = stride
        self.padding = padding
        self.kernel_size = kernel_size
        self.quant = _check_quant(quant)
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

    def effective_weight(self) -> torch.Tensor:
        """[in, out, k] weight, weight norm applied."""
        return _weight_normed(self.weight_g, self.weight_v)

    @property
    def subpixel(self) -> bool:
        """Whether the output is exactly stride times the input (JAX's auto
        rule for its subpixel route)."""
        return self.stride > 1 and self.kernel_size - self.stride - 2 * self.padding == 0

    def _subpixel_taps(self):
        """(q_max, q_min, a [W_len, stride]): the dense kernel's window
        offsets and, for window position w and phase r, the transposed
        kernel's tap (q_max - w) * stride + r + padding (JAX `_subpixel`)."""
        k, u, p = self.kernel_size, self.stride, self.padding
        q_min, q_max = -((p + u - 1) // u), (k - 1 - p) // u
        w = torch.arange(q_max - q_min + 1)
        return q_max, q_min, (q_max - w)[:, None] * u + torch.arange(u)[None, :] + p

    def subpixel_weight(self) -> torch.Tensor:
        """The dense stride-1 kernel [out * stride, in, W_len], row o *
        stride + r holding phase r's taps of output channel o (JAX's DK
        [W_len, in, stride * out], whose columns are ordered (phase, out))."""
        _, _, a = self._subpixel_taps()
        k = self.kernel_size
        w = self.effective_weight()  # [in, out, k]
        kg = w[:, :, a.clamp(0, k - 1).to(w.device)]  # [in, out, W_len, u]
        valid = ((a >= 0) & (a < k)).to(w.device)
        kg = torch.where(valid, kg, torch.zeros((), dtype=w.dtype, device=w.device))
        c_in, c_out = w.shape[:2]
        return kg.permute(1, 3, 0, 2).reshape(c_out * self.stride, c_in, a.shape[0])

    def forward(self, x: torch.Tensor, slope: Optional[float] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The transposed conv of leaky_relu(x, slope) * mask (each only
        when given; on the int8 route formed by the quantizer as it reads
        x)."""
        if self.quant is not None and self.subpixel:
            q_max, q_min, _ = self._subpixel_taps()
            w_q, s_w = self.int8_weights(lambda: quant_ops.conv_weights(self.subpixel_weight()))
            return quant_ops.int8_conv1d_quantized(x, w_q, s_w, self.bias, (q_max, -q_min),
                                                   phases=self.stride, slope=slope, mask=mask)
        return _conv(F.conv_transpose1d, pre_activation(x, slope, mask), self.effective_weight(),
                     self.bias, stride=self.stride, padding=self.padding)


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


class Linear(nn.Module):
    """Dense layer with nn.Linear's names and layout (`weight` [out, in],
    `bias` [out]) and its default uniform init, drawn from the generator."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def reset_parameters_(self, generator: torch.Generator):
        bound = 1.0 / math.sqrt(self.weight.shape[1])
        _uniform_(self.weight, bound, generator)
        _uniform_(self.bias, bound, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


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
