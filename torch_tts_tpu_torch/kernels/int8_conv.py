"""W8A8 int8 convolution: the dynamic activation quantizer and the int8
conv1d of the int8 decoder (`quantize_decoder`).

Replaces no Pallas kernel: in the JAX package this is XLA work
(`torch_tts_tpu/ops/quant.py`: `quantize_act_dynamic`'s round and clip,
`int8_conv1d`'s `lax.conv_general_dilated` with int32 accumulation).
PyTorch has no int8 convolution on the card, so the CUDA kernels of
`torch_tts_tpu_torch/csrc/int8_conv.cu` compute both; the bound and the
design are in its header.

- `quantize_act(x, slope=None, mask=None)`: x [B, C, T] fp32 -> (x_q [B,
  T, C] int8, s_x a 0-d fp32 tensor on x's device), the quantization of
  v = leaky_relu(x, slope) * mask (each factor only when given, computed
  as the decoder computes it before an int8 conv: x >= 0 ? x : fl(slope
  x), then times mask [B, 1, T]), so that no activation tensor is written
  before the conv. s_x = max(max |v| over the whole tensor, 1e-12) *
  fp32(1 / 127) (`symmetric_scale`), x_q = clip(round(v / s_x), -127,
  127) with IEEE division and round half to even (jnp.round and
  torch.round). x_q is channels-last, the conv's K axis contiguous; on the
  card its rows are `padded_channels(C)` apart, zero past C (a [B, T, C]
  view of a [B, T, padded_channels(C)] buffer). One kernel launch a call.
- `int8_conv1d(x_q, s_x, w_q, s_w, bias, padding, dilation, phases,
  residual=None)`: x_q [B, T, C_in] int8, w_q [N, k, C_in] int8, s_w [N]
  fp32, bias [N / phases] fp32 or None, padding (lo, hi), residual [B, N /
  phases, T_out * phases] fp32 or None -> [B, N / phases, T_out * phases]
  fp32, T_out = T + lo + hi - dilation * (k - 1). With acc[b, t, n] = sum
  over taps j and channels c of x_q[b, t + j * dilation - lo, c] * w_q[n,
  j, c] (zero outside [0, T)), exact in int32, column n = o * phases + r
  gives out[b, o, t * phases + r] = float(acc) * (s_x * s_w[n]) (+
  bias[o]) (+ residual[b, o, t * phases + r]), each step rounded in that
  order. phases = 1 is a conv in the port's [B, C, T] layout; phases = u
  is the subpixel transposed conv's dense product with its depth-to-space.
  Any C_in >= 1: on the card the kernel runs over padded_channels(C_in)
  channels, reading x_q's and w_q's rows that far. A tensor whose rows are
  C_in apart is copied into a zero-padded buffer first; one already
  padded (x_q from `quantize_act`, w_q from `ops/quant.conv_weights`) is
  read in place, and w_q's channels past C_in must then be zero (they
  cancel whatever x_q holds there), as `conv_weights` writes them. The
  kernel's tile follows the grid (`conv_tile`).

Dispatch: both wrappers call their operators, `tts::quantize_act` and
`tts::int8_conv1d` (`build.OPS`), so that `torch.export` records them; a
CPU tensor takes the plain version (`quantize_act_plain`,
`int8_conv1d_plain`); a CUDA tensor launches the kernel or raises. Both
wrappers raise when a gradient is needed (a rounded activation passes
none: the int8 decoder is for inference only) and `int8_conv1d` on a
stride other than 1. `supports` is the conv kernel's shape gate: on the
card `int8_conv1d` raises on a shape it does not take (a CUDA tensor never
takes the plain version). `quantize_act.launches` and
`int8_conv1d.launches` count kernel launches.
"""

from __future__ import annotations

import functools
import math
import struct
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from torch_tts_tpu_torch.kernels import build

EPS = 1e-12
# fp32(1 / 127): under jit, XLA turns the JAX package's division by the
# constant 127 into a product with its fp32 reciprocal (eager JAX divides),
# and jit is how the JAX package runs its decoder
INV_127 = float(torch.tensor(1.0) / 127.0)
K_MULTIPLE = 32  # x_q's and w_q's row granule on the card: 32 channels (bytes) of int8
MAX_K = 131072  # k * C_in: int32 sums of up to this many 127^2 products
# the conv kernel's tiles (rows, columns), largest first: the first whose
# grid has at least an SM's worth of tiles is taken, else the last
CONV_TILES = ((128, 128), (64, 128), (64, 64))
SCALE_WORDS = 1 + 1024  # the quantizer's s_x and its CTAs' scratch words


def symmetric_scale(amax: torch.Tensor) -> torch.Tensor:
    """max(amax, 1e-12) * fp32(1 / 127) in fp32: JAX's `jnp.maximum(., _EPS) /
    127.0` as XLA computes it under jit, bit for bit."""
    return torch.clamp(amax.to(torch.float32), min=EPS) * INV_127


def round_clip(v: torch.Tensor) -> torch.Tensor:
    """clip(round half to even(v), -127, 127) as int8."""
    return torch.clamp(torch.round(v), -127, 127).to(torch.int8)


def check_no_grad(*tensors: Optional[torch.Tensor]) -> None:
    """Raise when autograd would need a gradient through the int8 path."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError("int8: the int8 decoder is for inference only (a rounded activation "
                           "passes no gradient); run it under torch.no_grad() or "
                           "torch.inference_mode(), and train with quantize_decoder off")


def padded_channels(C: int) -> int:
    """C rounded up to the kernel's K step: the channel stride of the card's
    x_q and w_q rows."""
    return -(-C // K_MULTIPLE) * K_MULTIPLE


def supports(C_in: int, C_out: int, k: int, dilation: int) -> bool:
    """Whether the conv kernel takes C_in input channels (any C_in >= 1,
    padded to `padded_channels`), C_out product columns (the output
    channels times the phases), k taps and the dilation: at most MAX_K
    padded channels times taps (on the card `int8_conv1d` raises on any
    other shape)."""
    return (C_in >= 1 and C_out >= 1 and k >= 1 and dilation >= 1
            and k * padded_channels(C_in) <= MAX_K)


def padded_rows(t: torch.Tensor) -> torch.Tensor:
    """t [..., R, C] int8 (x_q or w_q) as the card's kernel reads it: rows
    padded_channels(C) apart. `t` itself when it is laid out so (contiguous
    rows of that stride, or a view of a buffer that holds them, from a
    16-byte aligned address), else a copy with zero channels past C."""
    C = t.shape[-1]
    Cp = padded_channels(C)
    rows = t.numel() // C if C else 0
    if (t.stride(-1) == 1 and all(t.stride(i) == Cp * math.prod(t.shape[i + 1:-1])
                                  for i in range(t.dim() - 1))
            and t.untyped_storage().nbytes() >= t.storage_offset() + rows * Cp
            and t.data_ptr() % 16 == 0):  # TMA reads from a 16-byte aligned base
        return t
    return F.pad(t, (0, Cp - C)).contiguous()[..., :C]


def pre_activation(x: torch.Tensor, slope: Optional[float] = None,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """leaky_relu(x, slope) * mask, each factor only when given: the
    activation the decoder forms before an int8 conv."""
    if slope is not None:
        x = F.leaky_relu(x, slope)
    return x * mask if mask is not None else x


def quantize_act_plain(x: torch.Tensor, slope: Optional[float] = None,
                       mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, C, T] -> (x_q [B, T, C] int8, s_x 0-d fp32) of
    pre_activation(x, slope, mask)."""
    x = pre_activation(x, slope, mask)
    s_x = symmetric_scale(x.abs().amax()).to(torch.float32)
    return round_clip(x.transpose(1, 2) / s_x).contiguous(), s_x


def quantize_act(x: torch.Tensor, slope: Optional[float] = None,
                 mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The activation quantizer (module docstring): x [B, C, T] fp32, the
    leaky ReLU's slope or None, mask [B, 1, T] or None -> (x_q [B, T, C]
    int8, s_x 0-d fp32 on x's device), through the operator
    `tts::quantize_act`."""
    build.check_device(x, "quantize_act")
    check_no_grad(x, mask)
    return torch.ops.tts.quantize_act(x, slope, mask)


def _quantize_fake(x, slope, mask):
    B, C, T = x.shape
    if x.device.type == "cuda":  # a view of x_q's padded rows (module docstring)
        x_q = torch.empty_strided((B, T, C), (T * padded_channels(C), padded_channels(C), 1),
                                  dtype=torch.int8, device=x.device)
    else:
        x_q = x.new_empty((B, T, C), dtype=torch.int8)
    return x_q, x.new_empty((), dtype=torch.float32)


def _quantize_cuda(x, slope, mask):
    """`tts::quantize_act` on CUDA tensors: one launch of the quantizer."""
    if x.dtype != torch.float32 or x.dim() != 3 or not x.is_contiguous():
        raise ValueError("quantize_act: x must be a contiguous fp32 [B, C, T] tensor")
    B, C, T = x.shape
    if mask is not None:
        if tuple(mask.shape) != (B, 1, T) or mask.device != x.device:
            raise ValueError(f"quantize_act: mask must be a [{B}, 1, {T}] tensor on {x.device}")
        mask = mask.to(torch.float32).contiguous()
    Cp = padded_channels(C)
    x_q = torch.empty(B, T, Cp, dtype=torch.int8, device=x.device)
    scale = torch.empty(SCALE_WORDS, dtype=torch.float32, device=x.device)
    lib = build.load_library()
    with torch.cuda.device(x.device):
        code = lib.tts_int8_quantize(
            x.data_ptr(), None if mask is None else mask.data_ptr(),
            _fp32_bits(1.0 if slope is None else slope), x_q.data_ptr(), scale.data_ptr(), B, C,
            Cp, T, torch.cuda.current_stream(x.device).cuda_stream)
    build.check_cuda_error(code, "quantize_act")
    build.count_launch(quantize_act)
    return x_q[..., :C], scale[0]


def _fp32_bits(v: float) -> int:
    """v rounded to fp32, as the int32 of its bits (the C entry points take
    pointers and ints only)."""
    return struct.unpack("<i", struct.pack("<f", v))[0]


def tile_columns(bn: int, phases: int) -> int:
    """The columns a tile of bn columns writes: whole phase groups (bn
    rounded down to a multiple of phases), or for phases > bn the largest
    divisor of phases up to bn (a run of one group's phases)."""
    if phases <= bn:
        return bn - bn % phases
    return max(d for d in range(1, bn + 1) if phases % d == 0)


def conv_tile(B: int, T_out: int, N: int, phases: int, sms: int) -> Tuple[int, int, int, int]:
    """The conv kernel's tile at this shape on a card of `sms` SMs -> (rows,
    columns, columns written, tiles): the first of CONV_TILES whose grid
    has at least `sms` tiles, else the smallest. Tiles never cross items:
    B * ceil(T_out / rows) * ceil(N / columns written)."""
    for bm, bn in CONV_TILES:
        bn_eff = tile_columns(bn, phases)
        tiles = B * -(-T_out // bm) * -(-N // bn_eff)
        if tiles >= sms:
            break
    return bm, bn, bn_eff, tiles


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _out_len(T: int, padding: Tuple[int, int], dilation: int, k: int) -> int:
    return T + padding[0] + padding[1] - dilation * (k - 1)


def int8_conv1d_plain(x_q: torch.Tensor, s_x: torch.Tensor, w_q: torch.Tensor,
                      s_w: torch.Tensor, bias: Optional[torch.Tensor],
                      padding: Tuple[int, int] = (0, 0), dilation: int = 1,
                      phases: int = 1, residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The conv (module docstring) in torch ops: the products summed in
    float64, exact (at most 127^2 each, far fewer than 2^53 / 127^2 of
    them), then rounded to fp32 as int32 -> fp32 rounds."""
    B, T, _ = x_q.shape
    N, k, _ = w_q.shape
    T_out = _out_len(T, padding, dilation, k)
    xp = F.pad(x_q.to(torch.float64), (0, 0, padding[0], padding[1]))
    w = w_q.to(torch.float64)
    acc = torch.zeros(B, T_out, N, dtype=torch.float64, device=x_q.device)
    for j in range(k):
        acc += torch.matmul(xp[:, j * dilation:j * dilation + T_out], w[:, j].T)
    y = (acc.to(torch.float32) * (s_x * s_w)).reshape(B, T_out, N // phases, phases)
    if bias is not None:
        y = y + bias[:, None]
    y = y.permute(0, 2, 1, 3).reshape(B, N // phases, T_out * phases)
    return y + residual if residual is not None else y


def _check_cuda_args(x_q, s_x, w_q, s_w, bias, phases, T_out, residual):
    dev = x_q.device
    if x_q.dtype != torch.int8 or x_q.dim() != 3:
        raise ValueError("int8_conv1d: x_q must be an int8 [B, T, C_in] tensor")
    if w_q.dtype != torch.int8 or w_q.dim() != 3:
        raise ValueError("int8_conv1d: w_q must be an int8 [N, k, C_in] tensor")
    N, k, C_in = w_q.shape
    if x_q.shape[2] != C_in:
        raise ValueError(f"int8_conv1d: x_q has {x_q.shape[2]} channels, w_q {C_in}")
    if phases < 1 or N % phases:
        raise ValueError(f"int8_conv1d: {N} columns are not a multiple of {phases} phases")
    if T_out < 1:
        raise ValueError("int8_conv1d: the padding leaves no output frame")
    out_shape = (x_q.shape[0], N // phases, T_out * phases)
    for name, t, shape in (("s_x", s_x, ()), ("s_w", s_w, (N,)),
                           ("bias", bias, (N // phases,)), ("residual", residual, out_shape)):
        if t is not None and (t.device != dev or t.dtype != torch.float32
                              or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"int8_conv1d: {name} must be a contiguous fp32 {shape} tensor "
                             f"on {dev}")


def int8_conv1d(x_q: torch.Tensor, s_x: torch.Tensor, w_q: torch.Tensor, s_w: torch.Tensor,
                bias: Optional[torch.Tensor], padding: Tuple[int, int] = (0, 0),
                dilation: int = 1, phases: int = 1, stride: int = 1,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The int8 conv (module docstring) -> [B, N / phases, T_out * phases]
    fp32, plus `residual` when given, through the operator
    `tts::int8_conv1d`."""
    if stride != 1:
        raise ValueError(f"int8_conv1d: stride {stride}; the int8 conv takes stride 1 only")
    build.check_device(x_q, "int8_conv1d")
    check_no_grad(s_x, s_w, bias, residual)
    return torch.ops.tts.int8_conv1d(x_q, s_x, w_q, s_w, bias,
                                     [int(padding[0]), int(padding[1])], dilation, phases,
                                     residual)


def _conv_cpu(x_q, s_x, w_q, s_w, bias, padding, dilation, phases, residual):
    return int8_conv1d_plain(x_q, s_x, w_q, s_w, bias, tuple(padding), dilation, phases,
                             residual).contiguous()


def _conv_fake(x_q, s_x, w_q, s_w, bias, padding, dilation, phases, residual):
    B, T, _ = x_q.shape
    N, k, _ = w_q.shape
    T_out = _out_len(T, padding, dilation, k)
    return x_q.new_empty((B, N // phases, T_out * phases), dtype=torch.float32)


def _conv_cuda(x_q, s_x, w_q, s_w, bias, padding, dilation, phases, residual):
    """`tts::int8_conv1d` on CUDA tensors: one launch of the conv."""
    B, T, _ = x_q.shape
    N, k, C_in = w_q.shape
    T_out = _out_len(T, padding, dilation, k)
    _check_cuda_args(x_q, s_x, w_q, s_w, bias, phases, T_out, residual)
    if not supports(C_in, N, k, dilation):
        raise ValueError(f"int8_conv1d: C_in={C_in}, C_out={N}, k={k}, dilation={dilation} is "
                         f"not taken by the kernel (k * C_in padded to a multiple of "
                         f"{K_MULTIPLE} <= {MAX_K})")
    x_q, w_q = padded_rows(x_q), padded_rows(w_q)
    out = torch.empty(B, N // phases, T_out * phases, dtype=torch.float32, device=x_q.device)
    bm, bn, bn_eff, _ = conv_tile(B, T_out, N, phases, _sm_count(x_q.device.index))
    lib = build.load_library()
    with torch.cuda.device(x_q.device):
        code = lib.tts_int8_conv1d(
            x_q.data_ptr(), s_x.data_ptr(), w_q.data_ptr(), s_w.data_ptr(),
            None if bias is None else bias.data_ptr(),
            None if residual is None else residual.data_ptr(), out.data_ptr(), B, T,
            padded_channels(C_in), N, k, dilation, padding[0], T_out, phases, bm, bn, bn_eff,
            torch.cuda.current_stream(x_q.device).cuda_stream)
    build.check_cuda_error(code, "int8_conv1d")
    build.count_launch(int8_conv1d)
    return out


quantize_act.launches = 0
int8_conv1d.launches = 0
build.define_op("quantize_act", quantize_act_plain, _quantize_cuda, _quantize_fake)
build.define_op("int8_conv1d", _conv_cpu, _conv_cuda, _conv_fake)
