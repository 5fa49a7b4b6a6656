"""W8A8 int8 convolution: the dynamic activation quantizer and the int8
conv1d of the int8 decoder (`quantize_decoder`).

Replaces no Pallas kernel: in the JAX package this is XLA work
(`torch_tts_tpu/ops/quant.py`: `quantize_act_dynamic`'s round and clip,
`int8_conv1d`'s `lax.conv_general_dilated` with int32 accumulation).
PyTorch has no int8 convolution on the card, so the CUDA kernels of
`torch_tts_tpu_torch/csrc/int8_conv.cu` compute both; the bound and the
design are in its header.

- `quantize_act(x)`: x [B, C, T] fp32 -> (x_q [B, T, C] int8, s_x a 0-d
  fp32 tensor on x's device). s_x = max(max |x| over the whole tensor,
  1e-12) * fp32(1 / 127) (`symmetric_scale`), x_q = clip(round(x / s_x),
  -127, 127) with IEEE division and round half to even (jnp.round and
  torch.round). x_q is channels-last, the conv's K axis contiguous.
- `int8_conv1d(x_q, s_x, w_q, s_w, bias, padding, dilation, phases)`: x_q
  [B, T, C_in] int8, w_q [N, k, C_in] int8, s_w [N] fp32, bias [N / phases]
  fp32 or None, padding (lo, hi) -> [B, N / phases, T_out * phases] fp32,
  T_out = T + lo + hi - dilation * (k - 1). With acc[b, t, n] = sum over
  taps j and channels c of x_q[b, t + j * dilation - lo, c] * w_q[n, j, c]
  (zero outside [0, T)), exact in int32, column n = o * phases + r gives
  out[b, o, t * phases + r] = float(acc) * (s_x * s_w[n]) (+ bias[o]).
  phases = 1 is a conv in the port's [B, C, T] layout; phases = u is the
  subpixel transposed conv's dense product with its depth-to-space.

Dispatch: a CPU tensor takes the plain version (`quantize_act_plain`,
`int8_conv1d_plain`); a CUDA tensor launches the kernel or raises. Both
wrappers raise when a gradient is needed (a rounded activation passes
none: the int8 decoder is for inference only) and `int8_conv1d` on a
stride other than 1. `supports` is the conv kernel's shape gate: on the
card `int8_conv1d` raises on a shape it does not take (a CUDA tensor never
takes the plain version). `quantize_act.launches` and
`int8_conv1d.launches` count kernel launches.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from torch_tts_tpu_torch.kernels import build

EPS = 1e-12
# fp32(1 / 127): under jit, XLA turns the JAX package's division by the
# constant 127 into a product with its fp32 reciprocal (eager JAX divides),
# and jit is how the JAX package runs its decoder
INV_127 = float(torch.tensor(1.0) / 127.0)
K_MULTIPLE = 32  # C_in must be a multiple of the kernel's 32-byte K steps
MAX_K = 131072  # k * C_in: int32 sums of up to this many 127^2 products


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


def supports(C_in: int, C_out: int, k: int, dilation: int) -> bool:
    """Whether the conv kernel takes C_in input channels, C_out product
    columns (the output channels times the phases), k taps and the
    dilation (on the card `int8_conv1d` raises on any other shape)."""
    return (C_in >= K_MULTIPLE and C_in % K_MULTIPLE == 0 and C_out >= 1 and k >= 1
            and dilation >= 1 and k * C_in <= MAX_K)


def quantize_act_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, C, T] -> (x_q [B, T, C] int8, s_x 0-d fp32)."""
    s_x = symmetric_scale(x.abs().amax()).to(torch.float32)
    return round_clip(x.transpose(1, 2) / s_x).contiguous(), s_x


def quantize_act(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The activation quantizer (module docstring): x [B, C, T] fp32 ->
    (x_q [B, T, C] int8, s_x 0-d fp32 on x's device)."""
    check_no_grad(x)
    if x.device.type == "cpu":
        return quantize_act_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_act: unsupported device {x.device}")
    if x.dtype != torch.float32 or x.dim() != 3 or not x.is_contiguous():
        raise ValueError("quantize_act: x must be a contiguous fp32 [B, C, T] tensor")
    B, C, T = x.shape
    x_q = torch.empty(B, T, C, dtype=torch.int8, device=x.device)
    scale = torch.empty(2, dtype=torch.float32, device=x.device)  # s_x, max |x| bits
    lib = build.load_library()
    with torch.cuda.device(x.device):
        code = lib.tts_int8_quantize(x.data_ptr(), x_q.data_ptr(), scale.data_ptr(), B, C, T,
                                     torch.cuda.current_stream(x.device).cuda_stream)
    build.check_cuda_error(code, "quantize_act")
    build.count_launch(quantize_act)
    return x_q, scale[0]


def _out_len(T: int, padding: Tuple[int, int], dilation: int, k: int) -> int:
    return T + padding[0] + padding[1] - dilation * (k - 1)


def int8_conv1d_plain(x_q: torch.Tensor, s_x: torch.Tensor, w_q: torch.Tensor,
                      s_w: torch.Tensor, bias: Optional[torch.Tensor],
                      padding: Tuple[int, int] = (0, 0), dilation: int = 1,
                      phases: int = 1) -> torch.Tensor:
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
    return y.permute(0, 2, 1, 3).reshape(B, N // phases, T_out * phases)


def _check_cuda_args(x_q, s_x, w_q, s_w, bias, phases, T_out):
    dev = x_q.device
    if x_q.dtype != torch.int8 or x_q.dim() != 3 or not x_q.is_contiguous():
        raise ValueError("int8_conv1d: x_q must be a contiguous int8 [B, T, C_in] tensor")
    if w_q.dtype != torch.int8 or w_q.dim() != 3 or not w_q.is_contiguous():
        raise ValueError("int8_conv1d: w_q must be a contiguous int8 [N, k, C_in] tensor")
    N, k, C_in = w_q.shape
    if x_q.shape[2] != C_in:
        raise ValueError(f"int8_conv1d: x_q has {x_q.shape[2]} channels, w_q {C_in}")
    if phases < 1 or N % phases:
        raise ValueError(f"int8_conv1d: {N} columns are not a multiple of {phases} phases")
    if T_out < 1:
        raise ValueError("int8_conv1d: the padding leaves no output frame")
    for name, t, shape in (("s_x", s_x, ()), ("s_w", s_w, (N,)),
                           ("bias", bias, (N // phases,))):
        if t is not None and (t.device != dev or t.dtype != torch.float32
                              or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"int8_conv1d: {name} must be a contiguous fp32 {shape} tensor "
                             f"on {dev}")


def int8_conv1d(x_q: torch.Tensor, s_x: torch.Tensor, w_q: torch.Tensor, s_w: torch.Tensor,
                bias: Optional[torch.Tensor], padding: Tuple[int, int] = (0, 0),
                dilation: int = 1, phases: int = 1, stride: int = 1) -> torch.Tensor:
    """The int8 conv (module docstring) -> [B, N / phases, T_out * phases]
    fp32."""
    if stride != 1:
        raise ValueError(f"int8_conv1d: stride {stride}; the int8 conv takes stride 1 only")
    check_no_grad(s_x, s_w, bias)
    padding = (int(padding[0]), int(padding[1]))
    if x_q.device.type == "cpu":
        return int8_conv1d_plain(x_q, s_x, w_q, s_w, bias, padding, dilation, phases)
    if x_q.device.type != "cuda":
        raise ValueError(f"int8_conv1d: unsupported device {x_q.device}")
    B, T, _ = x_q.shape
    N, k, C_in = w_q.shape
    T_out = _out_len(T, padding, dilation, k)
    _check_cuda_args(x_q, s_x, w_q, s_w, bias, phases, T_out)
    if not supports(C_in, N, k, dilation):
        raise ValueError(f"int8_conv1d: C_in={C_in}, C_out={N}, k={k}, dilation={dilation} is "
                         f"not taken by the kernel (C_in a multiple of {K_MULTIPLE}, "
                         f"k * C_in <= {MAX_K})")
    out = torch.empty(B, N // phases, T_out * phases, dtype=torch.float32, device=x_q.device)
    lib = build.load_library()
    with torch.cuda.device(x_q.device):
        code = lib.tts_int8_conv1d(
            x_q.data_ptr(), s_x.data_ptr(), w_q.data_ptr(), s_w.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(), B, T, C_in, N, k,
            dilation, padding[0], T_out, phases,
            torch.cuda.current_stream(x_q.device).cuda_stream)
    build.check_cuda_error(code, "int8_conv1d")
    build.count_launch(int8_conv1d)
    return out


quantize_act.launches = 0
int8_conv1d.launches = 0
