"""Fused MRF (multi-receptive-field) resblock bank of one HiFi-GAN stage.

Replaces the TPU kernel `torch_tts_tpu/kernels/mrf_fused.py`
(`mrf_fused` -> `_mrf_kernel`) with the CUDA kernel
`torch_tts_tpu_torch/csrc/mrf_fused.cu`, keeping its contract: x [B, T, C]
fp32 and `blocks`, a tuple over ResBlock1 blocks of tuples over iterations
of ((offsets1, w1 [k*C, C], b1 [C]), (offsets2, w2, b2)), where offsets are
the static output-relative tap positions and w[j*C:(j+1)*C] is tap j. The
result is the mean over blocks of x run through each block's
lrelu -> conv -> lrelu -> conv -> residual iterations, with zero padding
at both sequence ends.

On the H100 the bank is bound by operations: about 473.5 GFLOP per B=1,
1024-frame decode over the C=128/64/32 stages, 2.87 ms at the 165 TFLOP/s
that 3xTF32 tensor-core products (fp32-level error) reach, 7.07 ms at the
67 TFLOP/s of fp32 outside the tensor cores. Each launch of the kernel runs
one ResBlock1 iteration (two convs) on windows held in shared memory, each
conv an implicit GEMM (rows x C_out x taps * C_in) on Hopper's warpgroup
tensor-core products (wgmma) in 3xTF32 (`split_tf32` is its split), with
the weights streamed from L2 and split into a ring in shared memory.
`plan_mrf` below orders the launches over two scratch buffers, picks each
launch's tile to fit the 227 KB of shared memory beside the ring with the
least recompute, and plans which window rows each conv computes (see the
header of the .cu file).

Dispatch: a CPU tensor takes `mrf_plain`; a CUDA tensor launches the kernel
or raises. `mrf_fused.launches` counts kernel launches. The kernel has no
backward, as the TPU kernel has no VJP: under autograd, with any input that
requires a gradient, a CUDA tensor raises instead of dropping it (the
training decoder runs its plain convolutions, `fuse_mrf=False`).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from torch_tts_tpu_torch.kernels import build

_SLOPE = 0.1
SMEM_BYTES = 232448  # per-block dynamic shared memory limit on Hopper
SMEM_ROW_PAD = 4  # floats of padding per window row (mrf_fused.cu kPad)
K_CHUNK = 32  # input channels per staged weight chunk (mrf_fused.cu kKChunk)
SUPPORTED_CHANNELS = (32, 64, 128)
_MAX_TAPS = 16
_META_PER_CONV = 3 + _MAX_TAPS
_META_HEAD = 6
_META_PER_LAUNCH = _META_HEAD + 2 * _META_PER_CONV


def dilated_offsets(k: int, d: int) -> Tuple[int, ...]:
    """Output-relative tap offsets of a 'same'-padded dilated conv."""
    p = (k - 1) // 2
    return tuple((t - p) * d for t in range(k))


def block_halo(offs_per_iter: Sequence[Tuple[Tuple[int, ...], Tuple[int, ...]]]) -> int:
    """One-side receptive-field reach of a resblock: the two convs of each
    iteration compose, so their largest |offset|s add."""
    return sum(max(abs(o) for o in off1) + max(abs(o) for o in off2)
               for off1, off2 in offs_per_iter)


def _conv_offsets(x: torch.Tensor, offsets: Sequence[int], w: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """out[:, :, r] = sum_j x[:, :, r + offsets[j]] @ w[j*C:(j+1)*C] + b on
    [B, C, T] with zeros outside [0, T); offsets must be evenly spaced."""
    k, C = len(offsets), x.shape[1]
    d = offsets[1] - offsets[0] if k > 1 else 1
    if any(o != offsets[0] + j * d for j, o in enumerate(offsets)):
        raise ValueError(f"offsets {offsets} are not evenly spaced")
    weight = w.reshape(k, C, -1).permute(2, 1, 0)  # [out, in, k]
    if -offsets[0] == offsets[-1]:  # 'same' padding: let the conv pad
        return F.conv1d(x, weight, b, padding=offsets[-1], dilation=d)
    return F.conv1d(F.pad(x, (-offsets[0], offsets[-1])), weight, b, dilation=d)


def split_tf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's 3xTF32 split of a finite fp32 tensor: hi = cvt.rna.tf32(x),
    x rounded half away from zero to a 10-bit mantissa (the low 13 bits of
    the encoding cleared), and lo = cvt.rna.tf32(x - hi); a product a b is
    then a_lo b_hi + a_hi b_lo + a_hi b_hi to about 2^-22 of |a b|."""
    def rna(v):
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)

    hi = rna(x.float())
    return hi, rna(x.float() - hi)


def mrf_plain(x: torch.Tensor, blocks) -> torch.Tensor:
    """Plain PyTorch version of the bank, same contract as `mrf_fused`,
    computed in contiguous [B, C, T] as the unfused decoder does."""
    xc = x.transpose(1, 2).contiguous()
    acc = None
    for block in blocks:
        xb = xc
        for (off1, w1, b1), (off2, w2, b2) in block:
            xt = _conv_offsets(F.leaky_relu(xb, _SLOPE), off1, w1, b1)
            xt = _conv_offsets(F.leaky_relu(xt, _SLOPE), off2, w2, b2)
            xb = xb + xt
        acc = xb if acc is None else acc + xb
    return (acc / len(blocks)).transpose(1, 2)


@dataclass(frozen=True)
class Launch:
    """One kernel launch: two convs (one ResBlock1 iteration) on tiles of T0
    frames with `halo` frames each side; per conv the window rows [lo, hi)
    it computes (window = T0 + 2*halo rows). src/dst index the buffers
    (0 x, 1 out, 2 scratch0, 3 scratch1); the epilogue writes
    dst = xb (STORE), dst += xb (ADD), dst = (dst + xb) / div (ADD_DIV) or
    dst = xb / div (DIV). `convs` names the (block, iteration) it runs."""

    T0: int
    halo: int
    ranges: Tuple[Tuple[int, int], ...]
    src: int
    dst: int
    mode: int
    div: int
    convs: Tuple[int, int]


STORE, ADD, ADD_DIV, DIV = 0, 1, 2, 3


def rows_per_pass(C: int) -> int:
    """Window rows one pass of a conv computes: two warpgroups of one m64
    tile at C=128, two at C<=64 (mrf_fused.cu ROWS)."""
    return 128 if C == 128 else 256


def ring_bytes(C: int) -> int:
    """Shared memory of the weight ring at C channels: one chunk of K_CHUNK
    input channels as two TF32 tiles (hi and lo), and 128 bytes to align it."""
    return 2 * K_CHUNK * C * 4 + 128


def window_bytes(W: int, C: int) -> int:
    """Shared memory of the two [W, C] window buffers."""
    return 2 * W * (C + SMEM_ROW_PAD) * 4


@functools.lru_cache(maxsize=256)
def _tile(reaches: Tuple[int, ...], C: int, T: int, B: int, n_sm: int, smem_bytes: int) -> int:
    """The tile that minimises the launch's time, modelled as waves of CTAs
    (one CTA per SM: the window fills shared memory) times the rows each
    CTA executes: each conv computes the tile plus twice the reach of the
    convs after it, in passes of `rows_per_pass(C)` rows. The two window
    buffers share `smem_bytes` with the weight ring. n_sm=0 drops the wave
    term (rows per output row only)."""
    halo = sum(reaches)
    cap = (smem_bytes - ring_bytes(C)) // window_bytes(1, C) - 2 * halo
    if cap < 8:
        raise ValueError(f"halo {halo} at C={C} does not fit in shared memory")
    rows = rows_per_pass(C)
    best, best_cost = None, None
    for t0 in range(8, min(cap, max(T, 8)) + 1):
        rem, executed = halo, 0
        for r in reaches:
            rem -= r
            executed += -(-(t0 + 2 * rem) // rows) * rows
        n_cta = B * -(-T // t0)
        cost = executed * (-(-n_cta // n_sm) if n_sm else n_cta)
        if best_cost is None or cost <= best_cost:
            best, best_cost = t0, cost
    return min(best, T)


def plan_mrf(offsets: Sequence[Sequence[Tuple[Tuple[int, ...], Tuple[int, ...]]]], C: int,
             T: int, B: int = 1, n_sm: int = 0,
             smem_bytes: int = SMEM_BYTES) -> Tuple[Launch, ...]:
    """offsets: per block, per iteration, the (conv1, conv2) tap offsets.
    One launch per iteration: the first reads x, later ones the scratch
    buffer the previous wrote, and the block's last iteration accumulates
    the mean over blocks into `out`. Tiles as `_tile` picks them for B
    items on a card with n_sm SMs."""
    nb = len(offsets)
    launches = []
    for bi, block in enumerate(offsets):
        n_it = len(block)
        for it, convs in enumerate(block):
            reaches = tuple(max(abs(o) for o in offs) for offs in convs)
            halo = block_halo((convs,))
            T0 = _tile(reaches, C, T, B, n_sm, smem_bytes)
            ranges, rem = [], halo
            for r in reaches:
                rem -= r
                ranges.append((halo - rem, halo + T0 + rem))
            src = 0 if it == 0 else 2 + (it - 1) % 2
            if it < n_it - 1:
                dst, mode = 2 + it % 2, STORE
            else:
                dst = 1
                mode = DIV if nb == 1 else STORE if bi == 0 else ADD_DIV if bi == nb - 1 else ADD
            launches.append(Launch(T0, halo, tuple(ranges), src, dst, mode, nb, (bi, it)))
    return tuple(launches)


def _check_cuda_args(x: torch.Tensor, blocks):
    if (x.dtype != torch.float32 or x.dim() != 3 or not x.is_contiguous()
            or x.data_ptr() % 16):
        raise ValueError("mrf_fused: x must be a contiguous, 16-byte aligned fp32 "
                         "[B, T, C] tensor")
    C = x.shape[2]
    if C not in SUPPORTED_CHANNELS:
        raise ValueError(f"mrf_fused: C={C} not in {SUPPORTED_CHANNELS}")
    for block in blocks:
        for it in block:
            for offs, w, b in it:
                if not 1 <= len(offs) <= _MAX_TAPS:
                    raise ValueError(f"mrf_fused: 1 to {_MAX_TAPS} taps per conv")
                for t, shape in ((w, (len(offs) * C, C)), (b, (C,))):
                    if (t.device != x.device or t.dtype != torch.float32
                            or tuple(t.shape) != shape or not t.is_contiguous()
                            or t.data_ptr() % 16):
                        raise ValueError(f"mrf_fused: weights must be contiguous fp32 "
                                         f"{shape} on {x.device}")


def check_no_grad(x: torch.Tensor, blocks):
    """Raise when autograd would need the kernel's missing backward."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, *(t for block in blocks for it in block
                                           for _, w, b in it for t in (w, b)))):
        raise RuntimeError("mrf_fused: the CUDA kernel has no backward; run the decoder's "
                           "plain convolutions (fuse_mrf=False) when training")


@functools.lru_cache(maxsize=64)
def _planned(offsets: Tuple[Tuple[Tuple[Tuple[int, ...], Tuple[int, ...]], ...], ...], C: int,
             T: int, B: int, n_sm: int):
    """(launches, the C entry's meta array, whether scratch 0 and 1 are
    written) of one plan, built once per plan."""
    launches = plan_mrf(offsets, C, T, B, n_sm)
    meta = (ctypes.c_int * (_META_PER_LAUNCH * len(launches)))()
    for li, ln in enumerate(launches):
        m0 = li * _META_PER_LAUNCH
        bi, it = ln.convs
        meta[m0:m0 + _META_HEAD] = [ln.T0, ln.halo, ln.src, ln.dst, ln.mode, ln.div]
        for j, (offs, (lo, hi)) in enumerate(zip(offsets[bi][it], ln.ranges)):
            c0 = m0 + _META_HEAD + j * _META_PER_CONV
            meta[c0:c0 + 3 + len(offs)] = [len(offs), lo, hi, *offs]
    return launches, meta, tuple(any(ln.dst == i for ln in launches) for i in (2, 3))


def mrf_fused(x: torch.Tensor, blocks) -> torch.Tensor:
    """Fused resblock bank: x [B, T, C] -> [B, T, C]."""
    if x.device.type == "cpu":
        return mrf_plain(x, blocks)
    if x.device.type != "cuda":
        raise ValueError(f"mrf_fused: unsupported device {x.device}")
    check_no_grad(x, blocks)
    _check_cuda_args(x, blocks)
    B, T, C = x.shape
    n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    offsets = tuple(tuple((it[0][0], it[1][0]) for it in block) for block in blocks)
    launches, meta, scratch_used = _planned(offsets, C, T, B, n_sm)
    convs = [blocks[bi][it][j] for bi, it in (ln.convs for ln in launches) for j in (0, 1)]
    w_ptrs = (ctypes.c_longlong * len(convs))(*(w.data_ptr() for _, w, _ in convs))
    b_ptrs = (ctypes.c_longlong * len(convs))(*(b.data_ptr() for _, _, b in convs))
    out = torch.empty_like(x)
    scratch = [torch.empty_like(x) if used else out for used in scratch_used]
    lib = build.load_library()
    with torch.cuda.device(x.device):
        code = lib.tts_mrf_fused_forward(
            x.data_ptr(), out.data_ptr(), scratch[0].data_ptr(), scratch[1].data_ptr(),
            B, T, C, len(launches), ctypes.cast(meta, ctypes.c_void_p),
            ctypes.cast(w_ptrs, ctypes.c_void_p), ctypes.cast(b_ptrs, ctypes.c_void_p),
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check_cuda_error(code, "mrf_fused")
    mrf_fused.launches += 1
    return out


mrf_fused.launches = 0
