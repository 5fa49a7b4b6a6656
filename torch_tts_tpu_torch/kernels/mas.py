"""Monotonic alignment search (MAS): Viterbi DP and backtrack.

Replaces the TPU kernel `torch_tts_tpu/kernels/mas_pallas.py`
(`maximum_path_pallas` -> `_mas_kernel`) with the CUDA kernel
`torch_tts_tpu_torch/csrc/mas.cu`. `maximum_path(neg_cent, mask)` keeps the
contract of the JAX `kernels/mas.py:maximum_path`: neg_cent [B, T_y, T_x]
and a {0, 1} mask of the same shape (mask[b, y, x] = y < t_y and x < t_x);
the lengths come from the mask, cells outside it are set to MAX_NEG in
fp32, and the returned path is multiplied by the mask.

`maximum_path_plain` is the port of `maximum_path_scan`: the forward DP and
the backtrack as loops over rows, vectorised over the batch. The kernel
gives the same path bit for bit: the same fp32 operations in the same
order, and the same strict comparison at ties.

On the H100 the kernel is bound by its two chains of T_y dependent row
steps, not by bytes or operations (see the header of the .cu file).

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises. `maximum_path_via_plain` takes the plain version on any
device (the plain path that chip_smoke.py and scripts/profile_torch_train.py
compare against). `maximum_path.launches` counts kernel launches.
"""

from __future__ import annotations

import torch

from torch_tts_tpu_torch.kernels import build

MAX_NEG = -1e9
MAX_TEXT = 512  # columns the kernel takes (16 per lane)
SMEM_BYTES = 232448  # per-block dynamic shared memory limit on Hopper
_WORDS = (1, 2, 4, 6, 8, 12, 16)  # columns per lane the kernel is built for


def cols_per_lane(T_x: int) -> int:
    """Columns each of the 32 lanes owns for T_x text positions; also the
    32-bit words of move bits per row."""
    words = -(-T_x // 32)
    return next(w for w in _WORDS if w >= words)


def maximum_path_plain(neg_cent: torch.Tensor, t_ys: torch.Tensor,
                       t_xs: torch.Tensor) -> torch.Tensor:
    """Port of `maximum_path_scan`: neg_cent [B, T_y, T_x] fp32, lengths [B]
    -> {0, 1} path [B, T_y, T_x] (not multiplied by a mask)."""
    B, T_y, T_x = neg_cent.shape
    dev = neg_cent.device
    xs = torch.arange(T_x, device=dev)
    x_valid = xs[None, :] < t_xs[:, None]
    neg = torch.full((), MAX_NEG, dtype=neg_cent.dtype, device=dev)

    rows = [torch.where((xs[None, :] == 0) & x_valid, neg_cent[:, 0], neg)]
    for y in range(1, T_y):
        prev = rows[-1]
        v_stay = torch.where(xs[None, :] == y, neg, prev)
        v_adv = torch.cat([neg.expand(B, 1), prev[:, :-1]], dim=1)
        row = neg_cent[:, y] + torch.maximum(v_stay, v_adv)
        row = torch.where(x_valid, row, neg)
        rows.append(torch.maximum(row, neg))

    index = torch.clamp(t_xs.to(torch.int64) - 1, min=0)
    path = torch.zeros(B, T_y, T_x, dtype=torch.float32, device=dev)
    ar = torch.arange(B, device=dev)
    for y in range(T_y - 1, -1, -1):
        active = y < t_ys
        path[:, y] = ((xs[None, :] == index[:, None]) & active[:, None]).float()
        prev = rows[y - 1] if y > 0 else torch.zeros_like(rows[0])
        v_here = prev[ar, index]
        v_left = prev[ar, torch.clamp(index - 1, min=0)]
        move = (index == y) | (v_here < v_left)
        index = torch.where(active & (index > 0) & move, index - 1, index)
    return path


def _maximum_path_cuda(nc: torch.Tensor, t_ys: torch.Tensor, t_xs: torch.Tensor) -> torch.Tensor:
    B, T_y, T_x = nc.shape
    if T_x > MAX_TEXT:
        raise ValueError(f"maximum_path: T_x={T_x} above the kernel's {MAX_TEXT}")
    cpl = cols_per_lane(T_x)
    if T_y * 4 > SMEM_BYTES:
        raise ValueError(f"maximum_path: T_y={T_y} too long for the row index in shared memory")
    bits = None
    if T_y * 4 * (1 + cpl) > SMEM_BYTES:
        bits = torch.empty(B, T_y, cpl, dtype=torch.int32, device=nc.device)
    path = torch.empty_like(nc)
    t_ys = t_ys.to(torch.int32).contiguous()
    t_xs = t_xs.to(torch.int32).contiguous()
    lib = build.load_library()
    with torch.cuda.device(nc.device):
        code = lib.tts_mas_forward(
            nc.data_ptr(), t_ys.data_ptr(), t_xs.data_ptr(), path.data_ptr(),
            None if bits is None else bits.data_ptr(), B, T_y, T_x,
            torch.cuda.current_stream(nc.device).cuda_stream)
    build.check_cuda_error(code, "maximum_path")
    maximum_path.launches += 1
    return path


def _masked_inputs(neg_cent: torch.Tensor, mask: torch.Tensor):
    """The JAX wrapper's preparation -> (neg_cent set to MAX_NEG outside the
    mask, fp32, contiguous; t_ys; t_xs)."""
    t_ys = mask[:, :, 0].to(torch.int32).sum(dim=1)
    t_xs = mask[:, 0, :].to(torch.int32).sum(dim=1)
    nc = torch.where(mask > 0, neg_cent.float(), torch.full((), MAX_NEG, device=neg_cent.device))
    return nc.contiguous(), t_ys, t_xs


def maximum_path_via_plain(neg_cent: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """`maximum_path`'s contract through the plain version, on any device."""
    path = maximum_path_plain(*_masked_inputs(neg_cent, mask))
    return path * mask.to(path.dtype)


def maximum_path(neg_cent: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """neg_cent [B, T_y, T_x], mask [B, T_y, T_x] -> path * mask (fp32)."""
    if neg_cent.device.type == "cpu":
        return maximum_path_via_plain(neg_cent, mask)
    if neg_cent.device.type != "cuda":
        raise ValueError(f"maximum_path: unsupported device {neg_cent.device}")
    path = _maximum_path_cuda(*_masked_inputs(neg_cent, mask))
    return path * mask.to(path.dtype)


maximum_path.launches = 0
