"""Mask, segment-slicing and alignment-path helpers (port of
`torch_tts_tpu/core/masks.py`)."""

from __future__ import annotations

from typing import Optional

import torch


def sequence_mask(lengths: torch.Tensor, max_length: int) -> torch.Tensor:
    """[B] lengths -> [B, T] bool mask, True inside each sequence."""
    pos = torch.arange(max_length, dtype=lengths.dtype, device=lengths.device)
    return pos[None, :] < lengths[:, None]


def generate_path(duration: torch.Tensor, t_y: int) -> torch.Tensor:
    """[B, T_x] integer-valued durations -> hard monotonic path [B, T_y, T_x]
    with path[b, y, x] = 1 iff frame y belongs to token x. The caller
    multiplies the result by its attention mask."""
    cum = torch.cumsum(duration, dim=-1)
    pos = torch.arange(t_y, dtype=cum.dtype, device=cum.device)
    before = (pos[None, :, None] < cum[:, None, :]).to(duration.dtype)
    prev = torch.nn.functional.pad(before, (1, 0))[:, :, :-1]
    return before - prev


def slice_segments(x: torch.Tensor, ids_str: torch.Tensor, segment_size: int,
                   dim: int = 1) -> torch.Tensor:
    """Per-item windows of `segment_size` steps along `dim` starting at
    ids_str [B]; indices are clamped to [0, T - 1] as the JAX version
    clamps them. dim=1 is the JAX [B, T, C] layout, dim=2 the port's
    [B, C, T]."""
    T = x.shape[dim]
    idx = ids_str.to(torch.int64)[:, None] + torch.arange(segment_size, device=x.device)[None, :]
    idx = torch.clamp(idx, 0, T - 1)
    shape = [1] * x.dim()
    shape[0], shape[dim] = x.shape[0], segment_size
    idx = idx.reshape(shape).expand(*[segment_size if d == dim else s
                                      for d, s in enumerate(x.shape)])
    return torch.gather(x, dim, idx)


def rand_slice_segments(x: torch.Tensor, x_lengths: torch.Tensor, segment_size: int,
                        generator: Optional[torch.Generator] = None,
                        ids: Optional[torch.Tensor] = None, dim: int = 1):
    """Random per-item segment starts in [0, max(len - segment + 1, 1)):
    ids = int(u * max(len - segment + 1, 1)) with u uniform from
    `generator`, unless `ids` is given -> (segments, ids [B] int32)."""
    if ids is None:
        if generator is None:
            raise ValueError("rand_slice_segments: a torch.Generator (or ids) is required")
        ids_str_max = torch.clamp(x_lengths - segment_size + 1, min=1)
        u = torch.rand(x.shape[0], generator=generator, device=x.device)
        ids = (u * ids_str_max.to(u.dtype)).to(torch.int32)
    return slice_segments(x, ids, segment_size, dim), ids
