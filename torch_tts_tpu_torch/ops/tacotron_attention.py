"""Tacotron attention (port of `torch_tts_tpu/ops/tacotron_attention.py`):
`initial_att_weights` and `StepwiseMonotonicAttention` in deterministic
mode. The training sigmoid noise and the other attention types are not
ported yet.

The JAX module takes a `cmask` and ignores it: its only sink is
e[:, -1] = 1e4 at the last (possibly padded) position, so in a ragged batch
attention weight can move into the padding. This port does the same, so
that it gives the JAX model's numbers.
"""

from __future__ import annotations

import torch
from torch import nn

from torch_tts_tpu_torch.ops.tacotron_blocks import Linear, isru_sigmoid


def initial_att_weights(batch_size: int, memory_size: int, device=None,
                        dtype=torch.float32) -> torch.Tensor:
    """One-hot at position 0: [B, L]."""
    w = torch.zeros(batch_size, memory_size, device=device, dtype=dtype)
    w[:, 0] = 1.0
    return w


def shift_monotonic(w: torch.Tensor, p_stay: torch.Tensor) -> torch.Tensor:
    """w' = w * p + shift_right(w * (1 - p)): stay or move one step."""
    w1 = w * (1.0 - p_stay)
    return w * p_stay + torch.nn.functional.pad(w1, (1, 0))[:, :-1]


class StepwiseMonotonicAttention(nn.Module):
    """Stay/advance monotonic attention. `bias` is the reference's constant
    one-element parameter, kept as a buffer so its state dict loads; the
    JAX module has no use for it either."""

    def __init__(self, dim_input: int, dim_context: int):
        super().__init__()
        self.query_layer = Linear(dim_input, dim_context, bias=False)
        self.register_buffer("bias", torch.ones(1))

    def forward(self, x: torch.Tensor, w: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
        """x [B, D_in], w [B, L], memory [B, L, D_ctx] -> new w [B, L]."""
        q = self.query_layer(x)
        e = torch.einsum("bld,bd->bl", memory, q).clone()
        e[:, -1] = 1e4  # sink: always stay at the last position
        return shift_monotonic(w, isru_sigmoid(e))
