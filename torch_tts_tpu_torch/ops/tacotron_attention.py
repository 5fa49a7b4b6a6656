"""Tacotron attention (port of `torch_tts_tpu/ops/tacotron_attention.py`):
`initial_att_weights`, `StepwiseMonotonicAttention`, with the training
sigmoid noise (the caller's standard normal draws, times 1.0, added to the
energies), and `ContentMarkovAttention` (the Tacotron-1 cell's). The
content attentions and `GSTMultiHeadAttention`, which no model of the JAX
package builds, are not ported yet.

`StepwiseMonotonicAttention` takes no memory mask; the JAX module takes a
`cmask` and ignores it: its only sink is
e[:, -1] = 1e4 at the last (possibly padded) position, so in a ragged batch
attention weight can move into the padding. This port does the same, so
that it gives the JAX model's numbers.
"""

from __future__ import annotations

from typing import Optional

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


class ContentMarkovAttention(nn.Module):
    """Tri-diagonal Markov transition attention: each memory position emits
    a softmax over {stay, advance 1, ..., advance P-1}, and the previous
    weights move through those transitions. The mask test is the JAX
    module's: transition n at position l is forbidden where position
    (l + n) mod L is masked (a roll, which wraps around), and wherever
    l >= L - n."""

    NUM_PROBS = 3

    def __init__(self, dim_input: int, dim_context: int):
        super().__init__()
        self.dim_context = dim_context
        self.fc_query = Linear(dim_input, self.NUM_PROBS * dim_context, bias=False)

    def forward(self, x: torch.Tensor, w: torch.Tensor, memory: torch.Tensor,
                cmask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, D_in], w [B, L], memory [B, L, D_ctx], cmask [B, L] (True
        inside each text) or None -> new w [B, L]."""
        B, L, _ = memory.shape
        P = self.NUM_PROBS
        q = self.fc_query(x).reshape(B, self.dim_context, P)
        e = torch.einsum("bld,bdp->blp", memory, q)
        n = torch.arange(P, device=e.device)
        pos = torch.arange(L, device=e.device)
        forbid = ((n >= 1)[None, :] & (pos[:, None] >= L - n[None, :]))[None]  # [1, L, P]
        if cmask is not None:
            inv = ~cmask.bool()
            forbid = forbid | torch.stack([torch.roll(inv, -k, 1) for k in range(P)], 2)
        p = torch.softmax(torch.where(forbid, torch.full_like(e, -1e12), e), dim=2)
        wp = w[..., None] * p
        out = wp[:, :, 0]
        for k in range(1, P):
            out = out + torch.nn.functional.pad(wp[:, : L - k, k], (min(k, L), 0))
        return out


class StepwiseMonotonicAttention(nn.Module):
    """Stay/advance monotonic attention. `bias` is the reference's constant
    one-element parameter, kept as a buffer so its state dict loads; the
    JAX module has no use for it either."""

    SIGMOID_NOISE = 1.0  # the training noise's scale

    def __init__(self, dim_input: int, dim_context: int):
        super().__init__()
        self.query_layer = Linear(dim_input, dim_context, bias=False)
        self.register_buffer("bias", torch.ones(1))

    def forward(self, x: torch.Tensor, w: torch.Tensor, memory: torch.Tensor,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, D_in], w [B, L], memory [B, L, D_ctx] -> new w [B, L];
        noise [B, L]: the training draws (standard normal), else None."""
        q = self.query_layer(x)
        e = torch.einsum("bld,bd->bl", memory, q)
        if noise is not None:
            e = e + self.SIGMOID_NOISE * noise
        # sink: always stay at the last position (no in-place write, so
        # autograd keeps the energies it saved)
        e = torch.cat([e[:, :-1], torch.full_like(e[:, -1:], 1e4)], 1)
        return shift_monotonic(w, isru_sigmoid(e))
