"""Recurrent cells for the Tacotron stack (port of `torch_tts_tpu/ops/rnn.py`).

- `LSTMCell`: torch.nn.LSTMCell's names and gate order (i, f, g, o), with
  the JAX cell's order of sums: x @ w_ih + h @ w_hh + b_ih + b_hh.
- `LSTMZoneoutCell`: the same cell with zoneout: at eval the deterministic
  blend p * prev + (1 - p) * new on h and c; in training, given keep masks
  (the JAX module's `uniform((H,)) < p`, one for h and one for c, each
  shared over the batch), the previous h or c where the mask is set.
- `UnidirLSTM`: an `LSTMCell` run over [B, T, C] from a given (h0, c0);
  returns (ys, (h_n, c_n)), as the JAX module's scan.
- `GRUCell`: torch.nn.GRUCell's names and gate order (r, z, n), with
  optional zoneout: given a training mask [H] (the JAX module's
  `uniform((H,)) < p`, shared over the batch) the previous h where it is
  set; at eval the deterministic blend p * h + (1 - p) * h_new.
  `ResGRUCell`: the same cell whose output is x + h_new.
- `reverse_padded`: reverse each sequence within its length.
- `BiLSTM`: torch.nn.LSTM, bidirectional, over a packed sequence, so the
  backward direction starts at each item's last valid step as the JAX
  version's `reverse_padded` scan does; output zero past each length;
  differentiable (no in-place writes).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from torch_tts_tpu_torch.ops.layers import _uniform_


class LSTMCell(nn.Module):
    def __init__(self, input_size: int, hidden_size: int, bias: bool = True):
        super().__init__()
        self.hidden_size = hidden_size
        self.weight_ih = nn.Parameter(torch.zeros(4 * hidden_size, input_size))
        self.weight_hh = nn.Parameter(torch.zeros(4 * hidden_size, hidden_size))
        if bias:
            self.bias_ih = nn.Parameter(torch.zeros(4 * hidden_size))
            self.bias_hh = nn.Parameter(torch.zeros(4 * hidden_size))
        else:
            self.bias_ih = self.bias_hh = None

    def reset_parameters_(self, generator: torch.Generator):
        bound = 1.0 / math.sqrt(self.hidden_size)
        for p in (self.weight_ih, self.weight_hh, self.bias_ih, self.bias_hh):
            if p is not None:
                _uniform_(p, bound, generator)

    def forward(self, carry: Tuple[torch.Tensor, torch.Tensor], x: torch.Tensor):
        """(h, c) [B, H], x [B, in] -> (h_new, c_new)."""
        h, c = carry
        gates = F.linear(x, self.weight_ih) + F.linear(h, self.weight_hh)
        if self.bias_ih is not None:
            gates = gates + self.bias_ih + self.bias_hh
        i, f, g, o = gates.chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c_new), c_new


class LSTMZoneoutCell(LSTMCell):
    def __init__(self, input_size: int, hidden_size: int, p_zoneout: float = 0.1, bias: bool = True):
        super().__init__(input_size, hidden_size, bias)
        self.p_zoneout = p_zoneout

    def forward(self, carry, x, keep_prev: Optional[torch.Tensor] = None):
        """keep_prev: None (the eval blend) or the training masks [2, H]
        (h's, c's): True keeps the previous value."""
        h_new, c_new = super().forward(carry, x)
        p = self.p_zoneout
        if p:
            h_prev, c_prev = carry
            if keep_prev is not None:
                h_new = torch.where(keep_prev[0], h_prev, h_new)
                c_new = torch.where(keep_prev[1], c_prev, c_new)
            else:
                h_new = p * h_prev + (1.0 - p) * h_new
                c_new = p * c_prev + (1.0 - p) * c_new
        return h_new, c_new


class UnidirLSTM(nn.Module):
    """An LSTM over a whole sequence: `cell` stepped over the time axis."""

    def __init__(self, input_size: int, hidden_size: int, bias: bool = True):
        super().__init__()
        self.cell = LSTMCell(input_size, hidden_size, bias)

    def forward(self, x: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor):
        """x [B, T, in], h0/c0 [B, H] -> (ys [B, T, H], (h_n, c_n))."""
        carry, ys = (h0, c0), []
        for t in range(x.shape[1]):
            carry = self.cell(carry, x[:, t])
            ys.append(carry[0])
        return torch.stack(ys, 1), carry


class GRUCell(nn.Module):
    def __init__(self, input_size: int, hidden_size: int, p_zoneout: Optional[float] = None,
                 bias: bool = True):
        super().__init__()
        self.hidden_size, self.p_zoneout = hidden_size, p_zoneout
        self.weight_ih = nn.Parameter(torch.zeros(3 * hidden_size, input_size))
        self.weight_hh = nn.Parameter(torch.zeros(3 * hidden_size, hidden_size))
        if bias:
            self.bias_ih = nn.Parameter(torch.zeros(3 * hidden_size))
            self.bias_hh = nn.Parameter(torch.zeros(3 * hidden_size))
        else:
            self.bias_ih = self.bias_hh = None

    reset_parameters_ = LSTMCell.reset_parameters_

    def forward(self, h: torch.Tensor, x: torch.Tensor, keep_prev: Optional[torch.Tensor] = None):
        """h [B, H], x [B, in] -> h_new; keep_prev: None (the eval blend) or
        the training mask [H], True keeping the previous value."""
        i_r, i_z, i_n = F.linear(x, self.weight_ih, self.bias_ih).chunk(3, dim=-1)
        h_r, h_z, h_n = F.linear(h, self.weight_hh, self.bias_hh).chunk(3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        h_new = (1.0 - z) * torch.tanh(i_n + r * h_n) + z * h
        p = self.p_zoneout
        if p:
            if keep_prev is not None:
                h_new = torch.where(keep_prev, h, h_new)
            else:
                h_new = p * h + (1.0 - p) * h_new
        return h_new


class ResGRUCell(GRUCell):
    def forward(self, h, x, keep_prev=None):
        """-> (h_new, x + h_new)."""
        h_new = super().forward(h, x, keep_prev)
        return h_new, x + h_new


def reverse_padded(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """[B, T, ...] -> each item reversed within its length; padding stays."""
    T = x.shape[1]
    pos = torch.arange(T, device=x.device)
    idx = lengths.to(x.device)[:, None] - 1 - pos[None, :]
    idx = torch.where(idx >= 0, idx, pos[None, :].expand_as(idx))
    return torch.gather(x, 1, idx.view(*idx.shape, *([1] * (x.dim() - 2))).expand_as(x))


class BiLSTM(nn.Module):
    """Bidirectional LSTM with a given initial state; `rnn` is the
    torch.nn.LSTM whose names (`weight_ih_l0`, `weight_ih_l0_reverse`, ...)
    the reference's state dict uses."""

    def __init__(self, input_size: int, hidden_size: int, bias: bool = True):
        super().__init__()
        self.hidden_size = hidden_size
        self.rnn = nn.LSTM(input_size, hidden_size, batch_first=True, bidirectional=True, bias=bias)

    def reset_parameters_(self, generator: torch.Generator):
        for p in self.rnn.parameters():
            _uniform_(p, 1.0 / math.sqrt(self.hidden_size), generator)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor):
        """x [B, T, in], lengths [B], h0/c0 [B, 2H] (forward ++ backward)
        -> (ys [B, T, 2H], zero past each length; h_n [B, 2H])."""
        H, T = self.hidden_size, x.shape[1]
        state = tuple(s.view(s.shape[0], 2, H).transpose(0, 1).contiguous() for s in (h0, c0))
        packed = nn.utils.rnn.pack_padded_sequence(x, lengths.cpu().to(torch.int64), batch_first=True,
                                                   enforce_sorted=False)
        out, (h_n, _) = self.rnn(packed, state)
        ys, _ = nn.utils.rnn.pad_packed_sequence(out, batch_first=True, total_length=T)
        return ys, h_n.transpose(0, 1).reshape(x.shape[0], 2 * H)
