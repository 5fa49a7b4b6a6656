"""Tacotron (port of `torch_tts_tpu/models/tacotron/model.py`): the encoders
(`Encoder2`; `Encoder`, the Tacotron-1 CBHG encoder), the three decoder
cells (Taco2Prod, Tacotron-2, Tacotron-1) and their autoregressive
`Decoder`, `Tacotron` (encoder + optional VAE style encoder + decoder +
`MelPostnet` or `MelPostnet2`) and `build_tacotron`. Every variant the JAX
`Tacotron` builds is built here: `encoder_type` tacotron1 or any other
(Encoder2), `decoder_type` tacotron1, tacotron2 or any other
(tacotron2prod), `postnet_type` tacotron2 (MelPostnet), None (no postnet)
or any other (MelPostnet2), and `style_dim_vae` (the VAE).

Module and parameter names are the reference's torch names where the JAX
package's `export_torch_state_dict` emits them, and otherwise the JAX
param paths (see convert.py), so a converted state dict loads with
strict=True.

`Tacotron.forward` is the JAX `Tacotron.__call__`: with teacher mels x it
runs S = T // r steps, step t taking zeros at t = 0, else the teacher's
last frame of group t-1 where the step's coin says so and the model's own
previous frame (with its gradient) otherwise; `train` puts the BatchNorms
on batch statistics (updating their running ones) and `deterministic=False`
turns on the training draws. Every draw comes in one `TacotronDraws`, or
from an explicit `torch.Generator` (`Tacotron.draw`). At eval every step
is teacher-forced. Without x it decodes `max_steps` free-running, as
`Tacotron.infer` does. With a reference mel `xref` and a VAE, the style
[B, 1, dim_out] is added to the memory at every position (past each
text's length too) and `kl_loss` is the mean KL term.

The decoder returns per-item `stop_lengths` (the first step whose smallest
stop logit is below -2, else S); callers trim. The PreNet's dropout stays
on at inference (the original recipe). The memory mask is read by the
Tacotron-1 cell's Markov attention only; the stepwise monotonic attention
ignores it, as the JAX model's does (see ops/tacotron_attention.py).

The streaming surface of the JAX model: `encode`, `decode_init`,
`decode_chunk` and `apply_postnet`. The whole decode and a chunk share one
step loop, so a chunked decode equals the whole one exactly when each
step gets the same masks.

On a CUDA device each deterministic Taco2Prod step with no gradient
(inference, a chunk, the trainer's eval step) is one `kernels/taco_step.py:
taco_step_streamed` launch per row group of at most 8, with the big LSTM
matrices packed once per model (`Decoder.packed_weights`); on the CPU,
with `Decoder.use_kernel = False`, or with the training draws (which the
kernel does not draw, and which need the gradient it has no backward for),
each step runs the cell modules (`step_route`). The Tacotron-2 and
Tacotron-1 cells have no TPU kernel in the JAX package (XLA runs them
there): their steps run the cell modules on either device.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from torch_tts_tpu_torch.core.config import TacotronConfig
from torch_tts_tpu_torch.core.masks import sequence_mask
from torch_tts_tpu_torch.kernels import taco_step as ts
from torch_tts_tpu_torch.ops.layers import Conv1d, Embed, init_params_
from torch_tts_tpu_torch.ops.rnn import BiLSTM, GRUCell, LSTMZoneoutCell, ResGRUCell
from torch_tts_tpu_torch.ops.style import VAE
from torch_tts_tpu_torch.ops.tacotron_attention import (ContentMarkovAttention,
                                                        StepwiseMonotonicAttention,
                                                        initial_att_weights)
from torch_tts_tpu_torch.ops.tacotron_blocks import (CBHG, BatchNorm, Linear, MelPostnet,
                                                     MelPostnet2, PreNet, dropout_with_mask, isrlu)

ENCODER_DROPOUT = 0.1  # Encoder2's Dropout before the BiLSTM
P_NO_FORCING = 0.1  # a training step feeds back its own frame with this probability


@dataclasses.dataclass
class TacotronDraws:
    """Every random draw of one forward (the JAX model's "dropout" and
    "noise" streams). `prenet` is always needed (the PreNet's dropout stays
    on); `style_eps` whenever a reference mel goes through the VAE (at
    inference too); the others only in training (deterministic=False),
    else None. S steps, B texts of L ids.

    prenet [S, 2, B, W] bool: the PreNet's keep masks, a pair a step, W the
        wider of its two layers (each reads its first columns): tacotron2prod
        dim_pre; tacotron2 max(128, dim_pre); tacotron1 max(256, dim_pre).
    coin [S] bool: True feeds step t the teacher's frame (uniform > 0.1).
    zoneout: one bool keep-previous mask tensor per RNN of the cell
        (uniform < p, shared over the batch), in the order a step runs them:
        tacotron2prod [attention LSTM [S, 2, H_att], decoder LSTM [S, 2,
        H_dec]] ((h, c) a step); tacotron2 [LSTM 0 [S, 2, dim_rnn[0]], LSTM 1
        [S, 2, dim_rnn[1]]]; tacotron1 [attention GRU [S, dim_att], residual
        GRU 0 and 1 [S, dim_att + dim_ctx] each].
    att_noise [S, B, L]: the stepwise monotonic attention's standard normal
        sigmoid noise (tacotron2prod, tacotron2; None for tacotron1).
    encoder: Encoder2's dropout keep mask [B, L, 2 dim_emb]; for the
        tacotron1 Encoder, its PreNet's pair ([B, L, 256], [B, L, 128]).
    postnet: the postnet's keep masks: MelPostnet one [B, S r, hidden] a
        layer; MelPostnet2 two a block (after each leaky ReLU).
    style_eps [B, style_dim_vae]: the VAE's standard normal eps.

    In a JAX forward the draws come in this program order: the encoder's,
    style_eps, the coin, then per step the PreNet pair and the cell's
    (tacotron2prod: attention LSTM, noise, decoder LSTM; tacotron2: LSTM 0,
    LSTM 1, noise; tacotron1: the three GRUs), then the postnet's."""

    prenet: torch.Tensor
    coin: Optional[torch.Tensor] = None
    zoneout: Optional[Sequence[torch.Tensor]] = None
    att_noise: Optional[torch.Tensor] = None
    encoder: Optional[object] = None
    postnet: Optional[List[torch.Tensor]] = None
    style_eps: Optional[torch.Tensor] = None


def step_route(device_type: str, use_kernel: bool, deterministic: bool, grad_needed: bool) -> str:
    """"kernel" or "cells" for a Taco2Prod decoder step. The kernel runs a
    deterministic step on the card; the training draws take the cells, as
    does the CPU and `use_kernel = False`. A kernel step where a gradient is
    needed raises: the kernel has no backward, and its outputs would be
    silently detached."""
    if device_type != "cuda" or not use_kernel or not deterministic:
        return "cells"
    if grad_needed:
        raise RuntimeError("the Taco2Prod step kernel has no backward: run a deterministic decode "
                           "under torch.no_grad(), or set decoder.use_kernel = False")
    return "kernel"


class ISRLU(nn.Module):
    def forward(self, x):
        return isrlu(x)


class Encoder2(nn.Module):
    """Embedding (id 0 zeroed) -> 3 x (conv k=5 no bias, BN, ISRLU) with a
    concat skip from the embedding -> BiLSTM with learned h0/c0.
    `conv` holds [conv, bn, act] x 3, the reference's `conv.{0..8}`."""

    def __init__(self, alphabet_size: int, dim_out: int = 512, dim_emb: int = 512):
        super().__init__()
        self.emb = Embed(alphabet_size, dim_emb)
        layers = []
        for i in range(3):
            layers += [Conv1d(dim_emb, dim_emb, 5, padding=2, bias=False),
                       BatchNorm(dim_emb, affine=i < 2), ISRLU()]
        self.conv = nn.ModuleList(layers)
        self.rnn = BiLSTM(2 * dim_emb, dim_out // 2, bias=False)
        self.rnn_h0 = nn.Parameter(torch.zeros(1, 1, dim_out))
        self.rnn_c0 = nn.Parameter(torch.zeros(1, 1, dim_out))

    def draw_dropout(self, B: int, L: int, g: torch.Generator) -> torch.Tensor:
        return torch.rand(B, L, 2 * self.emb.weight.shape[1], generator=g,
                          device=g.device) >= ENCODER_DROPOUT

    def forward(self, x: torch.Tensor, x_lengths: torch.Tensor, batch_stats: bool = False,
                dropout_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """ids [B, T], lengths [B] -> memory [B, T, dim_out] (zero past each
        length). batch_stats: the BNs in training mode; dropout_mask: the
        keep mask [B, T, 2 dim_emb] of the Dropout before the BiLSTM."""
        h = self.emb(x) * (x != 0).to(torch.float32)[..., None]
        y = h
        for i in range(3):
            conv, bn, act = self.conv[3 * i: 3 * i + 3]
            y = act(bn(conv(y.transpose(1, 2)).transpose(1, 2), batch_stats))
        h = dropout_with_mask(torch.cat([y, h], dim=-1), dropout_mask, ENCODER_DROPOUT)
        B, D = h.shape[0], self.rnn_h0.shape[-1]
        ys, _ = self.rnn(h, x_lengths, self.rnn_h0.reshape(1, D).expand(B, D),
                         self.rnn_c0.reshape(1, D).expand(B, D))
        return ys


class Encoder(nn.Module):
    """The Tacotron-1 encoder: embedding -> PreNet(256, 128; its dropout
    only in training) -> CBHG(dim_out). The lengths are not read, so the
    memory is not zero past each text (as in the JAX module)."""

    def __init__(self, alphabet_size: int, dim_out: int = 256, dim_emb: int = 256):
        super().__init__()
        self.emb = Embed(alphabet_size, dim_emb)
        self.pre_net = PreNet(dim_emb, 128, dim_hidden=256, p_dropout=0.5)
        self.cbhg = CBHG(128, dim_out)

    def draw_dropout(self, B: int, L: int, g: torch.Generator):
        keep = 1.0 - self.pre_net.p_dropout
        return tuple(torch.rand(B, L, layer.weight.shape[0], generator=g, device=g.device) < keep
                     for layer in self.pre_net.layers)

    def forward(self, x: torch.Tensor, x_lengths: torch.Tensor, batch_stats: bool = False,
                dropout_mask=None) -> torch.Tensor:
        """ids [B, T] -> memory [B, T, dim_out]; dropout_mask: the PreNet's
        keep masks ([B, T, 256], [B, T, 128]) in training, else None."""
        return self.cbhg(self.pre_net(self.emb(x), dropout_mask), batch_stats)


class Taco2ProdDecoderCell(nn.Module):
    """PreNet -> attention LSTM -> stepwise monotonic attention -> context ->
    decoder LSTM (the plain step; the kernel computes the same)."""

    def __init__(self, dim_mel: int, dim_ctx: int, dim_rnn=(1024, 1024), dim_pre: int = 256,
                 p_zoneout: float = 0.1):
        super().__init__()
        self.dim_ctx, self.p_zoneout = dim_ctx, p_zoneout
        self.dim_output = dim_rnn[1] + dim_ctx
        self.pre_net = PreNet(dim_mel, dim_pre, dim_hidden=dim_pre, p_dropout=ts.PRENET_DROPOUT)
        self.attention_rnn = LSTMZoneoutCell(dim_pre + dim_ctx, dim_rnn[0], p_zoneout)
        self.attention_module = StepwiseMonotonicAttention(dim_rnn[0], dim_ctx)
        self.decoder_rnn = LSTMZoneoutCell(dim_rnn[0] + dim_ctx, dim_rnn[1], p_zoneout)
        self.initial_decoder_h = nn.ParameterList([nn.Parameter(torch.zeros(1, d)) for d in dim_rnn])
        self.initial_decoder_c = nn.ParameterList([nn.Parameter(torch.zeros(1, d)) for d in dim_rnn])

    @property
    def rnns(self):
        return (self.attention_rnn, self.decoder_rnn)

    def initial_state(self, B: int, L: int, device) -> ts.TacoStepState:
        bc = lambda p: p.expand(B, p.shape[1]).contiguous()  # noqa: E731
        return ts.TacoStepState(
            initial_att_weights(B, L, device), torch.zeros(B, self.dim_ctx, device=device),
            bc(self.initial_decoder_h[0]), bc(self.initial_decoder_c[0]),
            bc(self.initial_decoder_h[1]), bc(self.initial_decoder_c[1]))

    def forward(self, state: ts.TacoStepState, x: torch.Tensor, memory: torch.Tensor,
                mmask: Optional[torch.Tensor] = None,
                prenet_masks: Optional[Sequence[torch.Tensor]] = None,
                zoneout: Optional[Sequence[torch.Tensor]] = None,
                att_noise: Optional[torch.Tensor] = None):
        """-> (new state, out = [h_dec, ctx]). mmask is not read; zoneout:
        the two cells' training masks ([2, H_att], [2, H_dec]); att_noise
        [B, L]; None at eval."""
        x_pre = self.pre_net(x, prenet_masks)
        z_att, z_dec = zoneout if zoneout is not None else (None, None)
        h_att, c_att = self.attention_rnn((state.h_att, state.c_att),
                                          torch.cat([x_pre, state.ctx], -1), z_att)
        w = self.attention_module(h_att, state.w, memory, att_noise)
        ctx = torch.einsum("bl,bld->bd", w, memory)
        h_dec, c_dec = self.decoder_rnn((state.h_dec, state.c_dec), torch.cat([h_att, ctx], -1),
                                        z_dec)
        return ts.TacoStepState(w, ctx, h_att, c_att, h_dec, c_dec), torch.cat([h_dec, ctx], -1)


class Taco2State(NamedTuple):
    w: torch.Tensor  # [B, L]
    rnn: Tuple[Tuple[torch.Tensor, torch.Tensor], ...]  # each LSTM's (h, c) [B, H_i]


class Taco2DecoderCell(nn.Module):
    """PreNet(128, dim_pre) -> two zoneout LSTMs, each fed [x, ctx] with
    ctx = w @ memory from the previous weights -> stepwise monotonic
    attention on [h0, h1, 0] after the RNNs. The output is that same
    concatenation: its ctx slot holds zeros, which fc_mel and fc_stop see
    (as in the JAX cell). Learned initial states `initial_decoder_{h,c}`."""

    def __init__(self, dim_mel: int, dim_ctx: int, dim_rnn=(1024, 1024), dim_pre: int = 128,
                 p_zoneout: float = 0.1):
        super().__init__()
        self.dim_ctx = dim_ctx
        self.dim_output = sum(dim_rnn) + dim_ctx
        self.pre_net = PreNet(dim_mel, dim_pre, dim_hidden=128, p_dropout=0.5)
        ins = (dim_pre + dim_ctx, dim_rnn[0] + dim_ctx)
        self.decoder_rnn_list = nn.ModuleList(LSTMZoneoutCell(i, d, p_zoneout)
                                              for i, d in zip(ins, dim_rnn))
        self.attention_module = StepwiseMonotonicAttention(self.dim_output, dim_ctx)
        self.initial_decoder_h = nn.ParameterList([nn.Parameter(torch.zeros(1, d)) for d in dim_rnn])
        self.initial_decoder_c = nn.ParameterList([nn.Parameter(torch.zeros(1, d)) for d in dim_rnn])

    @property
    def rnns(self):
        return tuple(self.decoder_rnn_list)

    def initial_state(self, B: int, L: int, device) -> Taco2State:
        bc = lambda p: p.expand(B, p.shape[1]).contiguous()  # noqa: E731
        return Taco2State(initial_att_weights(B, L, device),
                          tuple((bc(h), bc(c)) for h, c in zip(self.initial_decoder_h,
                                                               self.initial_decoder_c)))

    def forward(self, state: Taco2State, x, memory, mmask=None, prenet_masks=None, zoneout=None,
                att_noise=None):
        x_dec = self.pre_net(x, prenet_masks)
        ctx = torch.einsum("bl,bld->bd", state.w, memory)
        new = []
        for i, rnn in enumerate(self.decoder_rnn_list):
            new.append(rnn(state.rnn[i], torch.cat([x_dec, ctx], -1),
                           None if zoneout is None else zoneout[i]))
            x_dec = new[-1][0]
        out = torch.cat([new[0][0], new[1][0], torch.zeros_like(ctx)], -1)
        w = self.attention_module(out, state.w, memory, att_noise)
        return Taco2State(w, tuple(new)), out


class Taco1State(NamedTuple):
    w: torch.Tensor  # [B, L]
    h_att: torch.Tensor  # [B, dim_att]
    h_dec: Tuple[torch.Tensor, ...]  # each residual GRU's h [B, dim_att + dim_ctx]


class Taco1DecoderCell(nn.Module):
    """PreNet(256, dim_pre) -> ctx = w @ memory from the previous weights ->
    attention GRU (dim_att, zoneout 0.1) on [ctx, x] -> Markov attention
    (reads the memory mask) -> two residual GRUs of dim_att + dim_ctx over
    [h_att, ctx]. Its state starts at zeros."""

    def __init__(self, dim_mel: int, dim_ctx: int, dim_pre: int = 128, dim_att: int = 256,
                 num_layers: int = 2, p_zoneout: float = 0.1):
        super().__init__()
        self.dim_att = dim_att
        self.dim_output = dim_att + dim_ctx
        self.pre_net = PreNet(dim_mel, dim_pre, dim_hidden=256, p_dropout=0.5)
        self.attention_rnn = GRUCell(dim_ctx + dim_pre, dim_att, p_zoneout=0.1)
        self.attention_module = ContentMarkovAttention(dim_att, dim_ctx)
        self.decoder_rnn_list = nn.ModuleList(
            ResGRUCell(self.dim_output, self.dim_output, p_zoneout) for _ in range(num_layers))

    @property
    def rnns(self):
        return (self.attention_rnn, *self.decoder_rnn_list)

    def initial_state(self, B: int, L: int, device) -> Taco1State:
        z = lambda d: torch.zeros(B, d, device=device)  # noqa: E731
        return Taco1State(initial_att_weights(B, L, device), z(self.dim_att),
                          tuple(z(self.dim_output) for _ in self.decoder_rnn_list))

    def forward(self, state: Taco1State, x, memory, mmask=None, prenet_masks=None, zoneout=None,
                att_noise=None):
        """att_noise is not read (the Markov attention draws none)."""
        z = zoneout if zoneout is not None else [None] * len(self.rnns)
        x_pre = self.pre_net(x, prenet_masks)
        ctx = torch.einsum("bl,bld->bd", state.w, memory)
        h_att = self.attention_rnn(state.h_att, torch.cat([ctx, x_pre], -1), z[0])
        w = self.attention_module(h_att, state.w, memory, mmask)
        x_dec, new = torch.cat([h_att, ctx], -1), []
        for i, rnn in enumerate(self.decoder_rnn_list):
            h_i, x_dec = rnn(state.h_dec[i], x_dec, z[i + 1])
            new.append(h_i)
        return Taco1State(w, h_att, tuple(new)), x_dec


class Decoder(nn.Module):
    """The autoregressive r-frame-group decoder over one of the three cells
    (`cell_type`: tacotron2prod, tacotron2 or tacotron1). The whole decode
    (`forward`) and a chunk of it (`decode_chunk`) run one step loop
    (`_run`) over a carry (the cell's state, previous frame) from a global
    step index, as the JAX `_ar_step` is shared by its scan and its
    `decode_chunk`: given each step's PreNet masks, chunks from
    `init_carry` give the whole decode's numbers exactly. Only the
    tacotron2prod cell routes to the step kernel."""

    def __init__(self, dim_ctx: int, dim_mel: int, r: int, dim_rnn=(1024, 1024), dim_pre: int = 256,
                 dim_att: int = 128, cell_type: str = "tacotron2prod", stop_threshold: float = -2.0):
        super().__init__()
        self.dim_ctx, self.dim_mel, self.r, self.dim_pre = dim_ctx, dim_mel, r, dim_pre
        self.cell_type, self.stop_threshold = cell_type, stop_threshold
        if cell_type == "tacotron1":
            self.decoder_cell = Taco1DecoderCell(dim_mel, dim_ctx, dim_pre, dim_att)
        elif cell_type == "tacotron2":
            self.decoder_cell = Taco2DecoderCell(dim_mel, dim_ctx, dim_rnn, dim_pre)
        else:
            self.decoder_cell = Taco2ProdDecoderCell(dim_mel, dim_ctx, dim_rnn, dim_pre)
        self.fc_mel = Linear(self.decoder_cell.dim_output, r * dim_mel)
        self.fc_stop = Linear(self.decoder_cell.dim_output, r)
        # on a CUDA device, each Taco2Prod step through the kernel (True) or
        # the cell module (False, the plain path the kernel is compared with)
        self.use_kernel = True
        self._packed = None  # (key, pack_streamed's weights), see packed_weights
        self.register_load_state_dict_post_hook(lambda module, keys: module.drop_packed())

    def drop_packed(self):
        self._packed = None

    def packed_weights(self) -> ts.TacoStepStreamed:
        """`pack_streamed`'s weights, packed once per model: kept until the
        state dict is loaded, a parameter changes in place or moves
        (the key holds each parameter's version counter and address)."""
        params = tuple(self.parameters())
        key = tuple((p.data_ptr(), p._version) for p in params)
        if self._packed is None or self._packed[0] != key:
            with torch.no_grad():
                packed = ts.pack_streamed(ts.weights_from_state_dict(self.state_dict(), prefix=""))
            self._packed = (key, packed)
        return self._packed[1]

    def draw_prenet_masks(self, steps: int, B: int, device, generator: torch.Generator) -> torch.Tensor:
        """[steps, 2, B, W] bool keep masks, P(keep) = 1 - p, W the
        PreNet's `mask_width`."""
        pre = self.decoder_cell.pre_net
        return torch.rand(steps, 2, B, pre.mask_width, generator=generator,
                          device=device) < 1.0 - pre.p_dropout

    def draw_training(self, S: int, B: int, L: int, g: torch.Generator):
        """(zoneout masks, one a cell RNN, attention noise or None) of S
        training steps, drawn in that order."""
        zone = []
        for rnn in self.decoder_cell.rnns:
            pairs = (2,) if isinstance(rnn, LSTMZoneoutCell) else ()
            zone.append(torch.rand(S, *pairs, rnn.hidden_size, generator=g, device=g.device)
                        < rnn.p_zoneout)
        noise = (None if self.cell_type == "tacotron1"
                 else torch.randn(S, B, L, generator=g, device=g.device))
        return zone, noise

    def init_carry(self, memory: torch.Tensor):
        """The decode's first carry: (learned or zero initial state, zero frame)."""
        B, L, _ = memory.shape
        state = self.decoder_cell.initial_state(B, L, memory.device)
        return state, torch.zeros(B, self.dim_mel, device=memory.device)

    def _run(self, carry, memory: torch.Tensor, prenet_masks: torch.Tensor,
             step_inputs: Optional[torch.Tensor] = None, *, mmask: Optional[torch.Tensor] = None,
             coin: Optional[Sequence[bool]] = None,
             zoneout: Optional[Sequence[torch.Tensor]] = None,
             att_noise: Optional[torch.Tensor] = None):
        """len(prenet_masks) steps from `carry` -> (carry, y [B, n, r*D_mel],
        s [B, n, r], w [B, n, L]). Step j takes prenet_masks[j] ([2, B, W])
        and, with step_inputs [B, n, D_mel], its frame step_inputs[:, j] where
        coin is None or coin[j], else the previous step's last frame (with
        its gradient). mmask [B, L]: the memory mask (None: all valid).
        zoneout (one [n, ...] tensor a cell RNN) and att_noise [n, B, L]
        are the training draws, with which the steps run the cells (see
        `step_route`)."""
        state, y_in = carry
        B, L, _ = memory.shape
        cell = self.decoder_cell
        deterministic = zoneout is None and att_noise is None and coin is None
        use_kernel = False
        if isinstance(cell, Taco2ProdDecoderCell):
            grad_needed = torch.is_grad_enabled() and (
                memory.requires_grad or any(p.requires_grad for p in self.parameters()))
            use_kernel = step_route(memory.device.type, self.use_kernel, deterministic,
                                    grad_needed) == "kernel"
        if use_kernel:
            packed = self.packed_weights()
            ones = torch.ones(B, L, device=memory.device)  # the attention reads no mask
        ys, ss, ws = [], [], []
        for j in range(prenet_masks.shape[0]):
            if step_inputs is not None and (coin is None or coin[j]):
                y_in = step_inputs[:, j]
            masks = (prenet_masks[j, 0], prenet_masks[j, 1])
            if use_kernel:
                y_t, s_t, state = ts.taco_step_streamed(y_in, state, memory, ones, packed,
                                                        cell.p_zoneout, prenet_masks=masks)
            else:
                z = None if zoneout is None else [zz[j] for zz in zoneout]
                state, out = cell(state, y_in, memory, mmask, masks, z,
                                  None if att_noise is None else att_noise[j])
                y_t = F.leaky_relu(self.fc_mel(out), 0.01)
                s_t = self.fc_stop(out)
            ys.append(y_t)
            ss.append(s_t)
            ws.append(state.w)
            y_in = y_t.reshape(B, self.r, self.dim_mel)[:, -1]
        return (state, y_in), torch.stack(ys, 1), torch.stack(ss, 1), torch.stack(ws, 1)

    def teacher_inputs(self, x: torch.Tensor) -> torch.Tensor:
        """Teacher mels [B, T, D_mel] -> each step's teacher input [B, S, D_mel],
        S = T // r: zeros, then the last frame of each group but the last."""
        B, S = x.shape[0], x.shape[1] // self.r
        last = x[:, : S * self.r].reshape(B, S, self.r, self.dim_mel)[:, :, -1]
        return torch.cat([torch.zeros_like(last[:, :1]), last[:, :-1]], 1)

    def forward(self, memory: torch.Tensor, max_steps: int = 400,
                prenet_masks: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                step_inputs: Optional[torch.Tensor] = None,
                x: Optional[torch.Tensor] = None, draws: Optional[TacotronDraws] = None,
                mmask: Optional[torch.Tensor] = None):
        """memory [B, L, D] -> (y [B, S*r, D_mel], s [B, S*r, 1], w [B, S, L],
        stop_lengths [B] in frame groups).

        Free-running (x None): S = max_steps; prenet_masks [S, 2, B, W] keep
        masks, else drawn from `generator`; step_inputs [B, S, D_mel], the
        input frame of each step in place of the previous step's last frame
        (zeros at step 0 otherwise), a way to hold two paths to the same
        inputs step by step.
        Teacher-forced (x [B, T, D_mel] the teacher mels): S = T // r, every
        step forced unless `draws` holds the training draws.
        draws: `TacotronDraws` in place of prenet_masks (not both); with its
        training draws, the coin (teacher-forced only), zoneout and attention
        noise. Without draws or prenet_masks, the masks come from `generator`
        in both modes. mmask [B, L]: the memory mask (None: all valid)."""
        B = memory.shape[0]
        train = {}
        if draws is not None:
            if prenet_masks is not None:
                raise ValueError("Decoder: give draws or prenet_masks, not both")
            prenet_masks = draws.prenet
            if draws.zoneout is not None:
                train = dict(zoneout=draws.zoneout, att_noise=draws.att_noise)
        if x is not None:
            step_inputs = self.teacher_inputs(x)
            S = step_inputs.shape[1]
            if train:
                train["coin"] = draws.coin.tolist()
        else:
            S = max_steps
        if prenet_masks is None:
            if generator is None:
                raise ValueError("Decoder: the PreNet's dropout needs prenet_masks or a "
                                 "generator")
            prenet_masks = self.draw_prenet_masks(S, B, memory.device, generator)
        _, y, s_groups, w = self._run(self.init_carry(memory), memory, prenet_masks[:S],
                                      step_inputs, mmask=mmask, **train)
        stopped = s_groups.min(dim=-1).values < self.stop_threshold
        first = torch.argmax(stopped.to(torch.int32), dim=1) + 1
        stop_lengths = torch.where(stopped.any(dim=1), first, torch.full_like(first, S))
        return (y.reshape(B, S * self.r, self.dim_mel), s_groups.reshape(B, S * self.r, 1), w,
                stop_lengths)

    def decode_chunk(self, memory: torch.Tensor, carry, prenet_masks: torch.Tensor,
                     mmask: Optional[torch.Tensor] = None):
        """The free-running decode continued for len(prenet_masks) = K groups
        from `carry` (init_carry's or a previous chunk's) -> (carry,
        y [B, K*r, D_mel], stopped [B, K] per-group stop flags, w [B, K, L]).
        prenet_masks [K, 2, B, W] are the masks of the chunk's global steps;
        mmask [B, L] the memory mask (None: all valid)."""
        B, K = memory.shape[0], prenet_masks.shape[0]
        carry, y, s_groups, w = self._run(carry, memory, prenet_masks, mmask=mmask)
        stopped = s_groups.min(dim=-1).values < self.stop_threshold
        return carry, y.reshape(B, K * self.r, self.dim_mel), stopped, w


CELL_TYPES = ("tacotron1", "tacotron2")  # any other decoder_type is tacotron2prod, as in JAX


class Tacotron(nn.Module):
    """Encoder (Encoder2, or the tacotron1 CBHG Encoder) + optional VAE
    style encoder (`refencoder`) + decoder + postnet (MelPostnet,
    MelPostnet2 or none)."""

    def __init__(self, cfg: TacotronConfig, alphabet_size: int):
        super().__init__()
        m, a = cfg.model, cfg.audio
        self.cfg = cfg
        enc = Encoder if m.encoder_type == "tacotron1" else Encoder2
        self.encoder = enc(alphabet_size, m.dim_out, m.dim_emb)
        self.decoder = Decoder(m.dim_out, a.num_mels, m.r, tuple(m.dim_rnn), m.dim_pre, m.dim_att,
                               m.decoder_type if m.decoder_type in CELL_TYPES else "tacotron2prod")
        if m.postnet_type == "tacotron2":
            self.postnet = MelPostnet(a.num_mels, m.postnet_dim_hidden,
                                      num_layers=m.postnet_num_layers)
        elif m.postnet_type is not None:
            self.postnet = MelPostnet2(a.num_mels, m.postnet_dim_hidden, m.postnet_num_layers)
        else:
            self.postnet = None
        # dim_emb follows the encoder width so that the style adds to the memory
        self.refencoder = (VAE(a.num_mels, dim_emb=m.dim_out, dim_vae=m.style_dim_vae)
                           if m.style_dim_vae else None)

    def draw_style_eps(self, B: int, generator: torch.Generator) -> torch.Tensor:
        """The VAE's eps [B, style_dim_vae], standard normal."""
        return torch.randn(B, self.refencoder.dim_vae, generator=generator,
                           device=generator.device)

    def draw(self, B: int, L: int, S: int, generator: torch.Generator,
             train: bool = True, style: bool = False) -> TacotronDraws:
        """The draws of one forward of S steps over B texts of L ids, from
        `generator` on its device, in this order: the PreNet masks; with
        train, then the coin, the cell's zoneout masks (its RNNs in order),
        the attention noise (not for tacotron1), the encoder's and each
        postnet dropout's masks; with style (a VAE model given a reference
        mel), last, the VAE's eps."""
        dev, g = generator.device, generator
        dec = self.decoder
        prenet = dec.draw_prenet_masks(S, B, dev, g)
        draws = TacotronDraws(prenet)
        if train:
            draws.coin = torch.rand(S, generator=g, device=dev) > P_NO_FORCING
            draws.zoneout, draws.att_noise = dec.draw_training(S, B, L, g)
            draws.encoder = self.encoder.draw_dropout(B, L, g)
            if self.postnet is not None:
                p = self.postnet.P_DROPOUT
                draws.postnet = [torch.rand(shape, generator=g, device=dev) >= p
                                 for shape in self.postnet.dropout_shapes(B, S * dec.r)]
        if style:
            draws.style_eps = self.draw_style_eps(B, g)
        return draws

    def _styled(self, memory, xref, xref_lengths, eps, batch_stats: bool = False):
        """memory + the VAE's style, and the mean KL term."""
        style, losses = self.refencoder(xref, xref_lengths, eps, batch_stats)
        return memory + style, losses["kl"].mean()

    def forward(self, cond: torch.Tensor, cond_lengths: torch.Tensor,
                x: Optional[torch.Tensor] = None, x_lengths: Optional[torch.Tensor] = None,
                xref: Optional[torch.Tensor] = None, xref_lengths: Optional[torch.Tensor] = None,
                train: bool = False, deterministic: bool = True,
                draws: Optional[TacotronDraws] = None,
                generator: Optional[torch.Generator] = None, max_steps: int = 400):
        """The JAX `Tacotron.__call__`: ids [B, L], lengths [B], teacher mels
        x [B, T, D_mel] (None: free-running for max_steps), reference mels
        xref [B, T_ref, D_mel] with xref_lengths (read with a VAE only) ->
        (y, y_post [B, S*r, D_mel], s [B, S*r, 1], {"w": [B, S, L],
        "kl_loss": the mean KL term (0 without a style), "stop_lengths":
        [B]}), S = T // r. train: the BatchNorms on batch statistics (their
        running statistics updated); deterministic=False: the training
        draws. `draws`, else drawn from `generator` (`draw`). x_lengths
        are unused, as in the JAX model."""
        B, L = cond.shape
        S = x.shape[1] // self.decoder.r if x is not None else max_steps
        styled = xref is not None and self.refencoder is not None
        if draws is None:
            if generator is None:
                raise ValueError("Tacotron.forward needs draws or a generator")
            draws = self.draw(B, L, S, generator, train=not deterministic, style=styled)
        if deterministic:
            draws = TacotronDraws(draws.prenet, style_eps=draws.style_eps)
        elif draws.coin is None:
            raise ValueError("deterministic=False needs the training draws")
        if styled and draws.style_eps is None:
            raise ValueError("a reference mel needs the VAE's style_eps")
        memory = self.encoder(cond, cond_lengths, train, draws.encoder)
        kl_loss = torch.zeros((), device=memory.device)
        if styled:
            memory, kl_loss = self._styled(memory, xref, xref_lengths, draws.style_eps, train)
        mmask = sequence_mask(cond_lengths, L)
        y, s, w, stop_lengths = self.decoder(memory, S, x=x, draws=draws, mmask=mmask)
        y_post = (self.postnet(y, train, draws.postnet) if self.postnet is not None else y)
        return y, y_post, s, {"w": w, "kl_loss": kl_loss, "stop_lengths": stop_lengths}

    @torch.no_grad()
    def infer(self, cond: torch.Tensor, cond_lengths: torch.Tensor, max_steps: int = 400,
              prenet_masks: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None,
              step_inputs: Optional[torch.Tensor] = None,
              xref: Optional[torch.Tensor] = None, xref_lengths: Optional[torch.Tensor] = None,
              style_eps: Optional[torch.Tensor] = None):
        """ids [B, L], lengths [B] -> (y, y_post [B, S*r, D_mel], s [B, S*r, 1],
        {"w": [B, S, L], "stop_lengths": [B]}), the JAX model's inference
        outputs but its kl_loss. prenet_masks, else drawn from `generator`;
        with xref on a VAE model, style_eps, else drawn from `generator`
        after the masks (the order of `draw(train=False, style=True)`)."""
        if prenet_masks is None:
            if generator is None:
                raise ValueError("Tacotron.infer: the PreNet's dropout needs prenet_masks or a "
                                 "generator")
            prenet_masks = self.decoder.draw_prenet_masks(max_steps, cond.shape[0], cond.device,
                                                          generator)
        memory, mmask = self.encode(cond, cond_lengths, xref, xref_lengths, style_eps, generator)
        y, s, w, stop_lengths = self.decoder(memory, max_steps, prenet_masks,
                                             step_inputs=step_inputs, mmask=mmask)
        y_post = self.postnet(y) if self.postnet is not None else y
        return y, y_post, s, {"w": w, "stop_lengths": stop_lengths}

    # -- the streaming surface (infer/taco_serving.py): the prefix once per
    #    utterance, then chunks of the decode, the postnet over any window

    @torch.no_grad()
    def encode(self, cond: torch.Tensor, cond_lengths: torch.Tensor,
               xref: Optional[torch.Tensor] = None, xref_lengths: Optional[torch.Tensor] = None,
               style_eps: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None):
        """ids [B, L], lengths [B] -> (memory [B, L, D], mmask [B, L]); with
        xref on a VAE model, the style added (eps: style_eps, else drawn
        from `generator`)."""
        memory = self.encoder(cond, cond_lengths)
        if xref is not None and self.refencoder is not None:
            if style_eps is None:
                if generator is None:
                    raise ValueError("a reference mel needs the VAE's style_eps or a generator")
                style_eps = self.draw_style_eps(cond.shape[0], generator)
            memory, _ = self._styled(memory, xref, xref_lengths, style_eps)
        return memory, sequence_mask(cond_lengths, cond.shape[1])

    def decode_init(self, memory: torch.Tensor):
        return self.decoder.init_carry(memory)

    @torch.no_grad()
    def decode_chunk(self, memory: torch.Tensor, carry, prenet_masks: torch.Tensor,
                     mmask: Optional[torch.Tensor] = None):
        """`Decoder.decode_chunk`: the masks of the chunk's global steps
        (those of steps t0 .. t0+K-1) stand for the JAX step index; mmask,
        `encode`'s (read by the tacotron1 cell)."""
        return self.decoder.decode_chunk(memory, carry, prenet_masks, mmask)

    @torch.no_grad()
    def apply_postnet(self, y: torch.Tensor) -> torch.Tensor:
        """The postnet over any frame window [B, T, D_mel]."""
        return self.postnet(y) if self.postnet is not None else y


def build_tacotron(cfg: TacotronConfig, seed: int = 0, device="cuda") -> Tacotron:
    """Tacotron for `cfg` (alphabet size 1 + |alphabet|), initialised from
    torch.Generator(seed) in module order, on `device` (the card unless the
    caller says otherwise), in eval mode."""
    model = Tacotron(cfg, 1 + len(cfg.text.alphabet))
    init_params_(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()
