"""Tacotron-2 (port of `torch_tts_tpu/models/tacotron/model.py`):
`Encoder2`, the Taco2Prod decoder cell and its autoregressive `Decoder`,
`Tacotron` (encoder + decoder + `MelPostnet`) and `build_tacotron`.

Module and parameter names are the reference's torch names, which the JAX
package's `export_torch_state_dict` emits and `convert.py` here
reproduces, so a converted state dict loads with strict=True.

`Tacotron.forward` is the JAX `Tacotron.__call__`: with teacher mels x it
runs S = T // r steps, step t taking zeros at t = 0, else the teacher's
last frame of group t-1 where the step's coin says so and the model's own
previous frame (with its gradient) otherwise; `train` puts the BatchNorms
on batch statistics (updating their running ones) and `deterministic=False`
turns on the training draws. Every draw comes in one `TacotronDraws`, or
from an explicit `torch.Generator` (`Tacotron.draw`): the teacher-forcing
coin, the PreNet masks, the zoneout masks, the attention's sigmoid noise
and the encoder's and the postnet's dropout masks. At eval every step is
teacher-forced. Without x it decodes `max_steps` free-running, as
`Tacotron.infer` does.

The decoder returns per-item `stop_lengths` (the first step whose smallest
stop logit is below -2, else S); callers trim. The PreNet's dropout stays
on at inference (the original recipe). The attention ignores the memory
mask, as the JAX model does (see ops/tacotron_attention.py).

The streaming surface of the JAX model: `encode`, `decode_init`,
`decode_chunk` and `apply_postnet`. The whole decode and a chunk share one
step loop, so a chunked decode equals the whole one exactly when each
step gets the same masks.

On a CUDA device each deterministic step with no gradient (inference, a
chunk, the trainer's eval step) is one `kernels/taco_step.py:
taco_step_streamed` launch per row group of at most 8, with the big LSTM
matrices packed once per model (`Decoder.packed_weights`); on the CPU,
with `Decoder.use_kernel = False`, or with the training draws (which the
kernel does not draw, and which need the gradient it has no backward for),
each step runs the cell modules (`step_route`).

Not ported yet, and raising NotImplementedError: the VAE/GST style
encoders, the tacotron1/tacotron2 decoder cells, the CBHG encoder and the
other postnets.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from torch_tts_tpu_torch.core.config import TacotronConfig
from torch_tts_tpu_torch.core.masks import sequence_mask
from torch_tts_tpu_torch.kernels import taco_step as ts
from torch_tts_tpu_torch.ops.layers import Conv1d, Embed, init_params_
from torch_tts_tpu_torch.ops.rnn import BiLSTM, LSTMZoneoutCell
from torch_tts_tpu_torch.ops.tacotron_attention import StepwiseMonotonicAttention, initial_att_weights
from torch_tts_tpu_torch.ops.tacotron_blocks import (BatchNorm, Linear, MelPostnet, PreNet,
                                                     dropout_with_mask, isrlu)

ENCODER_DROPOUT = 0.1  # Encoder2's Dropout before the BiLSTM
P_NO_FORCING = 0.1  # a training step feeds back its own frame with this probability


@dataclasses.dataclass
class TacotronDraws:
    """Every random draw of one forward (the JAX model's "dropout" and
    "noise" streams). `prenet` is always needed (the PreNet's dropout stays
    on); the others only in training (deterministic=False), else None.

    prenet [S, 2, B, P] bool: the PreNet's keep masks, a pair a step.
    coin [S] bool: True feeds step t the teacher's frame (uniform > 0.1).
    zoneout_att [S, 2, H_att], zoneout_dec [S, 2, H_dec] bool: each cell's
        (h, c) keep-previous masks a step (uniform < p), shared over the batch.
    att_noise [S, B, L]: the attention's standard normal sigmoid noise.
    encoder [B, T_text, 2 dim_emb] bool: the encoder's dropout keep mask.
    postnet: one [B, S r, postnet hidden] bool keep mask a postnet layer."""

    prenet: torch.Tensor
    coin: Optional[torch.Tensor] = None
    zoneout_att: Optional[torch.Tensor] = None
    zoneout_dec: Optional[torch.Tensor] = None
    att_noise: Optional[torch.Tensor] = None
    encoder: Optional[torch.Tensor] = None
    postnet: Optional[List[torch.Tensor]] = None


def step_route(device_type: str, use_kernel: bool, deterministic: bool, grad_needed: bool) -> str:
    """"kernel" or "cells" for a decoder step. The kernel runs a
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


class Taco2ProdDecoderCell(nn.Module):
    """PreNet -> attention LSTM -> stepwise monotonic attention -> context ->
    decoder LSTM (the plain step; the kernel computes the same)."""

    def __init__(self, dim_mel: int, dim_ctx: int, dim_rnn=(1024, 1024), dim_pre: int = 256,
                 p_zoneout: float = 0.1):
        super().__init__()
        self.p_zoneout = p_zoneout
        self.pre_net = PreNet(dim_mel, dim_pre, dim_hidden=dim_pre, p_dropout=ts.PRENET_DROPOUT)
        self.attention_rnn = LSTMZoneoutCell(dim_pre + dim_ctx, dim_rnn[0], p_zoneout)
        self.attention_module = StepwiseMonotonicAttention(dim_rnn[0], dim_ctx)
        self.decoder_rnn = LSTMZoneoutCell(dim_rnn[0] + dim_ctx, dim_rnn[1], p_zoneout)
        self.initial_decoder_h = nn.ParameterList([nn.Parameter(torch.zeros(1, d)) for d in dim_rnn])
        self.initial_decoder_c = nn.ParameterList([nn.Parameter(torch.zeros(1, d)) for d in dim_rnn])

    def initial_state(self, B: int, L: int, dim_ctx: int, device) -> ts.TacoStepState:
        bc = lambda p: p.expand(B, p.shape[1]).contiguous()  # noqa: E731
        return ts.TacoStepState(
            initial_att_weights(B, L, device), torch.zeros(B, dim_ctx, device=device),
            bc(self.initial_decoder_h[0]), bc(self.initial_decoder_c[0]),
            bc(self.initial_decoder_h[1]), bc(self.initial_decoder_c[1]))

    def forward(self, state: ts.TacoStepState, x: torch.Tensor, memory: torch.Tensor,
                prenet_masks: Optional[Sequence[torch.Tensor]] = None,
                zoneout: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                att_noise: Optional[torch.Tensor] = None):
        """-> (new state, out = [h_dec, ctx]). zoneout: the two cells'
        training masks ([2, H_att], [2, H_dec]); att_noise [B, L]; None at eval."""
        x_pre = self.pre_net(x, prenet_masks)
        z_att, z_dec = zoneout if zoneout is not None else (None, None)
        h_att, c_att = self.attention_rnn((state.h_att, state.c_att),
                                          torch.cat([x_pre, state.ctx], -1), z_att)
        w = self.attention_module(h_att, state.w, memory, att_noise)
        ctx = torch.einsum("bl,bld->bd", w, memory)
        h_dec, c_dec = self.decoder_rnn((state.h_dec, state.c_dec), torch.cat([h_att, ctx], -1),
                                        z_dec)
        return ts.TacoStepState(w, ctx, h_att, c_att, h_dec, c_dec), torch.cat([h_dec, ctx], -1)


class Decoder(nn.Module):
    """The autoregressive r-frame-group decoder. The whole decode (`forward`)
    and a chunk of it (`decode_chunk`) run one step loop (`_run`) over a
    carry (TacoStepState, previous frame) from a global step index, as the
    JAX `_ar_step` is shared by its scan and its `decode_chunk`: given each
    step's PreNet masks, chunks from `init_carry` give the whole decode's
    numbers exactly."""

    def __init__(self, dim_ctx: int, dim_mel: int, r: int, dim_rnn=(1024, 1024), dim_pre: int = 256,
                 stop_threshold: float = -2.0):
        super().__init__()
        self.dim_ctx, self.dim_mel, self.r, self.dim_pre = dim_ctx, dim_mel, r, dim_pre
        self.stop_threshold = stop_threshold
        self.decoder_cell = Taco2ProdDecoderCell(dim_mel, dim_ctx, dim_rnn, dim_pre)
        self.fc_mel = Linear(dim_rnn[1] + dim_ctx, r * dim_mel)
        self.fc_stop = Linear(dim_rnn[1] + dim_ctx, r)
        # on a CUDA device, each step through the kernel (True) or the cell
        # module (False, the plain path the kernel is compared with)
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
        """[steps, 2, B, P] bool keep masks, P(keep) = 1 - p."""
        keep = 1.0 - ts.PRENET_DROPOUT
        return torch.rand(steps, 2, B, self.dim_pre, generator=generator, device=device) < keep

    def init_carry(self, memory: torch.Tensor):
        """The decode's first carry: (learned initial state, zero frame)."""
        B, L, _ = memory.shape
        state = self.decoder_cell.initial_state(B, L, self.dim_ctx, memory.device)
        return state, torch.zeros(B, self.dim_mel, device=memory.device)

    def _run(self, carry, memory: torch.Tensor, prenet_masks: torch.Tensor,
             step_inputs: Optional[torch.Tensor] = None, *, coin: Optional[Sequence[bool]] = None,
             zoneout: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
             att_noise: Optional[torch.Tensor] = None):
        """len(prenet_masks) steps from `carry` -> (carry, y [B, n, r*D_mel],
        s [B, n, r], w [B, n, L]). Step j takes prenet_masks[j] ([2, B, P])
        and, with step_inputs [B, n, D_mel], its frame step_inputs[:, j] where
        coin is None or coin[j], else the previous step's last frame (with
        its gradient). zoneout ([n, 2, H_att], [n, 2, H_dec]) and att_noise
        [n, B, L] are the training draws, with which the steps run the cells
        (see `step_route`)."""
        state, y_in = carry
        B, L, _ = memory.shape
        cell = self.decoder_cell
        deterministic = zoneout is None and att_noise is None and coin is None
        grad_needed = torch.is_grad_enabled() and (
            memory.requires_grad or any(p.requires_grad for p in self.parameters()))
        use_kernel = step_route(memory.device.type, self.use_kernel, deterministic,
                                grad_needed) == "kernel"
        if use_kernel:
            packed = self.packed_weights()
            ones = torch.ones(B, L, device=memory.device)
        ys, ss, ws = [], [], []
        for j in range(prenet_masks.shape[0]):
            if step_inputs is not None and (coin is None or coin[j]):
                y_in = step_inputs[:, j]
            masks = (prenet_masks[j, 0], prenet_masks[j, 1])
            if use_kernel:
                y_t, s_t, state = ts.taco_step_streamed(y_in, state, memory, ones, packed,
                                                        cell.p_zoneout, prenet_masks=masks)
            else:
                z = None if zoneout is None else (zoneout[0][j], zoneout[1][j])
                state, out = cell(state, y_in, memory, masks, z,
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
                x: Optional[torch.Tensor] = None, draws: Optional[TacotronDraws] = None):
        """memory [B, L, D] -> (y [B, S*r, D_mel], s [B, S*r, 1], w [B, S, L],
        stop_lengths [B] in frame groups).

        Free-running (x None): S = max_steps; prenet_masks [S, 2, B, P] keep
        masks, else drawn from `generator`; step_inputs [B, S, D_mel], the
        input frame of each step in place of the previous step's last frame
        (zeros at step 0 otherwise), a way to hold two paths to the same
        inputs step by step.
        Teacher-forced (x [B, T, D_mel] the teacher mels): S = T // r, every
        step forced unless `draws` holds the training draws.
        draws: `TacotronDraws` in place of prenet_masks (not both); with its
        training draws, the coin (teacher-forced only), zoneout and attention
        noise. Without draws or prenet_masks, the masks come from `generator`
        in both modes."""
        B = memory.shape[0]
        train = {}
        if draws is not None:
            if prenet_masks is not None:
                raise ValueError("Decoder: give draws or prenet_masks, not both")
            prenet_masks = draws.prenet
            if draws.zoneout_att is not None:
                train = dict(zoneout=(draws.zoneout_att, draws.zoneout_dec),
                             att_noise=draws.att_noise)
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
                                      step_inputs, **train)
        stopped = s_groups.min(dim=-1).values < self.stop_threshold
        first = torch.argmax(stopped.to(torch.int32), dim=1) + 1
        stop_lengths = torch.where(stopped.any(dim=1), first, torch.full_like(first, S))
        return (y.reshape(B, S * self.r, self.dim_mel), s_groups.reshape(B, S * self.r, 1), w,
                stop_lengths)

    def decode_chunk(self, memory: torch.Tensor, carry, prenet_masks: torch.Tensor):
        """The free-running decode continued for len(prenet_masks) = K groups
        from `carry` (init_carry's or a previous chunk's) -> (carry,
        y [B, K*r, D_mel], stopped [B, K] per-group stop flags, w [B, K, L]).
        prenet_masks [K, 2, B, P] are the masks of the chunk's global steps."""
        B, K = memory.shape[0], prenet_masks.shape[0]
        carry, y, s_groups, w = self._run(carry, memory, prenet_masks)
        stopped = s_groups.min(dim=-1).values < self.stop_threshold
        return carry, y.reshape(B, K * self.r, self.dim_mel), stopped, w


def check_supported(cfg: TacotronConfig):
    m = cfg.model
    todo = [f"{k}={v!r}" for k, v, ok in (
        ("encoder_type", m.encoder_type, "tacotron2"),
        ("decoder_type", m.decoder_type, "tacotron2prod"))
        if v != ok]
    if m.postnet_type not in ("tacotron2", None):
        todo.append(f"postnet_type={m.postnet_type!r}")
    if m.style_dim_vae:
        todo.append(f"style_dim_vae={m.style_dim_vae}")
    if todo:
        raise NotImplementedError("the Tacotron port covers Encoder2, the tacotron2prod decoder and "
                                  "MelPostnet without style encoders; not yet: " + ", ".join(todo))


class Tacotron(nn.Module):
    """Encoder2 + Taco2Prod decoder + MelPostnet."""

    def __init__(self, cfg: TacotronConfig, alphabet_size: int):
        super().__init__()
        check_supported(cfg)
        m, a = cfg.model, cfg.audio
        self.cfg = cfg
        self.encoder = Encoder2(alphabet_size, m.dim_out, m.dim_emb)
        self.decoder = Decoder(m.dim_out, a.num_mels, m.r, tuple(m.dim_rnn), m.dim_pre)
        self.postnet = (MelPostnet(a.num_mels, m.postnet_dim_hidden, num_layers=m.postnet_num_layers)
                        if m.postnet_type == "tacotron2" else None)

    def draw(self, B: int, L: int, S: int, generator: torch.Generator,
             train: bool = True) -> TacotronDraws:
        """The draws of one forward of S steps over B texts of L ids, from
        `generator` on its device, in this order: the PreNet masks; with
        train, then the coin, the two cells' zoneout masks, the attention
        noise, the encoder's and each postnet layer's dropout masks."""
        dev, g = generator.device, generator
        dec, cell = self.decoder, self.decoder.decoder_cell
        prenet = dec.draw_prenet_masks(S, B, dev, g)
        if not train:
            return TacotronDraws(prenet)
        coin = torch.rand(S, generator=g, device=dev) > P_NO_FORCING
        zone = [torch.rand(S, 2, rnn.hidden_size, generator=g, device=dev) < rnn.p_zoneout
                for rnn in (cell.attention_rnn, cell.decoder_rnn)]
        noise = torch.randn(S, B, L, generator=g, device=dev)
        emb = self.encoder.emb.weight.shape[1]
        enc = torch.rand(B, L, 2 * emb, generator=g, device=dev) >= ENCODER_DROPOUT
        post = None
        if self.postnet is not None:
            p = self.postnet.P_DROPOUT
            post = [torch.rand(B, S * dec.r, conv.weight.shape[0], generator=g, device=dev) >= p
                    for conv, _ in self.postnet.conv]
        return TacotronDraws(prenet, coin, zone[0], zone[1], noise, enc, post)

    def forward(self, cond: torch.Tensor, cond_lengths: torch.Tensor,
                x: Optional[torch.Tensor] = None, x_lengths: Optional[torch.Tensor] = None,
                train: bool = False, deterministic: bool = True,
                draws: Optional[TacotronDraws] = None,
                generator: Optional[torch.Generator] = None, max_steps: int = 400):
        """The JAX `Tacotron.__call__`: ids [B, L], lengths [B], teacher mels
        x [B, T, D_mel] (None: free-running for max_steps) -> (y, y_post
        [B, S*r, D_mel], s [B, S*r, 1], {"w": [B, S, L], "kl_loss": 0,
        "stop_lengths": [B]}), S = T // r. train: the BatchNorms on batch
        statistics (their running statistics updated); deterministic=False:
        the training draws. `draws`, else drawn from `generator`
        (`draw`). x_lengths are unused, as in the JAX model without a style
        encoder."""
        B, L = cond.shape
        S = x.shape[1] // self.decoder.r if x is not None else max_steps
        if draws is None:
            if generator is None:
                raise ValueError("Tacotron.forward needs draws or a generator")
            draws = self.draw(B, L, S, generator, train=not deterministic)
        if deterministic:
            draws = TacotronDraws(draws.prenet)
        elif draws.coin is None:
            raise ValueError("deterministic=False needs the training draws")
        memory = self.encoder(cond, cond_lengths, train, draws.encoder)
        y, s, w, stop_lengths = self.decoder(memory, S, x=x, draws=draws)
        y_post = (self.postnet(y, train, draws.postnet) if self.postnet is not None else y)
        return y, y_post, s, {"w": w, "kl_loss": torch.zeros((), device=y.device),
                              "stop_lengths": stop_lengths}

    @torch.no_grad()
    def infer(self, cond: torch.Tensor, cond_lengths: torch.Tensor, max_steps: int = 400,
              prenet_masks: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None,
              step_inputs: Optional[torch.Tensor] = None):
        """ids [B, L], lengths [B] -> (y, y_post [B, S*r, D_mel], s [B, S*r, 1],
        {"w": [B, S, L], "stop_lengths": [B]}), the JAX model's inference
        outputs but its kl_loss."""
        memory = self.encoder(cond, cond_lengths)
        y, s, w, stop_lengths = self.decoder(memory, max_steps, prenet_masks, generator, step_inputs)
        y_post = self.postnet(y) if self.postnet is not None else y
        return y, y_post, s, {"w": w, "stop_lengths": stop_lengths}

    # -- the streaming surface (infer/taco_serving.py): the prefix once per
    #    utterance, then chunks of the decode, the postnet over any window

    @torch.no_grad()
    def encode(self, cond: torch.Tensor, cond_lengths: torch.Tensor):
        """ids [B, L], lengths [B] -> (memory [B, L, D], mmask [B, L]); the
        attention does not read mmask (as the JAX model's)."""
        return self.encoder(cond, cond_lengths), sequence_mask(cond_lengths, cond.shape[1])

    def decode_init(self, memory: torch.Tensor):
        return self.decoder.init_carry(memory)

    @torch.no_grad()
    def decode_chunk(self, memory: torch.Tensor, carry, prenet_masks: torch.Tensor):
        """`Decoder.decode_chunk`: the masks of the chunk's global steps
        (those of steps t0 .. t0+K-1) stand for the JAX step index."""
        return self.decoder.decode_chunk(memory, carry, prenet_masks)

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
