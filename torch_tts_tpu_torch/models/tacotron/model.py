"""Tacotron-2 inference (port of `torch_tts_tpu/models/tacotron/model.py`):
`Encoder2`, the Taco2Prod decoder cell and its autoregressive `Decoder`,
`Tacotron` (encoder + decoder + `MelPostnet`) and `build_tacotron`.

Module and parameter names are the reference's torch names, which the JAX
package's `export_torch_state_dict` emits and `convert.py` here
reproduces, so a converted state dict loads with strict=True.

The decoder scans all `max_steps` steps, as the JAX `lax.scan` does, and
returns per-item `stop_lengths` (the first step whose smallest stop logit
is below -2, else max_steps); callers trim. The PreNet's dropout stays on
at inference (the original recipe): each step's two keep masks come from
`prenet_masks` or are drawn from an explicit `torch.Generator`. The
attention ignores the memory mask, as the JAX model does (see
ops/tacotron_attention.py).

The streaming surface of the JAX model: `encode`, `decode_init`,
`decode_chunk` and `apply_postnet`. The whole decode and a chunk share one
step loop, so a chunked decode equals the whole one exactly when each
step gets the same masks.

On a CUDA device each step is one `kernels/taco_step.py:taco_step_streamed`
launch per row group of at most 8, with the big LSTM matrices packed once
per model (`Decoder.packed_weights`); on the CPU, or with
`Decoder.use_kernel = False`, each step runs the cell module.

Not ported yet, and raising NotImplementedError: training and teacher
forcing (`forward`), the VAE/GST style encoders, the tacotron1/tacotron2
decoder cells, the CBHG encoder and the other postnets.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from torch_tts_tpu_torch.core.config import TacotronConfig
from torch_tts_tpu_torch.core.masks import sequence_mask
from torch_tts_tpu_torch.kernels import taco_step as ts
from torch_tts_tpu_torch.ops.layers import Conv1d, Embed, init_params_
from torch_tts_tpu_torch.ops.rnn import BiLSTM, LSTMZoneoutCell
from torch_tts_tpu_torch.ops.tacotron_attention import StepwiseMonotonicAttention, initial_att_weights
from torch_tts_tpu_torch.ops.tacotron_blocks import BatchNorm, Linear, MelPostnet, PreNet, isrlu


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

    def forward(self, x: torch.Tensor, x_lengths: torch.Tensor) -> torch.Tensor:
        """ids [B, T], lengths [B] -> memory [B, T, dim_out] (zero past each length)."""
        h = self.emb(x) * (x != 0).to(torch.float32)[..., None]
        y = h
        for i in range(3):
            conv, bn, act = self.conv[3 * i: 3 * i + 3]
            y = act(bn(conv(y.transpose(1, 2)).transpose(1, 2)))
        h = torch.cat([y, h], dim=-1)
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
                prenet_masks: Optional[Sequence[torch.Tensor]] = None):
        """-> (new state, out = [h_dec, ctx])."""
        x_pre = self.pre_net(x, prenet_masks)
        h_att, c_att = self.attention_rnn((state.h_att, state.c_att), torch.cat([x_pre, state.ctx], -1))
        w = self.attention_module(h_att, state.w, memory)
        ctx = torch.einsum("bl,bld->bd", w, memory)
        h_dec, c_dec = self.decoder_rnn((state.h_dec, state.c_dec), torch.cat([h_att, ctx], -1))
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
             step_inputs: Optional[torch.Tensor] = None):
        """len(prenet_masks) steps from `carry` -> (carry, y [B, n, r*D_mel],
        s [B, n, r], w [B, n, L]). Step j takes prenet_masks[j] ([2, B, P])
        and, with step_inputs [B, n, D_mel], its frame step_inputs[:, j]."""
        state, y_in = carry
        B, L, _ = memory.shape
        cell = self.decoder_cell
        use_kernel = memory.device.type == "cuda" and self.use_kernel
        if use_kernel:
            packed = self.packed_weights()
            ones = torch.ones(B, L, device=memory.device)
        ys, ss, ws = [], [], []
        for j in range(prenet_masks.shape[0]):
            if step_inputs is not None:
                y_in = step_inputs[:, j]
            masks = (prenet_masks[j, 0], prenet_masks[j, 1])
            if use_kernel:
                y_t, s_t, state = ts.taco_step_streamed(y_in, state, memory, ones, packed,
                                                        cell.p_zoneout, prenet_masks=masks)
            else:
                state, out = cell(state, y_in, memory, masks)
                y_t = F.leaky_relu(self.fc_mel(out), 0.01)
                s_t = self.fc_stop(out)
            ys.append(y_t)
            ss.append(s_t)
            ws.append(state.w)
            y_in = y_t.reshape(B, self.r, self.dim_mel)[:, -1]
        return (state, y_in), torch.stack(ys, 1), torch.stack(ss, 1), torch.stack(ws, 1)

    def forward(self, memory: torch.Tensor, max_steps: int = 400,
                prenet_masks: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                step_inputs: Optional[torch.Tensor] = None):
        """memory [B, L, D] -> (y [B, S*r, D_mel], s [B, S*r, 1], w [B, S, L],
        stop_lengths [B] in frame groups), S = max_steps.

        prenet_masks: [S, 2, B, P] keep masks, else drawn from `generator`.
        step_inputs: [B, S, D_mel], the input frame of each step in place of
        the previous step's last frame (zeros at step 0 otherwise); a way to
        hold two paths to the same inputs step by step."""
        B, S = memory.shape[0], max_steps
        if prenet_masks is None:
            if generator is None:
                raise ValueError("Decoder: the PreNet's dropout needs prenet_masks or a generator")
            prenet_masks = self.draw_prenet_masks(S, B, memory.device, generator)
        _, y, s_groups, w = self._run(self.init_carry(memory), memory, prenet_masks[:S],
                                      step_inputs)
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
    """Encoder2 + Taco2Prod decoder + MelPostnet (inference)."""

    def __init__(self, cfg: TacotronConfig, alphabet_size: int):
        super().__init__()
        check_supported(cfg)
        m, a = cfg.model, cfg.audio
        self.cfg = cfg
        self.encoder = Encoder2(alphabet_size, m.dim_out, m.dim_emb)
        self.decoder = Decoder(m.dim_out, a.num_mels, m.r, tuple(m.dim_rnn), m.dim_pre)
        self.postnet = (MelPostnet(a.num_mels, m.postnet_dim_hidden, num_layers=m.postnet_num_layers)
                        if m.postnet_type == "tacotron2" else None)

    def forward(self, *args, **kwargs):
        raise NotImplementedError("Tacotron training and teacher forcing are not ported yet; "
                                  "use Tacotron.infer")

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
