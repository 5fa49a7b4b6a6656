"""VITS2 synthesizer (port of `torch_tts_tpu/models/vits2/model.py`),
[B, C, T] layout inside.

Parameter names are the kgoba reference's torch names, as
`export_torch_state_dict` emits them, so its state dicts load with
`strict=True`. That includes the parts `infer` does not run: the posterior
encoder `enc_q`, the SDP's posterior flows, and the `post_transformer` that
the reference declares in every `pre_conv` flow but never calls.

`infer` keeps the JAX return contract (channels-last audio, attn, y_mask,
aux, y_lengths) and the bucketed `max_frames` output with exact-length
semantics; `forward` is the training forward and returns the JAX
`__call__`'s 8-tuple, channels-last. Every random draw comes from an
explicit `torch.Generator` (dropout masks included), or is passed in as a
tensor; `infer`'s from the default generator when given `DEFAULT_RNG`, as
in an exported program (`infer/export.py`, through `infer_body`).

Multi-speaker models (`n_speakers > 1`) look up `emb_g(sid)` as g
[B, gin, 1] and condition on it as the JAX model does: the text encoder
(with `use_spk_conditioned_encoder`), the posterior encoder's and the
flows' WN stacks through their `cond_layer`, the duration predictor on a
detached g, and the decoder's `cond`. `voice_conversion` runs the
posterior encoder and the flows forward under the source speaker, then the
flows in reverse and the decoder under the target.

Where a kernel does not take a shape, the model takes the plain path,
chosen before the call by each kernel module's `supports`: the decoder's
banks (`mrf_fused.supports`), the WN stacks (`wn_stack.supports`) and MAS
(`mas.supports`, else `maximum_path_via_plain`).

`infer_latents` and `infer_pre_flow` run `infer` up to the decoder and up
to the flow reverse, for the streaming decoders (`infer/streaming.py`).

The decoder is the HiFi-GAN `Generator` (ResBlock1 or ResBlock2 banks) or,
with `decoder_type: mb_istft`, the `MultiBandISTFTGenerator`; the flows are
the plain VITS1 couplings (`use_transformer_flows=False`) or any of the
five VITS2 transformer flow types (`AVAILABLE_FLOW_TYPES`); SDP (both
directions) or the deterministic duration predictor; MAS
(`kernels/mas.py`); speaker conditioning; the int8 decoder
(`quantize_decoder`: W8A8 dynamic quantization of the decoder's wide
convolutions, inference only, on the kernels of `kernels/int8_conv.py`; the
HiFi-GAN stages it covers follow `pack_narrow_convs` as in the JAX
package, see `ops/hifigan.py`).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from torch_tts_tpu_torch.core.config import VITS2Config, VITS2ModelConfig
from torch_tts_tpu_torch.core.masks import generate_path, rand_slice_segments, sequence_mask
from torch_tts_tpu_torch.kernels import mas as mas_kernel
from torch_tts_tpu_torch.kernels.mas import maximum_path, maximum_path_via_plain
from torch_tts_tpu_torch.ops.convs import DDSConv
from torch_tts_tpu_torch.ops.flows import (ConvFlow, ElementwiseAffine, Flip, Log,
                                           ResidualCouplingLayer)
from torch_tts_tpu_torch.ops.hifigan import Generator
from torch_tts_tpu_torch.ops.layers import (Conv1d, Dropout, Embed, LayerNorm, init_params_,
                                            set_dropout_generator)
from torch_tts_tpu_torch.ops.mb_istft import MultiBandISTFTGenerator
from torch_tts_tpu_torch.ops.transformer import FFT, Encoder
from torch_tts_tpu_torch.ops.wavenet import WN

AVAILABLE_FLOW_TYPES = (
    "pre_conv",
    "pre_conv2",
    "fft",
    "mono_layer_inter_residual",
    "mono_layer_post_residual",
)


# `generator=DEFAULT_RNG` draws from torch's default generator of the
# device (seeded by `torch.manual_seed`), as an exported program does: a
# `torch.export` graph takes no generator, so it records plain `randn`s
DEFAULT_RNG = object()


def _normal(shape, like: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    if generator is None:
        raise ValueError("a torch.Generator (or the noise tensor) is required")
    if generator is DEFAULT_RNG:
        return torch.randn(shape, device=like.device, dtype=like.dtype)
    return torch.randn(shape, generator=generator, device=like.device, dtype=like.dtype)


def _channels_last(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else t.transpose(1, 2)


class TextEncoder(nn.Module):
    def __init__(self, n_vocab: int, out_channels: int, hidden_channels: int,
                 filter_channels: int, n_heads: int, n_layers: int, kernel_size: int,
                 p_dropout: float = 0.0, gin_channels: int = 0):
        super().__init__()
        self.hidden_channels = hidden_channels
        self.out_channels = out_channels
        self.emb = Embed(n_vocab, hidden_channels, init_std=hidden_channels ** -0.5)
        self.encoder = Encoder(hidden_channels, filter_channels, n_heads, n_layers, kernel_size,
                               p_dropout=p_dropout, gin_channels=gin_channels)
        self.proj = Conv1d(hidden_channels, out_channels * 2, 1)

    def forward(self, x: torch.Tensor, x_lengths: torch.Tensor, g=None):
        """ids [B, T], g [B, gin, 1] or None -> (hx [B, H, T], m, logs
        [B, D, T], x_mask [B, 1, T])."""
        emb = self.emb(x) * math.sqrt(self.hidden_channels)
        x_mask = sequence_mask(x_lengths, x.shape[1]).unsqueeze(1).to(emb.dtype)
        hx = self.encoder(emb.transpose(1, 2) * x_mask, x_mask, g=g)
        stats = self.proj(hx) * x_mask
        return hx, stats[:, :self.out_channels], stats[:, self.out_channels:], x_mask


class PosteriorEncoder(nn.Module):
    """1x1 pre -> WN -> (m, logs) -> z = m + eps * exp(logs)."""

    def __init__(self, in_channels: int, out_channels: int, hidden_channels: int,
                 kernel_size: int, dilation_rate: int, n_layers: int, gin_channels: int = 0):
        super().__init__()
        self.out_channels = out_channels
        self.pre = Conv1d(in_channels, hidden_channels, 1)
        self.enc = WN(hidden_channels, kernel_size, dilation_rate, n_layers,
                      gin_channels=gin_channels)
        self.proj = Conv1d(hidden_channels, out_channels * 2, 1)

    def forward(self, y, y_lengths, g=None, noise=None, generator=None):
        y_mask = sequence_mask(y_lengths, y.shape[2]).unsqueeze(1).to(y.dtype)
        h = self.enc(self.pre(y) * y_mask, y_mask, g=g)
        stats = self.proj(h) * y_mask
        m, logs = stats[:, :self.out_channels], stats[:, self.out_channels:]
        eps = noise if noise is not None else _normal(m.shape, m, generator)
        return (m + eps * torch.exp(logs)) * y_mask, m, logs, y_mask


def _mean_only_coupling(x0, x1, m, x_mask, reverse: bool):
    """x1 shifted by m (mean-only affine: logs = 0, so logdet 0)."""
    if not reverse:
        return (torch.cat([x0, (m + x1) * x_mask], dim=1),
                torch.zeros(x0.shape[0], dtype=x0.dtype, device=x0.device))
    return torch.cat([x0, (x1 - m) * x_mask], dim=1)


class ResidualCouplingTransformersLayer(nn.Module):
    """`pre_conv` coupling: a 2-layer transformer on x0 before the WN
    conditioner; mean-only affine on x1."""

    def __init__(self, channels: int, hidden_channels: int, kernel_size: int,
                 dilation_rate: int, n_layers: int, gin_channels: int = 0):
        super().__init__()
        self.half = channels // 2
        # p_dropout 0.1 is the reference's own, whatever the config says
        self.pre_transformer = Encoder(self.half, self.half, 2, 2, 3, window_size=None,
                                       p_dropout=0.1)
        # declared by the reference but never called; holds its checkpoint keys
        self.post_transformer = Encoder(hidden_channels, hidden_channels, 2, 2, 3,
                                        window_size=None)
        self.pre = Conv1d(self.half, hidden_channels, 1)
        self.enc = WN(hidden_channels, kernel_size, dilation_rate, n_layers,
                      gin_channels=gin_channels)
        self.post = Conv1d(hidden_channels, self.half, 1, zero_init=True)

    def forward(self, x, x_mask, g=None, reverse: bool = False):
        x0, x1 = x[:, :self.half], x[:, self.half:]
        x0_ = self.pre_transformer(x0 * x_mask, x_mask) + x0
        h = self.enc(self.pre(x0_) * x_mask, x_mask, g=g)
        return _mean_only_coupling(x0, x1, self.post(h) * x_mask, x_mask, reverse)


class ResidualCouplingTransformersLayer2(nn.Module):
    """`pre_conv2` coupling: a 1-layer windowed transformer added to the
    hidden stream between `pre` and the WN conditioner; mean-only."""

    def __init__(self, channels: int, hidden_channels: int, kernel_size: int,
                 dilation_rate: int, n_layers: int, gin_channels: int = 0):
        super().__init__()
        self.half = channels // 2
        self.pre = Conv1d(self.half, hidden_channels, 1)
        self.pre_transformer = Encoder(hidden_channels, hidden_channels, 2, 1, kernel_size)
        self.enc = WN(hidden_channels, kernel_size, dilation_rate, n_layers,
                      gin_channels=gin_channels)
        self.post = Conv1d(hidden_channels, self.half, 1, zero_init=True)

    def forward(self, x, x_mask, g=None, reverse: bool = False):
        x0, x1 = x[:, :self.half], x[:, self.half:]
        h = self.pre(x0) * x_mask
        h = h + self.pre_transformer(h * x_mask, x_mask)
        m = self.post(self.enc(h, x_mask, g=g)) * x_mask
        return _mean_only_coupling(x0, x1, m, x_mask, reverse)


class FFTransformerCouplingLayer(nn.Module):
    """`fft` coupling: a causal FFT block (`ops/transformer.FFT`, filter
    width 768) as the conditioner, added to `pre`'s output; mean-only."""

    def __init__(self, channels: int, hidden_channels: int, kernel_size: int, n_layers: int,
                 n_heads: int = 2, filter_channels: int = 768, gin_channels: int = 0):
        super().__init__()
        self.half = channels // 2
        self.pre = Conv1d(self.half, hidden_channels, 1)
        self.enc = FFT(hidden_channels, filter_channels, n_heads, n_layers, kernel_size,
                       gin_channels=gin_channels)
        self.post = Conv1d(hidden_channels, self.half, 1, zero_init=True)

    def forward(self, x, x_mask, g=None, reverse: bool = False):
        x0, x1 = x[:, :self.half], x[:, self.half:]
        h = self.pre(x0) * x_mask
        h = self.enc(h, x_mask, g=g) + h
        m = self.post(h) * x_mask
        return _mean_only_coupling(x0, x1, m, x_mask, reverse)


class MonoTransformerFlowLayer(nn.Module):
    """The mono-layer transformer flow: a 2-layer transformer on x0 and a
    zero-initialised 1x1 `post` shift x1 (mean-only). With
    `residual_connection` (VITS2 figure 1B) the forward adds its input,
    y = x + [x0, m + x1], with logdet sum(log(e^logs + 1)) + log 2 * half *
    T (T the padded length, as the JAX layer counts it); the reverse halves
    x0 first."""

    def __init__(self, channels: int, residual_connection: bool = False):
        super().__init__()
        self.half = channels // 2
        self.residual_connection = residual_connection
        # p_dropout 0.1 is the reference's own, whatever the config says
        self.pre_transformer = Encoder(self.half, self.half, 2, 2, 3, window_size=None,
                                       p_dropout=0.1)
        self.post = Conv1d(self.half, self.half, 1, zero_init=True)

    def forward(self, x, x_mask, g=None, reverse: bool = False):
        x0, x1 = x[:, :self.half], x[:, self.half:]
        if not self.residual_connection:
            m = self.post(self.pre_transformer(x0 * x_mask, x_mask) + x0) * x_mask
            return _mean_only_coupling(x0, x1, m, x_mask, reverse)
        if not reverse:
            m = self.post(self.pre_transformer(x0, x_mask)) * x_mask
            logs = torch.zeros_like(m)
            y = x + torch.cat([x0, (m + x1 * torch.exp(logs)) * x_mask], dim=1)
            logdet = torch.sum(torch.log(torch.exp(logs) + 1), dim=(1, 2))
            return y, logdet + math.log(2.0) * (self.half * x.shape[2])
        x0 = x0 / 2
        m = self.post(self.pre_transformer(x0, x_mask)) * x_mask
        # the inverse of x1' = m + 2 x1 (logs = 0)
        return torch.cat([x0, (x1 - m) / 2 * x_mask], dim=1)


class FlowBlock(nn.Module):
    """n_flows coupling steps: each a coupling and a channel flip (the
    plain mean-only VITS1 couplings with `use_transformer_flows=False`,
    else `pre_conv`, `pre_conv2` or `fft` couplings), or for the
    `mono_layer_*` types a plain coupling, a flip and a mono transformer
    flow. The plain couplings' WN stacks have a bounded receptive field
    (`StreamingFlowDecoder` relies on it); every transformer type attends
    over the whole sequence."""

    def __init__(self, channels: int, hidden_channels: int, kernel_size: int,
                 dilation_rate: int, n_layers: int, n_flows: int = 4,
                 use_transformer_flows: bool = True, transformer_flow_type: str = "pre_conv",
                 gin_channels: int = 0):
        super().__init__()
        t = transformer_flow_type if use_transformer_flows else None
        if t is not None and t not in AVAILABLE_FLOW_TYPES:
            raise ValueError(f"unknown transformer_flow_type {t!r}; one of {AVAILABLE_FLOW_TYPES}")
        args = (channels, hidden_channels, kernel_size, dilation_rate, n_layers)
        self.flows = nn.ModuleList()
        for _ in range(n_flows):
            if t == "pre_conv":
                self.flows.append(ResidualCouplingTransformersLayer(*args,
                                                                    gin_channels=gin_channels))
            elif t == "pre_conv2":
                self.flows.append(ResidualCouplingTransformersLayer2(*args,
                                                                     gin_channels=gin_channels))
            elif t == "fft":
                # the reference passes (dilation_rate, n_layers) into (n_layers,
                # n_heads): one FFT layer of n_layers heads, as the JAX package
                self.flows.append(FFTransformerCouplingLayer(
                    channels, hidden_channels, kernel_size, n_layers=dilation_rate,
                    n_heads=n_layers, gin_channels=gin_channels))
            else:
                self.flows.append(ResidualCouplingLayer(*args, gin_channels=gin_channels,
                                                        mean_only=True))
            self.flows.append(Flip())
            if t is not None and t.startswith("mono_layer_"):
                self.flows.append(MonoTransformerFlowLayer(
                    channels, residual_connection=t == "mono_layer_post_residual"))

    def forward(self, x, x_mask, g=None, reverse: bool = False):
        if not reverse:
            for flow in self.flows:
                x, _ = flow(x, x_mask, g=g)
            return x
        for flow in reversed(self.flows):
            x = flow(x, x_mask, g=g, reverse=True)
        return x


class StochasticDurationPredictor(nn.Module):
    """Spline-flow duration model: the NLL of given durations (training) or
    sampled log-durations (reverse)."""

    def __init__(self, in_channels: int, filter_channels: int, kernel_size: int,
                 n_flows: int = 4, p_dropout: float = 0.0, gin_channels: int = 0):
        super().__init__()
        fc = in_channels  # the reference overrides filter_channels
        self.log_flow = Log()
        self.flows = nn.ModuleList([ElementwiseAffine(2)])
        for _ in range(n_flows):
            self.flows.extend([ConvFlow(2, fc, kernel_size, n_layers=3), Flip()])
        self.post_pre = Conv1d(1, fc, 1)
        self.post_proj = Conv1d(fc, fc, 1)
        self.post_convs = DDSConv(fc, kernel_size, n_layers=3, p_dropout=p_dropout)
        self.post_flows = nn.ModuleList([ElementwiseAffine(2)])
        for _ in range(4):
            self.post_flows.extend([ConvFlow(2, fc, kernel_size, n_layers=3), Flip()])
        self.pre = Conv1d(in_channels, fc, 1)
        self.proj = Conv1d(fc, fc, 1)
        self.convs = DDSConv(fc, kernel_size, n_layers=3, p_dropout=p_dropout)
        if gin_channels > 0:
            self.cond = Conv1d(gin_channels, fc, 1)

    def forward(self, x, x_mask, w=None, g=None, reverse: bool = False,
                noise_scale: float = 1.0, noise=None, generator=None):
        """hx [B, H, T] and g [B, gin, 1] or None (no gradient flows back
        into either). Forward: durations w [B, 1, T] -> NLL [B]; noise is
        e_q [B, 2, T]. Reverse: -> logw [B, 1, T]; noise [B, 2, T]. Noise
        not given is drawn from `generator`."""
        x = self.pre(x.detach())
        if g is not None:
            x = x + self.cond(g.detach())
        x = self.proj(self.convs(x, x_mask)) * x_mask
        if not reverse:
            return self._nll(x, x_mask, w, noise, generator)
        flows = list(reversed(self.flows))
        flows = flows[:-2] + [flows[-1]]  # drop the vestigial extra flow
        if noise is None:
            noise = _normal((x.shape[0], 2, x.shape[2]), x, generator)
        z = noise * noise_scale
        for flow in flows:
            z = flow(z, x_mask, g=x, reverse=True)
        return z[:, 0:1]

    def _nll(self, x, x_mask, w, e_q, generator):
        """Variational dequantisation of w through the posterior flows, then
        the NLL of (log(w - u), z1) under the main flows (JAX model.py:453-489)."""
        h_w = self.post_proj(self.post_convs(self.post_pre(w), x_mask)) * x_mask
        if e_q is None:
            e_q = _normal((w.shape[0], 2, w.shape[2]), x, generator)
        e_q = e_q * x_mask
        z_q, logdet_tot_q = e_q, 0.0
        for flow in self.post_flows:
            z_q, logdet_q = flow(z_q, x_mask, g=x + h_w)
            logdet_tot_q = logdet_tot_q + logdet_q
        z_u, z1 = z_q[:, 0:1], z_q[:, 1:2]
        u = torch.sigmoid(z_u) * x_mask
        z0 = (w - u) * x_mask
        logdet_tot_q = logdet_tot_q + torch.sum(
            (F.logsigmoid(z_u) + F.logsigmoid(-z_u)) * x_mask, dim=(1, 2))
        logq = torch.sum(-0.5 * (math.log(2 * math.pi) + e_q ** 2) * x_mask,
                         dim=(1, 2)) - logdet_tot_q
        z0, logdet_tot = self.log_flow(z0, x_mask)
        z = torch.cat([z0, z1], dim=1)
        for flow in self.flows:
            z, logdet = flow(z, x_mask, g=x)
            logdet_tot = logdet_tot + logdet
        nll = torch.sum(0.5 * (math.log(2 * math.pi) + z ** 2) * x_mask, dim=(1, 2)) - logdet_tot
        return nll + logq


class DurationPredictor(nn.Module):
    def __init__(self, in_channels: int, filter_channels: int, kernel_size: int,
                 p_dropout: float = 0.0, gin_channels: int = 0):
        super().__init__()
        self.drop = Dropout(p_dropout)
        self.conv_1 = Conv1d(in_channels, filter_channels, kernel_size, padding=kernel_size // 2)
        self.norm_1 = LayerNorm(filter_channels)
        self.conv_2 = Conv1d(filter_channels, filter_channels, kernel_size,
                             padding=kernel_size // 2)
        self.norm_2 = LayerNorm(filter_channels)
        self.proj = Conv1d(filter_channels, 1, 1)
        if gin_channels > 0:
            self.cond = Conv1d(gin_channels, in_channels, 1)

    def forward(self, x, x_mask, g=None):
        """hx [B, H, T] and g [B, gin, 1] or None (no gradient flows back
        into either) -> logw [B, 1, T]."""
        x = x.detach()
        if g is not None:
            x = x + self.cond(g.detach())
        x = self.drop(self.norm_1(torch.relu(self.conv_1(x * x_mask))))
        x = self.drop(self.norm_2(torch.relu(self.conv_2(x * x_mask))))
        return self.proj(x * x_mask) * x_mask


class SynthesizerTrn(nn.Module):
    _PATCH_WINDOW = 128  # frames; >= 2x the decoder's receptive-field half-width

    def __init__(self, n_vocab: int, spec_channels: int, cfg: VITS2ModelConfig,
                 segment_frames: int = 32):
        super().__init__()
        c = cfg
        self.segment_frames = segment_frames
        if c.decoder_type not in ("hifigan", "mb_istft"):
            raise ValueError(f"unknown decoder_type {c.decoder_type!r}")
        self.cfg = cfg
        gin = c.gin_channels
        self.enc_p = TextEncoder(n_vocab, c.inter_channels, c.hidden_channels,
                                 c.filter_channels, c.n_heads, c.n_layers, c.kernel_size,
                                 p_dropout=c.p_dropout,
                                 gin_channels=gin if c.use_spk_conditioned_encoder else 0)
        dec_args = (c.inter_channels, c.resblock, c.resblock_kernel_sizes,
                    c.resblock_dilation_sizes, c.upsample_rates, c.upsample_initial_channel,
                    c.upsample_kernel_sizes)
        if c.decoder_type == "mb_istft":
            self.dec = MultiBandISTFTGenerator(*dec_args, subbands=c.subbands,
                                               istft_n_fft=c.gen_istft_n_fft,
                                               istft_hop=c.gen_istft_hop_size,
                                               fuse_mrf=c.fuse_mrf, gin_channels=gin,
                                               quant_int8=c.quantize_decoder)
        else:
            self.dec = Generator(*dec_args, fuse_mrf=c.fuse_mrf, gin_channels=gin,
                                 quant_int8=c.quantize_decoder,
                                 pack_narrow=c.pack_narrow_convs)
        self.enc_q = PosteriorEncoder(spec_channels, c.inter_channels, c.hidden_channels,
                                      5, 1, c.posterior_wn_layers, gin_channels=gin)
        self.flow = FlowBlock(c.inter_channels, c.hidden_channels, 5, 1, 4,
                              n_flows=c.flow_n_flows,
                              use_transformer_flows=c.use_transformer_flows,
                              transformer_flow_type=c.transformer_flow_type, gin_channels=gin)
        if c.use_sdp:
            self.dp = StochasticDurationPredictor(c.hidden_channels, 192, 3, 4,
                                                  p_dropout=c.dp_dropout, gin_channels=gin)
        else:
            self.dp = DurationPredictor(c.hidden_channels, 256, 3, p_dropout=c.dp_dropout,
                                        gin_channels=gin)
        if c.n_speakers > 1:
            self.emb_g = Embed(c.n_speakers, gin)

    def _speaker(self, sid: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """Speaker ids [B] -> g [B, gin, 1]; None for a single-speaker model
        or no ids."""
        if sid is None or self.cfg.n_speakers <= 1:
            return None
        return self.emb_g(sid).unsqueeze(2)

    def forward(self, x, x_lengths, y, y_lengths, sid=None, mas_noise_scale=None,
                generator: Optional[torch.Generator] = None,
                eps: Optional[torch.Tensor] = None, mas_noise: Optional[torch.Tensor] = None,
                sdp_noise_q: Optional[torch.Tensor] = None,
                sdp_noise: Optional[torch.Tensor] = None,
                ids_slice: Optional[torch.Tensor] = None):
        """Training forward (JAX `__call__`). ids [B, T_x]; y [B, T_y,
        spec_channels] (channels-last, as the JAX batch); sid [B] speaker
        ids or None. Returns
        (o [B, segment_frames*hop, 1], l_length [B], attn [B, T_y, T_x],
        ids_slice [B], x_mask [B, T_x, 1], y_mask [B, T_y, 1],
        (z, z_p, m_p_e, logs_p_e, m_q, logs_q) each [B, T_y, D],
        (hx [B, T_x, H], logw, logw_ [B, T_x, 1])).

        Random draws, each injectable (port layout) or drawn from
        `generator` on the model's device: posterior eps [B, D, T_y], MAS
        noise [B, T_y, T_x] (scaled by std(neg_cent) * mas_noise_scale;
        none when mas_noise_scale is None), SDP e_q [B, 2, T_x], SDP reverse
        noise [B, 2, T_x], segment starts ids_slice [B]. In training mode the
        dropout masks come from `generator` too."""
        set_dropout_generator(self, generator)
        g = self._speaker(sid)
        hx, m_p, logs_p, x_mask = self.enc_p(x, x_lengths, g=g)
        z, m_q, logs_q, y_mask = self.enc_q(y.transpose(1, 2), y_lengths, g=g, noise=eps,
                                            generator=generator)
        z_p = self.flow(z, y_mask, g=g)

        with torch.no_grad():  # MAS sees no gradient (JAX model.py:633-653)
            s_p_sq_r = torch.exp(-2 * logs_p)  # [B, D, T_x]
            neg_cent1 = torch.sum(-0.5 * math.log(2 * math.pi) - logs_p, dim=1)  # [B, T_x]
            zt = z_p.transpose(1, 2)  # [B, T_y, D]
            neg_cent2 = torch.matmul(-0.5 * zt ** 2, s_p_sq_r)
            neg_cent3 = torch.matmul(zt, m_p * s_p_sq_r)
            neg_cent4 = torch.sum(-0.5 * m_p ** 2 * s_p_sq_r, dim=1)  # [B, T_x]
            neg_cent = neg_cent2 + neg_cent3 + neg_cent1[:, None, :] + neg_cent4[:, None, :]
            if mas_noise_scale is not None:
                if mas_noise is None:
                    mas_noise = _normal(neg_cent.shape, neg_cent, generator)
                # population std over the whole tensor, as jnp.std; the noise is
                # fp32, as JAX's scale (an fp32 array in its step) makes it
                neg_cent = neg_cent + (torch.std(neg_cent, correction=0) * mas_noise).float() \
                    * mas_noise_scale
            attn_mask = y_mask.transpose(1, 2) * x_mask  # [B, T_y, T_x]
            # the kernel where it takes the shape, else the plain version
            mas = (maximum_path if mas_kernel.supports(*attn_mask.shape[1:])
                   else maximum_path_via_plain)
            attn = mas(neg_cent, attn_mask)

        w = attn.sum(dim=1, keepdim=True)  # [B, 1, T_x]
        logw_ = torch.log(w + 1e-6) * x_mask
        if self.cfg.use_sdp:
            l_length = self.dp(hx, x_mask, w=w, g=g, noise=sdp_noise_q, generator=generator)
            l_length = l_length / torch.sum(x_mask)
            logw = self.dp(hx, x_mask, g=g, reverse=True, noise_scale=1.0, noise=sdp_noise,
                           generator=generator)
        else:
            logw = self.dp(hx, x_mask, g=g)
            l_length = torch.sum((logw - logw_) ** 2, dim=(1, 2)) / torch.sum(x_mask)

        at = attn.transpose(1, 2)  # [B, T_x, T_y]
        m_p_e, logs_p_e = torch.matmul(m_p, at), torch.matmul(logs_p, at)  # [B, D, T_y]
        z_slice, ids_slice = rand_slice_segments(z, y_lengths, self.segment_frames,
                                                 generator=generator, ids=ids_slice, dim=2)
        o = self.dec(z_slice, g=g)
        cl = lambda t: t.transpose(1, 2)  # noqa: E731 - [B, C, T] -> [B, T, C]
        return (cl(o), l_length, attn, ids_slice, cl(x_mask), cl(y_mask),
                tuple(map(cl, (z, z_p, m_p_e, logs_p_e, m_q, logs_q))),
                (cl(hx), cl(logw), cl(logw_)))

    def _prior(self, x, x_lengths, sid, noise_scale: float, length_scale: float,
               noise_scale_w: float, max_frames: int, generator, sdp_noise, prior_noise):
        """The shared prefix of `infer`, `infer_latents` and `infer_pre_flow`:
        text encoder, durations, alignment and the prior's sample, drawing
        the SDP's noise first and then the prior's. -> (z_p, m_p_e,
        logs_p_e [B, D, T_y], g, y_mask [B, 1, T_y], attn, y_lengths)."""
        g = self._speaker(sid)
        hx, m_p, logs_p, x_mask = self.enc_p(x, x_lengths, g=g)
        if self.cfg.use_sdp:
            logw = self.dp(hx, x_mask, g=g, reverse=True, noise_scale=noise_scale_w,
                           noise=sdp_noise, generator=generator)
        else:
            logw = self.dp(hx, x_mask, g=g)
        w_ceil = torch.ceil(torch.exp(logw) * x_mask * length_scale)
        y_lengths = torch.clamp(torch.sum(w_ceil, dim=(1, 2)), min=1.0).to(torch.int32)
        y_lengths = torch.clamp(y_lengths, max=max_frames)
        y_mask = sequence_mask(y_lengths, max_frames).unsqueeze(1).to(x_mask.dtype)
        attn = generate_path(w_ceil[:, 0], max_frames) * (y_mask.transpose(1, 2) * x_mask)

        at = attn.transpose(1, 2)
        m_p_e, logs_p_e = torch.matmul(m_p, at), torch.matmul(logs_p, at)  # [B, D, T_y]
        if prior_noise is None:
            prior_noise = _normal(m_p_e.shape, m_p_e, generator)
        z_p = m_p_e + prior_noise * torch.exp(logs_p_e) * noise_scale
        return z_p, m_p_e, logs_p_e, g, y_mask, attn, y_lengths

    @torch.inference_mode()
    def infer(self, x, x_lengths, sid=None, noise_scale: float = 1.0, length_scale: float = 1.0,
              noise_scale_w: float = 1.0, max_frames: int = 1000,
              generator: Optional[torch.Generator] = None,
              sdp_noise: Optional[torch.Tensor] = None,
              prior_noise: Optional[torch.Tensor] = None):
        """ids [B, T_x], sid [B] speaker ids or None -> (audio [B,
        max_frames*hop, 1], attn [B, T_y, T_x], y_mask [B, T_y, 1], (z, z_p,
        m_p_e, logs_p_e) each [B, T_y, D], y_lengths [B]). Noise: sdp_noise
        [B, 2, T_x] and prior_noise [B, D, T_y], or drawn from `generator`
        on the model's device (`DEFAULT_RNG`: the default generator). The
        scales may be floats or 0-d tensors."""
        return self.infer_body(x, x_lengths, sid, noise_scale, length_scale, noise_scale_w,
                               max_frames, generator, sdp_noise, prior_noise)

    def infer_body(self, x, x_lengths, sid=None, noise_scale: float = 1.0,
                   length_scale: float = 1.0, noise_scale_w: float = 1.0,
                   max_frames: int = 1000, generator: Optional[torch.Generator] = None,
                   sdp_noise: Optional[torch.Tensor] = None,
                   prior_noise: Optional[torch.Tensor] = None):
        """`infer` outside inference mode, for `torch.export` (which refuses
        inference tensors; `infer/export.py` traces it under no_grad)."""
        z_p, m_p_e, logs_p_e, g, y_mask, attn, y_lengths = self._prior(
            x, x_lengths, sid, noise_scale, length_scale, noise_scale_w, max_frames,
            generator, sdp_noise, prior_noise)
        z = self.flow(z_p, y_mask, g=g, reverse=True)
        o = self._decode_padded(z * y_mask, y_mask, y_lengths, max_frames, g=g)
        aux = tuple(t.transpose(1, 2) for t in (z, z_p, m_p_e, logs_p_e))
        return o.transpose(1, 2), attn, y_mask.transpose(1, 2), aux, y_lengths

    @torch.inference_mode()
    def infer_latents(self, x, x_lengths, sid=None, noise_scale: float = 1.0,
                      length_scale: float = 1.0, noise_scale_w: float = 1.0,
                      max_frames: int = 1000, generator: Optional[torch.Generator] = None,
                      sdp_noise: Optional[torch.Tensor] = None,
                      prior_noise: Optional[torch.Tensor] = None):
        """`infer` up to, not including, the decoder, for streaming
        (`infer/streaming.StreamingDecoder`): -> (z * y_mask [B, max_frames,
        D], g [B, 1, gin] or None, y_mask [B, max_frames, 1], y_lengths [B]),
        channels-last as `infer` returns. The same arguments, and with the
        same generator the same draws in the same order, as `infer`; so
        `dec(z * y_mask, g=g, x_mask=y_mask)`, its samples past y_lengths
        zeroed, reproduces `infer`'s audio (JAX `infer_latents`)."""
        z_p, _, _, g, y_mask, _, y_lengths = self._prior(
            x, x_lengths, sid, noise_scale, length_scale, noise_scale_w, max_frames,
            generator, sdp_noise, prior_noise)
        z = self.flow(z_p, y_mask, g=g, reverse=True)
        return (z * y_mask).transpose(1, 2), _channels_last(g), y_mask.transpose(1, 2), y_lengths

    @torch.inference_mode()
    def infer_pre_flow(self, x, x_lengths, sid=None, noise_scale: float = 1.0,
                       length_scale: float = 1.0, noise_scale_w: float = 1.0,
                       max_frames: int = 1000, generator: Optional[torch.Generator] = None,
                       sdp_noise: Optional[torch.Tensor] = None,
                       prior_noise: Optional[torch.Tensor] = None):
        """`infer` up to, not including, the flow reverse, for streaming the
        flow and the decoder together (`infer/streaming.StreamingFlowDecoder`)
        when the flows are conv-local (plain couplings): -> (z_p [B,
        max_frames, D], g [B, 1, gin] or None, y_mask [B, max_frames, 1],
        y_lengths [B]), channels-last. The same draws as `infer`;
        `dec(flow(z_p, y_mask, reverse=True) * y_mask, g=g)` reproduces
        `infer`'s audio (JAX `infer_pre_flow`)."""
        z_p, _, _, g, y_mask, _, y_lengths = self._prior(
            x, x_lengths, sid, noise_scale, length_scale, noise_scale_w, max_frames,
            generator, sdp_noise, prior_noise)
        return z_p.transpose(1, 2), _channels_last(g), y_mask.transpose(1, 2), y_lengths

    @torch.inference_mode()
    def voice_conversion(self, y, y_lengths, sid_src, sid_tgt,
                         generator: Optional[torch.Generator] = None,
                         eps: Optional[torch.Tensor] = None):
        """Speaker swap by the flow round trip (JAX `voice_conversion`):
        y [B, T_y, spec_channels] (channels-last) of speakers sid_src [B] ->
        (o_hat [B, T_y*hop, 1] in the speakers sid_tgt [B], y_mask
        [B, T_y, 1], (z, z_p, z_hat) each [B, T_y, D]). The posterior's
        noise eps [B, D, T_y], or drawn from `generator`. The decode is
        masked as the JAX model's; where every item fills T_y, the mask is
        all ones and the decode runs unmasked, with the same values, so the
        decoder's banks can take their kernel."""
        if self.cfg.n_speakers <= 1:
            raise ValueError("voice conversion needs a multi-speaker model")
        g_src, g_tgt = self._speaker(sid_src), self._speaker(sid_tgt)
        z, _, _, y_mask = self.enc_q(y.transpose(1, 2), y_lengths, g=g_src, noise=eps,
                                     generator=generator)
        z_p = self.flow(z, y_mask, g=g_src)
        z_hat = self.flow(z_p, y_mask, g=g_tgt, reverse=True)
        full = bool((y_lengths == y.shape[1]).all())
        o_hat = self.dec(z_hat * y_mask, x_mask=None if full else y_mask, g=g_tgt)
        cl = lambda t: t.transpose(1, 2)  # noqa: E731 - [B, C, T] -> [B, T, C]
        return cl(o_hat), cl(y_mask), (cl(z), cl(z_p), cl(z_hat))

    def _decode_padded(self, zm, y_mask, y_lengths, max_frames: int, g=None):
        """Decode padded latents with exact-length semantics: the bulk is
        decoded unmasked, one masked window of _PATCH_WINDOW frames ending
        at each item's length is decoded again and its last half pasted
        over the bulk, then samples past the length are zeroed. With the fp
        decoder, the same values as a fully masked decode, at the cost of
        one small window. With the int8 decoder each of the two decodes
        quantizes its activations with its own per-tensor scales (the bulk's
        span the padded tail and the whole batch), so the result is JAX's
        for the same batch and max_frames, not a fully masked decode's."""
        T, W = max_frames, self._PATCH_WINDOW
        if T <= W:
            o = self.dec(zm, x_mask=y_mask, g=g)
            return o * torch.repeat_interleave(y_mask, o.shape[2] // T, dim=2)
        keep = W // 2
        o_bulk = self.dec(zm, g=g)
        f = o_bulk.shape[2] // T
        B, C, _ = zm.shape
        yl = y_lengths.to(torch.int64)
        ar_w = torch.arange(W, device=zm.device)
        starts = torch.clamp(yl - W, 0, T - W)
        zwin = torch.gather(zm, 2, (starts[:, None] + ar_w)[:, None, :].expand(B, C, W))
        win_mask = (ar_w[None, :] < (yl - starts)[:, None]).to(zm.dtype)[:, None, :]
        o_win = self.dec(zwin * win_mask, x_mask=win_mask, g=g)
        paste_start = torch.clamp(yl - keep, 0, T - keep)
        ar_k = torch.arange(keep * f, device=zm.device)
        o_keep = torch.gather(o_win, 2, ((paste_start - starts) * f)[:, None, None] + ar_k)
        o = o_bulk.scatter(2, (paste_start * f)[:, None, None] + ar_k, o_keep)
        return o * torch.repeat_interleave(y_mask, f, dim=2)


def build_synthesizer(cfg: VITS2Config, n_vocab: int, seed: int = 0,
                      device="cuda") -> SynthesizerTrn:
    """SynthesizerTrn for `cfg`, initialised from torch.Generator(seed) in
    module order (torch-default bounds, zero-init projections as the
    reference), moved to `device` (the card unless the caller says
    otherwise), in eval mode."""
    cfg.check()
    model = SynthesizerTrn(n_vocab, cfg.posterior_channels, cfg.model, cfg.segment_frames)
    init_params_(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()
