"""Standalone mel -> waveform HiFi-GAN vocoder training (port of
`torch_tts_tpu/train/vocoder_train.py`).

The `ops/hifigan.py` Generator learns to invert the Tacotron frontend's mel
(`audio/frontend.py`, m_fwd network domain, renormed with the vocoder's
affine), with the HiFi-GAN recipe: the MPD's adversarial and
feature-matching losses plus an L1 mel loss (the VITS2 step's losses,
`models/vits2/losses.py`), or recon-only (L1 mel + L1 wave) to bootstrap.

`vocoder_train_step` follows the JAX `make_vocoder_train_step`: with an
MPD, the D step on (real, y_hat.detach()), then the G step through the
*updated* D; the generator forward runs once and its graph serves the G
step (JAX recomputes it with the same parameters: the same values). The
mel of y_hat is framed from the segment (centre=True gives T + 1 frames
for T * hop samples) and trimmed to the target's T frames.

Optimizers: AdamW(b1 0.8, b2 0.99, weight decay 0.01) on a smooth
exponential decay of the learning rate by `lr_decay` every 1000 updates,
as `cli/vocoder_train.py` of the JAX package builds them. Training keeps
the plain convolutions: the MRF kernel has no backward, so the generator
is built with `fuse_mrf=False` (the artifact's loads with it on).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from torch_tts_tpu_torch.audio.frontend import AudioFrontend, amplitude_to_db, m_fwd
from torch_tts_tpu_torch.infer.vocoder import build_generator
from torch_tts_tpu_torch.models.vits2.discriminators import MultiPeriodDiscriminator
from torch_tts_tpu_torch.models.vits2.losses import discriminator_loss, feature_loss, generator_loss
from torch_tts_tpu_torch.ops.hifigan import Generator
from torch_tts_tpu_torch.ops.layers import init_params_
from torch_tts_tpu_torch.train.vits2_train import AdamW

BETAS, EPS, WEIGHT_DECAY, DECAY_STEPS = (0.8, 0.99), 1e-8, 0.01, 1000


@dataclasses.dataclass
class VocoderTrainState:
    """The names `train/checkpoint.py` saves and restores."""

    step: int
    model: Generator
    opt_g: AdamW
    mpd: Optional[MultiPeriodDiscriminator] = None
    opt_d: Optional[AdamW] = None


def make_mel_fn(fe: AudioFrontend) -> Callable[[torch.Tensor], torch.Tensor]:
    """wav [B, L] -> mel_net [B, T, M] with the Tacotron frontend's chain
    (window-normalised power STFT, mel, dB, m_fwd); differentiable."""
    fb = fe._mel_fb

    def mel_fn(wav):
        return m_fwd(amplitude_to_db(fe._stft_power(wav) @ fb.t()))

    return mel_fn


def make_optimizer(named, learning_rate: float, lr_decay: float) -> AdamW:
    names, params = zip(*named)
    return AdamW(params, learning_rate, BETAS, EPS, lr_decay, DECAY_STEPS,
                 weight_decay=WEIGHT_DECAY, names=names, staircase=False)


def create_vocoder_state(gen_kwargs, num_mels: int, learning_rate: float = 2e-4,
                         lr_decay: float = 0.999, gan: bool = True, seed: int = 0,
                         device="cuda") -> VocoderTrainState:
    """A seeded generator (and MPD with `gan`) with their optimizers, on
    `device` (the card unless the caller says otherwise)."""
    gen = build_generator(gen_kwargs, num_mels, fuse_mrf=False)
    init_params_(gen, torch.Generator().manual_seed(seed))
    gen.to(device)
    state = VocoderTrainState(0, gen, make_optimizer(gen.named_parameters(), learning_rate,
                                                     lr_decay))
    if gan:
        mpd = MultiPeriodDiscriminator()
        init_params_(mpd, torch.Generator().manual_seed(seed + 1))
        state.mpd = mpd.to(device)
        state.opt_d = make_optimizer(mpd.named_parameters(), learning_rate, lr_decay)
    return state


def _grads(loss: torch.Tensor, params) -> list:
    return [torch.zeros_like(p) if g is None else g for p, g in zip(
        params, torch.autograd.grad(loss, params, allow_unused=True))]


def vocoder_train_step(state: VocoderTrainState, batch: Dict[str, torch.Tensor], mel_fn, *,
                       mel_shift: float, mel_scale: float, c_mel: float = 45.0,
                       c_wav: float = 0.0) -> Dict[str, float]:
    """One step on batch {"wav": [B, L] target segments, "mel": [B, T, M]
    their network-domain mels, T * hop == L}; updates `state` in place and
    returns the JAX step's metrics as floats."""
    dev = next(state.model.parameters()).device
    wav, mel = batch["wav"].to(dev), batch["mel"].to(dev)
    y = wav[:, None]  # [B, 1, L]
    y_hat = state.model(((mel - mel_shift) / mel_scale).transpose(1, 2))  # [B, 1, L]
    metrics: Dict[str, torch.Tensor] = {}
    if state.mpd is not None:
        y_d_r, y_d_g, _, _ = state.mpd(y, y_hat.detach())
        loss_disc, _, _ = discriminator_loss(y_d_r, y_d_g)
        state.opt_d.step(_grads(loss_disc, state.opt_d.params))
        metrics["loss/d/total"] = loss_disc.detach()

    loss_mel = c_mel * torch.mean(torch.abs(mel_fn(y_hat[:, 0])[:, :mel.shape[1]] - mel))
    loss = loss_mel
    metrics["loss/g/mel"] = loss_mel.detach()
    if c_wav:
        loss_wav = c_wav * torch.mean(torch.abs(y_hat - y))
        loss = loss + loss_wav
        metrics["loss/g/wav"] = loss_wav.detach()
    if state.mpd is not None:
        _, y_d_g, fmap_r, fmap_g = state.mpd(y, y_hat)
        loss_fm = feature_loss(fmap_r, fmap_g)
        loss_gen, _ = generator_loss(y_d_g)
        loss = loss + loss_fm + loss_gen
        metrics["loss/g/fm"], metrics["loss/g/gen"] = loss_fm.detach(), loss_gen.detach()
    metrics["loss/g/total"] = loss.detach()
    state.opt_g.step(_grads(loss, state.opt_g.params))
    state.step += 1
    return {k: float(v) for k, v in metrics.items()}
