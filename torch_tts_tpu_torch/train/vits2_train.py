"""VITS2 GAN training steps (port of `torch_tts_tpu/train/vits2_train.py`).

Two step orders, as the JAX package's `make_train_step`:

- `ddp` (the reference's train.py):
  1. the generator forward in training mode (MAS, SDP, a random segment
     through the HiFi-GAN decoder), once, with gradients;
  2. the discriminator step on (real slice, y_hat.detach());
  3. with a duration discriminator, its step on the detached
     (hx, x_mask, logw_, logw);
  4. the generator step through the *updated* discriminators, with
     loss = gen + fm + c_mel * mel_l1 + dur + c_kl * kl (+ the duration
     discriminator's generator loss).
- `lightning` (the reference's cli.py): one generator forward; G updates
  first, against the *current* discriminators, with the gen and disc losses
  the mean over sub-discriminators and the total normalised by
  1 + c_fm + c_dur + c_kl + c_mel (the duration-discriminator term added
  after the normalisation); then D, and the duration discriminator, train
  on the detached outputs of that one forward.

JAX recomputes the generator forward for the `ddp` G step with the same
parameters and noise, which gives the same values as reusing the first
forward's graph; the reference reuses it too. Each network's gradient is
taken with `torch.autograd.grad` over its own parameters only.

The optimizer is `optax.adamw` with per-epoch staircase exponential decay,
written out functionally (`AdamW`): betas and eps from the config,
weight_decay 0.01, the decay counted in optimizer updates. `grad_accum = k
> 1` is `optax.MultiSteps`: each optimizer averages k micro-gradients
(optax's running mean) before one update, and its count and schedule
advance once per update (`transition_steps = steps_per_epoch // k`). A
non-finite loss or gradient (`skip_nonfinite`) zeroes the gradients: the
moments decay once and the counts advance, as in the JAX
`_guarded_update`, but the parameters stay bit-identical; under
accumulation the zero joins the window's mean, and on the window's last
micro-step that update is dropped too. `state.step` (the MAS noise's
schedule) advances when every network's step was finite, per micro-step.

A multi-speaker config (`n_speakers > 1`) takes the batch's `sid`
through the training forward, as the JAX step does; its gradient reaches
`emb_g` through the text encoder's `spk_emb_linear`, every WN
`cond_layer` (`d_gl` of the WN kernels) and the decoder's `cond`, not
through the duration predictor (g is detached there).

`train.use_bf16` is the JAX step's `_cast`: every forward (the
generator's, the MPD's, the duration discriminator's) runs on a bf16 copy
of its network's fp32 master parameters, taken inside the autograd graph
once per forward (`forward_as`, through `torch.func.functional_call`), so
that the gradients reach the fp32 masters through the cast. `spec` and the
real wav slice go in as bf16, as JAX casts them; the mel target comes from
the fp32 `spec`, the prediction's mel from y_hat cast to fp32. From there
the dtypes follow the activations as in JAX (the port's layers cast
their weights to their input's dtype, the losses cast to fp32). The
gradients, `global_norm`, `skip_nonfinite`, AdamW and `grad_accum` act on
fp32 masters; in the `ddp` order the generator's step goes through a bf16
copy of the *updated* discriminators. `eval_step` stays fp32, as JAX's
`make_eval_step` does.

Not ported (raises NotImplementedError): spectral norm.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from torch_tts_tpu_torch.audio import mel as melmod
from torch_tts_tpu_torch.core.config import VITS2Config
from torch_tts_tpu_torch.core.masks import slice_segments
from torch_tts_tpu_torch.models.vits2.discriminators import (MultiPeriodDiscriminator,
                                                             build_duration_discriminator)
from torch_tts_tpu_torch.models.vits2.losses import (discriminator_loss, feature_loss,
                                                     generator_loss, kl_loss)
from torch_tts_tpu_torch.models.vits2.model import SynthesizerTrn
from torch_tts_tpu_torch.ops.layers import init_params_


def check_supported(cfg: VITS2Config):
    """Raise on the training options this port does not run."""
    t, m = cfg.train, cfg.model
    if t.step_order not in ("ddp", "lightning"):
        raise ValueError(f"unknown step_order {t.step_order!r}")
    if t.grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {t.grad_accum}")
    if m.use_spectral_norm:
        raise NotImplementedError("spectral norm is not ported")
    if m.quantize_decoder:
        raise ValueError("quantize_decoder is an inference-only mode (a rounded activation "
                         "passes no gradient; the JAX package never trains it): train with it "
                         "off and set it for inference")


def forward_as(cfg: VITS2Config, module: torch.nn.Module, *args, **kwargs):
    """module(*args, **kwargs); under `train.use_bf16` on a bf16 copy of its
    fp32 parameters (the JAX step's `_cast`), made here once for this call,
    differentiably, so that the gradients reach the fp32 masters."""
    if not cfg.train.use_bf16:
        return module(*args, **kwargs)
    params = {n: p.to(torch.bfloat16) if p.dtype == torch.float32 else p
              for n, p in module.named_parameters()}
    return torch.func.functional_call(module, params, args, kwargs)


def _bf16_input(cfg: VITS2Config, t: torch.Tensor) -> torch.Tensor:
    """An fp32 input cast to bf16 under `train.use_bf16` (JAX `_cast`)."""
    return t.to(torch.bfloat16) if cfg.train.use_bf16 and t.dtype == torch.float32 else t


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(t)) for t in tensors))


class AdamW:
    """optax.adamw(exponential_decay(lr, steps_per_epoch, lr_decay,
    staircase), b1, b2, eps, weight_decay), in optax's order of
    operations, over a fixed list of parameters (updated in place); with
    accum = k > 1, wrapped as optax.MultiSteps(every_k_schedule=k).
    `names` keys the moments in `state_dict` (indices when not given).
    The VITS2 step's schedule is a staircase; the vocoder's is smooth.
    clip_norm: optax.clip_by_global_norm(clip_norm) chained before adamw
    (inside MultiSteps, so on the window's mean gradient): g / |g| *
    clip_norm when |g| >= clip_norm (the Tacotron step's 1.0)."""

    def __init__(self, params: Sequence[torch.nn.Parameter], learning_rate: float,
                 betas, eps: float, lr_decay: float, steps_per_epoch: int,
                 weight_decay: float = 0.01, accum: int = 1,
                 names: Optional[Sequence[str]] = None, staircase: bool = True,
                 clip_norm: Optional[float] = None):
        self.params = list(params)
        self.names = list(names) if names is not None else [str(i) for i in range(len(self.params))]
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0  # updates taken (the schedule's and Adam's count)
        self.learning_rate, self.lr_decay = learning_rate, lr_decay
        self.steps_per_epoch = max(1, steps_per_epoch)
        self.staircase = staircase
        self.b1, self.b2 = float(betas[0]), float(betas[1])
        self.eps, self.weight_decay = eps, weight_decay
        self.clip_norm = clip_norm
        self.accum = max(1, int(accum))
        self.mini_step = 0  # micro-steps in the open window
        self.acc = [torch.zeros_like(p) for p in self.params] if self.accum > 1 else []

    def lr(self) -> float:
        n = self.count / self.steps_per_epoch
        return self.learning_rate * self.lr_decay ** (int(n) if self.staircase else n)

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor], apply: bool = True):
        """One micro-step from `grads`. Without accumulation, or on a
        window's last micro-step, an update; apply=False advances the
        moments and the counts but leaves the parameters as they are."""
        if self.accum > 1:
            # optax.MultiSteps' running mean: acc + (g - acc) / (n + 1)
            delta = torch._foreach_sub(grads, self.acc)
            torch._foreach_div_(delta, float(self.mini_step + 1))
            torch._foreach_add_(self.acc, delta)
            if self.mini_step < self.accum - 1:
                self.mini_step += 1
                return
            self.mini_step = 0
            grads = self.acc
        if self.clip_norm is not None:
            # optax: select(|g| < max_norm, g, (g / |g|) * max_norm)
            g_norm = global_norm(grads)
            keep = g_norm < self.clip_norm
            den = torch.where(keep, torch.ones_like(g_norm), g_norm)
            num = torch.where(keep, torch.ones_like(g_norm), torch.full_like(g_norm, self.clip_norm))
            grads = [g / den * num for g in grads]
        lr = self.lr()
        self.count += 1
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1 - b1))
        torch._foreach_mul_(self.nu, b2)
        g2 = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(g2, 1 - b2)
        torch._foreach_add_(self.nu, g2)
        if self.accum > 1:
            torch._foreach_zero_(self.acc)
        if not apply:
            return
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(self.count))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(self.count))
        denom = torch._foreach_sqrt(torch._foreach_div(self.nu, bc2))
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(torch._foreach_div(self.mu, bc1), denom)
        torch._foreach_add_(upd, torch._foreach_mul(self.params, self.weight_decay))
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(self.params, upd)

    def state_dict(self) -> Dict:
        """Counts and moments (and the open window), keyed by parameter name."""
        out = {"count": self.count, "mini_step": self.mini_step,
               "mu": dict(zip(self.names, self.mu)), "nu": dict(zip(self.names, self.nu))}
        if self.accum > 1:
            out["acc"] = dict(zip(self.names, self.acc))
        return out


@dataclasses.dataclass
class TrainState:
    step: int
    model: SynthesizerTrn
    mpd: MultiPeriodDiscriminator
    opt_g: AdamW
    opt_d: AdamW
    dur_disc: Optional[torch.nn.Module] = None
    opt_dur: Optional[AdamW] = None


def generator_parameters(model: SynthesizerTrn) -> List[torch.nn.Parameter]:
    """The generator's trained parameters: all but the `post_transformer`
    of each pre_conv flow, which holds checkpoint keys and is never run."""
    return [p for _, p in _generator_named(model)]


def _generator_named(model):
    return [(n, p) for n, p in model.named_parameters() if ".post_transformer." not in n]


def build_mpd(cfg: VITS2Config, seed: int = 1, device="cuda") -> MultiPeriodDiscriminator:
    """MultiPeriodDiscriminator initialised from torch.Generator(seed), on
    `device` (the card unless the caller says otherwise)."""
    mpd = MultiPeriodDiscriminator(use_spectral_norm=cfg.model.use_spectral_norm)
    init_params_(mpd, torch.Generator().manual_seed(seed))
    return mpd.to(device)


def build_dur_disc(cfg: VITS2Config, seed: int = 2, device="cuda"):
    """The config's duration discriminator (`duration_discriminator_type`)
    initialised from torch.Generator(seed), on `device`; None when
    `use_duration_discriminator` is off."""
    if not cfg.model.use_duration_discriminator:
        return None
    dd = build_duration_discriminator(cfg.model.duration_discriminator_type,
                                      cfg.model.hidden_channels)
    init_params_(dd, torch.Generator().manual_seed(seed))
    return dd.to(device)


def create_train_state(cfg: VITS2Config, model: SynthesizerTrn, mpd: MultiPeriodDiscriminator,
                       steps_per_epoch: int = 1000, dur_disc=None) -> TrainState:
    """Optimizers for G, D and the duration discriminator (make_optimizer +
    create_train_state of the JAX package), one schedule for all three, on
    the device of the models' parameters."""
    check_supported(cfg)
    t = cfg.train
    k = t.grad_accum

    def opt(named):
        names, params = zip(*named)
        return AdamW(params, t.learning_rate, t.betas, t.eps, t.lr_decay,
                     max(1, steps_per_epoch // k), accum=k, names=names)

    state = TrainState(step=0, model=model, mpd=mpd, opt_g=opt(_generator_named(model)),
                       opt_d=opt(list(mpd.named_parameters())))
    if dur_disc is not None:
        trained = {id(p) for p in dur_disc.trained_parameters()}
        state.dur_disc = dur_disc
        state.opt_dur = opt([(n, p) for n, p in dur_disc.named_parameters() if id(p) in trained])
    return state


def _guarded_update(cfg: VITS2Config, opt: AdamW, loss: torch.Tensor,
                    grads: List[torch.Tensor]):
    """-> (ok, grad norm). Non-finite loss or gradient with skip_nonfinite:
    zero gradients into the optimizer, parameters untouched."""
    norm = global_norm(grads)
    ok = bool(torch.isfinite(loss) & torch.isfinite(norm)) or not cfg.train.skip_nonfinite
    if not ok:
        grads = [torch.zeros_like(g) for g in grads]
    opt.step(grads, apply=ok)
    return ok, norm


def _grads(loss: torch.Tensor, params: List[torch.Tensor]) -> List[torch.Tensor]:
    """d loss / d params, zeros for parameters the loss does not reach."""
    return [torch.zeros_like(p) if g is None else g for p, g in zip(
        params, torch.autograd.grad(loss, params, allow_unused=True))]


def _dur_disc_step(cfg, state: TrainState, hx, x_mask, logw_, logw):
    """The duration discriminator's step on detached inputs ([B, T, C] as the
    training forward returns them), with dur_r = logw_ and dur_hat = logw."""
    cl = lambda t: t.detach().transpose(1, 2)  # noqa: E731 - [B, T, C] -> [B, C, T]
    prob_r, prob_g = forward_as(cfg, state.dur_disc, cl(hx), cl(x_mask), cl(logw_), cl(logw))
    loss, _, _ = discriminator_loss([prob_r], [prob_g])
    ok, norm = _guarded_update(cfg, state.opt_dur, loss, _grads(loss, state.opt_dur.params))
    return ok, {"loss/dur_disc": loss, "grad_norm_dur_disc": norm}


def _dur_gen_loss(cfg, state: TrainState, hx, x_mask, logw_, logw) -> torch.Tensor:
    """generator_loss([prob_g]) of the duration discriminator; the gradient
    reaches the generator through logw (hx is detached inside)."""
    cl = lambda t: t.transpose(1, 2)  # noqa: E731
    _, prob_g = forward_as(cfg, state.dur_disc, cl(hx), cl(x_mask), cl(logw_), cl(logw))
    return generator_loss([prob_g])[0]


def _as_floats(metrics: Dict[str, torch.Tensor], ok: bool) -> Dict[str, float]:
    """One host read for every metric."""
    vals = torch.stack([v.detach().float().reshape(()) for v in metrics.values()]).tolist()
    out = dict(zip(metrics, vals))
    out["nonfinite"] = 0.0 if ok else 1.0
    return out


def _batch_on(cfg: VITS2Config, batch: Dict[str, torch.Tensor], dev, keys) -> Dict:
    """The step's tensors of `batch` on `dev`; `sid` among them for a
    multi-speaker config (None otherwise, as the JAX step)."""
    b = {k: v.to(dev) for k, v in batch.items() if k in keys}
    b["sid"] = batch["sid"].to(dev) if cfg.model.n_speakers > 1 else None
    return b


def train_step(cfg: VITS2Config, state: TrainState, batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator] = None, **noise) -> Dict[str, float]:
    """One step in the config's order on `batch` (x [B, T_x], x_lengths,
    spec [B, T_y, C], spec_lengths, wav [B, L, 1], and sid [B] for a
    multi-speaker config), on the device of the
    model's parameters. Random draws come from `generator` unless injected
    through `noise` (SynthesizerTrn.forward's eps, mas_noise, sdp_noise_q,
    sdp_noise, ids_slice). Updates `state` in place; returns the JAX step's
    metrics as floats."""
    check_supported(cfg)
    if (state.dur_disc is None) != (not cfg.model.use_duration_discriminator):
        raise ValueError("use_duration_discriminator and the state's dur_disc disagree")
    a, m = cfg.audio, cfg.model
    model, mpd = state.model.train(), state.mpd.train()
    dev = next(model.parameters()).device
    b = _batch_on(cfg, batch, dev, ("x", "x_lengths", "spec", "spec_lengths", "wav"))
    mas_noise = (max(m.mas_noise_scale_initial - m.noise_scale_delta * state.step, 0.0)
                 if m.use_noise_scaled_mas else None)

    y_hat, l_length, _, ids_slice, x_mask, z_mask, latents, (hx, logw, logw_) = forward_as(
        cfg, model, b["x"], b["x_lengths"], _bf16_input(cfg, b["spec"]), b["spec_lengths"],
        sid=b["sid"], mas_noise_scale=mas_noise, generator=generator, **noise)
    _, z_p, m_p, logs_p, _, logs_q = latents
    y_slice = _bf16_input(cfg, slice_segments(b["wav"], ids_slice * a.hop_length,
                                              m.segment_size).transpose(1, 2))
    mel = b["spec"] if m.use_mel_posterior_encoder else melmod.spec_to_mel(
        b["spec"], a.filter_length, a.n_mel_channels, a.sampling_rate, a.mel_fmin, a.mel_fmax)
    y_mel = slice_segments(mel, ids_slice, cfg.segment_frames)
    y_hat_mel = melmod.mel_spectrogram(y_hat[..., 0].float(), a.filter_length, a.n_mel_channels,
                                       a.sampling_rate, a.hop_length, a.win_length, a.mel_fmin,
                                       a.mel_fmax)
    terms = dict(dur=torch.sum(l_length.float()), mel=torch.mean(torch.abs(y_mel - y_hat_mel)),
                 kl=kl_loss(z_p, logs_q, m_p, logs_p, z_mask))
    dur_in = (hx, x_mask, logw_, logw)
    step = _lightning if cfg.train.step_order == "lightning" else _ddp
    ok, metrics = step(cfg, state, y_hat, y_slice, terms, dur_in)
    state.step += int(ok)
    return _as_floats(metrics, ok)


def _ddp(cfg, state: TrainState, y_hat, y_slice, terms, dur_in):
    t = cfg.train
    # D on the detached audio
    y_d_r, y_d_g, _, _ = forward_as(cfg, state.mpd, y_slice, y_hat.detach().transpose(1, 2))
    loss_disc, _, _ = discriminator_loss(y_d_r, y_d_g)
    ok_d, norm_d = _guarded_update(cfg, state.opt_d, loss_disc,
                                   _grads(loss_disc, state.opt_d.params))
    ok_dur, extra = True, {}
    if state.dur_disc is not None:
        ok_dur, extra = _dur_disc_step(cfg, state, *dur_in)

    # G through the updated discriminators
    _, y_d_g, fmap_r, fmap_g = forward_as(cfg, state.mpd, y_slice, y_hat.transpose(1, 2))
    loss_mel, loss_kl = terms["mel"] * t.c_mel, terms["kl"] * t.c_kl
    loss_fm = feature_loss(fmap_r, fmap_g)
    loss_gen, _ = generator_loss(y_d_g)
    loss_all = loss_gen + loss_fm + loss_mel + terms["dur"] + loss_kl
    if state.dur_disc is not None:
        loss_all = loss_all + _dur_gen_loss(cfg, state, *dur_in)
    ok_g, norm_g = _guarded_update(cfg, state.opt_g, loss_all,
                                   _grads(loss_all, state.opt_g.params))
    metrics = {"loss/d/total": loss_disc, "grad_norm_d": norm_d, "grad_norm_g": norm_g,
               "loss/g/total": loss_all, "loss/g/gen": loss_gen, "loss/g/fm": loss_fm,
               "loss/g/mel": loss_mel, "loss/g/dur": terms["dur"], "loss/g/kl": loss_kl, **extra}
    return ok_g and ok_d and ok_dur, metrics


def _lightning(cfg, state: TrainState, y_hat, y_slice, terms, dur_in):
    t = cfg.train
    # G first, against the current discriminators
    _, y_d_g, fmap_r, fmap_g = forward_as(cfg, state.mpd, y_slice, y_hat.transpose(1, 2))
    loss_fm = feature_loss(fmap_r, fmap_g)
    loss_gen = torch.mean(generator_loss(y_d_g)[1])
    loss_all = (loss_gen + t.c_fm * loss_fm + t.c_dur * terms["dur"] + t.c_kl * terms["kl"]
                + t.c_mel * terms["mel"]) / (1.0 + t.c_fm + t.c_dur + t.c_kl + t.c_mel)
    if state.dur_disc is not None:
        loss_all = loss_all + _dur_gen_loss(cfg, state, *dur_in)
    ok_g, norm_g = _guarded_update(cfg, state.opt_g, loss_all,
                                   _grads(loss_all, state.opt_g.params))

    # then D on the detached audio of that one forward
    y_d_r, y_d_g, _, _ = forward_as(cfg, state.mpd, y_slice, y_hat.detach().transpose(1, 2))
    _, r_l, g_l = discriminator_loss(y_d_r, y_d_g)
    loss_disc = torch.mean(r_l) + torch.mean(g_l)
    ok_d, norm_d = _guarded_update(cfg, state.opt_d, loss_disc,
                                   _grads(loss_disc, state.opt_d.params))
    ok_dur, extra = True, {}
    if state.dur_disc is not None:
        ok_dur, extra = _dur_disc_step(cfg, state, *dur_in)
    metrics = {"loss/d/total": loss_disc, "grad_norm_d": norm_d, "grad_norm_g": norm_g,
               "loss/g/total": loss_all, "loss/g/gen": loss_gen, "loss/g/fm": loss_fm,
               "loss/g/mel": terms["mel"], "loss/g/dur": terms["dur"], "loss/g/kl": terms["kl"],
               **extra}
    return ok_g and ok_d and ok_dur, metrics


@torch.no_grad()
def eval_step(cfg: VITS2Config, model: SynthesizerTrn, batch: Dict[str, torch.Tensor],
              generator: Optional[torch.Generator] = None, **noise) -> Dict[str, float]:
    """The generator's losses on a held-out batch (the JAX `make_eval_step`):
    no updates, no discriminators, dropout off, no MAS noise; the posterior
    and SDP noise and the segment starts from `generator` (or `noise`).
    -> eval/loss_mel, eval/loss_kl, eval/loss_dur."""
    a, m, t = cfg.audio, cfg.model, cfg.train
    was_training = model.training
    model.eval()
    try:
        dev = next(model.parameters()).device
        b = _batch_on(cfg, batch, dev, ("x", "x_lengths", "spec", "spec_lengths"))
        y_hat, l_length, _, ids, _, z_mask, latents, _ = model(
            b["x"], b["x_lengths"], b["spec"], b["spec_lengths"], sid=b["sid"],
            mas_noise_scale=None, generator=generator, **noise)
    finally:
        model.train(was_training)
    _, z_p, m_p, logs_p, _, logs_q = latents
    mel = b["spec"] if m.use_mel_posterior_encoder else melmod.spec_to_mel(
        b["spec"], a.filter_length, a.n_mel_channels, a.sampling_rate, a.mel_fmin, a.mel_fmax)
    y_mel = slice_segments(mel, ids, cfg.segment_frames)
    y_hat_mel = melmod.mel_spectrogram(y_hat[..., 0].float(), a.filter_length, a.n_mel_channels,
                                       a.sampling_rate, a.hop_length, a.win_length, a.mel_fmin,
                                       a.mel_fmax)
    metrics = {"eval/loss_mel": torch.mean(torch.abs(y_mel - y_hat_mel)) * t.c_mel,
               "eval/loss_kl": kl_loss(z_p, logs_q, m_p, logs_p, z_mask) * t.c_kl,
               "eval/loss_dur": torch.sum(l_length.float())}
    out = _as_floats(metrics, True)
    del out["nonfinite"]
    return out
