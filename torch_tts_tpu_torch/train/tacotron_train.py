"""Tacotron training: the train and eval steps and `TacotronTrainer` (port
of `torch_tts_tpu/train/tacotron_train.py`, on one device).

The optimizer is the JAX step's `optax.chain(clip_by_global_norm(1.0),
optax.adamw(lr))`, wrapped in `optax.MultiSteps` for accum_steps > 1: the
port's `AdamW` (optax's order of operations) at a constant rate with
optax's defaults, b1 0.9, b2 0.999, eps 1e-8 and weight decay 1e-4 on
every parameter (not on the BatchNorms' running statistics nor the
attention's constant `bias`, which are buffers), clipping the (window's
mean) gradient as optax does. The `grad_norm` metric is the norm of the
raw gradients.

`train_step`: the training forward (BatchNorms on batch statistics, the
training draws, the teacher-forcing coin; with a VAE, the teacher mels as
the reference and the KL term, weighted 2e-4 by `tacotron_loss`), the
gradients by autograd, the update. `eval_step`: train=False,
deterministic, teacher-forced, the PreNet's dropout on, no reference mel
(kl_loss 0, as in the JAX step); a Taco2Prod decode runs the step kernel
on the card.

`TacotronTrainer` keeps the JAX trainer's epoch loop: one checkpoint an
epoch (keep 3, `train/checkpoint.py`; its "model" is the strict Tacotron
state dict, so `load_generator_state` and `TacotronSynthesizer.
from_run_dir` take the run directory), `evaluate()` with its alignment
image after each epoch, resume from the latest checkpoint with an epoch
fast-forward when the batches have a len(), and the warning for a one-shot
iterator. Each step's draws come from a `torch.Generator` seeded by
(SEED, step) (`vits2_trainer.step_generator`), so a resume at an epoch
boundary is bit for bit; eval draws come from a disjoint stream
(`eval_generator`). (The JAX trainer keys each step with fold_in(key,
step); its threefry stream cannot be drawn in torch.)
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import os
import time
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from torch_tts_tpu_torch.core.config import TacotronConfig
from torch_tts_tpu_torch.core.masks import sequence_mask
from torch_tts_tpu_torch.models.tacotron.losses import tacotron_loss
from torch_tts_tpu_torch.models.tacotron.model import Tacotron, TacotronDraws, build_tacotron
from torch_tts_tpu_torch.train import checkpoint as ckpt
from torch_tts_tpu_torch.train.vits2_train import AdamW, global_norm
from torch_tts_tpu_torch.train.vits2_trainer import step_generator, to_tensors
from torch_tts_tpu_torch.utils import logging_utils as lu

logger = logging.getLogger(__name__)

CLIP_NORM, WEIGHT_DECAY = 1.0, 1e-4  # optax.clip_by_global_norm(1.0), adamw's default
KEEP_CKPTS = 3
SEED = 0  # the model's initialisation and every step's draws (the JAX trainer's PRNGKey(0))


@dataclasses.dataclass
class TacoTrainState:
    """The step, the model (parameters and BatchNorm buffers) and its
    optimizer (`opt_g`: the name `train/checkpoint.py` saves it under)."""

    step: int
    model: Tacotron
    opt_g: AdamW


def make_optimizer(model: Tacotron, lr: float = 1e-3, accum_steps: int = 1) -> AdamW:
    names, params = zip(*model.named_parameters())
    return AdamW(params, lr, (0.9, 0.999), 1e-8, lr_decay=1.0, steps_per_epoch=1,
                 weight_decay=WEIGHT_DECAY, accum=accum_steps, names=names, clip_norm=CLIP_NORM)


def create_train_state(model: Tacotron, lr: float = 1e-3, accum_steps: int = 1) -> TacoTrainState:
    return TacoTrainState(0, model, make_optimizer(model, lr, accum_steps))


def _loss(model: Tacotron, batch: Dict[str, torch.Tensor], train: bool, draws, generator):
    """The forward and `tacotron_loss`. A training step of a VAE model
    gives the teacher mels as the reference (`xref = x`), as the JAX step
    does; evaluation gives none, so the style is skipped and kl_loss is 0
    there (the JAX `eval_step`)."""
    x, x_lengths = batch["x"], batch["x_lengths"]
    ref = train and model.refencoder is not None
    y, y_post, s, aux = model(batch["c"], batch["c_lengths"], x, x_lengths,
                              xref=x if ref else None, xref_lengths=x_lengths if ref else None,
                              train=train, deterministic=not train, draws=draws,
                              generator=generator)
    xmask = sequence_mask(x_lengths, x.shape[1])
    loss, metrics = tacotron_loss(y, y_post, s, x, xmask, aux["w"], aux["kl_loss"])
    return loss, metrics, aux["w"]


def loss_and_grads(model: Tacotron, params, batch: Dict[str, torch.Tensor],
                   draws: Optional[TacotronDraws] = None,
                   generator: Optional[torch.Generator] = None):
    """The training forward and its loss on `batch` ({c, c_lengths, x,
    x_lengths} tensors) with `draws` (else drawn from `generator`) ->
    (metrics, the gradients of `params`). Updates the BatchNorms' running
    statistics. The forward runs in training mode, and the model's mode is
    restored after: the encoder's nn.LSTM reads it, and cuDNN's RNN backward
    refuses a forward run in eval mode (the other modules take train /
    deterministic explicitly)."""
    was_training = model.training
    model.train()
    try:
        loss, metrics, _ = _loss(model, batch, True, draws, generator)
        grads = torch.autograd.grad(loss, params)
    finally:
        model.train(was_training)
    return {k: v.detach() for k, v in metrics.items()}, list(grads)


def train_step(state: TacoTrainState, batch: Dict[str, torch.Tensor],
               draws: Optional[TacotronDraws] = None,
               generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """One step (`loss_and_grads`, then the optimizer) -> metrics (0-d
    tensors) with `grad_norm`, the raw gradients' norm."""
    metrics, grads = loss_and_grads(state.model, state.opt_g.params, batch, draws, generator)
    state.opt_g.step(grads)
    state.step += 1
    metrics["grad_norm"] = global_norm(grads)
    return metrics


@torch.no_grad()
def eval_step(model: Tacotron, batch: Dict[str, torch.Tensor],
              draws: Optional[TacotronDraws] = None,
              generator: Optional[torch.Generator] = None) -> Tuple[Dict[str, torch.Tensor],
                                                                     torch.Tensor]:
    """Teacher-forced, deterministic, BatchNorms on running statistics ->
    (metrics, w [B, S, L]); `draws` (only its PreNet masks are read) or
    `generator`."""
    _, metrics, w = _loss(model, batch, False, draws, generator)
    return metrics, w


def eval_generator(seed: int, step: int, i: int, device) -> torch.Generator:
    """The draws of eval batch i at `step`: a stream disjoint from every
    training step's (a three-word seed beside their two)."""
    s = int(np.random.SeedSequence([seed, 2 ** 31 + step, i]).generate_state(1, np.uint64)[0] >> 1)
    return torch.Generator(device=device).manual_seed(s)


class TacotronTrainer:
    """The epoch loop with checkpoint/resume and per-epoch alignment images.
    The model is built (seeded by `SEED`) on `device` and resumed from the
    latest checkpoint in `model_dir` at construction."""

    def __init__(self, cfg: TacotronConfig, model_dir: str, lr: float = 1e-3,
                 accum_steps: int = 1, make_writer: Callable = lu.make_writer, device="cuda"):
        self.cfg, self.model_dir = cfg, model_dir
        self.device = torch.device(device)
        os.makedirs(model_dir, exist_ok=True)
        self.writer = make_writer(model_dir)
        self.model = build_tacotron(cfg, seed=SEED, device=self.device)
        self.state = create_train_state(self.model, lr, accum_steps)
        latest = ckpt.latest_checkpoint(model_dir)
        if latest:
            logger.info("Resuming from %s", latest)
            ckpt.restore_checkpoint(latest, self.state)

    def batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return to_tensors(batch, self.device)

    def train(self, train_batches: Iterable[Dict[str, np.ndarray]],
              eval_batches: Optional[Iterable[Dict[str, np.ndarray]]] = None,
              num_epochs: int = 600, log_interval: int = 10) -> None:
        """Epochs up to `num_epochs` over `train_batches` (collated numpy
        batches), each followed by `evaluate(eval_batches)` and a checkpoint;
        the metrics and `perf/step_ms` every `log_interval` steps."""
        it = iter(train_batches)
        if it is train_batches:
            # a one-shot iterator: a later epoch would see it exhausted
            first = next(it, None)
            if first is None:
                return
            train_batches = itertools.chain([first], it)
            if num_epochs > 1:
                logger.warning("train_batches is a one-shot iterator; epochs after the first "
                               "will see it exhausted - pass a re-iterable for multi-epoch "
                               "training")
        step = self.state.step
        try:
            steps_per_epoch = len(train_batches)
        except TypeError:
            steps_per_epoch = None
        start_epoch = step // steps_per_epoch if steps_per_epoch else 0
        if step and not steps_per_epoch:
            logger.warning("resumed at step %d but the batch iterable has no len(); cannot "
                           "fast-forward past completed epochs - running %d epochs from here "
                           "(checkpoints keep the true step)", step, num_epochs)
        for epoch in range(start_epoch, num_epochs):
            for batch in train_batches:
                t0 = time.perf_counter()
                metrics = train_step(self.state, self.batch(batch),
                                     generator=step_generator(SEED, step, self.device))
                step += 1
                if step % log_interval == 0:
                    # the logged step's host ms, its loading and the wait
                    # for its metrics included
                    m = {k: float(v) for k, v in metrics.items()}
                    m["perf/step_ms"] = (time.perf_counter() - t0) * 1e3
                    lu.summarize(self.writer, step, scalars=m)
                    logger.info("step %d: %s", step, {k: round(v, 4) for k, v in m.items()})
            if eval_batches is not None:
                self.evaluate(eval_batches, step)
            ckpt.save_checkpoint(self.model_dir, step, self.state, keep=KEEP_CKPTS)
            logger.info("==== epoch %d done (step %d)", epoch + 1, step)

    def evaluate(self, eval_batches: Iterable[Dict[str, np.ndarray]], step: int) -> float:
        """`eval_step` over the batches -> their mean loss, logged with the
        last batch's first alignment as an image."""
        losses, w_last = [], None
        for i, batch in enumerate(eval_batches):
            metrics, w = eval_step(self.model, self.batch(batch),
                                   generator=eval_generator(SEED, step, i, self.device))
            losses.append(float(metrics["loss"]))
            w_last = w
        if w_last is None:
            return float("nan")
        loss = float(np.mean(losses))
        lu.summarize(self.writer, step, scalars={"eval/loss": loss},
                     images={"eval/alignment": lu.plot_alignment_to_numpy(
                         w_last[0].cpu().numpy())})
        return loss
