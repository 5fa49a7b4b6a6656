"""VITS2 training loop: data, steps, logging, evaluation, checkpoints (port
of `torch_tts_tpu/train/vits2_trainer.py`, on one device).

- The epoch loop runs over a `DistributedBucketSampler` whose buckets carry
  their padded frame counts; text is padded to `max_text_len * 2 + 1` ids
  with `add_blank` (the JAX package's static shapes).
- Scalars every `log_interval` steps, with `perf/steps_per_s`,
  `perf/nonfinite_skipped` and the window's mean host times,
  `perf/load_ms` (a batch's loading) and `perf/step_ms/<frames>` (a step,
  by the bucket's padded frame count); a window of only non-finite steps
  saves the state and raises FloatingPointError.
- Every `eval_interval` steps, `evaluate()` and a checkpoint (keep
  `keep_ckpts`, written off the step path by default).
- A new trainer resumes from the latest checkpoint in its directory.

Resume is exact at epoch boundaries: each step's random draws come from a
`torch.Generator` seeded by a pure function of (seed, step)
(`step_generator`), the sampler's schedule is a pure function of the
epoch, and the epoch loop restarts at the epoch the restored step implies.
A mid-epoch checkpoint rounds the step down to its epoch's start and the
partial epoch is replayed. (The JAX trainer keys each step with
`fold_in(seed_key, step)`; its threefry stream cannot be reproduced in
torch, so the two packages' trajectories differ in their draws.)

Writers come from the `make_writer` argument (tensorboardX by default;
`logging_utils.Recorder` where tensorboardX is not installed). Not
ported: the native C++ loader (`use_native_loader=True` raises), data
parallelism (`use_mesh=True` raises) and the orbax checkpoint backend.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from torch_tts_tpu_torch.core.config import VITS2Config
from torch_tts_tpu_torch.data.dataset import TextAudioDataset, collate_batch
from torch_tts_tpu_torch.data.sampler import DistributedBucketSampler
from torch_tts_tpu_torch.models.vits2 import build_synthesizer
from torch_tts_tpu_torch.text import symbols
from torch_tts_tpu_torch.train import checkpoint as ckpt
from torch_tts_tpu_torch.train.async_checkpoint import AsyncCheckpointer
from torch_tts_tpu_torch.train.vits2_train import (build_dur_disc, build_mpd, create_train_state,
                                                   eval_step, train_step)
from torch_tts_tpu_torch.utils import logging_utils as lu

logger = logging.getLogger(__name__)

BUCKET_BOUNDARIES = [32, 300, 400, 500, 600, 700, 800, 900, 1000]


def build_models(cfg: VITS2Config, device="cuda"):
    """(SynthesizerTrn in training mode, MultiPeriodDiscriminator, the
    duration discriminator or None), initialised from torch.Generators
    seeded by cfg.train.seed (+1 for the MPD, +2 for the duration
    discriminator), on `device` (the card unless the caller says otherwise)."""
    seed = cfg.train.seed
    model = build_synthesizer(cfg, len(symbols), seed=seed, device=device).train()
    return (model, build_mpd(cfg, seed=seed + 1, device=device),
            build_dur_disc(cfg, seed=seed + 2, device=device))


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of one step's random draws: a pure function of
    (seed, step), so a resumed run draws what an uninterrupted one does."""
    s = int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0] >> 1)
    return torch.Generator(device=device).manual_seed(s)


def to_tensors(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A collated numpy batch on `device`, every key (speaker ids `sid`
included), int32 ids, lengths and sids as int64."""
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32 else v).to(device)
            for k, v in batch.items()}


class VITS2Trainer:
    def __init__(self, cfg: VITS2Config, model_dir: str, train_dataset: TextAudioDataset,
                 eval_dataset: Optional[TextAudioDataset] = None, bucket_boundaries=None,
                 pad_text_to: Optional[int] = None, eval_max_frames: int = 1000,
                 use_native_loader: bool = False, async_ckpt: Optional[str] = "thread",
                 make_writer: Callable = lu.make_writer, use_mesh: bool = False,
                 device="cuda"):
        if use_native_loader:
            raise NotImplementedError("the native C++ loader (data/native.py) is not ported")
        if use_mesh:
            raise NotImplementedError("data parallelism is not ported: the trainer runs on "
                                      "one device")
        self.cfg = cfg
        self.model_dir = model_dir
        self.device = torch.device(device)
        self.train_dataset = train_dataset
        self.eval_dataset = eval_dataset
        self.eval_max_frames = eval_max_frames
        # "thread": snapshot on the step path, write in the background;
        # None: synchronous saves
        self.ckpt = AsyncCheckpointer(async_ckpt) if async_ckpt is not None else None
        os.makedirs(model_dir, exist_ok=True)
        lu.check_git_hash(model_dir)
        self.writer = make_writer(model_dir)
        self.writer_eval = make_writer(os.path.join(model_dir, "eval"))

        self.model, self.mpd, self.dur_disc = build_models(cfg, device=self.device)
        self.sampler = DistributedBucketSampler(train_dataset.lengths, cfg.train.batch_size,
                                                bucket_boundaries or BUCKET_BOUNDARIES,
                                                num_replicas=1, rank=0, shuffle=True)
        self.steps_per_epoch = max(1, len(self.sampler))
        self.pad_text = pad_text_to or (
            cfg.data.max_text_len * (2 if cfg.data.add_blank else 1) + 1)
        self.state = create_train_state(cfg, self.model, self.mpd, self.steps_per_epoch,
                                        dur_disc=self.dur_disc)
        latest = ckpt.latest_checkpoint(model_dir)
        if latest:
            logger.info("Resuming from %s", latest)
            ckpt.restore_checkpoint(latest, self.state)
        self.eval_s = 0.0  # the last evaluate()'s seconds

    def _make_batch(self, pad_frames: int, idxs) -> Dict[str, torch.Tensor]:
        samples = [self.train_dataset[i] for i in idxs]
        batch = collate_batch(samples, pad_text_to=self.pad_text, pad_frames_to=pad_frames)
        return to_tensors(batch, self.device)

    def train(self, epochs: Optional[int] = None, profile_steps: Optional[tuple] = None,
              profile_dir: Optional[str] = None) -> None:
        """Train to `epochs` (cfg.train.epochs by default). profile_steps =
        (start, stop) records a torch.profiler trace of those steps into
        profile_dir (default <model_dir>/profile)."""
        cfg = self.cfg
        epochs = epochs or cfg.train.epochs
        step = self.state.step
        start_epoch = step // self.steps_per_epoch
        if step % self.steps_per_epoch:
            # a mid-epoch checkpoint: round the step down to the epoch's
            # start and replay the partial epoch (the reference's
            # global_step = (epoch_str - 1) * len(train_loader))
            step = self.state.step = start_epoch * self.steps_per_epoch
            logger.info("mid-epoch checkpoint: step rounded down to the epoch boundary (%d) - "
                        "replaying the partial epoch", step)
        t_last = time.perf_counter()
        profiler = None
        nonfinite = 0.0
        # this log window's host times: step ms by padded frame count, and
        # the batches' loading ms
        step_ms: Dict[int, list] = {}
        load_ms = 0.0
        for epoch in range(start_epoch + 1, epochs + 1):
            self.sampler.set_epoch(epoch)
            for pad_frames, idxs in self.sampler:
                if profile_steps and step == profile_steps[0] and profiler is None:
                    acts = [torch.profiler.ProfilerActivity.CPU]
                    if self.device.type == "cuda":
                        acts.append(torch.profiler.ProfilerActivity.CUDA)
                    profiler = torch.profiler.profile(activities=acts)
                    profiler.__enter__()
                t0 = time.perf_counter()
                batch = self._make_batch(pad_frames, idxs)
                t1 = time.perf_counter()
                metrics = train_step(cfg, self.state, batch,
                                     generator=step_generator(cfg.train.seed, step, self.device))
                load_ms += (t1 - t0) * 1e3
                step_ms.setdefault(pad_frames, []).append((time.perf_counter() - t1) * 1e3)
                nonfinite += metrics["nonfinite"]
                step += 1
                if profiler is not None and step >= profile_steps[1]:
                    self._stop_profile(profiler, profile_dir)
                    profiler = None
                if step % cfg.train.log_interval == 0:
                    dt = time.perf_counter() - t_last
                    t_last = time.perf_counter()
                    m = dict(metrics)
                    m["perf/steps_per_s"] = cfg.train.log_interval / dt
                    m["perf/nonfinite_skipped"], nonfinite = nonfinite, 0.0
                    m["perf/load_ms"], load_ms = load_ms / cfg.train.log_interval, 0.0
                    m.update((f"perf/step_ms/{pad}", sum(v) / len(v))
                             for pad, v in step_ms.items())
                    step_ms.clear()
                    if m["perf/nonfinite_skipped"]:
                        logger.warning("%d of the last %d steps had non-finite losses (updates "
                                       "were skipped in-step)", int(m["perf/nonfinite_skipped"]),
                                       cfg.train.log_interval)
                    if m["perf/nonfinite_skipped"] >= cfg.train.log_interval:
                        self._save(step)
                        if self.ckpt is not None:
                            self.ckpt.wait()
                        raise FloatingPointError("every step in the last log window had a "
                                                 "non-finite loss; state saved")
                    lu.summarize(self.writer, step, scalars=m)
                    logger.info("step %d: %s", step, {k: round(v, 4) for k, v in m.items()})
                if step % cfg.train.eval_interval == 0:
                    self.evaluate(step)
                    self._save(step)
            logger.info("==== epoch %d done (step %d)", epoch, step)
        if profiler is not None:
            self._stop_profile(profiler, profile_dir)
        if self.ckpt is not None:
            # the last checkpoint is on disk before train() returns
            self.ckpt.wait()

    def _stop_profile(self, profiler, profile_dir: Optional[str]) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        profiler.__exit__(None, None, None)
        out = profile_dir or os.path.join(self.model_dir, "profile")
        os.makedirs(out, exist_ok=True)
        profiler.export_chrome_trace(os.path.join(out, "trace.json"))

    def _save(self, step: int) -> None:
        keep = self.cfg.train.keep_ckpts
        if self.ckpt is not None:
            self.ckpt.save(self.model_dir, step, self.state, keep=keep)
        else:
            ckpt.save_checkpoint(self.model_dir, step, self.state, keep=keep)

    def evaluate(self, step: int) -> None:
        """`eval_step` on up to 4 eval items, then their synthesis by
        `SynthesizerTrn.infer` at eval_max_frames (the decoder's ResBlock1
        banks and the flows' WN stacks through their kernels on the card);
        scalars, audio and alignment images to the eval writer."""
        if self.eval_dataset is None or len(self.eval_dataset) == 0:
            return
        t0 = time.perf_counter()
        sample = collate_batch([self.eval_dataset[i]
                                for i in range(min(4, len(self.eval_dataset)))],
                               pad_text_to=self.pad_text)
        batch = to_tensors(sample, self.device)
        scalars = eval_step(self.cfg, self.model, batch,
                            generator=torch.Generator(self.device).manual_seed(0))
        logger.info("eval step %d: %s", step, {k: round(v, 4) for k, v in scalars.items()})
        was_training = self.model.training
        self.model.eval()
        try:
            # no sid, as the JAX trainer's evaluate(): a multi-speaker
            # model's eval audio is unconditioned
            audio, attn, _, _, y_lengths = self.model.infer(
                batch["x"], batch["x_lengths"], noise_scale=0.667, noise_scale_w=0.8,
                length_scale=1.0, max_frames=self.eval_max_frames,
                generator=torch.Generator(self.device).manual_seed(step))
        finally:
            self.model.train(was_training)
        audio, attn, y_lengths = audio.cpu().numpy(), attn.cpu().numpy(), y_lengths.cpu().numpy()
        hop = self.cfg.audio.hop_length
        audios = {f"gen/audio_{i}": audio[i, : y_lengths[i] * hop, 0]
                  for i in range(audio.shape[0])}
        images = {f"gen/attn_{i}": lu.plot_alignment_to_numpy(attn[i])
                  for i in range(min(2, audio.shape[0]))}
        lu.summarize(self.writer_eval, step, scalars=scalars, images=images, audios=audios,
                     audio_sampling_rate=self.cfg.audio.sampling_rate)
        self.eval_s = time.perf_counter() - t0
