"""Tacotron training CLI (port of `torch_tts_tpu/cli/tacotron_train.py`):
an HDF5 dataset from `cli/tacotron_prepare.py` (needs h5py), the first
min(--eval-size, 10%) utterances held out for evaluation, batches from a
length-bucketed sampler padded to static shapes (text to 16 * (ceil(the
longest of the first 64 / 16) + 4) ids, frames to --max-audio-frames or the
longest mel, a multiple of r), AdamW with --optimizer-interval gradient
accumulation, a checkpoint an epoch and a resume from the latest.

--filter SCORES_OUT trains nothing: it scores every utterance's alignment
crispness (the mean over its decoder steps of the attention's largest
weight, from `eval_step` with the latest checkpoint) and writes
`utt_id<TAB>score` lines, the least crisp first.

The trainer runs on --device (the card by default). Summaries go to
tensorboardX event files (--writer tensorboard) or <run-dir>/scalars.jsonl
(--writer jsonl).

Usage:
  python -m torch_tts_tpu_torch.cli.tacotron_train cache.h5 \\
      configs/tacotron-ljspeech.yaml --run-dir runs/tacotron
"""

from __future__ import annotations

import argparse
import logging
from typing import Callable, Dict, Optional, Sequence

from torch_tts_tpu_torch.core.precision import fp32_cudnn


def pad_lengths(ds, r: int, max_audio_frames: Optional[int]):
    """The CLI's static padding -> (text ids, frames)."""
    longest = max(len(ds[i]["c"]) for i in range(min(64, len(ds))))
    pad_c = 16 * ((longest + 15) // 16 + 4)
    max_fr = max_audio_frames or max(ds.lengths)
    return pad_c, r * ((max_fr + r - 1) // r)


def filter_scores(trainer, ds, batch_size: int, pad_c: int, pad_x: int) -> Dict[str, float]:
    """{utt_id: alignment crispness} over every utterance of `ds`; each
    batch's eval draws from a generator seeded 0."""
    import torch

    from torch_tts_tpu_torch.data.tacotron_dataset import collate_tacotron
    from torch_tts_tpu_torch.train.tacotron_train import eval_step

    r = trainer.cfg.model.r
    scores = {}
    for start in range(0, len(ds), batch_size):
        chunk = list(range(start, min(start + batch_size, len(ds))))
        batch = collate_tacotron([ds[i] for i in chunk], pad_text_to=pad_c, pad_frames_to=pad_x,
                                 r=r)
        gen = torch.Generator(device=trainer.device).manual_seed(0)
        _, w = eval_step(trainer.model, trainer.batch(batch), generator=gen)
        w = w.cpu().numpy()  # [B, S, L]
        for bi, i in enumerate(chunk):
            S = max(1, int(batch["x_lengths"][bi]) // r)
            scores[ds.utt_ids[i]] = float(w[bi, :S].max(axis=1).mean())
    return scores


class EpochIterable:
    """One epoch's batches a pass; sized, so that a resumed trainer can
    fast-forward completed epochs."""

    def __init__(self, ds, idx, batch_size: int, pad_c: int, pad_x: int, r: int):
        self.ds, self.idx, self.bs = ds, idx, batch_size
        self.pad_c, self.pad_x, self.r = pad_c, pad_x, r

    def __iter__(self):
        from torch_tts_tpu_torch.data.sampler import LengthBucketRandomSampler
        from torch_tts_tpu_torch.data.tacotron_dataset import collate_tacotron

        sampler = LengthBucketRandomSampler([self.ds.lengths[i] for i in self.idx], self.bs,
                                            seed=0)
        for batch_ids in sampler:
            yield collate_tacotron([self.ds[self.idx[i]] for i in batch_ids],
                                   pad_text_to=self.pad_c, pad_frames_to=self.pad_x, r=self.r)

    def __len__(self):
        return (len(self.idx) + self.bs - 1) // self.bs


def main(argv: Optional[Sequence[str]] = None, make_writer: Optional[Callable] = None):
    """Run the CLI on `argv`; `make_writer` overrides --writer. Returns the
    trainer (with --filter, the scores)."""
    fp32_cudnn()
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("dataset", help="HDF5 dataset (from tacotron_prepare)")
    p.add_argument("config", help="YAML or JSON Tacotron config")
    p.add_argument("--run-dir", default="runs/tacotron")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--eval-batch-size", type=int, default=32)
    p.add_argument("--eval-size", type=int, default=64)
    p.add_argument("--epochs", type=int, default=600)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--optimizer-interval", type=int, default=1,
                   help="gradient accumulation steps")
    p.add_argument("--max-audio-frames", type=int, default=None)
    p.add_argument("--filter", default=None, metavar="SCORES_OUT",
                   help="instead of training, score every utterance's alignment crispness with "
                        "the latest checkpoint and write 'utt_id score' lines, least crisp first")
    p.add_argument("--writer", choices=("tensorboard", "jsonl"), default="tensorboard",
                   help="summaries as tensorboardX events, or scalars.jsonl")
    p.add_argument("--device", default="cuda", help="torch device to train on")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from torch_tts_tpu_torch.cli.tacotron_infer import text_encoder
    from torch_tts_tpu_torch.core.config import load_tacotron_config
    from torch_tts_tpu_torch.data.tacotron_dataset import TacotronDatasetHDF5
    from torch_tts_tpu_torch.train.tacotron_train import TacotronTrainer
    from torch_tts_tpu_torch.utils import logging_utils as lu

    cfg = load_tacotron_config(args.config)
    ds = TacotronDatasetHDF5(args.dataset, text_encoder(cfg), max_frames=args.max_audio_frames)
    r = cfg.model.r
    pad_c, pad_x = pad_lengths(ds, r, args.max_audio_frames)
    if make_writer is None:
        make_writer = lu.make_writer if args.writer == "tensorboard" else lu.Recorder
    trainer = TacotronTrainer(cfg, args.run_dir, lr=args.lr, accum_steps=args.optimizer_interval,
                              make_writer=make_writer, device=args.device)

    if args.filter:
        scores = filter_scores(trainer, ds, args.batch_size, pad_c, pad_x)
        with open(args.filter, "w") as f:
            for utt, s in sorted(scores.items(), key=lambda kv: kv[1]):
                f.write(f"{utt}\t{s:.4f}\n")
        print(f"wrote {len(scores)} alignment-crispness scores to {args.filter}")
        return scores

    n_eval = min(args.eval_size, len(ds) // 10)
    train_idx, eval_idx = list(range(n_eval, len(ds))), list(range(n_eval))
    trainer.train(EpochIterable(ds, train_idx, args.batch_size, pad_c, pad_x, r),
                  EpochIterable(ds, eval_idx, args.eval_batch_size, pad_c, pad_x, r)
                  if n_eval else None,
                  num_epochs=args.epochs)
    return trainer


if __name__ == "__main__":
    main()
