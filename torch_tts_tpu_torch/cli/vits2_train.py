"""VITS2 training CLI (port of `torch_tts_tpu/cli/vits2_train.py`).

Pass --data-root (an LJSpeech directory: metadata.csv + wavs/) and/or
--filelist (the reference's `audio|text` or `audio|sid|text` format),
each repeatable, to train on their concatenation; --sid-offset shifts each
corpus's speaker ids above the previous ones. A seeded min(--val-size,
5%) random split is held out for evaluation. The config is copied into the
run directory; a run directory with checkpoints resumes from the latest.

The trainer runs on --device (the card by default). Summaries go to
tensorboardX event files (--writer tensorboard, the default) or, where
tensorboardX is not installed, to <run>/scalars.jsonl (--writer jsonl).
A `.json` config needs nothing beyond the standard library; a `.yaml`
one needs PyYAML.

Usage:
  python -m torch_tts_tpu_torch.cli.vits2_train -c configs/vits2-ljspeech.yaml \\
      -m runs/ljspeech --data-root /path/to/LJSpeech-1.1
"""

from __future__ import annotations

import argparse
import logging
import os
import shutil
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from torch_tts_tpu_torch.core.precision import fp32_cudnn


def split_train_val(items: Sequence, val_size: int, val_seed: int) -> Tuple[List, List]:
    """-> (train items, eval items): min(val_size, max(1, 5%)) items drawn
    by a permutation seeded with val_seed."""
    n_val = min(val_size, max(1, len(items) // 20))
    perm = np.random.default_rng(val_seed).permutation(len(items))
    return [items[i] for i in perm[n_val:]], [items[i] for i in perm[:n_val]]


def main(argv: Optional[Sequence[str]] = None, make_writer: Optional[Callable] = None):
    """Run the CLI on `argv`; `make_writer` (a log directory -> writer)
    overrides --writer. Returns the trainer."""
    fp32_cudnn()
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-c", "--config", required=True, help="config YAML/JSON")
    p.add_argument("-m", "--model-dir", required=True, help="run directory")
    p.add_argument("--data-root", action="append", default=None,
                   help="LJSpeech root (metadata.csv + wavs/); repeatable")
    p.add_argument("--filelist", action="append", default=None,
                   help="reference-format filelist; repeatable")
    p.add_argument("--sid-offset", action="store_true",
                   help="shift each corpus's speaker ids above the previous corpora's")
    p.add_argument("--val-seed", type=int, default=1234, help="seed of the train/val split")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--val-size", type=int, default=100)
    p.add_argument("--writer", choices=("tensorboard", "jsonl"), default="tensorboard",
                   help="summaries as tensorboardX events, or scalars.jsonl")
    p.add_argument("--device", default="cuda", help="torch device to train on")
    args = p.parse_args(argv)

    logging.basicConfig(level=logging.INFO)

    from torch_tts_tpu_torch.core.config import load_vits2_config
    from torch_tts_tpu_torch.data.dataset import TextAudioDataset
    from torch_tts_tpu_torch.train.vits2_trainer import VITS2Trainer
    from torch_tts_tpu_torch.utils import logging_utils as lu

    cfg = load_vits2_config(args.config)
    os.makedirs(args.model_dir, exist_ok=True)
    # the config beside the run, for provenance
    cfg_copy = os.path.join(args.model_dir, "config" + os.path.splitext(args.config)[1])
    if not (os.path.exists(cfg_copy) and os.path.samefile(args.config, cfg_copy)):
        shutil.copyfile(args.config, cfg_copy)

    use_mel = cfg.model.use_mel_posterior_encoder
    corpora = [TextAudioDataset.from_filelist(f, cfg.audio, cfg.data, use_mel=use_mel)
               for f in (args.filelist or ())]
    corpora += [TextAudioDataset.from_ljspeech(r, cfg.audio, cfg.data, use_mel=use_mel)
                for r in (args.data_root or ())]
    if not corpora:
        p.error("one of --data-root / --filelist is required")
    if len(corpora) == 1 and not args.sid_offset:
        full = corpora[0]
    else:
        full = TextAudioDataset.concat(corpora, cfg.audio, cfg.data, sid_offset=args.sid_offset,
                                       use_mel=use_mel)
        logging.info("concatenated %d corpora -> %d utterances (sid_offset=%s)", len(corpora),
                     len(full), args.sid_offset)

    # speaker ids past the config's table would train silently wrong
    max_sid = max((it.sid for it in full.items), default=0)
    if max_sid > 0 and cfg.model.n_speakers <= max_sid:
        p.error(f"speaker ids reach {max_sid} but the config has n_speakers="
                f"{cfg.model.n_speakers}; set model.n_speakers > {max_sid} (multi-speaker) "
                "or drop --sid-offset")

    train_items, eval_items = split_train_val(full.items, args.val_size, args.val_seed)
    train_ds = TextAudioDataset(train_items, cfg.audio, cfg.data, use_mel=use_mel)
    eval_ds = TextAudioDataset(eval_items, cfg.audio, cfg.data, use_mel=use_mel)

    if make_writer is None:
        make_writer = lu.make_writer if args.writer == "tensorboard" else lu.Recorder
    trainer = VITS2Trainer(cfg, args.model_dir, train_ds, eval_ds, make_writer=make_writer,
                           device=args.device)
    trainer.train(epochs=args.epochs)
    return trainer


if __name__ == "__main__":
    main()
