"""Neural vocoder (mel -> waveform HiFi-GAN) training CLI (port of
`torch_tts_tpu/cli/vocoder_train.py`).

Trains the `ops/hifigan.py` Generator to invert the Tacotron frontend's mel
(`train/vocoder_train.py`): the HiFi-GAN recipe (MPD adversarial + feature
matching + L1 mel) or `--no-gan` recon-only. The hop of the config's audio
section is factored into upsample rates (largest first, each stage's
kernel twice its rate). Every wav is resampled to the config's rate if
needed, peak-normalised and encoded once. Each checkpoint
(`<run-dir>/ckpt_<step>.pt`, `train/checkpoint.py`) also writes the
artifact `<run-dir>/vocoder.pt` (`infer/vocoder.py`), which
`cli/tacotron_infer.py --vocoder` takes; a run directory with checkpoints
resumes from the latest.

Usage:
  python -m torch_tts_tpu_torch.cli.vocoder_train FILELIST config.json \\
      [--run-dir runs/vocoder] [--steps N] [--seg-frames 32] [--no-gan]

FILELIST: one wav path per line (absolute or relative to --data-root, the
first `|` field), or a directory whose *.wav files are taken.
"""

from __future__ import annotations

import argparse
import logging
import os
import time
from typing import List, Optional, Sequence

import numpy as np

from torch_tts_tpu_torch.core.precision import fp32_cudnn


def wav_list(path: str, data_root: str) -> List[str]:
    if os.path.isdir(path):
        return sorted(os.path.join(path, f) for f in os.listdir(path) if f.endswith(".wav"))
    out = []
    with open(path) as f:
        for line in f:
            p = line.strip().split("|")[0]
            if p:
                out.append(p if os.path.isabs(p) else os.path.join(data_root, p))
    return out


def hop_rates(hop: int) -> List[int]:
    """hop as a product of upsample rates, largest first (8, 8, 5, 4, 3, 2,
    then what is left)."""
    rates, h = [], hop
    for r in (8, 8, 5, 4, 3, 2):
        while h % r == 0 and h > 1:
            rates.append(r)
            h //= r
    if h != 1:
        rates.append(h)
    return sorted(rates, reverse=True)


def gen_kwargs_for(hop: int, upsample_initial_channel: int = 256) -> dict:
    rates = hop_rates(hop)
    return dict(resblock="1", resblock_kernel_sizes=(3, 7, 11),
                resblock_dilation_sizes=((1, 3, 5),) * 3, upsample_rates=tuple(rates),
                upsample_initial_channel=upsample_initial_channel,
                upsample_kernel_sizes=tuple(2 * r for r in rates))


def main(argv: Optional[Sequence[str]] = None):
    """Run the CLI on `argv`; returns the final VocoderTrainState."""
    fp32_cudnn()
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("filelist", help="wav filelist (or directory of wavs)")
    p.add_argument("config", help="Tacotron config YAML/JSON (audio section)")
    p.add_argument("--data-root", default=".")
    p.add_argument("--run-dir", default="runs/vocoder")
    p.add_argument("--steps", type=int, default=100000)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--seg-frames", type=int, default=32, help="mel frames per training segment")
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--lr-decay", type=float, default=0.999)
    p.add_argument("--c-mel", type=float, default=45.0)
    p.add_argument("--no-gan", action="store_true",
                   help="recon-only (L1 mel + L1 wav): a fast bootstrap")
    p.add_argument("--upsample-initial-channel", type=int, default=256)
    p.add_argument("--log-interval", type=int, default=100)
    p.add_argument("--ckpt-interval", type=int, default=5000)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--device", default="cuda", help="torch device to train on")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    log = logging.getLogger("vocoder_train")

    import torch

    from torch_tts_tpu_torch.audio.frontend import AudioFrontend, m_fwd, resample_poly
    from torch_tts_tpu_torch.core.config import load_tacotron_config
    from torch_tts_tpu_torch.data.audio_np import load_wav
    from torch_tts_tpu_torch.infer.vocoder import REF_MEL_SCALE, REF_MEL_SHIFT, save_vocoder
    from torch_tts_tpu_torch.train import checkpoint as ckpt
    from torch_tts_tpu_torch.train.vocoder_train import (create_vocoder_state, make_mel_fn,
                                                         vocoder_train_step)

    cfg = load_tacotron_config(args.config)
    a, device = cfg.audio, torch.device(args.device)
    fe = AudioFrontend(a, device)
    hop = a.hop_length
    gen_kwargs = gen_kwargs_for(hop, args.upsample_initial_channel)
    log.info("hop=%d -> upsample_rates=%s, gan=%s", hop, gen_kwargs["upsample_rates"],
             not args.no_gan)

    # the corpus: every wav encoded once, mel_net and the normalised wave kept
    utts = []
    for path in wav_list(args.filelist, args.data_root):
        wav, sr = load_wav(path)
        if sr != a.sample_rate:
            wav = resample_poly(wav, sr, a.sample_rate)
        wav = (wav / max(float(np.abs(wav).max()), 1e-8)).astype(np.float32)
        _, M_db = fe.encode(wav)
        mel = m_fwd(M_db).cpu().numpy()  # [T, M]
        if mel.shape[0] >= args.seg_frames + 2:
            utts.append((wav, mel))
    if not utts:
        raise SystemExit("no usable utterances (all shorter than --seg-frames)")
    log.info("%d utterances cached", len(utts))

    state = create_vocoder_state(gen_kwargs, a.num_mels, args.lr, args.lr_decay,
                                 gan=not args.no_gan, seed=args.seed, device=device)
    latest = ckpt.latest_checkpoint(args.run_dir)
    if latest:
        ckpt.restore_checkpoint(latest, state)
        log.info("resumed from %s (step %d)", latest, state.step)
    mel_fn = make_mel_fn(fe)

    rng = np.random.default_rng(args.seed)
    seg_f, seg_s = args.seg_frames, args.seg_frames * hop

    def sample_batch():
        mels = np.empty((args.batch_size, seg_f, a.num_mels), np.float32)
        wavs = np.empty((args.batch_size, seg_s), np.float32)
        for i in range(args.batch_size):
            wav, mel = utts[rng.integers(len(utts))]
            # the conditioning and the mel loss's target: the whole
            # utterance's mel at [t0, t0 + seg_f); the generated segment's
            # mel is framed from the segment alone (the recipe's edge frames)
            t0 = int(rng.integers(0, mel.shape[0] - seg_f))
            mels[i] = mel[t0: t0 + seg_f]
            seg = wav[t0 * hop: t0 * hop + seg_s]
            wavs[i] = np.pad(seg, (0, seg_s - len(seg)))
        return {"wav": torch.from_numpy(wavs), "mel": torch.from_numpy(mels)}

    artifact = os.path.join(args.run_dir, "vocoder.pt")
    t_log = time.perf_counter()
    for k in range(state.step, args.steps):
        metrics = vocoder_train_step(state, sample_batch(), mel_fn, mel_shift=REF_MEL_SHIFT,
                                     mel_scale=REF_MEL_SCALE, c_mel=args.c_mel,
                                     c_wav=1.0 if args.no_gan else 0.0)
        if (k + 1) % args.log_interval == 0:
            dt = time.perf_counter() - t_log
            log.info("step %d: %s; %.1f ms/step", k + 1,
                     {m: f"{v:.4f}" for m, v in metrics.items()}, dt / args.log_interval * 1e3)
            t_log = time.perf_counter()
        if (k + 1) % args.ckpt_interval == 0 or k + 1 == args.steps:
            ckpt.save_checkpoint(args.run_dir, k + 1, state)
            save_vocoder(artifact, state.model, gen_kwargs=gen_kwargs, sample_rate=a.sample_rate,
                         num_mels=a.num_mels)
    log.info("done; artifact at %s", artifact)
    return state


if __name__ == "__main__":
    main()
