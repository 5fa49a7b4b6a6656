"""Offline audio preprocessing: resample and silence trim (port of
`torch_tts_tpu/cli/preprocess_audio.py`, numpy and scipy on the host).

Input is wav; trimming is energy-based (frames `--trim-db` below the
loudest are cut at both ends); clips shorter than `--min-samples` after
trimming (the training segment) are skipped.

Usage:
  python -m torch_tts_tpu_torch.cli.preprocess_audio --in-dir wavs_raw \\
      --out-dir wavs --sr 22050 --min-samples 8192 [--trim-db 40]
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np

from torch_tts_tpu_torch.core.precision import fp32_cudnn


def trim_silence(wav: np.ndarray, sr: int, top_db: float = 40.0, frame: int = 512,
                 hop: int = 128) -> np.ndarray:
    """Trim leading/trailing frames whose RMS is `top_db` below the peak."""
    if len(wav) < frame:
        return wav
    n = 1 + (len(wav) - frame) // hop
    idx = np.arange(frame)[None, :] + hop * np.arange(n)[:, None]
    rms = np.sqrt(np.mean(wav[idx] ** 2, axis=1) + 1e-12)
    db = 20 * np.log10(rms / (rms.max() + 1e-12) + 1e-12)
    keep = np.nonzero(db > -top_db)[0]
    if len(keep) == 0:
        return wav
    start = keep[0] * hop
    end = min(len(wav), keep[-1] * hop + frame)
    return wav[start:end]


def main(argv: Optional[Sequence[str]] = None):
    fp32_cudnn()
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--in-dir", required=True)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--sr", type=int, default=22050)
    p.add_argument("--min-samples", type=int, default=8192,
                   help="skip clips shorter than this after trimming "
                        "(the training segment size)")
    p.add_argument("--trim-db", type=float, default=40.0)
    args = p.parse_args(argv)

    from torch_tts_tpu_torch.audio.frontend import resample_poly
    from torch_tts_tpu_torch.cli.vits2_infer import write_wav
    from torch_tts_tpu_torch.data.audio_np import load_wav

    os.makedirs(args.out_dir, exist_ok=True)
    n_done = n_skip = 0
    for root, _dirs, files in os.walk(args.in_dir):
        for name in sorted(files):
            if not name.lower().endswith(".wav"):
                continue
            src = os.path.join(root, name)
            wav, sr = load_wav(src)
            if sr != args.sr:
                wav = resample_poly(wav, sr, args.sr)
            wav = trim_silence(wav, args.sr, args.trim_db)
            if len(wav) < args.min_samples:
                n_skip += 1
                continue
            dst = os.path.join(args.out_dir, os.path.relpath(src, args.in_dir))
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            peak = np.abs(wav).max()
            write_wav(dst, wav / peak if peak > 1.0 else wav, args.sr)
            n_done += 1
    print(f"processed {n_done}, skipped {n_skip} (< {args.min_samples} samples)")
    return n_done, n_skip


if __name__ == "__main__":
    main()
