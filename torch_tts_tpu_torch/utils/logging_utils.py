"""Observability: summaries, an alignment image, provenance (port of
`torch_tts_tpu/utils/logging_utils.py`).

`make_writer` opens a tensorboardX `SummaryWriter`; tensorboardX is
imported there and only there, and its absence raises. `Recorder` is the
writer to use where tensorboardX is not installed: it keeps every summary
in memory and, given a directory, appends the scalars to
`<dir>/scalars.jsonl`. The trainer takes its writers from a factory
argument, so either serves. `plot_alignment_to_numpy` renders in numpy
(no matplotlib).
"""

from __future__ import annotations

import io
import json
import logging
import os
import subprocess
from typing import Dict, Optional

import numpy as np

logger = logging.getLogger(__name__)


def make_writer(log_dir: str):
    """A tensorboardX SummaryWriter on `log_dir`."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError as e:
        raise ImportError("make_writer needs tensorboardX; without it use Recorder "
                          "(the train CLI's --writer jsonl)") from e
    os.makedirs(log_dir, exist_ok=True)
    return SummaryWriter(log_dir=log_dir)


class Recorder:
    """A writer that keeps summaries in memory (`scalars[tag]` is a list of
    (step, value)); with `log_dir`, each scalar is also appended to
    `<log_dir>/scalars.jsonl` as {"step", "tag", "value"}."""

    def __init__(self, log_dir: Optional[str] = None):
        self.log_dir = log_dir
        self.scalars: Dict[str, list] = {}
        self.histograms: Dict[str, list] = {}
        self.images: Dict[str, list] = {}
        self.audios: Dict[str, list] = {}
        if log_dir is not None:
            os.makedirs(log_dir, exist_ok=True)

    def add_scalar(self, tag: str, value: float, global_step: int):
        self.scalars.setdefault(tag, []).append((int(global_step), float(value)))
        if self.log_dir is not None:
            with open(os.path.join(self.log_dir, "scalars.jsonl"), "a") as f:
                f.write(json.dumps({"step": int(global_step), "tag": tag,
                                    "value": float(value)}) + "\n")

    def add_histogram(self, tag: str, values, global_step: int):
        self.histograms.setdefault(tag, []).append((int(global_step), np.asarray(values)))

    def add_image(self, tag: str, img, global_step: int, dataformats: str = "HWC"):
        self.images.setdefault(tag, []).append((int(global_step), np.asarray(img)))

    def add_audio(self, tag: str, snd, global_step: int, sample_rate: int = 22050):
        self.audios.setdefault(tag, []).append((int(global_step), np.asarray(snd), sample_rate))

    def flush(self):
        pass

    def close(self):
        pass


def summarize(writer, global_step: int, scalars: Optional[Dict[str, float]] = None,
              histograms: Optional[Dict[str, np.ndarray]] = None,
              images: Optional[Dict[str, np.ndarray]] = None,
              audios: Optional[Dict[str, np.ndarray]] = None,
              audio_sampling_rate: int = 22050) -> None:
    for k, v in (scalars or {}).items():
        writer.add_scalar(k, float(v), global_step)
    for k, v in (histograms or {}).items():
        writer.add_histogram(k, np.asarray(v), global_step)
    for k, v in (images or {}).items():
        writer.add_image(k, np.asarray(v), global_step, dataformats="HWC")
    for k, v in (audios or {}).items():
        if hasattr(writer, "_get_file_writer"):  # a tensorboardX SummaryWriter
            _add_audio(writer, k, np.asarray(v), global_step, audio_sampling_rate)
        else:
            writer.add_audio(k, np.asarray(v), global_step, sample_rate=audio_sampling_rate)


def _add_audio(writer, tag: str, wav: np.ndarray, global_step: int, sample_rate: int) -> None:
    """tensorboardX audio summary without soundfile: a scipy-encoded 16-bit
    WAV in the Summary proto (tensorboardX's add_audio imports soundfile)."""
    from scipy.io import wavfile
    from tensorboardX.proto.summary_pb2 import Summary

    wav = np.clip(np.asarray(wav, np.float32).reshape(-1), -1.0, 1.0)
    buf = io.BytesIO()
    wavfile.write(buf, sample_rate, np.round(wav * 32767.0).astype(np.int16))
    audio = Summary.Audio(sample_rate=sample_rate, num_channels=1, length_frames=wav.shape[0],
                          encoded_audio_string=buf.getvalue(), content_type="audio/wav")
    writer._get_file_writer().add_summary(
        Summary(value=[Summary.Value(tag=tag, audio=audio)]), global_step)


# viridis at 0, 1/4, 1/2, 3/4, 1
_VIRIDIS = np.array([[68, 1, 84], [59, 82, 139], [33, 145, 140], [94, 201, 98], [253, 231, 37]],
                    np.float64)


def plot_alignment_to_numpy(alignment: np.ndarray) -> np.ndarray:
    """[T_dec, T_enc] attention matrix -> HWC uint8 image: decoder steps
    along the width, encoder steps up the height (origin lower), values
    scaled to [0, 1] and coloured by viridis (no axes or text)."""
    a = np.asarray(alignment, np.float64).T[::-1]  # [T_enc, T_dec], row 0 at the top
    lo, hi = float(a.min()) if a.size else 0.0, float(a.max()) if a.size else 0.0
    v = (a - lo) / (hi - lo) if hi > lo else np.zeros_like(a)
    pos = v * (len(_VIRIDIS) - 1)
    i = np.clip(np.floor(pos).astype(int), 0, len(_VIRIDIS) - 2)
    frac = (pos - i)[..., None]
    rgb = _VIRIDIS[i] * (1 - frac) + _VIRIDIS[i + 1] * frac
    return np.round(rgb).astype(np.uint8)


def check_git_hash(model_dir: str) -> None:
    """Record the repository's commit in <model_dir>/githash, or warn when
    it differs from the one recorded."""
    source_dir = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    if not os.path.exists(os.path.join(source_dir, ".git")):
        return
    try:
        cur_hash = subprocess.run(["git", "rev-parse", "HEAD"], cwd=source_dir,
                                  capture_output=True, text=True, check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return
    path = os.path.join(model_dir, "githash")
    if os.path.exists(path):
        with open(path) as f:
            saved = f.read().strip()
        if saved != cur_hash:
            logger.warning("git hash mismatch: saved %s vs current %s", saved[:8], cur_hash[:8])
    else:
        os.makedirs(model_dir, exist_ok=True)
        with open(path, "w") as f:
            f.write(cur_hash)
