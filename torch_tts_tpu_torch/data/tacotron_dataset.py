"""Tacotron data pipeline with an HDF5 feature cache (port of
`torch_tts_tpu/data/tacotron_dataset.py`).

- `TranscribedAudioDataset`: `utt|...|text` rows and a wav directory (a
  regex maps the utterance id to its wav path).
- `TacotronDataset`: (text ids, mel) on the fly, the mel by the port's
  `AudioFrontend.encode` and `m_fwd` into [0, 1], with an optional HDF5
  write-through cache (`<utt>/mel`, `<utt>/text`).
- `TacotronDatasetHDF5`: a built cache, its file opened lazily, each mel
  randomly cropped to `max_frames` (numpy seeded).
- `build_dataset_hdf5`: fills the cache; `collate_tacotron`: pads text and
  mels, frames rounded down to a multiple of r.

The cache's layout is the JAX package's, so either package reads the
other's. h5py is imported only where an HDF5 file is opened, so that
`TacotronDataset` without a cache runs where h5py is not installed.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from torch_tts_tpu_torch.audio.frontend import AudioFrontend, m_fwd
from torch_tts_tpu_torch.data.audio_np import load_wav
from torch_tts_tpu_torch.text.encoder import TextEncoder


class TranscribedAudioDataset:
    """Rows of `utt|...|text` and a wav directory."""

    def __init__(self, dataset_path: str, transcript_filename: str = "metadata.csv",
                 id_column: int = 0, text_column: int = 2, re_match: str = "(.*)",
                 re_path: str = r"wavs/\1.wav", re_id: str = r"\1", delimiter: str = "|"):
        self.path = dataset_path
        self.entries: List[Tuple[str, str, str]] = []  # (utt_id, wav_path, text)
        with open(os.path.join(dataset_path, transcript_filename), encoding="utf-8") as f:
            for line in f:
                cols = line.rstrip("\n").split(delimiter)
                if len(cols) <= max(id_column, text_column):
                    continue
                key = cols[id_column]
                # count=1: '(.*)' also matches the empty string at the end
                utt_id = re.sub(re_match, re_id, key, count=1)
                rel = re.sub(re_match, re_path, key, count=1)
                self.entries.append((utt_id, os.path.join(dataset_path, rel), cols[text_column]))

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, idx: int):
        utt_id, wav_path, text = self.entries[idx]
        wav, sr = load_wav(wav_path)
        return utt_id, text, wav, sr


class TacotronDataset:
    """{"utt_id", "c": int32 ids, "x": float32 mel [T, M] in [0, 1]}, the mel
    from the cache when it holds the utterance, else computed (and written
    to the cache when there is one)."""

    def __init__(self, audio_dataset: TranscribedAudioDataset, text_encoder: TextEncoder,
                 frontend: AudioFrontend, cache_path: Optional[str] = None):
        self.ds = audio_dataset
        self.text_encoder = text_encoder
        self.frontend = frontend
        self.cache_path = cache_path

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        utt_id, text, wav, sr = self.ds[idx]
        ids = np.asarray(self.text_encoder.encode(text), np.int32)
        mel = None
        if self.cache_path and os.path.exists(self.cache_path):
            import h5py

            with h5py.File(self.cache_path, "r") as f:
                if f"{utt_id}/mel" in f:
                    mel = np.asarray(f[f"{utt_id}/mel"])
        if mel is None:
            _, M_db = self.frontend.encode(wav, sr)
            mel = m_fwd(M_db).cpu().numpy().astype(np.float32)
            if self.cache_path:
                import h5py

                with h5py.File(self.cache_path, "a") as f:
                    if f"{utt_id}/mel" not in f:
                        f.create_dataset(f"{utt_id}/mel", data=mel)
                    if f"{utt_id}/text" not in f:
                        f.create_dataset(f"{utt_id}/text", data=text)
        return {"utt_id": utt_id, "c": ids, "x": mel}


class TacotronDatasetHDF5:
    """A built cache: utterances in sorted id order, `lengths` their frame
    counts; the file handle opened on first read; mels longer than
    max_frames cropped at a random start (numpy, seeded)."""

    def __init__(self, h5_path: str, text_encoder: TextEncoder, max_frames: Optional[int] = None,
                 seed: int = 0):
        import h5py

        self.h5_path = h5_path
        self.text_encoder = text_encoder
        self.max_frames = max_frames
        self._file = None
        self.rng = np.random.default_rng(seed)
        with h5py.File(h5_path, "r") as f:
            self.utt_ids = sorted(f.keys())
            self.lengths = [f[f"{u}/mel"].shape[0] for u in self.utt_ids]

    def _f(self):
        if self._file is None:
            import h5py

            self._file = h5py.File(self.h5_path, "r")
        return self._file

    def __len__(self):
        return len(self.utt_ids)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        u = self.utt_ids[idx]
        f = self._f()
        mel = np.asarray(f[f"{u}/mel"])
        text = f[f"{u}/text"][()]
        if isinstance(text, bytes):
            text = text.decode("utf-8")
        if self.max_frames and mel.shape[0] > self.max_frames:
            start = int(self.rng.integers(0, mel.shape[0] - self.max_frames + 1))
            mel = mel[start: start + self.max_frames]
        ids = np.asarray(self.text_encoder.encode(str(text)), np.int32)
        return {"utt_id": u, "c": ids, "x": mel}


def build_dataset_hdf5(dataset_path: str, config, cache_path: str,
                       transcript_filename: str = "metadata.csv", device="cuda") -> None:
    """Fill the HDF5 cache at `cache_path` with every utterance of the
    dataset, the mels computed on `device` (the card unless the caller says
    otherwise)."""
    from torch_tts_tpu_torch.cli.tacotron_infer import text_encoder

    base = TranscribedAudioDataset(dataset_path, transcript_filename)
    ds = TacotronDataset(base, text_encoder(config), AudioFrontend(config.audio, device),
                         cache_path=cache_path)
    for i in range(len(ds)):
        ds[i]  # reading an item writes it to the cache


def collate_tacotron(samples: Sequence[Dict[str, np.ndarray]], pad_text_to: Optional[int] = None,
                     pad_frames_to: Optional[int] = None, r: int = 1) -> Dict[str, np.ndarray]:
    """Pad text and mel; the frame count is rounded down to a multiple of r
    (the decoder's r-frame groups)."""
    B = len(samples)
    t_c = pad_text_to or max(len(s["c"]) for s in samples)
    t_x = pad_frames_to or max(s["x"].shape[0] for s in samples)
    t_x = (t_x // r) * r
    M = samples[0]["x"].shape[1]
    c = np.zeros((B, t_c), np.int32)
    c_lengths = np.zeros((B,), np.int32)
    x = np.zeros((B, t_x, M), np.float32)
    x_lengths = np.zeros((B,), np.int32)
    for i, s in enumerate(samples):
        lc = min(len(s["c"]), t_c)
        lx = min(s["x"].shape[0], t_x)
        c[i, :lc] = s["c"][:lc]
        c_lengths[i] = lc
        x[i, :lx] = s["x"][:lx]
        x_lengths[i] = lx
    return {"c": c, "c_lengths": c_lengths, "x": x, "x_lengths": x_lengths}
