"""Text + audio dataset with a feature cache, and the static-shape collate
(port of `torch_tts_tpu/data/dataset.py`).

`TextAudioDataset` loads (text, wav) pairs from an LJSpeech directory or a
reference-format filelist, filters by text length, converts text to ids
(with the blank interspersed when `add_blank`) through this package's
`text/`, and computes spectrogram or mel features in numpy with a
write-through cache (`.mel.npy` / `.spec.npy` next to each wav). The
features, and so the cache, equal the JAX package's bit for bit.

`collate_batch` pads a batch to fixed shapes (the bucket's frame count and
the text length the trainer sets), the JAX package's static shapes, so both
packages see the same batches.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from torch_tts_tpu_torch.core.config import AudioConfig, DataConfig
from torch_tts_tpu_torch.data import audio_np
from torch_tts_tpu_torch.data.ljspeech import parse_ljspeech
from torch_tts_tpu_torch.text import cleaned_text_to_sequence, intersperse, text_to_sequence


@dataclass
class Item:
    utt_id: str
    audio_path: str
    text: str
    sid: int = 0


class TextAudioDataset:
    """Filelist- or LJSpeech-backed dataset yielding numpy features."""

    def __init__(self, items: Sequence[Item], audio: AudioConfig, data: DataConfig,
                 use_mel: bool = True, cache: bool = True):
        self.audio = audio
        self.data = data
        self.use_mel = use_mel
        self.cache = cache
        self.items = [it for it in items if data.min_text_len <= len(it.text) <= data.max_text_len]
        # spec frame counts for bucketing from the file size (no decode),
        # as the reference's data_utils.py: getsize / (2 * hop)
        self.lengths = [
            max(1, os.path.getsize(it.audio_path) // (2 * audio.hop_length))
            if os.path.exists(it.audio_path) else 1
            for it in self.items
        ]

    @classmethod
    def from_ljspeech(cls, path, audio: AudioConfig, data: DataConfig, **kw):
        items = [Item(e["id"], e["audio_path"], e["text_normalised"])
                 for e in parse_ljspeech(path)]
        return cls(items, audio, data, **kw)

    @classmethod
    def from_filelist(cls, path, audio: AudioConfig, data: DataConfig, **kw):
        """Reference filelist format: audio_path|text (or audio|sid|text)."""
        items = []
        with open(path, encoding="utf-8") as f:
            for line in f:
                parts = line.rstrip("\n").split("|")
                if len(parts) == 2:
                    items.append(Item(os.path.basename(parts[0]), parts[0], parts[1]))
                elif len(parts) >= 3:
                    items.append(Item(os.path.basename(parts[0]), parts[0], parts[2],
                                      int(parts[1])))
        return cls(items, audio, data, **kw)

    @classmethod
    def concat(cls, datasets: Sequence["TextAudioDataset"], audio: AudioConfig,
               data: DataConfig, sid_offset: bool = False, **kw) -> "TextAudioDataset":
        """Chain several corpora into one dataset. With `sid_offset`, each
        corpus's speaker ids are shifted above the previous corpora's largest
        id, so several single-speaker corpora become speakers 0..K-1."""
        items: List[Item] = []
        offset = 0
        for ds in datasets:
            mx = -1
            for it in ds.items:
                items.append(replace(it, sid=it.sid + offset) if sid_offset else it)
                mx = max(mx, it.sid)
            if sid_offset:
                offset += mx + 1
        return cls(items, audio, data, **kw)

    def __len__(self):
        return len(self.items)

    def get_text_ids(self, text: str) -> np.ndarray:
        if self.data.cleaned_text:
            ids = cleaned_text_to_sequence(text)
        else:
            ids = text_to_sequence(text, list(self.data.text_cleaners))
        if self.data.add_blank:
            ids = intersperse(ids, 0)
        return np.asarray(ids, dtype=np.int32)

    def get_audio_features(self, path: str) -> Tuple[np.ndarray, np.ndarray]:
        """-> (features [T, C], wav [L]), through the write-through cache."""
        a = self.audio
        cache_path = path + (".mel.npy" if self.use_mel else ".spec.npy")
        wav, sr = audio_np.load_wav(path)
        if sr != a.sampling_rate:
            raise ValueError(f"{path}: sr {sr} != configured {a.sampling_rate}")
        n_frames = len(wav) // a.hop_length  # trimmed, so the frame count is exact
        wav = wav[: n_frames * a.hop_length]
        if self.cache and os.path.exists(cache_path):
            feats = np.load(cache_path)
            if feats.shape[0] == n_frames:
                return feats, wav
        if self.use_mel:
            feats = audio_np.mel_spectrogram_np(wav, a.filter_length, a.n_mel_channels,
                                                a.sampling_rate, a.hop_length, a.win_length,
                                                a.mel_fmin, a.mel_fmax)
        else:
            feats = audio_np.spectrogram_np(wav, a.filter_length, a.hop_length, a.win_length)
        if self.cache:
            try:
                np.save(cache_path, feats)
            except OSError:  # a read-only corpus: features are recomputed next time
                pass
        return feats, wav

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        it = self.items[idx]
        feats, wav = self.get_audio_features(it.audio_path)
        return {"x": self.get_text_ids(it.text), "spec": feats, "wav": wav.astype(np.float32),
                "sid": np.int32(it.sid)}


def collate_batch(samples: List[Dict[str, np.ndarray]], pad_text_to: Optional[int] = None,
                  pad_frames_to: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Zero-pad a list of samples to fixed shapes: `pad_text_to` ids and
    `pad_frames_to` frames (the batch's largest when not given)."""
    B = len(samples)
    t_x = pad_text_to or max(len(s["x"]) for s in samples)
    t_y = pad_frames_to or max(s["spec"].shape[0] for s in samples)
    n_c = samples[0]["spec"].shape[1]
    hop = len(samples[0]["wav"]) // samples[0]["spec"].shape[0]
    L = t_y * hop

    x = np.zeros((B, t_x), np.int32)
    x_lengths = np.zeros((B,), np.int32)
    spec = np.zeros((B, t_y, n_c), np.float32)
    spec_lengths = np.zeros((B,), np.int32)
    wav = np.zeros((B, L, 1), np.float32)
    wav_lengths = np.zeros((B,), np.int32)
    sid = np.zeros((B,), np.int32)
    for i, s in enumerate(samples):
        lx = min(len(s["x"]), t_x)
        ly = min(s["spec"].shape[0], t_y)
        ll = min(len(s["wav"]), L)
        x[i, :lx] = s["x"][:lx]
        x_lengths[i] = lx
        spec[i, :ly] = s["spec"][:ly]
        spec_lengths[i] = ly
        wav[i, :ll, 0] = s["wav"][:ll]
        wav_lengths[i] = ll
        sid[i] = s["sid"]
    return {"x": x, "x_lengths": x_lengths, "spec": spec, "spec_lengths": spec_lengths,
            "wav": wav, "wav_lengths": wav_lengths, "sid": sid}
