"""The VITS2 trainer's data path of the port (torch_tts_tpu_torch)
against the JAX package, on the CPU.

- `DistributedBucketSampler` gives the JAX package's schedule exactly
  (epochs 1-3, one and two replicas).
- `TextAudioDataset` (`from_ljspeech`, `from_filelist`, `concat`) gives
  the JAX package's items, text ids and features bit for bit, and
  `collate_batch` its padded batch; a feature cache written by either
  package is the same file, and each reads the other's.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from torch_tts_tpu.core.config import AudioConfig as JAudio
from torch_tts_tpu.core.config import DataConfig as JData
from torch_tts_tpu.data import dataset as jdataset
from torch_tts_tpu.data import sampler as jsampler
from torch_tts_tpu_torch.core.config import AudioConfig, DataConfig
from torch_tts_tpu_torch.data import dataset, sampler
from torch_tts_tpu_torch.train import vits2_trainer

HOP, SR = 64, 8000
AUDIO_KW = dict(sampling_rate=SR, filter_length=128, hop_length=HOP, win_length=128,
                n_mel_channels=20)
DATA_KW = dict(text_cleaners=("basic_cleaners",), add_blank=True)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while this module runs: under pytest-xdist a thread
    per core in every worker oversubscribes the cores, which slowed the
    port's tests about twofold and took CPU from the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_corpus(root, n=10, frames=(20, 24, 28), seed=0):
    """An LJSpeech-layout corpus of n seeded noise clips (16-bit PCM) of
    the given frame counts in turn, and a filelist of the same clips."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "wavs"), exist_ok=True)
    meta, flist = [], []
    for i in range(n):
        pcm = (rng.standard_normal(HOP * frames[i % len(frames)] + 17) * 2000).astype(np.int16)
        path = os.path.join(root, "wavs", f"u{i}.wav")
        wavfile.write(path, SR, pcm)
        meta.append(f"u{i}|Hello there, {i}!|hello there number {i}")
        flist.append(f"{path}|{i % 2}|Hello there number {i}.")
    with open(os.path.join(root, "metadata.csv"), "w") as f:
        f.write("\n".join(meta))
    with open(os.path.join(root, "filelist.txt"), "w") as f:
        f.write("\n".join(flist))
    return str(root)


# ---------------------------------------------------------------- sampler


@pytest.mark.parametrize("num_replicas", [1, 2])
def test_bucket_sampler_schedule_matches_jax(num_replicas):
    rng = np.random.default_rng(3)
    lengths = list(rng.integers(1, 1200, 300))
    kw = dict(lengths=lengths, batch_size=4, boundaries=vits2_trainer.BUCKET_BOUNDARIES,
              num_replicas=num_replicas)
    for rank in range(num_replicas):
        got, want = (mod.DistributedBucketSampler(**kw, rank=rank) for mod in (sampler, jsampler))
        assert len(got) == len(want) > 0 and got.boundaries == want.boundaries
        for epoch in (1, 2, 3):
            got.set_epoch(epoch)
            want.set_epoch(epoch)
            a = [(pf, [int(i) for i in b]) for pf, b in got]
            assert a == [(pf, [int(i) for i in b]) for pf, b in want]
            assert len(a) == len(got)
    a = sampler.LengthBucketRandomSampler(lengths, 8, seed=5)
    b = jsampler.LengthBucketRandomSampler(lengths, 8, seed=5)
    assert [list(map(int, x)) for x in a] == [list(map(int, x)) for x in b]


# ---------------------------------------------------------------- data


def _pair(kind, root, **kw):
    audio, data = AudioConfig(**AUDIO_KW), DataConfig(**DATA_KW, max_text_len=40)
    jaudio, jdata = JAudio(**AUDIO_KW), JData(**DATA_KW, max_text_len=40)
    src = os.path.join(root, "filelist.txt") if kind == "from_filelist" else root
    return (getattr(dataset.TextAudioDataset, kind)(src, audio, data, **kw),
            getattr(jdataset.TextAudioDataset, kind)(src, jaudio, jdata, **kw))


@pytest.mark.parametrize("kind", ["from_ljspeech", "from_filelist"])
def test_dataset_and_collate_match_jax(tmp_path, kind):
    root = make_corpus(tmp_path / "ds", n=6)
    got, want = _pair(kind, root, cache=False)
    assert [dataclasses.astuple(i) for i in got.items] == \
        [dataclasses.astuple(i) for i in want.items]
    assert got.lengths == want.lengths and len(got) == 6
    samples = []
    for i in range(len(got)):
        a, b = got[i], want[i]
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        samples.append((a, b))
    for kw in (dict(pad_text_to=81, pad_frames_to=40), {}):
        a = dataset.collate_batch([s[0] for s in samples], **kw)
        b = jdataset.collate_batch([s[1] for s in samples], **kw)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    # spectrogram features (a linear posterior) too
    ga, wa = _pair(kind, root, cache=False, use_mel=False)
    assert np.array_equal(ga[0]["spec"], wa[0]["spec"]) and ga[0]["spec"].shape[1] == 65


def test_feature_cache_is_shared_with_jax(tmp_path):
    roots = [make_corpus(tmp_path / name, n=3) for name in ("port", "jax")]
    got, _ = _pair("from_ljspeech", roots[0])
    _, want = _pair("from_ljspeech", roots[1])
    for ds in (got, want):
        for i in range(len(ds)):
            ds[i]
    for i in range(3):
        a, b = (os.path.join(r, "wavs", f"u{i}.wav.mel.npy") for r in roots)
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
    # each package reads the other's cache: a marked cache comes back as is
    for reader_root, reader in ((roots[1], "port"), (roots[0], "jax")):
        path = os.path.join(reader_root, "wavs", "u0.wav.mel.npy")
        marked = np.load(path) + 1.0
        np.save(path, marked)
        ds = _pair("from_ljspeech", reader_root)[0 if reader == "port" else 1]
        assert np.array_equal(ds[0]["spec"], marked)


def test_concat_offsets_speakers_as_jax(tmp_path):
    root = make_corpus(tmp_path / "ds", n=4)
    a1, b1 = _pair("from_filelist", root, cache=False)
    a2, b2 = _pair("from_ljspeech", root, cache=False)
    got = dataset.TextAudioDataset.concat([a1, a2], a1.audio, a1.data, sid_offset=True)
    want = jdataset.TextAudioDataset.concat([b1, b2], b1.audio, b1.data, sid_offset=True)
    assert [dataclasses.astuple(i) for i in got.items] == \
        [dataclasses.astuple(i) for i in want.items]
    assert {i.sid for i in got.items} == {0, 1, 2}
