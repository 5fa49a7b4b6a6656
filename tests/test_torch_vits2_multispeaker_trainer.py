"""The multi-speaker trainer path and CLIs of the port (torch_tts_tpu_torch)
on the CPU.

- The trainer on a tiny synthetic corpus in the reference's
  `audio|sid|text` filelist form with 3 speakers (the tiny config of
  tests/test_torch_vits2_trainer.py made multi-speaker, a narrow MPD): each
  batch carries its items' speaker ids to the step; two epochs straight
  end with the same parameters and optimizer state, `emb_g` and its
  moments included, bit for bit, as one epoch and a fresh trainer resumed
  for the second; `emb_g` moved.
- The train CLI on that filelist with a multi-speaker JSON config.
- The inference CLI's `--sid` (the same speaker gives the same audio,
  another speaker other audio) and the voice conversion CLI
  (`cli/vits2_vc.py`) from a state dict and from a trainer run directory.
"""

import dataclasses
import json
import wave

import numpy as np
import pytest
import torch

from test_torch_vits2_data import AUDIO_KW, DATA_KW, HOP, SR, make_corpus
from test_torch_vits2_trainer import assert_trees_equal, narrow_mpd, tiny_cfg
from torch_tts_tpu_torch.core.config import load_vits2_config
from torch_tts_tpu_torch.data import dataset, sampler
from torch_tts_tpu_torch.train import checkpoint, vits2_trainer
from torch_tts_tpu_torch.utils import logging_utils as lu

SPEAKERS = 3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while this module runs: under pytest-xdist a thread
    per core in every worker oversubscribes the cores, which slowed the
    port's tests about twofold and took CPU from the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ms_cfg(**train_kw):
    """tests/test_torch_vits2_trainer.py's tiny config with 3 speakers and
    the speaker-conditioned text encoder (three layers: it conditions
    before layer 2)."""
    cfg = tiny_cfg(**train_kw)
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, n_layers=3, n_speakers=SPEAKERS, gin_channels=8,
        use_spk_conditioned_encoder=True))


def ms_filelist(root, n=8, **kw):
    """The corpus of make_corpus as an `audio|sid|text` filelist, speaker
    i % 3 for clip i."""
    root = make_corpus(root, n=n, **kw)
    lines = []
    with open(f"{root}/filelist.txt") as f:
        for i, line in enumerate(f.read().splitlines()):
            path, _, text = line.split("|")
            lines.append(f"{path}|{i % SPEAKERS}|{text}")
    path = f"{root}/filelist_ms.txt"
    with open(path, "w") as f:
        f.write("\n".join(lines))
    return path


@pytest.fixture
def narrow(monkeypatch):
    monkeypatch.setattr(vits2_trainer, "build_mpd", narrow_mpd)


def _trainer(cfg, run, ds, **kw):
    return vits2_trainer.VITS2Trainer(cfg, str(run), ds, bucket_boundaries=[4, 48],
                                      pad_text_to=48, make_writer=lu.Recorder, device="cpu",
                                      **kw)


def test_multispeaker_trainer_resume_is_bit_identical(tmp_path, narrow, monkeypatch):
    cfg = ms_cfg()
    ds = dataset.TextAudioDataset.from_filelist(ms_filelist(tmp_path / "ds"), cfg.audio,
                                                cfg.data)
    assert sorted({it.sid for it in ds.items}) == list(range(SPEAKERS))
    spe = len(sampler.DistributedBucketSampler(ds.lengths, 2, [4, 48]))
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, eval_interval=spe))
    seen = []
    step = vits2_trainer.train_step

    def recording(cfg_, state, batch, **kw):
        seen.append(batch["sid"].tolist())
        return step(cfg_, state, batch, **kw)

    monkeypatch.setattr(vits2_trainer, "train_step", recording)
    straight = _trainer(cfg, tmp_path / "a", ds, eval_dataset=ds, eval_max_frames=32)
    emb0 = straight.model.emb_g.weight.detach().clone()
    straight.train(epochs=2)
    assert straight.state.step == 2 * spe and len(seen) == 2 * spe
    assert {s for batch in seen for s in batch} == set(range(SPEAKERS))
    assert not torch.equal(straight.model.emb_g.weight, emb0)
    assert "emb_g.weight" in straight.state.opt_g.names
    first = _trainer(cfg, tmp_path / "b", ds)
    first.train(epochs=1)
    saved = checkpoint.load_file(checkpoint.latest_checkpoint(str(tmp_path / "b")))
    assert "emb_g.weight" in saved["model"] and "emb_g.weight" in saved["opt_g"]["mu"]
    resumed = _trainer(cfg, tmp_path / "b", ds)
    assert resumed.state.step == spe
    assert_trees_equal(checkpoint.state_tree(resumed.state), saved)
    resumed.train(epochs=2)
    assert_trees_equal(checkpoint.state_tree(resumed.state),
                       checkpoint.state_tree(straight.state))


def _json_config(tmp_path, cfg, **train):
    raw = {"model": dataclasses.asdict(cfg.model), "data": {**DATA_KW, **AUDIO_KW},
           "train": train}
    path = tmp_path / "c.json"
    path.write_text(json.dumps(raw))
    return str(path)


def test_cli_trains_a_multispeaker_config(tmp_path, monkeypatch):
    from torch_tts_tpu_torch.cli import vits2_train as cli

    monkeypatch.setattr(vits2_trainer, "build_mpd", narrow_mpd)
    filelist = ms_filelist(tmp_path / "ds", n=10, frames=(34, 38))  # the (32, 300] bucket
    cfg_path = _json_config(tmp_path, ms_cfg(), batch_size=4, log_interval=1, eval_interval=2)
    run = tmp_path / "run"
    trainer = cli.main(["-c", cfg_path, "-m", str(run), "--filelist", filelist, "--epochs", "1",
                        "--device", "cpu"], make_writer=lu.Recorder)
    assert trainer.cfg.model.n_speakers == SPEAKERS and trainer.state.step == 3
    assert checkpoint.latest_checkpoint(str(run)) is not None
    assert all(np.isfinite(v) for _, v in trainer.writer.scalars["loss/g/total"])


@pytest.fixture(scope="module")
def ms_checkpoint(tmp_path_factory):
    """A seeded tiny multi-speaker model saved as a state dict and as a
    trainer checkpoint, its JSON config, and a 1 s wav at the config's
    rate."""
    from test_torch_vits2_trainer import tiny_state
    from torch_tts_tpu_torch.models.vits2 import build_synthesizer
    from torch_tts_tpu_torch.text import symbols
    from torch_tts_tpu_torch.train import vits2_train
    from scipy.io import wavfile

    tmp = tmp_path_factory.mktemp("ms")
    cfg = ms_cfg()
    model = build_synthesizer(cfg, len(symbols), seed=0, device="cpu")
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():  # the flows' zero-initialised output convs would hide the speaker
        for flow in model.flow.flows[::2]:
            flow.post.weight.copy_(torch.randn(flow.post.weight.shape, generator=g) * 0.1)
    torch.save({"model": model.state_dict()}, tmp / "G.pth")
    state = vits2_train.create_train_state(cfg, model, tiny_state().mpd)
    checkpoint.save_checkpoint(str(tmp / "run"), 7, state)
    wav = tmp / "in.wav"
    pcm = (np.random.default_rng(0).standard_normal(SR) * 3000).astype(np.int16)
    wavfile.write(str(wav), SR, pcm)
    return dict(cfg=_json_config(tmp, cfg), pth=str(tmp / "G.pth"), run=str(tmp / "run"),
                wav=str(wav), tmp=tmp)


def test_infer_cli_takes_a_speaker_id(ms_checkpoint):
    from torch_tts_tpu_torch.cli import vits2_infer

    c = ms_checkpoint
    out = {}
    for key, sid in (("a", 0), ("b", 2), ("a again", 0)):
        out[key] = vits2_infer.main(["-c", c["cfg"], "-m", c["pth"], "--text", "Hello there.",
                                     "-o", str(c["tmp"] / "o.wav"), "--max-frames", "64",
                                     "--sid", str(sid), "--device", "cpu"])
    assert np.array_equal(out["a"], out["a again"])
    n = min(out["a"].size, out["b"].size)
    assert n > 0 and not np.array_equal(out["a"][:n], out["b"][:n])


@pytest.mark.parametrize("source", ["pth", "run"])
def test_voice_conversion_cli_on_cpu(ms_checkpoint, source):
    from torch_tts_tpu_torch.cli import vits2_vc

    c = ms_checkpoint
    out = c["tmp"] / f"vc_{source}.wav"
    audio = vits2_vc.main(["-c", c["cfg"], "-m", c[source], "--wav", c["wav"], "--sid-src", "0",
                           "--sid-tgt", "2", "-o", str(out), "--device", "cpu"])
    frames = vits2_vc.wav_features(c["wav"], load_vits2_config(c["cfg"])).shape[0]
    assert audio.shape == (frames * HOP,) and np.isfinite(audio).all()
    with wave.open(str(out)) as f:
        assert (f.getframerate(), f.getnframes()) == (SR, audio.size)
    same = vits2_vc.main(["-c", c["cfg"], "-m", c[source], "--wav", c["wav"], "--sid-src", "0",
                          "--sid-tgt", "0", "-o", str(out), "--device", "cpu"])
    assert not np.array_equal(audio, same)
