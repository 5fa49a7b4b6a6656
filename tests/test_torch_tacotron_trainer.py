"""The Tacotron data pipeline, trainer and CLIs of the port, on the CPU,
against the JAX package where it has the same function.

A synthetic LJSpeech-layout corpus (12 seeded clips of tones and noise,
0.2-0.45 s at 8 kHz) and the tiny config of tests/test_torch_tacotron_train.py.
- The datasets on the same wavs: the transcript's entries, the ids and the
  m_fwd mels of `TacotronDataset` (no cache, with h5py unimportable)
  within 2e-5 (1e-3 dB: two FFT libraries), `collate_tacotron` equal;
  `build_dataset_hdf5` through the prepare CLI, read by both packages'
  `TacotronDatasetHDF5` (the same crops), and the JAX package's cache
  read by the port's.
- `TacotronTrainer`: two epochs (a checkpoint, evaluate() and its image
  each), keep=3 over four; a resume at an epoch boundary equal bit for bit
  to the run it continues; a one-shot iterator.
- The CLIs: prepare -> train (two epochs) -> `--filter` (its scores
  against the JAX CLI's loop on the same checkpoint and PreNet masks,
  within 1e-4, least crisp first) -> `tacotron_infer --run-dir` and
  `TacotronSynthesizer.from_run_dir`.
"""

import json
import logging
import os
import sys

import numpy as np
import pytest
import torch

import jax

from test_torch_tacotron_train import ALPHABET, recorded, tiny_cfg
from torch_tts_tpu.audio.frontend import AudioFrontend as JaxFrontend
from torch_tts_tpu.core import config as jcfg
from torch_tts_tpu.data import tacotron_dataset as jdata
from torch_tts_tpu.models.tacotron import build_tacotron as jax_build
from torch_tts_tpu.models.tacotron.convert import load_torch_state_dict
from torch_tts_tpu.text.encoder import TextEncoder as JaxTextEncoder
from torch_tts_tpu.train import tacotron_train as jtrain
from torch_tts_tpu_torch.audio.frontend import AudioFrontend
from torch_tts_tpu_torch.cli import tacotron_infer, tacotron_prepare, tacotron_train
from torch_tts_tpu_torch.core import config as tcfg
from torch_tts_tpu_torch.data import tacotron_dataset as tdata
from torch_tts_tpu_torch.infer.taco_serving import TacotronSynthesizer
from torch_tts_tpu_torch.models.tacotron.model import TacotronDraws
from torch_tts_tpu_torch.train import checkpoint as ckpt
from torch_tts_tpu_torch.train import tacotron_train as ttrain
from torch_tts_tpu_torch.utils.logging_utils import Recorder

SR, N_CLIPS, MEL_ATOL = 8000, 12, 2e-5
WORDS = "hello there speech synthesis turns written text into natural sounding audio".split()


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_corpus(root, n=N_CLIPS, seed=0):
    """metadata.csv and wavs/LJ0xx.wav, 16-bit PCM at SR."""
    from scipy.io import wavfile

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "wavs"))
    lines = []
    for i in range(n):
        t = np.arange(int(rng.uniform(0.2, 0.45) * SR)) / SR
        f0 = rng.uniform(90, 260)
        wav = sum(0.2 / k * np.sin(2 * np.pi * k * f0 * t) for k in (1, 2, 3))
        wav = wav + 0.02 * rng.standard_normal(t.size)
        wavfile.write(os.path.join(root, "wavs", f"LJ{i:03d}.wav"), SR,
                      np.round(np.clip(wav, -1, 1) * 32767).astype(np.int16))
        text = " ".join(rng.choice(WORDS, size=2 + i % 3))
        lines.append(f"LJ{i:03d}|{text}|{text}")
    with open(os.path.join(root, "metadata.csv"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return root


def write_config(path):
    import dataclasses

    cfg = tiny_cfg(tcfg)
    with open(path, "w") as f:
        json.dump({k: dataclasses.asdict(getattr(cfg, k)) for k in ("audio", "text", "model")}, f)
    return str(path)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = write_corpus(str(tmp_path_factory.mktemp("corpus") / "ljs"))
    cfg = tiny_cfg(tcfg)
    ds = tdata.TacotronDataset(tdata.TranscribedAudioDataset(root),
                               tacotron_infer.text_encoder(cfg),
                               AudioFrontend(cfg.audio, device="cpu"))
    items = [ds[i] for i in range(8)]
    pad_c = max(len(it["c"]) for it in items)
    pad_x = max(it["x"].shape[0] for it in items)
    batches = [tdata.collate_tacotron(items[i: i + 4], pad_text_to=pad_c, pad_frames_to=pad_x,
                                      r=cfg.model.r) for i in (0, 4)]
    return dict(root=root, cfg=cfg, items=items, batches=batches)


JAX_ITEMS = (0, 5)


@pytest.fixture(scope="module")
def jax_items(corpus, tmp_path_factory):
    """The JAX package's TacotronDataset items JAX_ITEMS, written through to
    an HDF5 cache of its own."""
    jc = tiny_cfg(jcfg)
    cache = str(tmp_path_factory.mktemp("jax_cache") / "cache.h5")
    jds = jdata.TacotronDataset(jdata.TranscribedAudioDataset(corpus["root"]),
                                JaxTextEncoder(jc.text.alphabet, (), None, "#"),
                                JaxFrontend(jc.audio), cache_path=cache)
    return {i: jds[i] for i in JAX_ITEMS}, cache


def test_datasets_match_jax_on_the_same_wavs(corpus, jax_items, monkeypatch):
    root, cfg = corpus["root"], corpus["cfg"]
    jbase, tbase = jdata.TranscribedAudioDataset(root), tdata.TranscribedAudioDataset(root)
    assert tbase.entries == jbase.entries and len(tbase) == N_CLIPS
    monkeypatch.setitem(sys.modules, "h5py", None)  # no cache: h5py is never imported
    tds = tdata.TacotronDataset(tbase, tacotron_infer.text_encoder(cfg),
                                AudioFrontend(cfg.audio, device="cpu"))
    for i, want in jax_items[0].items():
        got = tds[i]
        assert got["utt_id"] == want["utt_id"]
        np.testing.assert_array_equal(got["c"], want["c"])
        assert got["x"].dtype == np.float32 and got["x"].shape == want["x"].shape
        np.testing.assert_allclose(got["x"], want["x"], rtol=0, atol=MEL_ATOL)
        assert 0.0 <= got["x"].min() and got["x"].max() <= 1.0


def test_collate_tacotron_matches_jax(corpus):
    items = corpus["items"][:5]
    for kw in (dict(r=2), dict(pad_text_to=40, pad_frames_to=61, r=2), dict(pad_frames_to=20)):
        got, want = tdata.collate_tacotron(items, **kw), jdata.collate_tacotron(items, **kw)
        assert sorted(got) == sorted(want)
        for k in got:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["x"].shape[1] == 20 and (got["x_lengths"] <= 20).all()


def test_prepare_cli_and_hdf5_datasets_match_jax(corpus, jax_items, tmp_path):
    """The prepare CLI's cache read by both packages' TacotronDatasetHDF5
    (the same ids, lengths and max_frames crops from one seed), and the
    JAX package's cache read by the port's."""
    cfg_path = write_config(tmp_path / "c.json")
    ours = str(tmp_path / "ours.h5")
    tacotron_prepare.main([corpus["root"], cfg_path, "--data", ours, "--device", "cpu"])
    jenc = JaxTextEncoder(ALPHABET, (), None, "#")
    tenc = tacotron_infer.text_encoder(corpus["cfg"])
    t = tdata.TacotronDatasetHDF5(ours, tenc, max_frames=30, seed=3)
    j = jdata.TacotronDatasetHDF5(ours, jenc, max_frames=30, seed=3)
    assert t.utt_ids == j.utt_ids and t.lengths == j.lengths and len(t) == N_CLIPS
    assert max(t.lengths) > 30  # some mels are cropped
    for i in range(len(t)):
        a, b = t[i], j[i]
        assert a["utt_id"] == b["utt_id"]
        np.testing.assert_array_equal(a["c"], b["c"])
        np.testing.assert_array_equal(a["x"], b["x"])
    full = tdata.TacotronDatasetHDF5(ours, tenc)
    theirs = tdata.TacotronDatasetHDF5(jax_items[1], tenc)
    assert theirs.utt_ids == [jax_items[0][i]["utt_id"] for i in JAX_ITEMS]
    for k, u in enumerate(theirs.utt_ids):
        np.testing.assert_allclose(theirs[k]["x"], full[full.utt_ids.index(u)]["x"], rtol=0,
                                   atol=MEL_ATOL)
    # a write-through cache on the fly fills the same entries
    cache = str(tmp_path / "cache.h5")
    ds = tdata.TacotronDataset(tdata.TranscribedAudioDataset(corpus["root"]), tenc,
                               AudioFrontend(corpus["cfg"].audio, device="cpu"), cache_path=cache)
    first = ds[2]
    np.testing.assert_array_equal(ds[2]["x"], first["x"])
    np.testing.assert_array_equal(tdata.TacotronDatasetHDF5(cache, tenc)[0]["x"], first["x"])


def _trainer(cfg, run_dir, **kw):
    return ttrain.TacotronTrainer(cfg, run_dir, make_writer=Recorder, device="cpu", **kw)


def test_trainer_two_epochs_checkpoints_and_evaluates(corpus, tmp_path):
    cfg, batches = corpus["cfg"], corpus["batches"]
    run = str(tmp_path / "run")
    tr = _trainer(cfg, run)
    tr.train(batches, eval_batches=batches[:1], num_epochs=2, log_interval=1)
    assert tr.state.step == 4 and tr.state.opt_g.count == 4
    assert [os.path.basename(p) for p in ckpt.list_checkpoints(run)] == ["ckpt_2.pt", "ckpt_4.pt"]
    sc = tr.writer.scalars
    assert [s for s, _ in sc["loss"]] == [1, 2, 3, 4] and [s for s, _ in sc["eval/loss"]] == [2, 4]
    assert all(np.isfinite(v) for k in ("loss", "grad_norm", "eval/loss") for _, v in sc[k])
    img = tr.writer.images["eval/alignment"][-1][1]
    assert img.ndim == 3 and img.dtype == np.uint8
    saved = ckpt.load_file(ckpt.latest_checkpoint(run))
    assert saved["step"] == 4 and saved["opt_g"]["count"] == 4
    assert sorted(saved["model"]) == sorted(tr.model.state_dict())


def test_trainer_resume_is_bit_for_bit(corpus, tmp_path):
    """Four epochs straight against two, then a new trainer in the same
    directory (the epoch fast-forward) for the last two: every tensor of the
    state equal; keep=3 leaves the last three checkpoints."""
    cfg, batches = corpus["cfg"], corpus["batches"]
    straight = _trainer(cfg, str(tmp_path / "a"))
    straight.train(batches, num_epochs=4)
    run = str(tmp_path / "b")
    _trainer(cfg, run).train(batches, num_epochs=2)
    resumed = _trainer(cfg, run)
    assert resumed.state.step == 4
    resumed.train(batches, num_epochs=4)
    assert resumed.state.step == 8
    a, b = ckpt.state_tree(straight.state), ckpt.state_tree(resumed.state)
    assert a["opt_g"]["count"] == b["opt_g"]["count"] == 8
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    for slot in ("mu", "nu"):
        for k, v in a["opt_g"][slot].items():
            assert torch.equal(v, b["opt_g"][slot][k]), (slot, k)
    assert [os.path.basename(p) for p in ckpt.list_checkpoints(run)] == [
        "ckpt_4.pt", "ckpt_6.pt", "ckpt_8.pt"]


def test_trainer_one_shot_iterator(corpus, tmp_path, caplog):
    tr = _trainer(corpus["cfg"], str(tmp_path / "run"))
    with caplog.at_level(logging.WARNING):
        tr.train(iter(corpus["batches"]), num_epochs=2)
    assert tr.state.step == 2 and "one-shot iterator" in caplog.text
    tr.train(iter([]), num_epochs=1)
    assert tr.state.step == 2


@pytest.fixture(scope="module")
def cli_run(corpus, tmp_path_factory):
    """prepare -> train (two epochs) through the CLIs."""
    tmp = tmp_path_factory.mktemp("cli")
    cfg_path = write_config(tmp / "c.json")
    h5 = str(tmp / "data.h5")
    tacotron_prepare.main([corpus["root"], cfg_path, "--data", h5, "--device", "cpu"])
    run = str(tmp / "run")
    tr = tacotron_train.main([h5, cfg_path, "--run-dir", run, "--batch-size", "4",
                              "--eval-batch-size", "4", "--epochs", "2", "--writer", "jsonl",
                              "--device", "cpu"])
    return dict(tmp=tmp, cfg_path=cfg_path, h5=h5, run=run, trainer=tr)


def test_train_cli_filter_scores_match_jax(cli_run, monkeypatch):
    c = cli_run
    assert c["trainer"].state.step == 2 * 3  # 11 training items (1 held out) in batches of 4
    tenc = tacotron_infer.text_encoder(tiny_cfg(tcfg))
    assert os.path.exists(os.path.join(c["run"], "scalars.jsonl"))
    # the JAX CLI's --filter loop on the same checkpoint, its PreNet masks recorded
    jc = tiny_cfg(jcfg)
    jm = jax_build(jc)
    ds = jdata.TacotronDatasetHDF5(c["h5"], JaxTextEncoder(jc.text.alphabet, (), None, "#"))
    pad_c, pad_x = tacotron_train.pad_lengths(
        tdata.TacotronDatasetHDF5(c["h5"], tenc), jc.model.r, None)
    first = jdata.collate_tacotron([ds[i] for i in range(4)], pad_c, pad_x, jc.model.r)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2)}, first["c"], first["c_lengths"], first["x"],
        first["x_lengths"], train=True, deterministic=False))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    sd = {k: v.numpy() for k, v in ckpt.load_file(ckpt.latest_checkpoint(c["run"]))["model"].items()}
    params, stats = load_torch_state_dict(sd, zeros["params"], zeros["batch_stats"], jc)
    state = jtrain.TacoTrainState(step=0, params=params, batch_stats=stats, opt=None)
    with recorded() as record:
        eval_fn = jax.jit(jtrain.make_eval_step(jc, jm))
        want, masks = {}, []
        for start in range(0, len(ds), 4):
            chunk = list(range(start, min(start + 4, len(ds))))
            batch = jdata.collate_tacotron([ds[i] for i in chunk], pad_c, pad_x, jc.model.r)
            n0 = len(record)
            _, w = eval_fn(state, batch, jax.random.PRNGKey(0))
            w = np.asarray(w)
            jax.effects_barrier()
            pairs = [torch.from_numpy(np.array(v)) for _, v in record[n0:]]
            masks.append(torch.stack([torch.stack(pairs[i: i + 2])
                                      for i in range(0, len(pairs), 2)]))
            for bi, i in enumerate(chunk):
                S = max(1, int(batch["x_lengths"][bi]) // jc.model.r)
                want[ds.utt_ids[i]] = float(w[bi, :S].max(axis=1).mean())
    # the port's CLI with those masks in place of its generator's
    real_eval = ttrain.eval_step
    calls = iter(masks)
    monkeypatch.setattr(ttrain, "eval_step", lambda model, batch, draws=None, generator=None:
                        real_eval(model, batch, draws=TacotronDraws(next(calls))))
    out = str(c["tmp"] / "scores.tsv")
    scores = tacotron_train.main([c["h5"], c["cfg_path"], "--run-dir", c["run"], "--batch-size",
                                  "4", "--filter", out, "--writer", "jsonl", "--device", "cpu"])
    assert sorted(scores) == sorted(want) and len(scores) == N_CLIPS
    for k in want:
        assert abs(scores[k] - want[k]) < 1e-4, k
    lines = [ln.split("\t") for ln in open(out).read().splitlines()]
    assert [u for u, _ in lines] == sorted(scores, key=scores.get)
    assert [float(s) for _, s in lines] == sorted(float(s) for _, s in lines)


def test_infer_run_dir_and_synthesizer_from_run_dir(cli_run, tmp_path):
    c = cli_run
    latest = ckpt.load_file(ckpt.latest_checkpoint(c["run"]))["model"]
    out = str(tmp_path / "o.wav")
    argv = ["hello there", c["cfg_path"], "-o", out, "--max-steps", "6",
            "--griffin-lim-iters", "2", "--device", "cpu"]
    wav, mel = tacotron_infer.main(argv + ["--run-dir", c["run"]])
    assert np.isfinite(wav).all() and wav.size > 0 and os.path.getsize(out) == 44 + 2 * wav.size
    model = tacotron_infer.load_model(tiny_cfg(tcfg), c["run"], "cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(v, latest[k]), k
    with pytest.raises(SystemExit):  # exactly one of -m and --run-dir
        tacotron_infer.main(argv + ["--run-dir", c["run"], "-m", "x.pth"])
    synth = TacotronSynthesizer.from_run_dir(c["cfg_path"], c["run"], device="cpu",
                                             buckets=((16, 8),), batch_tiers=(1,),
                                             griffin_lim_iters=2)
    for k, v in synth.model.state_dict().items():
        assert torch.equal(v.cpu(), latest[k]), k
    res = synth.synthesize(["hello there"], seed=1)[0]
    assert res.audio.size > 0 and np.isfinite(res.audio).all()
