"""The MB-iSTFT model (`decoder_type: mb_istft`) through the serving layer,
the trainer and the CLIs of the port, on the CPU.

The serving files' tiny model and buckets (tests/test_torch_serving.py)
with the MB-iSTFT decoder: one trunk stage x4, iSTFT x4 (n_fft 16, hop 4),
PQMF x4 = the hop of 64. Its audio is not bounded (no tanh), so the
tolerances below are relative to each clip's peak.

- `Synthesizer.synthesize` at zero noise against the JAX package's
  `Synthesizer` on the same weights (float32 transfer): equal lengths,
  samples within 1e-5 of the peak (plus rtol 1e-4).
- `stream()` against `synthesize` of the same text and seed, in windows
  and in one window: within 2e-5 of the peak; `ContinuousBatcher` results
  against serial `synthesize` at zero noise (1e-5 of the peak: other batch
  shapes sum in other orders, and exp of the log-magnitude multiplies
  that);
  `synthesize_long`'s length; `make_server`'s /tts and /tts_stream.
- The trainer at the trainer files' tiny config with the MB-iSTFT decoder
  and a narrow MPD: two epochs straight equal, bit for bit, one epoch and
  a fresh trainer resumed for the second; the train CLI for one epoch
  from a JSON config.
- The inference CLI with a flow type's JSON config (`fft`, a mono type)
  and a seeded state dict.
- The inference CLI with the config as JSON and a trainer checkpoint:
  the whole decode and `--stream-chunk` agree within 2e-5 of the peak but
  for the last EDGE samples (below), and `from_run_dir` (the web UI's
  loader) builds the model.

Where the two decodes differ: a stream decodes its last window masked,
whose padded frames give `conv_post`'s bias as log-magnitudes; the iSTFT
(n_fft / 2 subband samples, x subbands) and the PQMF (taps / 2) carry that
EDGE = 8 * 4 + 31 samples back across the utterance's end. `infer` (JAX
and port alike) decodes an utterance of at least 128 frames in a
max_frames above 128 with its patch window ending at the utterance's end,
the exact-length decode, so its last EDGE samples differ from the stream's;
below that it decodes masked too, and the two agree everywhere (the
serving buckets here are below 128 frames).
"""

import dataclasses
import io
import json
import threading
import urllib.request
import wave

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_serving import AUDIO_KW as SERVING_AUDIO_KW
from test_torch_serving import BUCKETS, DATA_KW, HOP, MODEL_KW
from test_torch_vits2_data import AUDIO_KW as DATA_AUDIO_KW
from test_torch_vits2_data import DATA_KW as CORPUS_DATA_KW
from test_torch_vits2_data import make_corpus
from test_torch_vits2_infer import random_params
from test_torch_vits2_trainer import assert_trees_equal, narrow_mpd, tiny_cfg
from torch_tts_tpu_torch.infer import serving
from torch_tts_tpu_torch.ops.mb_istft import MultiBandISTFTGenerator
from torch_tts_tpu_torch.train import checkpoint, vits2_trainer
from torch_tts_tpu_torch.utils import logging_utils as lu

MB_KW = dict(upsample_rates=(4,), upsample_kernel_sizes=(8,), decoder_type="mb_istft",
             subbands=4, gen_istft_n_fft=16, gen_istft_hop_size=4)
TEXTS = ["hi", "hello there", "a longer sentence here.", "ok"]
ZERO = dict(noise_scale=0.0, noise_scale_w=0.0)
SCALES = dict(noise_scale=0.667, length_scale=1.0, noise_scale_w=0.8)
JAX_RTOL, JAX_REL_ATOL = 1e-4, 1e-5
STREAM_REL_ATOL, SAME_REL_ATOL = 2e-5, 1e-5
EDGE = 16 // 2 * 4 + 62 // 2  # n_fft / 2 * subbands + PQMF taps / 2
LONG = ("Speech synthesis is neat. It turns text into audio, one sentence at a time; "
        "long texts are split at their sentences, then at their clauses.")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while this module runs: under pytest-xdist a thread
    per core in every worker oversubscribes the cores, which slowed the
    port's tests about twofold and took CPU from the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(a, b, rel_atol, rtol=0.0):
    assert a.shape == b.shape and len(a) > 0
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rel_atol * max(1.0, float(np.abs(b).max())))


@pytest.fixture(scope="module")
def weights():
    """One set of random weights of the MB-iSTFT serving model: the JAX
    config and params, the port's config and state dict."""
    from torch_tts_tpu.core.config import AudioConfig, DataConfig, VITS2Config, VITS2ModelConfig
    from torch_tts_tpu.train.vits2_trainer import build_models
    from torch_tts_tpu_torch.core import config as pc
    from torch_tts_tpu_torch.models.vits2.convert import state_dict_from_jax_params

    kw = dict(MODEL_KW, **MB_KW)
    jcfg = VITS2Config(audio=AudioConfig(**SERVING_AUDIO_KW), data=DataConfig(**DATA_KW),
                       model=VITS2ModelConfig(**kw))
    jmodel, _, _ = build_models(jcfg)
    rngs = {k: jax.random.PRNGKey(i) for i, k in enumerate(("params", "noise", "dropout"))}
    shapes = jax.eval_shape(lambda: jmodel.init(
        rngs, jnp.ones((1, 5), jnp.int32), jnp.asarray([5]),
        jnp.zeros((1, 16, jcfg.posterior_channels)), jnp.asarray([16]))["params"])
    params = random_params(shapes, np.random.default_rng(9))
    cfg = pc.VITS2Config(audio=pc.AudioConfig(**SERVING_AUDIO_KW),
                         data=pc.DataConfig(**DATA_KW),
                         model=pc.VITS2ModelConfig(**kw, fuse_mrf=True)).check()
    return dict(jcfg=jcfg, params=params, cfg=cfg,
                sd=state_dict_from_jax_params(params, jcfg.model))


def synth(weights, **kw):
    kw.setdefault("transfer_dtype", "float32")
    return serving.Synthesizer(weights["cfg"], weights["sd"], buckets=BUCKETS, device="cpu", **kw)


def test_synthesize_matches_the_jax_synthesizer(weights):
    from torch_tts_tpu.infer.serving import Synthesizer as JaxSynthesizer

    want = JaxSynthesizer(weights["jcfg"], weights["params"], buckets=BUCKETS,
                          transfer_dtype="float32").synthesize(TEXTS, seed=0, **ZERO)
    s = synth(weights)
    assert isinstance(s.model.dec, MultiBandISTFTGenerator)
    got = s.synthesize(TEXTS, seed=0, **ZERO)
    assert {s._bucket_for(len(s.encode_text(t))) for t in TEXTS} == set(BUCKETS)
    for a, b in zip(got, want):
        assert a.sample_rate == b.sample_rate and len(a.audio) % HOP == 0
        _close(a.audio, np.asarray(b.audio), JAX_REL_ATOL, JAX_RTOL)


@pytest.mark.parametrize("chunk,context", [(16, 16), (64, 32)], ids=["windows", "one_window"])
def test_stream_matches_synthesize(weights, chunk, context):
    s = synth(weights)
    text = "a longer sentence here."
    whole = s.synthesize([text], seed=21, **SCALES)[0].audio
    pieces = list(s.stream(text, chunk_frames=chunk, context_frames=context, seed=21, **SCALES))
    n_frames = len(whole) // HOP
    windowed = chunk + 2 * context < BUCKETS[1][1]
    assert len(pieces) == (-(-n_frames // chunk) if windowed else 1)
    assert not windowed or n_frames > 2 * chunk
    _close(np.concatenate(pieces), whole, STREAM_REL_ATOL)


def test_batcher_matches_serial_synthesize(weights):
    s = synth(weights)
    serial = {t: s.synthesize([t], **ZERO)[0].audio for t in TEXTS}
    with serving.ContinuousBatcher(s) as b:
        futs = [(t, b.submit(t, seed=i, **ZERO)) for i, t in enumerate(TEXTS * 2)]
        results = [(t, f.result(timeout=300)) for t, f in futs]
        stats = b.stats()
    for t, r in results:
        _close(r.audio, serial[t], SAME_REL_ATOL)
    assert stats["failures_total"] == 0 and stats["batched_requests_total"] == 2 * len(TEXTS)


def test_synthesize_long_is_its_pieces_and_pauses(weights):
    s = synth(weights)
    chunks = s._long_chunks(LONG)
    pieces = s.synthesize(chunks, seed=5, **SCALES)
    r = s.synthesize_long(LONG, pause_ms=50.0, seed=5, **SCALES)
    pause = int(SERVING_AUDIO_KW["sampling_rate"] * 50 / 1000)
    assert len(chunks) > 1
    assert len(r.audio) == sum(len(p.audio) for p in pieces) + pause * (len(chunks) - 1)
    np.testing.assert_array_equal(r.audio[:len(pieces[0].audio)], pieces[0].audio)


def test_web_ui_serves_the_mbistft_model(weights):
    from torch_tts_tpu_torch.cli import webui

    s = synth(weights, transfer_dtype="int16")
    srv, batcher = webui.make_server(s, port=0, host="127.0.0.1", stream_chunks=(16,))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        with urllib.request.urlopen(f"{url}/tts?text=hello%20there&seed=3", timeout=300) as r:
            body = r.read()
        with wave.open(io.BytesIO(body)) as f:
            pcm = np.frombuffer(f.readframes(f.getnframes()), "<i2")
        want = s.synthesize(["hello there"], seed=3)[0].audio
        np.testing.assert_array_equal(pcm, np.round(want * 32767).astype("<i2"))
        with urllib.request.urlopen(f"{url}/tts_stream?text=hello%20there&seed=3&chunk=16",
                                    timeout=300) as r:
            streamed = np.frombuffer(r.read(), "<i2").astype(np.int32)
        assert streamed.shape == pcm.shape and int(np.abs(streamed - pcm).max()) <= 1
    finally:
        srv.shutdown()
        srv.server_close()
        batcher.close()
        thread.join(timeout=30)


def mb_tiny_cfg(**train_kw):
    """tests/test_torch_vits2_trainer.py's tiny config (hop 64) with the
    MB-iSTFT decoder."""
    cfg = tiny_cfg(**train_kw)
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **MB_KW)).check()


def _trainer(cfg, run, ds, **kw):
    return vits2_trainer.VITS2Trainer(cfg, str(run), ds, bucket_boundaries=[4, 48],
                                      pad_text_to=48, make_writer=lu.Recorder, device="cpu",
                                      **kw)


def test_trainer_resume_is_bit_identical(tmp_path, monkeypatch):
    from torch_tts_tpu_torch.data import dataset, sampler

    monkeypatch.setattr(vits2_trainer, "build_mpd", narrow_mpd)
    cfg = mb_tiny_cfg()
    ds = dataset.TextAudioDataset.from_ljspeech(make_corpus(tmp_path / "ds", n=8), cfg.audio,
                                                cfg.data)
    spe = len(sampler.DistributedBucketSampler(ds.lengths, 2, [4, 48]))
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, eval_interval=spe))
    straight = _trainer(cfg, tmp_path / "a", ds, eval_dataset=ds, eval_max_frames=32)
    assert isinstance(straight.model.dec, MultiBandISTFTGenerator)
    bias0 = straight.model.dec.conv_post.bias.detach().clone()
    straight.train(epochs=2)
    assert straight.state.step == 2 * spe
    assert not torch.equal(straight.model.dec.conv_post.bias, bias0)
    assert all(np.isfinite(v) for vals in straight.writer.scalars.values() for _, v in vals)
    first = _trainer(cfg, tmp_path / "b", ds)
    first.train(epochs=1)
    saved = checkpoint.load_file(checkpoint.latest_checkpoint(str(tmp_path / "b")))
    assert "dec.conv_post.bias" in saved["model"]
    resumed = _trainer(cfg, tmp_path / "b", ds)
    assert resumed.state.step == spe
    assert_trees_equal(checkpoint.state_tree(resumed.state), saved)
    resumed.train(epochs=2)
    assert_trees_equal(checkpoint.state_tree(resumed.state),
                       checkpoint.state_tree(straight.state))


def _json_config(path, cfg, **train):
    path.write_text(json.dumps({"model": dataclasses.asdict(cfg.model),
                                "data": {**CORPUS_DATA_KW, **DATA_AUDIO_KW}, "train": train}))
    return str(path)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The train CLI for one epoch on a tiny corpus with the MB-iSTFT JSON
    config (a narrow MPD): its run directory and config."""
    from torch_tts_tpu_torch.cli import vits2_train as cli

    tmp = tmp_path_factory.mktemp("mb_cli")
    build_mpd = vits2_trainer.build_mpd
    vits2_trainer.build_mpd = narrow_mpd
    try:
        root = make_corpus(tmp / "ds", n=10, frames=(34, 38))  # the (32, 300] bucket
        cfg_path = _json_config(tmp / "c.json", mb_tiny_cfg(), batch_size=4, log_interval=1,
                                eval_interval=2)
        run = tmp / "run"
        trainer = cli.main(["-c", cfg_path, "-m", str(run), "--data-root", str(root),
                            "--epochs", "1", "--device", "cpu"], make_writer=lu.Recorder)
    finally:
        vits2_trainer.build_mpd = build_mpd
    return dict(trainer=trainer, cfg=cfg_path, run=str(run), tmp=tmp)


def test_train_cli_runs_an_epoch_of_the_mbistft_config(trained):
    trainer = trained["trainer"]
    assert trainer.cfg.model.decoder_type == "mb_istft" and trainer.state.step >= 2
    assert isinstance(trainer.model.dec, MultiBandISTFTGenerator)
    assert checkpoint.latest_checkpoint(trained["run"]) is not None
    assert all(np.isfinite(v) for _, v in trainer.writer.scalars["loss/g/total"])


def test_infer_cli_whole_and_streamed_on_the_trained_run(trained):
    from torch_tts_tpu_torch.cli import vits2_infer

    tmp, text = trained["tmp"], "a longer sentence here, with a clause."
    common = ["-c", trained["cfg"], "-m", trained["run"], "--text", text, "--max-frames", "300",
              "--device", "cpu", "--seed", "4"]
    whole = vits2_infer.main(common + ["-o", str(tmp / "whole.wav")])
    streamed = vits2_infer.main(common + ["--stream-chunk", "16", "-o", str(tmp / "stream.wav")])
    assert np.isfinite(whole).all() and len(whole) > 128 * HOP and len(whole) % HOP == 0
    assert streamed.shape == whole.shape
    _close(streamed[:-EDGE], whole[:-EDGE], STREAM_REL_ATOL)
    with wave.open(str(tmp / "whole.wav")) as f:
        assert f.getnframes() == whole.size
    s = serving.Synthesizer.from_run_dir(trained["cfg"], trained["run"], device="cpu",
                                         transfer_dtype="float32")
    assert isinstance(s.model.dec, MultiBandISTFTGenerator)
    assert np.isfinite(s.synthesize([text], seed=4)[0].audio).all()


@pytest.mark.parametrize("flow_type", ["fft", "mono_layer_post_residual"])
def test_infer_cli_takes_a_flow_type_config(tmp_path, flow_type):
    from torch_tts_tpu_torch.cli import vits2_infer
    from torch_tts_tpu_torch.models.vits2 import build_synthesizer
    from torch_tts_tpu_torch.text import symbols

    cfg = tiny_cfg()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                             transformer_flow_type=flow_type))
    torch.save({"model": build_synthesizer(cfg, len(symbols), seed=0, device="cpu").state_dict()},
               tmp_path / "G.pth")
    audio = vits2_infer.main(["-c", _json_config(tmp_path / "c.json", cfg), "-m",
                              str(tmp_path / "G.pth"), "--text", "hello there", "-o",
                              str(tmp_path / "o.wav"), "--max-frames", "64", "--device", "cpu"])
    assert audio.size > 0 and audio.size % HOP == 0 and np.isfinite(audio).all()
