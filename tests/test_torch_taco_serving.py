"""The Tacotron serving layer (`infer/taco_serving.py`): the port's
`TacotronSynthesizer` against the JAX package's, and its stream against
its own batch path.

A tiny Taco2Prod (dim_rnn (16, 16), PreNet 8, r = 2, 20 mels, 8 kHz, hop
32) with numpy-seeded weights and batch statistics, and the tiny HiFi-GAN
vocoder of tests/test_torch_vocoder.py, carried across by the port's
converters; buckets ((16, 12), (32, 24)), tiers (1, 2). The port takes the
JAX decoder's PreNet masks through `prenet_masks(seed, steps, tier)`: the
key JAX derives for a group (fold_in(PRNGKey(seed), tier), split),
replayed per step (fold_in(fold_in(kd, t), j)). Griffin-Lim's phases are
injected on both sides. The stop bias is set on both sides (from the
port's stop logits) so that the stream's text stops at a chosen group.

Tolerances: `synthesize` with the vocoder and with Griffin-Lim (4
iterations) within 1e-4 of the peak (the peak-normalised audio within
1e-4), the stop lengths and so the lengths exactly, the attention within
1e-4. The port against itself: padding rows change nothing (1e-6; beside
another text 1e-5, the vocoder's batch is the real rows); the
stream equals the tier-1 batch audio after its peak (1e-6) when no stop
fires (chunks that divide the bucket's steps and chunks whose last one
overhangs them); with a stop it equals postnet + vocoder over the tier-1
batch decode's mel trimmed at the stop (1e-6), and the batch audio but for
the frames whose receptive field reaches past the stop; a stop before one
window, and a bucket shorter than one window, fall back to the batch path.
"""

import contextlib
import logging
import unittest.mock as mock
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_tacotron import _fill, replay_prenet_masks
from test_torch_vocoder import AUDIO, GEN_KWARGS, M, jax_generator_params
from torch_tts_tpu.core import config as jcfg
from torch_tts_tpu.infer import taco_serving as jserving
from torch_tts_tpu.infer import vocoder as jvoc
from torch_tts_tpu.models.tacotron import build_tacotron as jax_build
from torch_tts_tpu_torch.core import config as tcfg
from torch_tts_tpu_torch.infer import taco_serving as serving
from torch_tts_tpu_torch.infer import vocoder
from torch_tts_tpu_torch.infer.serving import ContinuousBatcher
from torch_tts_tpu_torch.models.tacotron.convert import state_dict_from_jax_params
from torch_tts_tpu_torch.models.vits2.convert import generator_state_dict_from_jax_params

R, HOP, P = 2, 32, 8
BUCKETS, TIERS = ((16, 12), (32, 24)), (1, 2)
TEXTS = ["hello world", "abc", "a somewhat longer sentence here", "ok then"]
STREAM_TEXT = TEXTS[2]
STOP_GROUP = (16, 21)  # the stream text's stop lands in this range of groups
PEAK_ATOL, SAME_ATOL = 1e-4, 1e-6
# the vocoder's batch is the group's real rows: a text beside a padding row
# and beside another text goes through convolutions of batch 1 and 2
PAD_ATOL = 1e-5
# the frames at the end of an utterance whose audio reaches past its stop:
# the postnet's (2 layers of k 5, 4 frames) and the vocoder's receptive field
EDGE_FRAMES = 12


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while this module runs: under pytest-xdist a thread
    per core in every worker oversubscribes the cores, which slowed the
    port's tests about twofold and took CPU from the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfgs(pkg):
    return pkg.TacotronConfig(
        audio=pkg.TacotronAudioConfig(**AUDIO), text=pkg.TacotronTextConfig(),
        model=pkg.TacotronModelConfig(dim_emb=16, dim_out=16, r=R, dim_pre=P, dim_att=16,
                                      dim_rnn=(16, 16), postnet_dim_hidden=16,
                                      postnet_num_layers=2))


_MASKS = {}


def jax_masks(seed, steps, batch):
    """The masks the JAX synthesizer's group of `batch` rows draws."""
    k = (seed, steps, batch)
    if k not in _MASKS:
        kd, _ = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), batch))
        _MASKS[k] = torch.from_numpy(replay_prenet_masks(kd, steps, batch, P))
    return _MASKS[k]


def phases(shape):
    return np.random.default_rng(int(np.prod(shape))).random(shape).astype(np.float32) * 2 * np.pi


@contextlib.contextmanager
def injected_phases(port_synth):
    """Griffin-Lim's initial phases from `phases` on both sides."""
    gl = port_synth.frontend.griffin_lim

    def port_gl(p, n_iter=32, **kw):
        return gl(p, n_iter, phases=torch.from_numpy(phases(tuple(p.shape))))

    with mock.patch.object(jax.random, "uniform",
                           lambda key, shape, *a, **k: jnp.asarray(phases(shape))), \
            mock.patch.object(port_synth.frontend, "griffin_lim", port_gl):
        yield


def _with_stop_bias(tm, sd_bias):
    with torch.no_grad():
        tm.decoder.fc_stop.bias.copy_(torch.as_tensor(sd_bias))


def choose_stop_bias(cfg, sd, ids):
    """A shift of the stop bias that makes the tier-1 decode of `ids` stop
    at a group in STOP_GROUP: the first group whose smallest stop logit sets
    a new low there, the bias halfway between it and the previous low."""
    from torch_tts_tpu_torch.models.tacotron.model import Tacotron

    tm = Tacotron(cfg, 1 + len(cfg.text.alphabet))
    tm.load_state_dict(sd)
    steps = BUCKETS[1][1]
    x = torch.zeros(1, BUCKETS[1][0], dtype=torch.int64)
    x[0, :len(ids)] = torch.tensor(ids)
    _, _, s, _ = tm.infer(x, torch.tensor([len(ids)]), max_steps=steps,
                          prenet_masks=jax_masks(0, steps, 1))
    low = s.reshape(steps, R).min(-1).values.numpy()
    run = np.minimum.accumulate(low)
    for g in range(*STOP_GROUP):
        if low[g] < run[g - 1]:
            return -2.0 - (low[g] + run[g - 1]) / 2
    raise AssertionError(f"no new low of the stop logits in groups {STOP_GROUP}: {low}")


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(31)  # stop logits that reach new lows in STOP_GROUP
    jcfg_, cfg = cfgs(jcfg), cfgs(tcfg)
    jm = jax_build(jcfg_)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2)}, jnp.zeros((1, 8), jnp.int32), jnp.asarray([8]),
        jnp.zeros((1, 2 * R, M)), train=True, deterministic=False))
    params = _fill(shapes["params"], rng)
    params["decoder"]["fc_stop"]["bias"] = np.zeros((R,), np.float32)
    stats = _fill(shapes["batch_stats"], rng, stats=True)

    def port_sd():
        return {k: torch.from_numpy(np.array(v))
                for k, v in state_dict_from_jax_params(params, stats, cfg).items()}

    from torch_tts_tpu_torch.cli.tacotron_infer import text_encoder

    shift = choose_stop_bias(cfg, port_sd(), text_encoder(cfg).encode(STREAM_TEXT))
    params["decoder"]["fc_stop"]["bias"] = np.full((R,), shift, np.float32)
    variables = {"params": params, "batch_stats": stats}
    vparams = jax_generator_params(GEN_KWARGS, M, seed=9)
    jv = jvoc.Vocoder(params=vparams, gen_kwargs=GEN_KWARGS, sample_rate=AUDIO["sample_rate"],
                      num_mels=M)
    gen = vocoder.build_generator(GEN_KWARGS, M)
    gen.load_state_dict(generator_state_dict_from_jax_params(vparams, (3,)), strict=True)
    tv = vocoder.Vocoder(gen, GEN_KWARGS, AUDIO["sample_rate"], M, device="cpu")
    return dict(jcfg=jcfg_, cfg=cfg, variables=variables, sd=port_sd(), jv=jv, tv=tv)


def port_synth(p, vocoded=True, **kw):
    kw = dict(dict(buckets=BUCKETS, batch_tiers=TIERS, prenet_masks=jax_masks, device="cpu"), **kw)
    return serving.TacotronSynthesizer(p["cfg"], p["sd"], vocoder=p["tv"] if vocoded else None,
                                       **kw)


@pytest.fixture(scope="module")
def jax_results(pair):
    """The JAX synthesizer's TEXTS with the vocoder and with Griffin-Lim,
    compiled in two threads."""
    p = pair
    synths = [jserving.TacotronSynthesizer(p["jcfg"], p["variables"], vocoder=v, buckets=BUCKETS,
                                           batch_tiers=TIERS, griffin_lim_iters=4)
              for v in (p["jv"], None)]
    gl = port_synth(p, vocoded=False, griffin_lim_iters=4)
    with ThreadPoolExecutor(2) as ex:
        voc = ex.submit(synths[0].synthesize, TEXTS, 3)
        for pad_text, max_steps in BUCKETS:  # compile the GL synthesizer's cells first
            for t in TIERS:
                synths[1]._infer_fn(t, pad_text, max_steps)
        with injected_phases(gl):
            gl_res = synths[1].synthesize(TEXTS, seed=3)
        return {"vocoder": voc.result(), "griffin-lim": gl_res}


def _agree(got, want, atol=PEAK_ATOL):
    for g, w in zip(got, want):
        assert g.audio.shape == w.audio.shape and g.audio.size > 0
        np.testing.assert_allclose(g.audio, w.audio, rtol=0, atol=atol)


def test_synthesize_with_the_vocoder_matches_jax(pair, jax_results):
    s = port_synth(pair)
    got, want = s.synthesize(TEXTS, seed=3), jax_results["vocoder"]
    _agree(got, want)
    lengths = {len(r.audio) // (R * HOP) for r in got}
    assert len(lengths) > 1 and min(lengths) < BUCKETS[1][1]  # ragged, some stop early
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.attn, np.asarray(w.attn), rtol=0, atol=PEAK_ATOL)
    assert s.shapes_run <= {(t, *b) for t in TIERS for b in BUCKETS}


def test_synthesize_with_griffin_lim_matches_jax(pair, jax_results):
    s = port_synth(pair, vocoded=False, griffin_lim_iters=4)
    with injected_phases(s):
        got = s.synthesize(TEXTS, seed=3)
    _agree(got, jax_results["griffin-lim"])


def test_padding_rows_change_nothing(pair):
    s = port_synth(pair)
    ids = s.encode_text(TEXTS[0])
    alone = s._collect_group(s._dispatch_group([ids], seed=5, bucket=BUCKETS[1]))
    padded = s._collect_group(s._dispatch_group([ids], seed=5, bucket=BUCKETS[1]))
    # tier 2: a padding row beside the text, then another real text
    s.batch_tiers = [2]
    pad = s._collect_group(s._dispatch_group([ids], seed=5, bucket=BUCKETS[1]))
    two = s._collect_group(s._dispatch_group([ids, s.encode_text(TEXTS[3])], seed=5,
                                             bucket=BUCKETS[1]))
    np.testing.assert_array_equal(alone[0].audio, padded[0].audio)
    np.testing.assert_allclose(pad[0].audio, two[0].audio, rtol=0, atol=PAD_ATOL)
    assert len(pad) == 1 and len(two) == 2


def _stream(s, seed, chunk, pad):
    return list(s.stream(STREAM_TEXT, seed=seed, chunk_steps=chunk, pad_frames=pad))


@pytest.mark.parametrize("chunk", [4, 5])
def test_stream_without_a_stop_equals_the_batch_path(pair, chunk):
    s = port_synth(pair)
    _with_stop_bias(s.model, [50.0] * R)  # never below the threshold
    want = s.synthesize([STREAM_TEXT], seed=3)[0].audio
    assert want.size == BUCKETS[1][1] * R * HOP  # the whole bucket; 24 % 5 != 0 overhangs
    pieces = _stream(s, 3, chunk, 16)
    assert len(pieces) > 1
    got = np.concatenate(pieces)
    assert got.shape == want.shape
    np.testing.assert_allclose(got / np.abs(got).max(), want, rtol=0, atol=SAME_ATOL)


def test_stream_with_a_stop_flushes_exactly(pair):
    s = port_synth(pair)
    res = s.synthesize([STREAM_TEXT], seed=0)[0]
    n_frames = res.audio.size // HOP
    assert STOP_GROUP[0] * R < n_frames <= STOP_GROUP[1] * R
    pieces = _stream(s, 0, 2, 10)  # windows of 24 frames, emitted 4 at a time
    assert len(pieces) > 2
    got = np.concatenate(pieces)
    assert got.size == res.audio.size
    # postnet + vocoder over the batch decode's mel trimmed at the stop
    ids = s.encode_text(STREAM_TEXT)
    x = torch.zeros(1, BUCKETS[1][0], dtype=torch.int64)
    x[0, :len(ids)] = torch.tensor(ids)
    y, *_ = s.model.infer(x, torch.tensor([len(ids)]), max_steps=BUCKETS[1][1],
                          prenet_masks=jax_masks(0, BUCKETS[1][1], 1))
    want = s.vocoder.wave(s.model.apply_postnet(y[:, :n_frames]))[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=SAME_ATOL)
    # the batch path vocodes the whole bucket's mel, the frames past the stop
    # too: the stream has its audio but for the last EDGE_FRAMES frames
    whole = s.vocoder.wave(s.model.apply_postnet(y))[0, :n_frames * HOP].numpy()
    np.testing.assert_allclose(res.audio, whole / np.abs(whole).max(), rtol=0, atol=SAME_ATOL)
    keep = (n_frames - EDGE_FRAMES) * HOP
    np.testing.assert_allclose(got[:keep], whole[:keep], rtol=0, atol=SAME_ATOL)


def test_short_utterances_fall_back_to_the_batch_path(pair):
    s = port_synth(pair)
    _with_stop_bias(s.model, [-100.0] * R)  # stops at the first group
    want = s.synthesize([STREAM_TEXT], seed=5)[0].audio
    assert want.size == R * HOP
    pieces = _stream(s, 5, 4, 16)
    assert len(pieces) == 1
    np.testing.assert_array_equal(pieces[0], want)
    # a text of the small bucket: 12 groups of 2 frames < one 40-frame window
    s2 = port_synth(pair)
    pieces = list(s2.stream(TEXTS[1], seed=2, chunk_steps=4, pad_frames=16))
    assert len(pieces) == 1
    np.testing.assert_array_equal(pieces[0], s2.synthesize([TEXTS[1]], seed=2)[0].audio)


def test_warmup_and_the_batcher(pair):
    s = port_synth(pair)
    assert s.warmup() == len(BUCKETS) * len(TIERS)
    assert s.warmup_streaming(chunk_steps=4, pad_frames=16) == 1  # (16, 12) is too short
    assert port_synth(pair, vocoded=False).warmup_streaming() == 0
    serial = {t: s.synthesize([t], seed=7)[0].audio for t in TEXTS}
    with ContinuousBatcher(s) as b:
        one_by_one = [b.submit(t, seed=7).result(timeout=120) for t in TEXTS]
        futs = [b.submit(t, seed=7) for t in TEXTS * 2]
        together = [f.result(timeout=120) for f in futs]
        stats = b.stats()
    for r, t in zip(one_by_one, TEXTS):  # alone in its group: tier 1, as synthesize
        np.testing.assert_array_equal(r.audio, serial[t])
    assert all(r.audio.size > 0 and np.isfinite(r.audio).all() for r in together)
    assert stats["failures_total"] == 0 and stats["batched_requests_total"] == 3 * len(TEXTS)


def test_checks_and_from_run_dir(pair, tmp_path, caplog):
    s = port_synth(pair, vocoded=False)
    with pytest.raises(ValueError, match="vocoder"):
        next(s.stream("hello"))
    with pytest.raises(ValueError, match="speaker"):
        s._dispatch_group([[1]], sid=[0])
    with pytest.raises(ValueError, match="too long"):
        s.synthesize(["x" * 100])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serving.TacotronSynthesizer(pair["cfg"], pair["sd"])
    import dataclasses
    import json

    cfg_path = tmp_path / "taco.json"
    cfg_path.write_text(json.dumps({k: dataclasses.asdict(getattr(pair["cfg"], k))
                                    for k in ("audio", "text", "model")}))
    torch.save({"model": pair["sd"]}, tmp_path / "t.pth")
    vocoder.save_vocoder(str(tmp_path / "v.pt"), pair["tv"].generator, gen_kwargs=GEN_KWARGS,
                         sample_rate=AUDIO["sample_rate"], num_mels=M)
    kw = dict(buckets=BUCKETS, batch_tiers=TIERS, prenet_masks=jax_masks, device="cpu")
    loaded = serving.TacotronSynthesizer.from_run_dir(str(cfg_path), str(tmp_path / "t.pth"),
                                                      vocoder_path=str(tmp_path / "v.pt"), **kw)
    np.testing.assert_array_equal(loaded.synthesize([TEXTS[0]], seed=1)[0].audio,
                                  port_synth(pair).synthesize([TEXTS[0]], seed=1)[0].audio)
    (tmp_path / "empty").mkdir()
    with caplog.at_level(logging.WARNING):
        rnd = serving.TacotronSynthesizer.from_run_dir(str(cfg_path), str(tmp_path / "empty"), **kw)
    assert "random weights" in caplog.text and rnd.vocoder is None
    assert serving.DEFAULT_TACO_BUCKETS == jserving.DEFAULT_TACO_BUCKETS
    assert serving.DEFAULT_TACO_TIERS == jserving.DEFAULT_TACO_TIERS
