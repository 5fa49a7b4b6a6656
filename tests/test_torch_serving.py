"""The serving layer (`infer/serving.py`): the port's `Synthesizer` against
the JAX package's.

A tiny VITS2 (ResBlock1 decoder, pre_conv flows, SDP; 8 kHz, hop 64) with
random weights from a numpy seed, carried across by the port's converter
and loaded with strict=True; the JAX `Synthesizer` and the port's take
the same buckets as tests/test_serving.py, ((16, 24), (80, 96)), and tiers
(1, 2, 8). The JAX side compiles two (tier, bucket) cells in each of its
two synthesizers (float32 and int16 transfer), compiled in two threads.

Compared: `bucket_for`, `tier_for` and `split_for_synthesis` equal to the
JAX functions; `synthesize` of mixed-length texts over both buckets at
noise_scale = noise_scale_w = 0 (both deterministic): lengths exactly,
float32 transfer within 1e-4, int16 within one 16-bit step. On the port
alone: at nonzero noise, `synthesize` against `infer` with the same
generator (1e-6); determinism per (seed, tier); tier padding against the
exact batch; a group larger than the top tier splits; an over-long text
raises; `return_attn`; the device and option checks.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_vits2_infer import random_params
from torch_tts_tpu_torch.infer import serving

HOP = 64
BUCKETS = ((16, 24), (80, 96))
TEXTS = ["hi", "hello there", "a longer sentence here.", "ok"]
JAX_ATOL, LSB = 1e-4, 1.0 / 32767
SAME_ATOL = 1e-6  # the port against itself: one model, other batch shapes
MODEL_KW = dict(
    inter_channels=16, hidden_channels=16, filter_channels=32, n_heads=2, n_layers=1,
    kernel_size=3, p_dropout=0.1, resblock="1", resblock_kernel_sizes=(3,),
    resblock_dilation_sizes=((1, 3),), upsample_rates=(8, 8), upsample_initial_channel=32,
    upsample_kernel_sizes=(16, 16), segment_size=4 * HOP, posterior_wn_layers=2)
AUDIO_KW = dict(sampling_rate=8000, filter_length=128, hop_length=HOP, win_length=128,
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


def port_config(**model_kw):
    from torch_tts_tpu_torch.core.config import (AudioConfig, DataConfig, VITS2Config,
                                                 VITS2ModelConfig)

    return VITS2Config(audio=AudioConfig(**AUDIO_KW), data=DataConfig(**DATA_KW),
                       model=VITS2ModelConfig(**dict(MODEL_KW, fuse_mrf=True, **model_kw)))


def jax_pair(seed: int = 5):
    """(JAX config, JAX params, the port's config, the port's state dict):
    one set of random weights. The JAX side keeps its default plain MRF
    bank (its Pallas kernel would run in interpret mode)."""
    from torch_tts_tpu.core.config import (AudioConfig, DataConfig, VITS2Config,
                                           VITS2ModelConfig)
    from torch_tts_tpu.train.vits2_trainer import build_models
    from torch_tts_tpu_torch.models.vits2.convert import state_dict_from_jax_params

    jcfg = VITS2Config(audio=AudioConfig(**AUDIO_KW), data=DataConfig(**DATA_KW),
                       model=VITS2ModelConfig(**MODEL_KW))
    jmodel, _, _ = build_models(jcfg)
    rngs = {k: jax.random.PRNGKey(i) for i, k in enumerate(("params", "noise", "dropout"))}
    shapes = jax.eval_shape(lambda: jmodel.init(
        rngs, jnp.ones((1, 5), jnp.int32), jnp.asarray([5]),
        jnp.zeros((1, 16, jcfg.posterior_channels)), jnp.asarray([16]))["params"])
    params = random_params(shapes, np.random.default_rng(seed))
    return jcfg, params, port_config(), state_dict_from_jax_params(params, jcfg.model)


@pytest.fixture(scope="module")
def pair():
    from torch_tts_tpu.infer.serving import Synthesizer as JaxSynthesizer

    jcfg, params, cfg, sd = jax_pair()
    jax_synths = [JaxSynthesizer(jcfg, params, buckets=BUCKETS, transfer_dtype=t)
                  for t in ("float32", "int16")]
    with ThreadPoolExecutor(2) as ex:
        ref = list(ex.map(lambda s: s.synthesize(TEXTS, noise_scale=0.0, noise_scale_w=0.0,
                                                 seed=0), jax_synths))
    cells = [len(s._infer_cache) for s in jax_synths]
    return dict(cfg=cfg, sd=sd, ref=dict(zip(("float32", "int16"), ref)), jax_cells=cells)


def synth(pair, **kw):
    kw.setdefault("buckets", BUCKETS)
    return serving.Synthesizer(pair["cfg"], pair["sd"], device="cpu", **kw)


def test_bucket_and_tier_equal_jax():
    from torch_tts_tpu.infer import serving as jserving

    for n in (1, 16, 17, 64, 65, 512, 513, 10_000):
        want = _outcome(jserving.bucket_for, jserving.DEFAULT_BUCKETS, n)
        assert _outcome(serving.bucket_for, serving.DEFAULT_BUCKETS, n) == want
    for n in range(0, 11):
        want = _outcome(jserving.tier_for, jserving.DEFAULT_BATCH_TIERS, n)
        assert _outcome(serving.tier_for, serving.DEFAULT_BATCH_TIERS, n) == want
    assert serving.DEFAULT_BUCKETS == jserving.DEFAULT_BUCKETS
    assert serving.DEFAULT_BATCH_TIERS == jserving.DEFAULT_BATCH_TIERS


def _outcome(fn, *args):
    try:
        return fn(*args)
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("limit", [5, 12, 40, 400])
def test_split_for_synthesis_equals_jax(limit):
    from torch_tts_tpu.infer.serving import split_for_synthesis as jax_split

    texts = ["One. Two, three four; five six! Seven: eight nine, ten.",
             "a b c d e f g h i j k l m n o p q r s t u v w x y z " * 3,
             "unbreakablewordthatislong and short words."]
    for text in texts:
        assert (_outcome(serving.split_for_synthesis, text, lambda s: len(s) <= limit)
                == _outcome(jax_split, text, lambda s: len(s) <= limit))


@pytest.mark.parametrize("transfer", ["float32", "int16"])
def test_synthesize_matches_jax_at_zero_noise(pair, transfer):
    assert pair["jax_cells"] == [2, 2]  # tier 2 in each bucket
    out = synth(pair, transfer_dtype=transfer).synthesize(TEXTS, noise_scale=0.0,
                                                          noise_scale_w=0.0, seed=0)
    atol = JAX_ATOL if transfer == "float32" else LSB + 1e-7
    lengths = set()
    for r, ref in zip(out, pair["ref"][transfer]):
        assert r.sample_rate == ref.sample_rate == 8000
        assert r.audio.shape == ref.audio.shape and r.audio.dtype == np.float32
        np.testing.assert_allclose(r.audio, ref.audio, rtol=0, atol=atol)
        lengths.add(len(r.audio) // HOP)
    assert len(lengths) > 2  # lengths differ: each row's trim is exercised
    if transfer == "int16":
        grid = out[1].audio * 32767.0
        np.testing.assert_allclose(grid, np.round(grid), atol=1e-3)


def _padded_infer(s, texts, seed, **scales):
    """`infer` on the texts padded to their bucket, at their own batch
    size, with the generator of `seed` -> audio trimmed per row."""
    encoded = [s.encode_text(t) for t in texts]
    pad_text, max_frames = s._bucket_for(max(map(len, encoded)))
    x = torch.zeros(len(texts), pad_text, dtype=torch.int64)
    for i, e in enumerate(encoded):
        x[i, :len(e)] = torch.tensor(e)
    audio, _, _, _, yl = s.model.infer(x, torch.tensor([len(e) for e in encoded]),
                                       max_frames=max_frames,
                                       generator=torch.Generator().manual_seed(seed), **scales)
    return [audio[i, :int(yl[i]) * HOP, 0].numpy() for i in range(len(texts))]


def test_synthesize_with_noise_matches_own_infer(pair):
    """At nonzero noise one text draws at tier 1 exactly what `infer` draws
    at batch 1 from the same seed."""
    s = synth(pair, transfer_dtype="float32")
    scales = dict(noise_scale=0.667, length_scale=1.0, noise_scale_w=0.8)
    for text in TEXTS[1:3]:
        r = s.synthesize([text], seed=9, **scales)[0]
        np.testing.assert_allclose(r.audio, _padded_infer(s, [text], 9, **scales)[0], rtol=0,
                                   atol=SAME_ATOL)


def test_determinism_per_seed_and_tier(pair):
    s = synth(pair, transfer_dtype="float32")
    a, b, c = (s.synthesize(["hello world"], seed=k)[0].audio for k in (3, 3, 4))
    np.testing.assert_array_equal(a, b)
    assert a.shape != c.shape or not np.array_equal(a, c)
    d = s.synthesize(["hello world", "hello world"], seed=3)  # tier 2: other draws
    np.testing.assert_array_equal(d[0].audio, s.synthesize(["hello world"] * 2, seed=3)[0].audio)


def test_tier_padding_equals_exact_batch(pair):
    """Three texts of one bucket ride the 8-tier (five padding rows of one
    blank token); at zero noise they equal the unpadded batch of three."""
    s = synth(pair, transfer_dtype="float32")
    texts = ["hello there", "a longer sentence here.", "and a third one"]
    out = s.synthesize(texts, noise_scale=0.0, noise_scale_w=0.0)
    assert s.shapes_run == {(8, 80, 96)}
    for r, want in zip(out, _padded_infer(s, texts, 0, noise_scale=0.0, noise_scale_w=0.0)):
        np.testing.assert_allclose(r.audio, want, rtol=0, atol=SAME_ATOL)


def test_group_larger_than_top_tier_splits(pair):
    s = synth(pair, batch_tiers=(1, 2), transfer_dtype="float32")
    texts = ["one", "two", "six", "ten", "red"]
    out = s.synthesize(texts, noise_scale=0.0, noise_scale_w=0.0)
    assert s.shapes_run == {(2, 16, 24), (1, 16, 24)}
    for r, text in zip(out, texts):
        np.testing.assert_allclose(r.audio, s.synthesize([text], noise_scale=0.0,
                                                         noise_scale_w=0.0)[0].audio,
                                   rtol=0, atol=SAME_ATOL)


def test_too_long_raises_and_attn_returns(pair):
    s = synth(pair)
    with pytest.raises(ValueError, match="too long"):
        s.synthesize(["x " * 200])
    r = s.synthesize(["hello", "hello there"], return_attn=True)
    for item, pad_text, frames in zip(r, (16, 80), (24, 96)):
        assert item.attn.shape == (frames, pad_text)
        n = len(item.audio) // HOP
        np.testing.assert_array_equal(item.attn[:n].sum(1), np.ones(n, np.float32))


def test_device_and_options_are_checked(pair, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving.Synthesizer(pair["cfg"], pair["sd"])  # the default device is the card
    with pytest.raises(NotImplementedError, match="queue 8"):
        synth(pair, mesh=object())
    with pytest.raises(ValueError):
        synth(pair, transfer_dtype="int8")
    assert serving.Synthesizer(pair["cfg"], pair["sd"], device="cpu").buckets == list(
        serving.DEFAULT_BUCKETS)
