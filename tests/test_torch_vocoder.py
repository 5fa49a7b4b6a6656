"""The neural vocoder (`infer/vocoder.py`), its generator-only converter
and the Tacotron frontend's encode side (`audio/frontend.py`): the port
against the JAX package.

A tiny HiFi-GAN (ResBlock1 (3,) with dilations (1, 3), upsample (4, 4, 2),
initial channel 64, 20 mels, 8 kHz): its first stage has C=32, which the
MRF gate takes (on the CPU `mrf_fused` runs its plain version), the others
run the plain convolutions. Flax parameters from a numpy seed, carried
across by `generator_state_dict_from_jax_params` and loaded strictly.

Tolerances: the frontend's power spectrogram rtol 1e-4 (atol 1e-6 of the
peak power), encode's dB within 1e-3 dB, resample_poly exactly (both are
scipy); `Vocoder.synth` within 1e-4 of the peak (the peak-normalised wave
within 1e-4); the port's artifact round trip and the JAX msgpack artifact
exactly (the same weights, the same program).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_vits2_infer import random_params
from torch_tts_tpu.audio import frontend as jfe
from torch_tts_tpu.core import config as jcfg
from torch_tts_tpu.infer import vocoder as jvoc
from torch_tts_tpu.ops.hifigan import Generator as JaxGenerator
from torch_tts_tpu_torch.audio import frontend as tfe
from torch_tts_tpu_torch.cli.vocoder_train import gen_kwargs_for
from torch_tts_tpu_torch.core import config as tcfg
from torch_tts_tpu_torch.infer import vocoder
from torch_tts_tpu_torch.kernels import mrf_fused
from torch_tts_tpu_torch.models.vits2.convert import generator_state_dict_from_jax_params

M, SR = 20, 8000
GEN_KWARGS = dict(resblock="1", resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),),
                  upsample_rates=(4, 4, 2), upsample_initial_channel=64,
                  upsample_kernel_sizes=(8, 8, 4))
AUDIO = dict(sample_rate=SR, hop_length=32, win_length=128, num_mels=M, fmin=0.0, fmax=3800.0)
PEAK_ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while this module runs: under pytest-xdist a thread
    per core in every worker oversubscribes the cores, which slowed the
    port's tests about twofold and took CPU from the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_generator_params(gen_kwargs, num_mels, seed=3):
    shapes = jax.eval_shape(lambda: JaxGenerator(**gen_kwargs).init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 8, num_mels)))["params"])
    return random_params(shapes, np.random.default_rng(seed))


@pytest.fixture(scope="module")
def pair():
    params = jax_generator_params(GEN_KWARGS, M)
    jv = jvoc.Vocoder(params=params, gen_kwargs=GEN_KWARGS, sample_rate=SR, num_mels=M)
    gen = vocoder.build_generator(GEN_KWARGS, M)
    gen.load_state_dict(generator_state_dict_from_jax_params(params, (3,)), strict=True)
    tv = vocoder.Vocoder(gen, GEN_KWARGS, SR, M, device="cpu")
    mel = np.random.default_rng(5).random((2, 19, M)).astype(np.float32)  # network domain
    return dict(params=params, jv=jv, tv=tv, mel=mel, want=jv.synth(mel))


def test_frontend_encode_side_matches_jax():
    fj = jfe.AudioFrontend(jcfg.TacotronAudioConfig(**AUDIO))
    ft = tfe.AudioFrontend(tcfg.TacotronAudioConfig(**AUDIO), device="cpu")
    rng = np.random.default_rng(0)
    wav = (0.3 * rng.standard_normal((2, 1000))).astype(np.float32)
    want = np.asarray(jax.jit(fj._stft_power)(jnp.asarray(wav)))
    got = ft._stft_power(torch.from_numpy(wav)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6 * want.max())
    np.testing.assert_allclose(ft._stft_power(torch.from_numpy(wav[0])).numpy(), got[0], rtol=0,
                               atol=0)
    # encode: peak normalisation, power STFT, mel, dB; with resampling from 11025 Hz
    for sr, w in ((None, wav[0]), (11025, wav[1, :900])):
        d_j, m_j = fj.encode(jnp.asarray(w), sr)
        d_t, m_t = ft.encode(w, sr)
        np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=0, atol=1e-3)
        np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), rtol=0, atol=1e-3)
    np.testing.assert_array_equal(tfe.resample_poly(wav[0], 11025, SR),
                                  jfe.resample_poly(wav[0], 11025, SR))


def test_converter_covers_the_jax_generator(pair):
    sd = generator_state_dict_from_jax_params(pair["params"], (3,))
    assert sorted(sd) == sorted(pair["tv"].generator.state_dict())
    assert "ups.2.weight_v" in sd and "resblocks.2.convs1.1.weight_g" in sd


def test_full_width_vocoder_shapes():
    """The vocoder the JAX CLI builds for hop 256: upsample (8, 8, 4), kernels
    (16, 16, 8), initial channel 256, no speaker input; every parameter of
    the JAX Generator has the port's shape, and its three banks (C = 128,
    64, 32) are widths the MRF kernel takes."""
    kw = gen_kwargs_for(256)
    assert kw["upsample_rates"] == (8, 8, 4) and kw["upsample_kernel_sizes"] == (16, 16, 8)
    shapes = jax.eval_shape(lambda: JaxGenerator(**kw).init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 4, 80)))["params"])
    want = generator_state_dict_from_jax_params(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes), (3, 7, 11))
    gen = vocoder.build_generator(kw, 80)
    got = gen.state_dict()
    assert sorted(got) == sorted(want) and not hasattr(gen, "cond")
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
    chans = [gen.resblocks[3 * i].channels for i in range(3)]
    assert chans == [128, 64, 32] and gen.fuse_mrf
    assert all(mrf_fused.supports(c, gen.max_taps) for c in chans)


def test_synth_matches_jax(pair):
    got = pair["tv"].synth(pair["mel"])
    want = pair["want"]
    assert got.shape == want.shape == (2, 19 * 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=PEAK_ATOL)
    np.testing.assert_allclose(np.abs(got).max(-1), 1.0, rtol=1e-6)
    # one utterance [T, M], and the renormed generator output without the peak
    one = pair["tv"].synth(pair["mel"][0])  # batch 1: the convolutions sum in another order
    np.testing.assert_allclose(one[0], got[0], rtol=0, atol=1e-5)
    raw = pair["tv"].synth(pair["mel"], normalize=False)
    want_raw = np.asarray(pair["jv"].synth(pair["mel"], normalize=False))
    np.testing.assert_allclose(raw, want_raw, rtol=0, atol=PEAK_ATOL * np.abs(want_raw).max())


def test_artifact_round_trip(pair, tmp_path):
    tv = pair["tv"]
    path = str(tmp_path / "vocoder.pt")
    vocoder.save_vocoder(path, tv.generator, gen_kwargs=GEN_KWARGS, sample_rate=SR, num_mels=M,
                         mel_shift=0.9, mel_scale=0.1)
    blob = torch.load(path, weights_only=True)
    assert blob["meta"]["format"] == vocoder.FORMAT
    assert set(blob["meta"]) == {"format", "sample_rate", "num_mels", "mel_shift", "mel_scale",
                                 "gen_kwargs"}
    back = vocoder.load_vocoder(path, device="cpu")
    assert back.generator.fuse_mrf and back.hop_length == 32
    assert (back.sample_rate, back.num_mels, back.mel_shift, back.mel_scale) == (SR, M, 0.9, 0.1)
    assert back.gen_kwargs == GEN_KWARGS
    for k, v in tv.generator.state_dict().items():
        torch.testing.assert_close(back.generator.state_dict()[k], v, rtol=0, atol=0)
    tv2 = vocoder.Vocoder(tv.generator, GEN_KWARGS, SR, M, 0.9, 0.1, device="cpu")
    np.testing.assert_array_equal(back.synth(pair["mel"]), tv2.synth(pair["mel"]))


def test_reads_the_jax_msgpack_artifact(pair, tmp_path):
    path = str(tmp_path / "vocoder.msgpack")
    jvoc.save_vocoder(path, pair["params"], gen_kwargs=GEN_KWARGS, sample_rate=SR, num_mels=M)
    back = vocoder.load_vocoder(path, device="cpu")
    assert (back.sample_rate, back.num_mels, back.hop_length) == (SR, M, 32)
    assert (back.mel_shift, back.mel_scale) == (vocoder.REF_MEL_SHIFT, vocoder.REF_MEL_SCALE)
    np.testing.assert_array_equal(back.synth(pair["mel"]), pair["tv"].synth(pair["mel"]))
    np.testing.assert_allclose(back.synth(pair["mel"]), pair["want"], rtol=0, atol=PEAK_ATOL)


def test_check_compat_names_every_mismatch(pair):
    tv = pair["tv"]
    vocoder.check_compat(tv, num_mels=M, hop_length=32, sample_rate=SR)
    with pytest.raises(ValueError) as e:
        vocoder.check_compat(tv, num_mels=80, hop_length=256, sample_rate=22050)
    msg = str(e.value)
    assert "num_mels 20 != config 80" in msg and "hop_length 256" in msg
    assert "sample_rate 8000 != config 22050" in msg
    with pytest.raises(ValueError, match="^vocoder artifact incompatible.*hop") as e:
        vocoder.check_compat(tv, num_mels=M, hop_length=64, sample_rate=SR)
    assert "num_mels 20" not in str(e.value) and "sample_rate 8000" not in str(e.value)


def test_the_card_is_the_default_and_is_required(pair, tmp_path):
    path = str(tmp_path / "vocoder.pt")
    vocoder.save_vocoder(path, pair["tv"].generator, gen_kwargs=GEN_KWARGS, sample_rate=SR,
                         num_mels=M)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vocoder.load_vocoder(path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vocoder.Vocoder(pair["tv"].generator, GEN_KWARGS, SR, M)
    bad = dataclasses.replace(jcfg.TacotronAudioConfig(), num_mels=M)  # 22050 Hz, hop 256
    with pytest.raises(ValueError, match="hop"):
        vocoder.check_compat(pair["tv"], num_mels=bad.num_mels, hop_length=bad.hop_length,
                             sample_rate=bad.sample_rate)
