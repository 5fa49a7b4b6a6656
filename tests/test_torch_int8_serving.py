"""The serving layer on the int8 decoder (`quantize_decoder: true`): the
port's `Synthesizer` dispatch and stream against the JAX package's, the
inference CLI, on the CPU.

A tiny VITS2 (SDP, pre_conv flows; 8 kHz, hop 64) whose HiFi-GAN decoder
has a 128-channel stage (int8, its x8 transposed conv on the subpixel
route) and a 64-channel one (fp under `pack_narrow_convs`, as the shipped
config), random weights from a numpy seed carried over by the port's
converter. At zero noise both packages are deterministic.

- One dispatch: two texts in one bucket and tier, so the batch that sets
  the activation scales is the same in both packages: lengths exactly,
  the audio's error within JAX_REL_L2 of its L2 norm (an int8 decoder
  turns the latents' ulps into flipped roundings, see
  tests/test_torch_int8_infer.py; measured here up to 2.2e-3 of the peak
  in a sample).
- One stream in the same bucket, chunk 16 and context 16: each window has
  its own scales, in both packages, so the port's stream is held against
  JAX's stream (not against `synthesize`, whose whole decode has other
  scales); windows decoded unmasked equal the all-ones masked ones.
- The CLI on the int8 config: the whole and the streamed decode run the
  int8 path and stay within the int8 error of the fp model's audio.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_vits2_infer import random_params
from torch_tts_tpu_torch.infer import serving
from torch_tts_tpu_torch.kernels import int8_conv

HOP = 64
BUCKETS = ((16, 24), (80, 96))
TEXTS = ["a longer sentence here.", "hello there, a text."]
ZERO = dict(noise_scale=0.0, noise_scale_w=0.0)
JAX_REL_L2 = 2e-2
CHUNK, CONTEXT = 16, 16
MODEL_KW = dict(
    inter_channels=16, hidden_channels=16, filter_channels=32, n_heads=2, n_layers=1,
    kernel_size=3, p_dropout=0.1, resblock="1", resblock_kernel_sizes=(3,),
    resblock_dilation_sizes=((1, 3),), upsample_rates=(8, 8), upsample_initial_channel=256,
    upsample_kernel_sizes=(16, 16), segment_size=4 * HOP, posterior_wn_layers=2,
    quantize_decoder=True, pack_narrow_convs=True)
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


def _configs(**model_kw):
    from torch_tts_tpu.core import config as jc
    from torch_tts_tpu_torch.core import config as pc

    kw = dict(MODEL_KW, **model_kw)
    return (jc.VITS2Config(audio=jc.AudioConfig(**AUDIO_KW), data=jc.DataConfig(**DATA_KW),
                           model=jc.VITS2ModelConfig(**kw)),
            pc.VITS2Config(audio=pc.AudioConfig(**AUDIO_KW), data=pc.DataConfig(**DATA_KW),
                           model=pc.VITS2ModelConfig(**kw, fuse_mrf=True)))


@pytest.fixture(scope="module")
def weights():
    """The JAX synthesizer's dispatch and stream (compiled by their first
    calls), and the port's config and state dict on the same weights."""
    from torch_tts_tpu.infer.serving import Synthesizer as JaxSynthesizer
    from torch_tts_tpu.train.vits2_trainer import build_models
    from torch_tts_tpu_torch.models.vits2.convert import state_dict_from_jax_params

    jcfg, cfg = _configs()
    jmodel, _, _ = build_models(jcfg)
    rngs = {k: jax.random.PRNGKey(i) for i, k in enumerate(("params", "noise", "dropout"))}
    shapes = jax.eval_shape(lambda: jmodel.init(
        rngs, jnp.ones((1, 5), jnp.int32), jnp.asarray([5]),
        jnp.zeros((1, 16, jcfg.posterior_channels)), jnp.asarray([16]))["params"])
    params = random_params(shapes, np.random.default_rng(71))
    js = JaxSynthesizer(jcfg, params, buckets=BUCKETS, transfer_dtype="float32")
    batch = js.synthesize(TEXTS, seed=0, **ZERO)
    stream = list(js.stream(TEXTS[0], chunk_frames=CHUNK, context_frames=CONTEXT, seed=0,
                            **ZERO))
    return dict(cfg=cfg, sd=state_dict_from_jax_params(params, jcfg.model), batch=batch,
                stream=stream, cells=len(js._infer_cache))


def synth(weights):
    return serving.Synthesizer(weights["cfg"], weights["sd"], buckets=BUCKETS, device="cpu",
                               transfer_dtype="float32")


def _close(a, b):
    assert a.shape == b.shape and len(a) > 0
    rel = float(np.linalg.norm(a - b) / np.linalg.norm(b))
    print(f"int8 audio against JAX: {rel:.2e} of its L2 norm")
    assert rel <= JAX_REL_L2


def test_int8_synthesize_matches_the_jax_synthesizer(weights):
    s = synth(weights)
    assert weights["cells"] == 1  # one (tier, bucket) cell: the same batch on both sides
    assert {s._bucket_for(len(s.encode_text(t))) for t in TEXTS} == {BUCKETS[1]}
    got = s.synthesize(TEXTS, seed=0, **ZERO)
    assert s.shapes_run == {(2, *BUCKETS[1])}
    for a, b in zip(got, weights["batch"]):
        assert len(a.audio) == len(b.audio) and len(a.audio) % HOP == 0
        _close(a.audio, np.asarray(b.audio))


def test_int8_stream_matches_the_jax_stream(weights):
    """Window by window; together the chunks cover `synthesize`'s length."""
    s = synth(weights)
    got = list(s.stream(TEXTS[0], chunk_frames=CHUNK, context_frames=CONTEXT, seed=0, **ZERO))
    want = weights["stream"]
    assert len(got) == len(want) > 2
    for a, b in zip(got, want):
        _close(a, np.asarray(b))
    whole = s.synthesize([TEXTS[0]], seed=0, **ZERO)[0].audio
    assert len(np.concatenate(got)) == len(whole)


def test_int8_unmasked_windows_equal_all_ones_masked_ones(weights):
    """A window whose mask is all ones decodes to the same int8 values
    without it (the scales see the same tensor), so the stream may decode
    it unmasked (the card's MRF kernel then takes the fp stage)."""
    from torch_tts_tpu_torch.infer.streaming import StreamingDecoder

    s = synth(weights)
    rng = np.random.default_rng(5)
    z = torch.from_numpy(rng.standard_normal((1, 80, 16)).astype(np.float32))
    mask = torch.ones(1, 80, 1)
    dec = StreamingDecoder(s.model, CHUNK, CONTEXT)
    masked = list(dec.stream(z, None, mask))
    unmasked = list(dec.stream(z, None, mask, lengths=[80]))
    for a, b in zip(masked, unmasked):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def _write_run(d, weights, **model_kw):
    cfg = dataclasses.replace(weights["cfg"], model=dataclasses.replace(
        weights["cfg"].model, **model_kw))
    torch.save({"model": weights["sd"]}, d / "G.pth")
    path = d / f"config{len(model_kw)}.json"
    path.write_text(json.dumps({
        "model": dataclasses.asdict(cfg.model),
        "data": {**dataclasses.asdict(cfg.data), **dataclasses.asdict(cfg.audio)}}))
    return ["-c", str(path), "-m", str(d / "G.pth"), "--device", "cpu", "--seed", "4",
            "--text", TEXTS[0], "--max-frames", "200"]


def test_infer_cli_runs_the_int8_config(weights, tmp_path):
    """Whole and streamed, each through the int8 quantizer; the fp config's
    audio (the same weights) within the int8 error."""
    from torch_tts_tpu_torch.cli import vits2_infer

    calls, orig = [0], int8_conv.quantize_act

    def counting(x, *args, **kwargs):  # the pre-activation's slope and mask pass through
        calls[0] += 1
        return orig(x, *args, **kwargs)
    int8_conv.quantize_act = counting
    try:
        args = _write_run(tmp_path, weights)
        whole = vits2_infer.main(args + ["-o", str(tmp_path / "whole.wav")])
        n_whole = calls[0]
        streamed = vits2_infer.main(args + ["--stream-chunk", "16", "-o",
                                            str(tmp_path / "stream.wav")])
    finally:
        int8_conv.quantize_act = orig
    assert n_whole > 0 and calls[0] > n_whole
    fp = vits2_infer.main(_write_run(tmp_path, weights, quantize_decoder=False)
                          + ["-o", str(tmp_path / "fp.wav")])
    for audio in (whole, streamed):
        assert np.isfinite(audio).all() and audio.shape == fp.shape and len(audio) % HOP == 0
        assert 0 < np.abs(audio - fp).max() < 0.2 * np.abs(fp).max()
