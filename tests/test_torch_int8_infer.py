"""`SynthesizerTrn` with the int8 decoder (`quantize_decoder: true`): the
port's `infer` and `voice_conversion` against the JAX package's, on the
CPU.

A tiny multi-speaker VITS2 (4 speakers, gin 8, the speaker-conditioned
text encoder, SDP, pre_conv flows) whose HiFi-GAN decoder has a 128- and a
64-channel stage, with `pack_narrow_convs` as the shipped LJSpeech config
sets it (the 64-channel stage stays fp) and without it (every stage
int8); and a tiny MB-iSTFT one. Random
weights from a numpy seed carried over by the port's converter
(strict=True), the same ids, spectrogram and noise (`jax.random.normal`
patched to numpy arrays). Each JAX reference is jitted once and compiled
in a thread pool.

`infer` two speakers at max_frames 200 (above the 128-frame patch window:
an unmasked bulk decode and a masked window per item, each with its own
activation scales, in both packages): durations, attn and y_mask exactly,
the latents within rtol 1e-4 / atol 1e-5 as the fp model's, the
waveform's error within WAVE_REL_L2 of its L2 norm. An int8 decoder is
sensitive to its input at the ulp level: an activation on a rounding
boundary flips by one int8 step (1/127 of the tensor's peak) and the next
layers' roundings follow. Measured on the port alone (the decoder with
every stage int8, on JAX's latents): a 1e-6 relative change of the input
moves the waveform by 2.7e-3 of its L2 norm, 1e-5 by 7.7e-3 (up to 8e-2
of the peak in single samples, so no per-sample bound is held). The two
packages' latents (the flows, about 2e-5) and fp32 weights (the weight
norm's summation order, XLA's fused dequantize) differ by that order:
measured 1.4e-4 to 7.5e-3 of the L2 norm, with one torch thread or four.
`voice_conversion` on ragged lengths the same way. The MB-iSTFT model's
`infer` (every trunk conv int8) likewise.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_vits2_infer import _close, _t, injected_noise, random_params
from torch_tts_tpu.core.config import VITS2ModelConfig as JaxModelConfig
from torch_tts_tpu.models.vits2 import SynthesizerTrn as JaxSynth
from torch_tts_tpu_torch.core.config import VITS2ModelConfig
from torch_tts_tpu_torch.kernels import int8_conv
from torch_tts_tpu_torch.models.vits2.convert import state_dict_from_jax_params
from torch_tts_tpu_torch.models.vits2.model import SynthesizerTrn

N_VOCAB, SPEC_CH, B, T_X, T_Y, D, G = 20, 12, 2, 24, 30, 8, 8
X_LENGTHS, Y_LENGTHS = (24, 17), (30, 21)
MF = 200
SIDS, SID_TGT = (1, 3), (2, 0)
WAVE_REL_L2 = 2e-2
HIFI_KW = dict(
    inter_channels=D, hidden_channels=8, filter_channels=16, n_heads=2, n_layers=3,
    kernel_size=3, p_dropout=0.0, resblock="1", resblock_kernel_sizes=(3, 5),
    resblock_dilation_sizes=((1, 2), (1, 3)), upsample_rates=(4, 2),
    upsample_initial_channel=256, upsample_kernel_sizes=(8, 4),
    use_transformer_flows=True, transformer_flow_type="pre_conv", segment_size=64,
    posterior_wn_layers=2, n_speakers=4, gin_channels=G, use_spk_conditioned_encoder=True,
    use_sdp=True, quantize_decoder=True, pack_narrow_convs=True,
)
MB_KW = dict(HIFI_KW, n_speakers=0, gin_channels=0, use_spk_conditioned_encoder=False,
             upsample_rates=(2,), upsample_kernel_sizes=(4,), decoder_type="mb_istft",
             subbands=4, gen_istft_n_fft=16, gen_istft_hop_size=4)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while this module runs: under pytest-xdist a thread
    per core in every worker oversubscribes the cores, which slowed the
    port's tests about twofold and took CPU from the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(kw, rng, sid):
    jcfg = JaxModelConfig(**kw)
    jmodel = JaxSynth(n_vocab=N_VOCAB, spec_channels=SPEC_CH, segment_frames=4, cfg=jcfg)
    rngs = {k: jax.random.PRNGKey(i) for i, k in enumerate(("params", "noise", "dropout"))}
    extra = {"sid": jnp.asarray([1])} if sid else {}
    shapes = jax.eval_shape(lambda: jmodel.init(
        rngs, jnp.ones((1, 5), jnp.int32), jnp.asarray([5]), jnp.zeros((1, 16, SPEC_CH)),
        jnp.asarray([16]), **extra)["params"])
    params = random_params(shapes, rng)
    model = SynthesizerTrn(N_VOCAB, SPEC_CH, VITS2ModelConfig(**kw))
    model.load_state_dict(state_dict_from_jax_params(params, jcfg), strict=True)
    return jmodel, params, model.eval()


@pytest.fixture(scope="module")
def refs():
    rng = np.random.default_rng(61)
    ms_jax, ms_params, ms_model = _pair(HIFI_KW, rng, sid=True)
    mb_jax, mb_params, mb_model = _pair(MB_KW, rng, sid=False)
    # the same weights with every HiFi-GAN stage int8 (pack_narrow_convs off)
    nopack_kw = dict(HIFI_KW, pack_narrow_convs=False)
    np_jax = JaxSynth(n_vocab=N_VOCAB, spec_channels=SPEC_CH, segment_frames=4,
                      cfg=JaxModelConfig(**nopack_kw))
    np_model = SynthesizerTrn(N_VOCAB, SPEC_CH, VITS2ModelConfig(**nopack_kw))
    np_model.load_state_dict(ms_model.state_dict(), strict=True)
    ids = rng.integers(1, N_VOCAB, (B, T_X))
    spec = rng.standard_normal((B, T_Y, SPEC_CH)).astype(np.float32)
    noise = {shape: rng.standard_normal(shape).astype(np.float32)
             for shape in ((B, T_X, 2), (B, T_Y, D), (B, MF, D))}

    def apply(jmodel, method, **kw):
        return lambda p, *a: jmodel.apply({"params": p}, *a, method=method,
                                          rngs={"noise": jax.random.PRNGKey(0)}, **kw)

    x, xl = jnp.asarray(ids, jnp.int32), jnp.asarray(X_LENGTHS)
    sid = jnp.asarray(SIDS, jnp.int32)
    scales = dict(noise_scale=0.667, noise_scale_w=0.8, max_frames=MF)
    calls = {
        "infer": (apply(ms_jax, JaxSynth.infer, **scales), ms_params, (x, xl, sid)),
        "vc": (apply(ms_jax, JaxSynth.voice_conversion), ms_params,
               (jnp.asarray(spec), jnp.asarray(Y_LENGTHS), sid, jnp.asarray(SID_TGT, jnp.int32))),
        "mb": (apply(mb_jax, JaxSynth.infer, **scales), mb_params, (x, xl)),
        "nopack": (apply(np_jax, JaxSynth.infer, **scales), ms_params, (x, xl, sid)),
    }
    with ThreadPoolExecutor(len(calls)) as ex, injected_noise(noise):
        pending = {name: (ex.submit(jax.jit(fn).lower(p, *args).compile), p, args)
                   for name, (fn, p, args) in calls.items()}
        ref = {name: fut.result()(p, *args) for name, (fut, p, args) in pending.items()}
    return dict(ms=ms_model, mb=mb_model, nopack=np_model.eval(), ids=ids, spec=spec, noise=noise,
                ref=jax.tree.map(np.asarray, ref))


def _wave_close(got, want):
    assert got.shape == want.shape
    rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    print(f"int8 waveform against JAX: {rel:.2e} of its L2 norm")
    assert rel <= WAVE_REL_L2


def _counted(fn):
    """Run fn with the int8 quantizer's calls counted (the CPU takes the
    plain version, so the wrapper is counted, not a launch)."""
    n, orig = [0], int8_conv.quantize_act

    def counting(x):
        n[0] += 1
        return orig(x)
    int8_conv.quantize_act = counting
    try:
        return fn(), n[0]
    finally:
        int8_conv.quantize_act = orig


@pytest.mark.parametrize("which", ["ms", "nopack", "mb"],
                         ids=["hifigan_two_speakers", "hifigan_every_stage_int8", "mbistft"])
def test_int8_infer_matches_jax(refs, which):
    model = refs[which]
    kw = dict(sid=torch.tensor(SIDS)) if which != "mb" else {}
    out, n_quant = _counted(lambda: model.infer(
        torch.from_numpy(refs["ids"]), torch.tensor(X_LENGTHS), noise_scale=0.667,
        noise_scale_w=0.8, max_frames=MF,
        sdp_noise=_t(refs["noise"][(B, T_X, 2)]).transpose(1, 2),
        prior_noise=_t(refs["noise"][(B, MF, D)]).transpose(1, 2), **kw))
    audio, attn, y_mask, aux, y_lengths = out
    r_audio, r_attn, r_mask, r_aux, r_len = refs["ref"]["infer" if which == "ms" else which]
    np.testing.assert_array_equal(y_lengths.numpy(), r_len)
    assert r_len[0] != r_len[1]  # ragged: the patch window masks a tail
    np.testing.assert_array_equal(attn.numpy(), r_attn)
    np.testing.assert_array_equal(y_mask.numpy(), r_mask)
    for a, b in zip(aux, r_aux):
        _close(a.numpy(), b)
    assert audio.shape == r_audio.shape
    _wave_close(audio.numpy(), r_audio)
    # two decoder calls (the bulk and the patch window), each quantizing
    # the input of every int8 conv: HiFi-GAN conv_pre, up_0 and the
    # 128-channel bank's 8 convs (without pack_narrow_convs also up_1 and
    # the 64-channel bank's 8); MB-iSTFT conv_pre, up_0 and its 8
    assert n_quant == 2 * (19 if which == "nopack" else 10)


def test_int8_voice_conversion_matches_jax(refs):
    """sid_src != sid_tgt, ragged lengths: a masked int8 decode."""
    o_hat, y_mask, latents = refs["ms"].voice_conversion(
        _t(refs["spec"]), torch.tensor(Y_LENGTHS), torch.tensor(SIDS), torch.tensor(SID_TGT),
        eps=_t(refs["noise"][(B, T_Y, D)]).transpose(1, 2))
    r_o, r_mask, r_latents = refs["ref"]["vc"]
    np.testing.assert_array_equal(y_mask.numpy(), r_mask)
    for a, b in zip(latents, r_latents):  # through the flows forward and back
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-4)
    assert o_hat.shape == r_o.shape == (B, T_Y * 8, 1)
    _wave_close(o_hat.numpy(), r_o)


def test_shipped_config_with_quantize_decoder_matches_chip_smoke():
    """configs/vits2-ljspeech.yaml with quantize_decoder on equals
    chip_smoke.py's `int8_config` (the card has no PyYAML), builds on the
    meta device with the 39 int8 convs the chip check counts, and the
    train step refuses it."""
    import dataclasses
    import importlib.util
    import pathlib

    from torch_tts_tpu_torch.core.config import load_vits2_config
    from torch_tts_tpu_torch.ops.layers import Conv1d, ConvTranspose1d
    from torch_tts_tpu_torch.train import vits2_train

    root = pathlib.Path(__file__).resolve().parents[1]
    cfg = load_vits2_config(str(root / "configs" / "vits2-ljspeech.yaml"))
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, quantize_decoder=True))
    spec = importlib.util.spec_from_file_location("chip_smoke", root / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert chip_smoke.int8_config() == cfg and cfg.model.pack_narrow_convs
    with torch.device("meta"):
        model = SynthesizerTrn(100, cfg.posterior_channels, cfg.model, cfg.segment_frames)
    assert chip_smoke.int8_convs(model.dec) == 39
    assert sum(isinstance(m, (Conv1d, ConvTranspose1d)) and m.quant is not None
               for m in model.dec.modules()) == 39
    with pytest.raises(ValueError, match="inference-only"):
        vits2_train.check_supported(cfg)
