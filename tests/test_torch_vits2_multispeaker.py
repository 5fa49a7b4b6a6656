"""Multi-speaker VITS2 inference and voice conversion: the port
(torch_tts_tpu_torch) against the JAX package.

The JAX multi-speaker model at a small size (4 speakers, gin_channels 8,
the speaker-conditioned text encoder with three layers so that its
conditioning before layer 2 runs, SDP, pre_conv flows, a ResBlock1
decoder with fuse_mrf), random weights from a numpy seed carried across
by the port's converter and loaded with strict=True, and the same inputs.
JAX draws its noise through `jax.random.normal`, patched to return
numpy-seeded arrays that the port receives as tensors. Each JAX reference
is jitted once and compiled in a thread as soon as it is traced.

Compared: the speaker-conditioned text encoder; the SDP (both directions)
and the deterministic duration predictor with g, and that g takes no
gradient through them; `infer` with two speakers in one batch (above the
128-frame patch window) and with sid=None (below it): durations and attn
exactly, latents within rtol 1e-4 / atol 1e-5, the waveform within 1e-4;
`voice_conversion` with sid_src != sid_tgt on ragged and on full lengths
(o_hat, z, z_p, z_hat); the converter's names and shapes against the JAX
exporter's.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_vits2_infer import (_check_infer, _cl, _close, _t, injected_noise,
                                    random_params)
from torch_tts_tpu.core.config import VITS2ModelConfig as JaxModelConfig
from torch_tts_tpu.models.vits2 import SynthesizerTrn as JaxSynth
from torch_tts_tpu_torch.core.config import VITS2ModelConfig
from torch_tts_tpu_torch.models.vits2.convert import state_dict_from_jax_params
from torch_tts_tpu_torch.models.vits2.model import SynthesizerTrn

N_VOCAB, SPEC_CH, B, T_X, T_Y, D, G = 20, 12, 2, 24, 30, 8, 8
X_LENGTHS, Y_LENGTHS = (24, 17), (30, 21)
MF_LOW, MF_HIGH = 64, 200  # below / above SynthesizerTrn._PATCH_WINDOW
SIDS, SID_TGT = (1, 3), (2, 0)
CFG_KW = dict(
    inter_channels=D, hidden_channels=8, filter_channels=16, n_heads=2, n_layers=3,
    kernel_size=3, p_dropout=0.0, resblock="1", resblock_kernel_sizes=(3, 5),
    resblock_dilation_sizes=((1, 3, 5), (1, 3, 5)), upsample_rates=(4, 2),
    upsample_initial_channel=16, upsample_kernel_sizes=(8, 4),
    use_transformer_flows=True, transformer_flow_type="pre_conv", segment_size=64,
    fuse_mrf=True, posterior_wn_layers=4, n_speakers=4, gin_channels=G,
    use_spk_conditioned_encoder=True, use_sdp=True,
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while this module runs: under pytest-xdist a thread
    per core in every worker oversubscribes the cores, which slowed the
    port's tests about twofold and took CPU from the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ms():
    rng = np.random.default_rng(21)
    jcfg = JaxModelConfig(**CFG_KW)
    jmodel = JaxSynth(n_vocab=N_VOCAB, spec_channels=SPEC_CH, segment_frames=4, cfg=jcfg)
    rngs = {k: jax.random.PRNGKey(i) for i, k in enumerate(("params", "noise", "dropout"))}
    shapes = jax.eval_shape(lambda: jmodel.init(
        rngs, jnp.ones((1, 5), jnp.int32), jnp.asarray([5]), jnp.zeros((1, 16, SPEC_CH)),
        jnp.asarray([16]), sid=jnp.asarray([1]))["params"])
    params = random_params(shapes, rng)
    model = SynthesizerTrn(N_VOCAB, SPEC_CH, VITS2ModelConfig(**CFG_KW))
    model.load_state_dict(state_dict_from_jax_params(params, jcfg), strict=True)
    model.eval()

    ids = rng.integers(1, N_VOCAB, (B, T_X))
    spec = rng.standard_normal((B, T_Y, SPEC_CH)).astype(np.float32)
    noise = {shape: rng.standard_normal(shape).astype(np.float32)
             for shape in ((B, T_X, 2), (B, T_Y, D), (B, MF_LOW, D), (B, MF_HIGH, D))}

    def jit(fn, *args, static=()):
        return jax.jit(lambda p, *a: fn(p, *a), static_argnums=static).lower(params, *args)

    def apply(method, **kw):
        return lambda p, *a: jmodel.apply({"params": p}, *a, method=method,
                                          rngs={"noise": jax.random.PRNGKey(0)}, **kw)

    x, xl = jnp.asarray(ids, jnp.int32), jnp.asarray(X_LENGTHS)
    sid = jnp.asarray(SIDS, jnp.int32)
    y = jnp.asarray(spec)
    calls = {
        "enc": (apply(lambda m, a, b, s: m.enc_p(a, b, g=m._speaker(s))), (x, xl, sid)),
        "two_sids": (apply(JaxSynth.infer, noise_scale=0.667, noise_scale_w=0.8,
                           max_frames=MF_HIGH), (x, xl, sid)),
        "no_sid": (apply(JaxSynth.infer, noise_scale=0.667, noise_scale_w=0.8,
                         max_frames=MF_LOW), (x, xl)),
        "vc": (apply(JaxSynth.voice_conversion), (y, jnp.asarray(Y_LENGTHS), sid,
                                                  jnp.asarray(SID_TGT, jnp.int32))),
    }
    pending = {}
    with ThreadPoolExecutor(len(calls)) as ex, injected_noise(noise):
        for name, (fn, args) in calls.items():
            pending[name] = ex.submit(jit(fn, *args).compile), args
        ref = {name: fut.result()(params, *args) for name, (fut, args) in pending.items()}
        # the same compiled conversion on full lengths
        fn, args = pending["vc"]
        ref["vc_full"] = fn.result()(params, y, jnp.asarray([T_Y, T_Y]), *args[2:])
    ref = jax.tree.map(np.asarray, ref)
    return dict(model=model, params=params, jcfg=jcfg, ids=ids, spec=spec, noise=noise, ref=ref)


def _inputs(ms):
    return torch.from_numpy(ms["ids"]), torch.tensor(X_LENGTHS)


def test_speaker_conditioned_text_encoder_matches_jax(ms):
    model = ms["model"]
    assert model.enc_p.encoder.cond_layer_idx == 2 < len(model.enc_p.encoder.attn_layers)
    with torch.no_grad():
        out = model.enc_p(*_inputs(ms), g=model._speaker(torch.tensor(SIDS)))
        plain = model.enc_p(*_inputs(ms))
    for a, b in zip(out, ms["ref"]["enc"]):
        _close(_cl(a), b)
    assert float((out[0] - plain[0]).abs().max()) > 1e-3  # the speaker moved hx


@pytest.mark.parametrize("case,sid,max_frames", [("two_sids", SIDS, MF_HIGH),
                                                 ("no_sid", None, MF_LOW)])
def test_infer_with_speakers_matches_jax(ms, case, sid, max_frames):
    noise = ms["noise"]
    out = ms["model"].infer(
        *_inputs(ms), sid=None if sid is None else torch.tensor(sid), noise_scale=0.667,
        noise_scale_w=0.8, max_frames=max_frames,
        sdp_noise=_t(noise[(B, T_X, 2)]).transpose(1, 2),
        prior_noise=_t(noise[(B, max_frames, D)]).transpose(1, 2))
    _check_infer(out, ms["ref"][case])
    if case == "two_sids":
        assert (out[4] < max_frames).any()  # the pasted window and the zeroed tail run


@pytest.mark.parametrize("case,lengths", [("vc", Y_LENGTHS), ("vc_full", (T_Y, T_Y))])
def test_voice_conversion_matches_jax(ms, case, lengths):
    """sid_src != sid_tgt; ragged lengths decode masked, full lengths
    unmasked (the same values, the decoder's banks free to take their
    kernel)."""
    o_hat, y_mask, latents = ms["model"].voice_conversion(
        _t(ms["spec"]), torch.tensor(lengths), torch.tensor(SIDS), torch.tensor(SID_TGT),
        eps=_t(ms["noise"][(B, T_Y, D)]).transpose(1, 2))
    r_o, r_mask, r_latents = ms["ref"][case]
    np.testing.assert_array_equal(y_mask.numpy(), r_mask)
    for a, b in zip(latents, r_latents):
        _close(a.numpy(), b)
    assert o_hat.shape == r_o.shape == (B, T_Y * 8, 1)
    np.testing.assert_allclose(o_hat.numpy(), r_o, rtol=0, atol=1e-4)
    assert float(np.abs(r_latents[2] - r_latents[0]).max()) > 1e-3  # the speaker changed z


def test_voice_conversion_needs_a_multi_speaker_model():
    model = SynthesizerTrn(N_VOCAB, SPEC_CH, VITS2ModelConfig(**dict(CFG_KW, n_speakers=0)))
    with pytest.raises(ValueError, match="multi-speaker"):
        model.voice_conversion(torch.zeros(1, 5, SPEC_CH), torch.tensor([5]), torch.tensor([0]),
                               torch.tensor([1]), generator=torch.Generator())


def test_names_and_shapes_match_the_jax_exporter(ms):
    """The converter gives the JAX exporter's names and shapes for the whole
    multi-speaker tree, the speaker parameters among them."""
    from torch_tts_tpu.models.vits2.convert import export_torch_state_dict

    got = state_dict_from_jax_params(ms["params"], ms["jcfg"])
    want = export_torch_state_dict(ms["params"], ms["jcfg"])
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    spk = {"emb_g.weight", "enc_p.encoder.spk_emb_linear.weight", "dec.cond.weight",
           "dp.cond.weight", "enc_q.enc.cond_layer.weight_v",
           *(f"flow.flows.{2 * i}.enc.cond_layer.weight_v" for i in range(4))}
    assert spk <= set(got)
    assert got["emb_g.weight"].shape == (4, G)


def _predictor_pair(kind, rng):
    """A JAX SDP or DurationPredictor with gin_channels, its seeded params,
    and the port's module loaded from them."""
    from torch_tts_tpu.models.vits2.model import DurationPredictor as JaxDP
    from torch_tts_tpu.models.vits2.model import StochasticDurationPredictor as JaxSDP
    from torch_tts_tpu_torch.models.vits2.model import (DurationPredictor,
                                                        StochasticDurationPredictor)

    H, T = 8, 11
    hx = rng.standard_normal((B, T, H)).astype(np.float32)
    x_mask = (np.arange(T)[None, :, None] < np.array([T, 7])[:, None, None]).astype(np.float32)
    g = rng.standard_normal((B, 1, G)).astype(np.float32)
    w = (rng.integers(1, 5, (B, T, 1)) * x_mask).astype(np.float32)
    if kind == "sdp":
        jmod, mod = JaxSDP(H, 192, 3, 0.0, 4, gin_channels=G), StochasticDurationPredictor(
            H, 192, 3, 4, gin_channels=G)
    else:
        jmod, mod = JaxDP(16, 3, 0.0, gin_channels=G), DurationPredictor(H, 16, 3, gin_channels=G)
    args = tuple(map(jnp.asarray, (hx, x_mask)))
    kw = dict(w=jnp.asarray(w)) if kind == "sdp" else {}
    shapes = jax.eval_shape(lambda: jmod.init({"params": jax.random.PRNGKey(0),
                                               "noise": jax.random.PRNGKey(1)}, *args,
                                              g=jnp.asarray(g), **kw))
    params = random_params(shapes["params"], rng)
    mod.load_state_dict(state_dict_from_jax_params(params), strict=True)
    return jmod, params, mod, (hx, x_mask, g, w)


@pytest.mark.parametrize("kind", ["sdp", "dp"])
def test_duration_predictors_with_speaker_match_jax(kind):
    """With g: the SDP's NLL and its reverse (injected noise), or the
    DurationPredictor; g takes no gradient through either (JAX applies
    stop_gradient to it), while `cond` does."""
    rng = np.random.default_rng(31)
    jmod, params, mod, (hx, x_mask, g, w) = _predictor_pair(kind, rng)
    e = rng.standard_normal((B, hx.shape[1], 2)).astype(np.float32)
    jargs = tuple(map(jnp.asarray, (hx, x_mask)))
    outs = []
    with injected_noise({(B, hx.shape[1], 2): e}):
        if kind == "sdp":
            for reverse in (False, True):
                kw = dict(reverse=True, noise_scale=0.8) if reverse else dict(w=jnp.asarray(w))
                outs.append(jax.jit(lambda p, gg, kw=kw: jmod.apply(
                    {"params": p}, *jargs, g=gg, rngs={"noise": jax.random.PRNGKey(1)}, **kw))(
                        params, jnp.asarray(g)))
        else:
            outs.append(jax.jit(lambda p, gg: jmod.apply({"params": p}, *jargs, g=gg))(
                params, jnp.asarray(g)))
    gt = torch.from_numpy(g).transpose(1, 2).requires_grad_()
    hxt = _t(hx).transpose(1, 2).requires_grad_()
    mt = _t(x_mask).transpose(1, 2)
    if kind == "sdp":
        nll = mod(hxt, mt, w=_t(w).transpose(1, 2), g=gt, noise=_t(e).transpose(1, 2))
        logw = mod(hxt, mt, g=gt, reverse=True, noise_scale=0.8, noise=_t(e).transpose(1, 2))
        _close(nll.detach().numpy(), outs[0], atol=1e-4)
        _close(_cl(logw.detach()), outs[1])
        loss = nll.sum() + logw.sum()
    else:
        logw = mod(hxt, mt, g=gt)
        _close(_cl(logw.detach()), outs[0])
        loss = logw.sum()
    loss.backward()
    assert gt.grad is None and hxt.grad is None
    assert float(mod.cond.weight.grad.abs().max()) > 0
