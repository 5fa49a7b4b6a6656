"""VITS2 inference: the port (torch_tts_tpu_torch) against the JAX package.

One tiny LJSpeech-shaped config (ResBlock1 decoder with fuse_mrf, pre_conv
transformer flows), random weights from a numpy seed loaded into both
through the port's converter with strict=True, and the same inputs. JAX
draws its noise through `jax.random.normal`, which is patched to return
numpy-seeded arrays that the port receives as tensors, so both see the
same noise. Compared, per module: text encoder, SDP reverse or
DurationPredictor, flow reverse on JAX's own z_p, decoder (both
`_decode_padded` branches) on JAX's own z, posterior encoder; and the
whole `infer` at noise 0 for use_sdp True and False with max_frames below
and above the 128-frame patch window. Tolerances: fp32 rtol 1e-4,
atol 1e-5 per module; durations and attn exactly equal; waveform
atol 1e-4. This file holds the SDP model's cases;
tests/test_torch_vits2_infer_dp.py runs the same tests on the
deterministic duration predictor's (split so that no port test file
queues ahead of the suite's longest under `--dist loadfile`).
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_tts_tpu.core.config import VITS2ModelConfig as JaxModelConfig
from torch_tts_tpu.models.vits2 import SynthesizerTrn as JaxSynth
from torch_tts_tpu_torch.core.config import VITS2ModelConfig
from torch_tts_tpu_torch.models.vits2.convert import state_dict_from_jax_params
from torch_tts_tpu_torch.models.vits2.model import SynthesizerTrn

RTOL, ATOL, WAVE_ATOL = 1e-4, 1e-5, 1e-4
N_VOCAB, SPEC_CH, B, T_X = 20, 12, 2, 24
X_LENGTHS = (24, 17)
MF_LOW, MF_HIGH = 64, 200  # below / above SynthesizerTrn._PATCH_WINDOW
CFG_KW = dict(
    inter_channels=8, hidden_channels=8, filter_channels=16, n_heads=2, n_layers=2,
    kernel_size=3, p_dropout=0.0, resblock="1", resblock_kernel_sizes=(3, 5),
    resblock_dilation_sizes=((1, 3, 5), (1, 3, 5)), upsample_rates=(4, 2),
    upsample_initial_channel=16, upsample_kernel_sizes=(8, 4),
    use_transformer_flows=True, transformer_flow_type="pre_conv", segment_size=64,
    fuse_mrf=True, posterior_wn_layers=4,
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


def random_params(shapes, rng):
    """Seeded weights of a sensible scale for every leaf of a flax tree."""
    def fill(path, s):
        name = path[-1].key
        n = rng.standard_normal(s.shape)
        if name in ("scale", "g"):
            return (1 + 0.1 * n).astype(np.float32)
        if name in ("kernel", "v"):
            return (n / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        return (0.2 * n).astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, shapes)


def init_params(cfg, rng):
    model = JaxSynth(n_vocab=N_VOCAB, spec_channels=SPEC_CH, segment_frames=4, cfg=cfg)
    x, xl = jnp.ones((1, 5), jnp.int32), jnp.asarray([5])
    y, yl = jnp.zeros((1, 16, SPEC_CH)), jnp.asarray([16])
    rngs = {k: jax.random.PRNGKey(i) for i, k in enumerate(("params", "noise", "dropout"))}
    shapes = jax.eval_shape(lambda: model.init(rngs, x, xl, y, yl)["params"])
    return model, random_params(shapes, rng)


@contextlib.contextmanager
def injected_noise(table):
    """jax.random.normal returns table[shape] (same draws for both sides)."""
    orig = jax.random.normal

    def fake(key, shape=(), dtype=jnp.float32):
        return jnp.asarray(table[tuple(shape)], dtype)

    jax.random.normal = fake
    try:
        yield
    finally:
        jax.random.normal = orig


def build_pair(use_sdp):
    """The JAX model and the port's on the same weights, inputs, noise and
    the JAX references, for use_sdp True or False."""
    rng = np.random.default_rng(7 if use_sdp else 8)
    jcfg = JaxModelConfig(use_sdp=use_sdp, **CFG_KW)
    jmodel, params = init_params(jcfg, rng)
    model = SynthesizerTrn(N_VOCAB, SPEC_CH, VITS2ModelConfig(use_sdp=use_sdp, **CFG_KW))
    model.load_state_dict(state_dict_from_jax_params(params, jcfg), strict=True)
    model.eval()

    ids = rng.integers(1, N_VOCAB, (B, T_X))
    D = jcfg.inter_channels
    noise = {(B, T_X, 2): rng.standard_normal((B, T_X, 2)),
             (B, 30, D): rng.standard_normal((B, 30, D))}
    for mf in (MF_LOW, MF_HIGH):
        noise[(B, mf, D)] = rng.standard_normal((B, mf, D))
    noise = {k: v.astype(np.float32) for k, v in noise.items()}
    spec = rng.standard_normal((B, 30, SPEC_CH)).astype(np.float32)

    # each JAX reference is compiled once: `infer` once per max_frames (its
    # noise scales are arguments), the modules on their own
    def apply(method):
        return jax.jit(lambda p, *a: jmodel.apply({"params": p}, *a, method=method,
                                                  rngs={"noise": jax.random.PRNGKey(0)}))

    infer = jax.jit(lambda p, x, xl, ns, nsw, mf: jmodel.apply(
        {"params": p}, x, xl, noise_scale=ns, noise_scale_w=nsw, max_frames=mf,
        method=JaxSynth.infer, rngs={"noise": jax.random.PRNGKey(0)}), static_argnums=5)
    x, xl = jnp.asarray(ids, jnp.int32), jnp.asarray(X_LENGTHS)
    with injected_noise(noise):
        hx, m_p, logs_p, x_mask = apply(lambda m, a, b: m.enc_p(a, b))(params, x, xl)
        if use_sdp:
            logw = apply(lambda m, a, b: m.dp(a, b, reverse=True, noise_scale=0.8))(
                params, hx, x_mask)
        else:
            logw = apply(lambda m, a, b: m.dp(a, b))(params, hx, x_mask)
        ref = dict(enc=(hx, m_p, logs_p, x_mask), logw=logw)
        for name, ns, mf in (("noisy", 0.667, MF_HIGH), ("low", 0.0, MF_LOW),
                             ("high", 0.0, MF_HIGH)):
            ref[name] = infer(params, x, xl, ns, 0.8 * (ns > 0), mf)
        ref["enc_q"] = apply(lambda m, a, b: m.enc_q(a, b))(params, jnp.asarray(spec),
                                                             jnp.asarray([30, 21]))
    ref = jax.tree.map(np.asarray, ref)
    return dict(model=model, ids=ids, noise=noise, spec=spec, ref=ref, use_sdp=use_sdp)


@pytest.fixture(scope="module", params=[True], ids=["sdp"])
def pair(request):
    """The SDP model's pair; the deterministic duration predictor's runs the
    same tests in tests/test_torch_vits2_infer_dp.py."""
    return build_pair(request.param)


def _t(a):
    return torch.from_numpy(np.array(a))


def _cl(t):
    """[B, C, T] torch -> [B, T, C] numpy."""
    return t.transpose(1, 2).numpy()


def _close(actual, desired, atol=ATOL):
    np.testing.assert_allclose(actual, desired, rtol=RTOL, atol=atol)


def _inputs(pair):
    return torch.from_numpy(pair["ids"]), torch.tensor(X_LENGTHS)


def test_text_encoder(pair):
    with torch.no_grad():
        hx, m_p, logs_p, x_mask = pair["model"].enc_p(*_inputs(pair))
    for a, b in zip((hx, m_p, logs_p, x_mask), pair["ref"]["enc"]):
        _close(_cl(a), b)


def test_duration_predictor(pair):
    """SDP reverse with the injected noise at noise_scale 0.8, or the
    deterministic DurationPredictor."""
    model = pair["model"]
    hx, _, _, x_mask = (_t(a).transpose(1, 2) for a in pair["ref"]["enc"])
    with torch.no_grad():
        if pair["use_sdp"]:
            logw = model.dp(hx, x_mask, reverse=True, noise_scale=0.8,
                            noise=_t(pair["noise"][(B, T_X, 2)]).transpose(1, 2))
        else:
            logw = model.dp(hx, x_mask)
    _close(_cl(logw), pair["ref"]["logw"])


def test_flow_reverse_on_jax_latents(pair):
    _, _, y_mask, (z, z_p, _, _), _ = pair["ref"]["noisy"]
    with torch.no_grad():
        out = pair["model"].flow(_t(z_p).transpose(1, 2), _t(y_mask).transpose(1, 2),
                                 reverse=True)
    _close(_cl(out), z)


@pytest.mark.parametrize("name", ["noisy", "low"])
def test_decoder_on_jax_latents(pair, name):
    """`_decode_padded` on JAX's z: the patch-window branch (max_frames 200)
    and the fully masked branch (64)."""
    audio, _, y_mask, (z, _, _, _), y_lengths = pair["ref"][name]
    ym = _t(y_mask).transpose(1, 2)
    with torch.no_grad():
        out = pair["model"]._decode_padded(_t(z).transpose(1, 2) * ym, ym, _t(y_lengths),
                                           y_mask.shape[1])
    _close(_cl(out), audio, atol=WAVE_ATOL)


def test_posterior_encoder(pair):
    z, m, logs, y_mask = pair["ref"]["enc_q"]
    with torch.no_grad():
        out = pair["model"].enc_q(_t(pair["spec"]).transpose(1, 2), torch.tensor([30, 21]),
                                  noise=_t(pair["noise"][(B, 30, 8)]).transpose(1, 2))
    for a, b in zip(out, (z, m, logs, y_mask)):
        _close(_cl(a), b)


def _check_infer(out, ref):
    audio, attn, y_mask, aux, y_lengths = out
    r_audio, r_attn, r_mask, r_aux, r_len = ref
    np.testing.assert_array_equal(y_lengths.numpy(), r_len)
    np.testing.assert_array_equal(attn.numpy(), r_attn)
    np.testing.assert_array_equal(y_mask.numpy(), r_mask)
    for a, b in zip(aux, r_aux):
        _close(a.numpy(), b)
    np.testing.assert_allclose(audio.numpy(), r_audio, rtol=0, atol=WAVE_ATOL)
    assert audio.shape == r_audio.shape
    assert int(y_lengths.min()) > 0


@pytest.mark.parametrize("name,max_frames", [("low", MF_LOW), ("high", MF_HIGH)])
def test_infer_matches_jax_at_noise_zero(pair, name, max_frames):
    out = pair["model"].infer(*_inputs(pair), noise_scale=0.0, noise_scale_w=0.0,
                              max_frames=max_frames, generator=torch.Generator().manual_seed(0))
    _check_infer(out, pair["ref"][name])


def test_infer_matches_jax_with_injected_noise(pair):
    noise = pair["noise"]
    out = pair["model"].infer(
        *_inputs(pair), noise_scale=0.667, noise_scale_w=0.8, max_frames=MF_HIGH,
        sdp_noise=_t(noise[(B, T_X, 2)]).transpose(1, 2),
        prior_noise=_t(noise[(B, MF_HIGH, 8)]).transpose(1, 2))
    _check_infer(out, pair["ref"]["noisy"])


def test_patch_window_branch_sees_short_items(pair):
    """Above the patch window some item ends before max_frames, so the
    pasted window and the zeroed tail are both exercised."""
    for name in ("noisy", "high"):
        r_len = pair["ref"][name][4]
        assert (r_len < MF_HIGH).any() and (r_len > 0).all()


def test_infer_needs_generator_or_noise(pair):
    with pytest.raises(ValueError):
        pair["model"].infer(*_inputs(pair), max_frames=MF_LOW)


@pytest.mark.parametrize("reverse", [False, True])
def test_flow_blocks_match_jax(reverse):
    """Log, Flip, ElementwiseAffine and ConvFlow, forward (with logdet) and
    reverse, on the same weights and inputs."""
    from torch_tts_tpu.ops import flows as jflows
    from torch_tts_tpu_torch.ops import flows

    rng = np.random.default_rng(3)
    x = np.abs(rng.standard_normal((2, 13, 2))).astype(np.float32) + 0.1
    mask = (np.arange(13)[None, :, None] < np.array([13, 9])[:, None, None]).astype(np.float32)
    g = rng.standard_normal((2, 13, 6)).astype(np.float32)
    xt, mt, gt = (torch.from_numpy(a).transpose(1, 2) for a in (x, mask, g))
    cases = [(jflows.Log(), flows.Log()), (jflows.Flip(), flows.Flip()),
             (jflows.ElementwiseAffine(2), flows.ElementwiseAffine(2)),
             (jflows.ConvFlow(2, 6, 3, n_layers=3), flows.ConvFlow(2, 6, 3, n_layers=3))]
    for jmod, mod in cases:
        variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask),
                              g=jnp.asarray(g))
        params = jax.tree.map(
            lambda p: np.asarray(p) + (0.3 * rng.standard_normal(p.shape)).astype(np.float32),
            variables.get("params", {}))
        mod.load_state_dict(state_dict_from_jax_params(params), strict=True)
        ref = jmod.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask), g=jnp.asarray(g),
                         reverse=reverse)
        with torch.no_grad():
            out = mod(xt, mt, g=gt, reverse=reverse)
        if reverse:
            _close(_cl(out), np.asarray(ref))
        else:
            _close(_cl(out[0]), np.asarray(ref[0]))
            _close(out[1].numpy(), np.asarray(ref[1]), atol=1e-4)  # a sum over T and C
