"""The plain VITS1 couplings (`use_transformer_flows=False`) and the
streaming prefixes `infer_latents` / `infer_pre_flow`: the port
(torch_tts_tpu_torch) against the JAX package.

A tiny config with plain mean-only couplings (four `ResidualCouplingLayer`s
of a 4-layer WN) and a ResBlock1 decoder, random weights from a numpy seed
carried across by the port's converter and loaded with strict=True, the
same inputs. JAX draws its noise through `jax.random.normal`, patched to
return numpy-seeded arrays that the port receives as tensors; each JAX
reference is jitted once and compiled in a thread as soon as it is traced.

Compared: `ResidualCouplingLayer` forward (with logdet) and reverse, mean
only and not, within rtol 1e-4 / atol 1e-5; whole `infer` with injected
noise (durations and attn exactly, latents within rtol 1e-4 / atol 1e-5,
the waveform within 1e-4); `infer_latents` and `infer_pre_flow` with
injected noise (y_lengths and y_mask exactly, the latents within rtol 1e-4
/ atol 1e-5). On the port alone: the two prefixes draw what `infer` draws
from one generator, and decoding them reproduces `infer`'s audio exactly.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_vits2_infer import (CFG_KW, N_VOCAB, SPEC_CH, _check_infer, _cl, _close, _t,
                                    injected_noise, random_params)
from torch_tts_tpu.core.config import VITS2ModelConfig as JaxModelConfig
from torch_tts_tpu.models.vits2 import SynthesizerTrn as JaxSynth
from torch_tts_tpu_torch.core.config import VITS2ModelConfig
from torch_tts_tpu_torch.models.vits2.convert import state_dict_from_jax_params
from torch_tts_tpu_torch.models.vits2.model import FlowBlock, SynthesizerTrn

B, T_X, D = 2, 24, 8
X_LENGTHS = (24, 17)
MF_LOW, MF_HIGH = 64, 200  # below / above SynthesizerTrn._PATCH_WINDOW
PLAIN_KW = dict(CFG_KW, use_transformer_flows=False)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while this module runs: under pytest-xdist a thread
    per core in every worker oversubscribes the cores, which slowed the
    port's tests about twofold and took CPU from the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def plain_pair(seed: int = 7):
    """The JAX plain-coupling model and the port's on the same weights."""
    rng = np.random.default_rng(seed)
    jcfg = JaxModelConfig(**PLAIN_KW)
    jmodel = JaxSynth(n_vocab=N_VOCAB, spec_channels=SPEC_CH, segment_frames=4, cfg=jcfg)
    rngs = {k: jax.random.PRNGKey(i) for i, k in enumerate(("params", "noise", "dropout"))}
    shapes = jax.eval_shape(lambda: jmodel.init(
        rngs, jnp.ones((1, 5), jnp.int32), jnp.asarray([5]), jnp.zeros((1, 16, SPEC_CH)),
        jnp.asarray([16]))["params"])
    params = random_params(shapes, rng)
    model = SynthesizerTrn(N_VOCAB, SPEC_CH, VITS2ModelConfig(**PLAIN_KW))
    model.load_state_dict(state_dict_from_jax_params(params, jcfg), strict=True)
    return jmodel, jcfg, params, model.eval(), rng


@pytest.fixture(scope="module")
def pair():
    jmodel, jcfg, params, model, rng = plain_pair()
    ids = rng.integers(1, N_VOCAB, (B, T_X))
    noise = {shape: rng.standard_normal(shape).astype(np.float32)
             for shape in ((B, T_X, 2), (B, MF_LOW, D), (B, MF_HIGH, D))}

    def apply(method, max_frames):
        return lambda p, a, b: jmodel.apply(
            {"params": p}, a, b, noise_scale=0.667, noise_scale_w=0.8, max_frames=max_frames,
            method=method, rngs={"noise": jax.random.PRNGKey(0)})

    x, xl = jnp.asarray(ids, jnp.int32), jnp.asarray(X_LENGTHS)
    calls = {"infer": apply(JaxSynth.infer, MF_HIGH),
             "latents": apply(JaxSynth.infer_latents, MF_HIGH),
             "pre_flow": apply(JaxSynth.infer_pre_flow, MF_LOW)}
    with ThreadPoolExecutor(len(calls)) as ex, injected_noise(noise):
        pending = {n: ex.submit(jax.jit(fn).lower(params, x, xl).compile)
                   for n, fn in calls.items()}
        ref = {n: fut.result()(params, x, xl) for n, fut in pending.items()}
    ref = jax.tree.map(lambda a: None if a is None else np.asarray(a), ref)
    return dict(model=model, ids=ids, noise=noise, ref=ref)


def _inputs(pair):
    return torch.from_numpy(pair["ids"]), torch.tensor(X_LENGTHS)


def _noise(pair, max_frames):
    noise = pair["noise"]
    return dict(sdp_noise=_t(noise[(B, T_X, 2)]).transpose(1, 2),
                prior_noise=_t(noise[(B, max_frames, D)]).transpose(1, 2))


@pytest.mark.parametrize("mean_only", [True, False], ids=["mean_only", "affine"])
@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
def test_coupling_layer_matches_jax(mean_only, reverse):
    from torch_tts_tpu.ops import flows as jflows
    from torch_tts_tpu_torch.ops import flows

    rng = np.random.default_rng(5 + 2 * mean_only + reverse)
    C, H, T = 6, 8, 21
    x = rng.standard_normal((2, T, C)).astype(np.float32)
    mask = (np.arange(T)[None, :, None] < np.array([T, 13])[:, None, None]).astype(np.float32)
    jmod = jflows.ResidualCouplingLayer(C, H, 5, 1, 4, mean_only=mean_only)
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                              jnp.asarray(mask))["params"])
    params = random_params(shapes, rng)
    mod = flows.ResidualCouplingLayer(C, H, 5, 1, 4, mean_only=mean_only)
    mod.load_state_dict(state_dict_from_jax_params(params), strict=True)
    ref = jax.jit(lambda p, a, m: jmod.apply({"params": p}, a, m, reverse=reverse))(
        params, jnp.asarray(x), jnp.asarray(mask))
    with torch.no_grad():
        out = mod(torch.from_numpy(x).transpose(1, 2), torch.from_numpy(mask).transpose(1, 2),
                  reverse=reverse)
    if reverse:
        _close(_cl(out), np.asarray(ref))
    else:
        _close(_cl(out[0]), np.asarray(ref[0]))
        _close(out[1].numpy(), np.asarray(ref[1]), atol=1e-4)  # a sum over T and C


def test_converter_loads_plain_couplings_under_reference_names():
    """The JAX tree of a plain-coupling flow converts to the names and
    shapes of the JAX exporter (`flow.flows.{2i}.pre/enc/post`, no
    transformer placeholders), and loads with strict=True (plain_pair's
    load)."""
    from torch_tts_tpu.models.vits2.convert import export_torch_state_dict

    _, jcfg, params, model, _ = plain_pair(seed=3)
    sd = state_dict_from_jax_params(params, jcfg)
    want = export_torch_state_dict(params, jcfg)
    assert {k: tuple(v.shape) for k, v in sd.items()} == {k: tuple(v.shape)
                                                         for k, v in want.items()}
    flow_keys = {k for k in sd if k.startswith("flow.")}
    assert flow_keys == {k for k in model.state_dict() if k.startswith("flow.")}
    assert "flow.flows.6.post.weight" in sd and "flow.flows.0.enc.in_layers.3.weight_v" in sd
    assert sd["flow.flows.0.post.weight"].shape == (D // 2, CFG_KW["hidden_channels"], 1)
    assert not any("transformer" in k for k in flow_keys)


def test_infer_with_plain_couplings_matches_jax(pair):
    out = pair["model"].infer(*_inputs(pair), noise_scale=0.667, noise_scale_w=0.8,
                              max_frames=MF_HIGH, **_noise(pair, MF_HIGH))
    _check_infer(out, pair["ref"]["infer"])
    assert (out[4] < MF_HIGH).any()  # the pasted window and the zeroed tail run


def _check_prefix(out, ref):
    lat, g, y_mask, y_lengths = out
    np.testing.assert_array_equal(y_lengths.numpy(), ref[3])
    np.testing.assert_array_equal(y_mask.numpy(), ref[2])
    assert g is None and ref[1] is None
    _close(lat.numpy(), ref[0])


def test_infer_latents_matches_jax(pair):
    out = pair["model"].infer_latents(*_inputs(pair), noise_scale=0.667, noise_scale_w=0.8,
                                      max_frames=MF_HIGH, **_noise(pair, MF_HIGH))
    _check_prefix(out, pair["ref"]["latents"])


def test_infer_pre_flow_matches_jax(pair):
    out = pair["model"].infer_pre_flow(*_inputs(pair), noise_scale=0.667, noise_scale_w=0.8,
                                       max_frames=MF_LOW, **_noise(pair, MF_LOW))
    _check_prefix(out, pair["ref"]["pre_flow"])


def test_prefixes_draw_what_infer_draws(pair):
    """From one generator seed the prefixes draw infer's noise in infer's
    order, and decoding them (below the patch window: the whole masked
    decode) gives infer's audio exactly."""
    model = pair["model"]

    def run(method):
        return method(*_inputs(pair), noise_scale=0.667, noise_scale_w=0.8, max_frames=MF_LOW,
                      generator=torch.Generator().manual_seed(11))

    audio, _, y_mask, (z, z_p, _, _), y_lengths = run(model.infer)
    lat, g, ym, yl = run(model.infer_latents)
    zp, _, _, _ = run(model.infer_pre_flow)
    assert torch.equal(yl, y_lengths) and torch.equal(ym, y_mask) and g is None
    assert torch.equal(lat, z * y_mask) and torch.equal(zp, z_p)
    m = ym.transpose(1, 2)
    with torch.inference_mode():
        o = model.dec(lat.transpose(1, 2), x_mask=m)
        o = o * torch.repeat_interleave(m, o.shape[2] // MF_LOW, dim=2)
        zf = model.flow(zp.transpose(1, 2), m, reverse=True)
    assert torch.equal(o.transpose(1, 2), audio)
    assert torch.equal(zf.transpose(1, 2) * y_mask, lat)


def test_flow_block_raises_on_flow_types_not_ported():
    """Every JAX flow type is ported (tests/test_torch_vits2_flow_types.py);
    a type the JAX package does not have is refused."""
    for t in ("pre_conv2", "fft", "mono_layer_inter_residual", "mono_layer_post_residual"):
        FlowBlock(8, 8, 5, 1, 4, transformer_flow_type=t)
    with pytest.raises(ValueError, match="conv3"):
        FlowBlock(8, 8, 5, 1, 4, transformer_flow_type="conv3")
