"""The four VITS2 transformer flow types beyond `pre_conv` (`pre_conv2`,
`fft`, `mono_layer_inter_residual`, `mono_layer_post_residual`): the port
(torch_tts_tpu_torch) against the JAX package.

Random weights from a numpy seed carried into the port by its converters
with strict=True, the same inputs and noise (`jax.random.normal` /
`uniform` patched to numpy-seeded arrays, the JAX Dropout the identity,
the port's dropout p = 0). Each JAX reference is jitted once and compiled
in a thread.

- Each type's own layer (the `pre_conv2` and `fft` couplings, the mono
  transformer flow in both residual modes) forward, with its logdet, and
  reverse, with a speaker embedding g and without, on ragged lengths;
  then a two-step FlowBlock of the type both ways: within rtol 1e-4 /
  atol 1e-5 (the logdet, a sum over T and C, atol 1e-4).
- `infer` of a tiny single-speaker model of each type, with injected
  noise below the patch window: durations and attn exactly, the latents
  within rtol 1e-4 / atol 1e-5, the waveform within 1e-4; the converter's
  names and shapes equal to the JAX exporter's.
- One `ddp` train step of each type from one state: every loss term
  within rtol 1e-4.
- `StreamingFlowDecoder` refuses each type, as it refuses `pre_conv`.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_vits2_infer import _check_infer
from test_torch_vits2_train import (AUDIO_KW, B, HOP, MODEL_KW, N_MELS, N_VOCAB, PERIODS, SEG, T_X,
                                    T_Y, X_LENGTHS, Y_LENGTHS, _recording, _t, _tc, _torch_batch,
                                    patched_jax, random_params)
from torch_tts_tpu.core.config import AudioConfig as JAudio
from torch_tts_tpu.core.config import VITS2Config as JConfig
from torch_tts_tpu.core.config import VITS2ModelConfig as JModelConfig
from torch_tts_tpu.models.vits2 import MultiPeriodDiscriminator as JaxMPD
from torch_tts_tpu.models.vits2 import SynthesizerTrn as JaxSynth
from torch_tts_tpu.models.vits2 import model as jmodel_module
from torch_tts_tpu.train import vits2_train as jtrain
from torch_tts_tpu_torch.core.config import AudioConfig, VITS2Config, VITS2ModelConfig
from torch_tts_tpu_torch.models.vits2 import model as model_module
from torch_tts_tpu_torch.models.vits2.convert import (mpd_state_dict_from_jax_params,
                                                      state_dict_from_jax_params)
from torch_tts_tpu_torch.models.vits2.discriminators import MultiPeriodDiscriminator
from torch_tts_tpu_torch.ops.layers import Dropout
from torch_tts_tpu_torch.train import vits2_train

TYPES = ("pre_conv2", "fft", "mono_layer_inter_residual", "mono_layer_post_residual")
RTOL, ATOL = 1e-4, 1e-5
C, H, T, GIN = 8, 8, 21, 4
LENGTHS = (21, 13)
MAX_FRAMES = 64
LOSSES = ("loss/g/total", "loss/g/gen", "loss/g/fm", "loss/g/mel", "loss/g/dur", "loss/g/kl",
          "loss/d/total")
# a single-speaker model of each type: the train file's tiny config, one flow
# step, the deterministic duration predictor
TYPE_KW = dict(MODEL_KW, use_sdp=False, flow_n_flows=1)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while this module runs: under pytest-xdist a thread
    per core in every worker oversubscribes the cores, which slowed the
    port's tests about twofold and took CPU from the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _layers(t):
    """The type's own layer in JAX and in the port (with speaker input)."""
    if t == "pre_conv2":
        return (jmodel_module.ResidualCouplingTransformersLayer2(C, H, 5, 1, 4, gin_channels=GIN),
                model_module.ResidualCouplingTransformersLayer2(C, H, 5, 1, 4, gin_channels=GIN))
    if t == "fft":
        return (jmodel_module.FFTransformerCouplingLayer(C, H, 5, n_layers=1, n_heads=4,
                                                         gin_channels=GIN),
                model_module.FFTransformerCouplingLayer(C, H, 5, n_layers=1, n_heads=4,
                                                        gin_channels=GIN))
    post = t == "mono_layer_post_residual"
    return (jmodel_module.MonoTransformerFlowLayer(C, H, residual_connection=post),
            model_module.MonoTransformerFlowLayer(C, residual_connection=post))


def _blocks(t):
    kw = dict(n_flows=2, gin_channels=GIN, use_transformer_flows=True, transformer_flow_type=t)
    return jmodel_module.FlowBlock(C, H, 5, 1, 4, **kw), model_module.FlowBlock(C, H, 5, 1, 4, **kw)


def _configs(t):
    kw = dict(TYPE_KW, transformer_flow_type=t)
    return (JConfig(audio=JAudio(**AUDIO_KW), model=JModelConfig(**kw)),
            VITS2Config(audio=AudioConfig(**AUDIO_KW), model=VITS2ModelConfig(**kw)))


def _no_dropout(model):
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0  # the mono flows' pre_transformer has the reference's fixed 0.1
    return model


@pytest.fixture(scope="module")
def refs():
    """Per type: the layers' and blocks' weights, the whole model's weights
    and every JAX reference, compiled in threads."""
    rng = np.random.default_rng(29)
    x = rng.standard_normal((2, T, C)).astype(np.float32)
    g = rng.standard_normal((2, 1, GIN)).astype(np.float32)
    mask = (np.arange(T)[None, :, None] < np.asarray(LENGTHS)[:, None, None]).astype(np.float32)
    ids = rng.integers(1, N_VOCAB, (B, T_X)).astype(np.int32)
    D = TYPE_KW["inter_channels"]
    prior = rng.standard_normal((B, MAX_FRAMES, D)).astype(np.float32)
    batch = {
        "x": ids, "x_lengths": np.asarray(X_LENGTHS, np.int32),
        "spec": rng.standard_normal((B, T_Y, N_MELS)).astype(np.float32),
        "spec_lengths": np.asarray(Y_LENGTHS, np.int32),
        "wav": (rng.standard_normal((B, T_Y * HOP, 1)) * 0.1).astype(np.float32),
    }
    eps = rng.standard_normal((B, T_Y, D)).astype(np.float32)
    mas = rng.standard_normal((B, T_Y, T_X)).astype(np.float32)
    u = rng.uniform(size=B).astype(np.float32)
    seg_ids = (u * np.maximum(np.asarray(Y_LENGTHS) - SEG + 1, 1)).astype(np.int32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    rngs = {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1),
            "dropout": jax.random.PRNGKey(2)}
    jmpd = JaxMPD(periods=PERIODS)
    wav_seg = jnp.zeros((B, MODEL_KW["segment_size"], 1))
    params_d = random_params(jax.eval_shape(lambda: jmpd.init(rngs, wav_seg, wav_seg)["params"]),
                             rng)
    xa, ma, ga = jnp.asarray(x), jnp.asarray(mask), jnp.asarray(g)

    calls, params = {}, {}
    for t in TYPES:
        jlayer, _ = _layers(t)
        jblock, _ = _blocks(t)
        for name, mod in (("layer", jlayer), ("block", jblock)):
            params[t, name] = random_params(jax.eval_shape(lambda m=mod: m.init(
                jax.random.PRNGKey(0), xa, ma, g=ga)["params"]), rng)
            for reverse in (False, True):
                for with_g in (True, False):
                    calls[t, name, reverse, with_g] = (
                        lambda p, a, m, gg, _mod=mod, _r=reverse, _w=with_g: _mod.apply(
                            {"params": p}, a, m, g=gg if _w else None, reverse=_r),
                        (params[t, name], xa, ma, ga))
        jcfg, _ = _configs(t)
        jsynth = JaxSynth(n_vocab=N_VOCAB, spec_channels=N_MELS, segment_frames=SEG,
                          cfg=jcfg.model)
        params[t, "model"] = random_params(jax.eval_shape(lambda m=jsynth: m.init(
            rngs, jb["x"], jb["x_lengths"], jb["spec"], jb["spec_lengths"])["params"]), rng)
        calls[t, "infer"] = (lambda p, a, b, _m=jsynth: _m.apply(
            {"params": p}, a, b, noise_scale=0.667, max_frames=MAX_FRAMES,
            method=JaxSynth.infer, rngs={"noise": jax.random.PRNGKey(0)}),
            (params[t, "model"], jb["x"], jb["x_lengths"]))
        tx = _recording(jtrain.make_optimizer(jcfg, steps_per_epoch=1000))
        state = jtrain.TrainState(step=jnp.zeros((), jnp.int32), params_g=params[t, "model"],
                                  opt_g=tx.init(params[t, "model"]), params_d=params_d,
                                  opt_d=tx.init(params_d))
        calls[t, "step"] = (jtrain.make_train_step(jcfg, jsynth, jmpd, tx),
                            (state, jb, jax.random.PRNGKey(0)))

    table = {(B, T_Y, D): [eps], (B, T_Y, T_X): [mas], (B, MAX_FRAMES, D): [prior]}
    with ThreadPoolExecutor(8) as ex, patched_jax(table, u):
        pending = {k: (ex.submit(jax.jit(fn).lower(*args).compile), args)
                   for k, (fn, args) in calls.items()}
        out = {}
        for k, (fut, args) in pending.items():
            res = fut.result()(*args)
            out[k] = jax.tree.map(np.asarray, res[1] if k[1] == "step" else res)
    return dict(x=x, g=g, mask=mask, params=params, params_d=params_d, jax=out, batch=batch,
                prior=prior,
                port_noise=dict(eps=_tc(eps), mas_noise=_t(mas), ids_slice=_t(seg_ids)))


def _port(module, params, cfg=None):
    module.load_state_dict(state_dict_from_jax_params(params, cfg), strict=True)
    return _no_dropout(module).eval()


@pytest.mark.parametrize("t", TYPES)
def test_flow_type_layer_and_block_match_jax(refs, t):
    """The type's layer forward (with logdet) and reverse, and a FlowBlock
    of two steps both ways, with g and without."""
    x, mask, g = _tc(refs["x"]), _tc(refs["mask"]), _tc(refs["g"])
    for name, module in (("layer", _layers(t)[1]), ("block", _blocks(t)[1])):
        module = _port(module, refs["params"][t, name])
        for reverse in (False, True):
            for with_g in (True, False):
                want = refs["jax"][t, name, reverse, with_g]
                with torch.no_grad():
                    got = module(x, mask, g=g if with_g else None, reverse=reverse)
                if name == "layer" and not reverse:
                    np.testing.assert_allclose(got[1].numpy(), want[1], rtol=RTOL, atol=1e-4)
                    got, want = got[0], want[0]
                np.testing.assert_allclose(got.transpose(1, 2).numpy(), want, rtol=RTOL,
                                           atol=ATOL, err_msg=f"{name} reverse={reverse}")
        if name == "block" and t.startswith("mono_layer_"):
            kinds = [type(f).__name__ for f in module.flows]
            assert kinds == ["ResidualCouplingLayer", "Flip", "MonoTransformerFlowLayer"] * 2


@pytest.mark.parametrize("t", TYPES)
def test_flow_type_infer_matches_jax(refs, t):
    """`infer`, with the model's weights loaded by the converter under the
    JAX exporter's names (`flows.{3i}` / `flows.{3i + 2}` for the mono
    triplets, the `fft` flows' `enc`, `pre_conv2`'s `pre_transformer`)."""
    from torch_tts_tpu.models.vits2.convert import export_torch_state_dict

    jcfg, cfg = _configs(t)
    params = refs["params"][t, "model"]
    names = {k: tuple(v.shape) for k, v in state_dict_from_jax_params(params, jcfg.model).items()}
    want = export_torch_state_dict(params, jcfg.model)
    assert names == {k: tuple(v.shape) for k, v in want.items()}
    model = _port(model_module.SynthesizerTrn(N_VOCAB, N_MELS, cfg.model, SEG), params, jcfg.model)
    out = model.infer(torch.from_numpy(refs["batch"]["x"].astype(np.int64)),
                      torch.tensor(X_LENGTHS), noise_scale=0.667, max_frames=MAX_FRAMES,
                      prior_noise=_tc(refs["prior"]))
    _check_infer(out, refs["jax"][t, "infer"])


@pytest.mark.parametrize("t", TYPES)
def test_flow_type_ddp_step_loss_terms_match_jax(refs, t):
    jcfg, cfg = _configs(t)
    model = _port(model_module.SynthesizerTrn(N_VOCAB, N_MELS, cfg.model, SEG),
                  refs["params"][t, "model"], jcfg.model)
    mpd = MultiPeriodDiscriminator(periods=PERIODS)
    mpd.load_state_dict(mpd_state_dict_from_jax_params(refs["params_d"], PERIODS), strict=True)
    state = vits2_train.create_train_state(cfg, model.train(), mpd)
    metrics = vits2_train.train_step(cfg, state, _torch_batch(refs["batch"]), **refs["port_noise"])
    want = refs["jax"][t, "step"]
    assert metrics["nonfinite"] == 0.0 == float(want["nonfinite"]) and state.step == 1
    for k in LOSSES:
        np.testing.assert_allclose(metrics[k], float(want[k]), rtol=1e-4, err_msg=k)


def test_streaming_flow_decoder_refuses_every_transformer_flow_type():
    from torch_tts_tpu_torch.infer.streaming import StreamingFlowDecoder

    for t in ("pre_conv",) + TYPES:
        cfg = VITS2ModelConfig(**dict(TYPE_KW, transformer_flow_type=t))
        with torch.device("meta"):
            model = model_module.SynthesizerTrn(N_VOCAB, N_MELS, cfg, SEG)
        with pytest.raises(ValueError, match=t):
            StreamingFlowDecoder(model)
        StreamingFlowDecoder(model, allow_nonlocal_flow=True)
