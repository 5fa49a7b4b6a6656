"""VITS2 training: the port (torch_tts_tpu_torch) against the JAX package.

A tiny LJSpeech-shaped config (mel posterior, noise-scaled MAS, pre_conv
flows, ResBlock1 decoder, a full-width period and scale discriminator; the
model and step tests use the deterministic duration predictor, because the
SDP doubles the JAX step's compile time, and the SDP's NLL has its own test),
random weights from a numpy seed loaded into both sides through the port's
converters with strict=True, the same batch, and the same noise: JAX draws
through `jax.random.normal` / `uniform`, patched to return numpy-seeded
arrays that the port receives as tensors. Dropout is off on both sides
(the JAX `Dropout` is patched to the identity, the port's modules get
p = 0); `test_dropout_*` covers the port's dropout itself.

- MPD outputs and feature maps (rtol 1e-4, atol 1e-4); the other modules
  (the spline forward with its logabsdet, the SDP NLL, the mel
  spectrogram of a waveform, each loss, segment slicing) in
  tests/test_torch_vits2_train_modules.py.
- `SynthesizerTrn.forward` against the JAX `__call__` (the step's first
  forward): all eight outputs, attn and the segment ids exactly.
- One whole `ddp` train step against the JAX `make_train_step` (jitted)
  from the same state: every loss term within rtol 1e-4; every G and D gradient
  tensor within 1e-3 of its JAX norm (plus 1e-6 of the global norm);
  the port's AdamW fed JAX's gradients gives JAX's updated parameters
  within 1e-6; a non-finite step leaves every parameter bit-identical.
"""

import contextlib
import dataclasses

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_tts_tpu.core.config import AudioConfig as JAudio
from torch_tts_tpu.core.config import VITS2Config as JConfig
from torch_tts_tpu.core.config import VITS2ModelConfig as JModelConfig
from torch_tts_tpu.models.vits2 import MultiPeriodDiscriminator as JaxMPD
from torch_tts_tpu.models.vits2 import SynthesizerTrn as JaxSynth
from torch_tts_tpu.ops import layers as jlayers
from torch_tts_tpu.train import vits2_train as jtrain
from torch_tts_tpu_torch.core.config import AudioConfig, VITS2Config, VITS2ModelConfig
from torch_tts_tpu_torch.models.vits2.convert import (mpd_state_dict_from_jax_params,
                                                      state_dict_from_jax_params)
from torch_tts_tpu_torch.models.vits2.discriminators import MultiPeriodDiscriminator
from torch_tts_tpu_torch.models.vits2.model import SynthesizerTrn
from torch_tts_tpu_torch.ops.layers import Dropout
from torch_tts_tpu_torch.train import vits2_train

RTOL, ATOL = 1e-4, 1e-5
N_VOCAB, B, T_X, T_Y, HOP, N_MELS = 20, 2, 10, 30, 8, 12
X_LENGTHS, Y_LENGTHS = (10, 7), (30, 22)
MODEL_KW = dict(
    inter_channels=8, hidden_channels=8, filter_channels=16, n_heads=2, n_layers=1,
    kernel_size=3, p_dropout=0.0, dp_dropout=0.0, resblock="1", resblock_kernel_sizes=(3,),
    resblock_dilation_sizes=((1, 3),), upsample_rates=(8,), upsample_initial_channel=16,
    upsample_kernel_sizes=(16,), use_sdp=True, use_noise_scaled_mas=True,
    use_mel_posterior_encoder=True, use_transformer_flows=True, transformer_flow_type="pre_conv",
    segment_size=8 * HOP, posterior_wn_layers=2, flow_n_flows=2,
)
AUDIO_KW = dict(sampling_rate=8000, filter_length=32, hop_length=HOP, win_length=32,
                n_mel_channels=N_MELS)
SEG = MODEL_KW["segment_size"] // HOP
PERIODS = (2,)  # of the default (2, 3, 5, 7, 11): one code path; all five in test_mpd_names_*


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
    def fill(path, s):
        name = path[-1].key
        n = rng.standard_normal(s.shape)
        if name in ("scale", "g"):
            return (1 + 0.1 * n).astype(np.float32)
        if name in ("kernel", "v"):
            return (n / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        return (0.2 * n).astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, shapes)


@contextlib.contextmanager
def patched_jax(normal_table, uniform):
    """jax.random.normal cycles through normal_table[shape] (several draws
    of one shape come out in call order); uniform of uniform's shape returns
    it; the JAX Dropout is the identity."""
    orig = jax.random.normal, jax.random.uniform, jlayers.Dropout.__call__
    counts = {}

    def normal(key, shape=(), dtype=jnp.float32):
        draws = normal_table[tuple(shape)]
        i = counts.get(tuple(shape), 0)
        counts[tuple(shape)] = i + 1
        return jnp.asarray(draws[i % len(draws)], dtype)

    def uniform_(key, shape=(), dtype=jnp.float32, *a, **k):
        if tuple(shape) == uniform.shape:  # the segment starts
            return jnp.asarray(uniform, dtype)
        return orig[1](key, shape, dtype, *a, **k)  # parameter initialisers

    jax.random.normal = normal
    jax.random.uniform = uniform_
    jlayers.Dropout.__call__ = lambda self, x, deterministic, rng=None: x
    try:
        yield
    finally:
        jax.random.normal, jax.random.uniform, jlayers.Dropout.__call__ = orig


def _t(a):
    return torch.from_numpy(np.array(a))


def _tc(a):
    """JAX channels-last [B, T, C] -> port [B, C, T] tensor."""
    return _t(a).transpose(1, 2)


def _recording(tx):
    """optax transform whose state also keeps the gradients it was given."""
    def init(params):
        return tx.init(params), jax.tree.map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        upd, inner = tx.update(grads, state[0], params)
        return upd, (inner, grads)
    return optax.GradientTransformation(init, update)


def _configs(use_sdp):
    kw = dict(MODEL_KW, use_sdp=use_sdp)
    return (JConfig(audio=JAudio(**AUDIO_KW), model=JModelConfig(**kw)),
            VITS2Config(audio=AudioConfig(**AUDIO_KW), model=VITS2ModelConfig(**kw)))


@pytest.fixture(scope="module")
def setup():
    """Random G (with the deterministic duration predictor: the SDP doubles
    the JAX step's compile time, and test_sdp_nll_matches_jax holds it to
    JAX's on its own) and MPD weights, a batch and noise; one jitted JAX
    `ddp` step, whose first generator forward comes back beside it."""
    rng = np.random.default_rng(11)
    jmpd = JaxMPD(periods=PERIODS)
    batch = {
        "x": rng.integers(1, N_VOCAB, (B, T_X)).astype(np.int32),
        "x_lengths": np.asarray(X_LENGTHS, np.int32),
        "spec": rng.standard_normal((B, T_Y, N_MELS)).astype(np.float32),
        "spec_lengths": np.asarray(Y_LENGTHS, np.int32),
        "wav": (rng.standard_normal((B, T_Y * HOP, 1)) * 0.1).astype(np.float32),
    }
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    rngs = {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1),
            "dropout": jax.random.PRNGKey(2)}
    wav_seg = jnp.zeros((B, MODEL_KW["segment_size"], 1))
    params_d = random_params(jax.eval_shape(lambda: jmpd.init(rngs, wav_seg, wav_seg)["params"]),
                             rng)
    jcfg, cfg = _configs(use_sdp=False)
    jmodel = JaxSynth(n_vocab=N_VOCAB, spec_channels=N_MELS, segment_frames=SEG, cfg=jcfg.model)
    shapes = jax.eval_shape(lambda: jmodel.init(rngs, jb["x"], jb["x_lengths"], jb["spec"],
                                                jb["spec_lengths"])["params"])
    params_g = random_params(shapes, rng)

    D = MODEL_KW["inter_channels"]
    noise = {"eps": rng.standard_normal((B, T_Y, D)), "mas": rng.standard_normal((B, T_Y, T_X)),
             "e_q": rng.standard_normal((B, T_X, 2)), "sdp": rng.standard_normal((B, T_X, 2))}
    noise = {k: v.astype(np.float32) for k, v in noise.items()}
    u = rng.uniform(size=B).astype(np.float32)
    table = {(B, T_Y, D): [noise["eps"]], (B, T_Y, T_X): [noise["mas"]],
             (B, T_X, 2): [noise["e_q"], noise["sdp"]]}
    ids_max = np.maximum(np.asarray(Y_LENGTHS) - SEG + 1, 1).astype(np.float32)
    ids = (u * ids_max).astype(np.int32)
    port_noise = dict(eps=_tc(noise["eps"]), mas_noise=_t(noise["mas"]),
                      sdp_noise_q=_tc(noise["e_q"]), sdp_noise=_tc(noise["sdp"]),
                      ids_slice=_t(ids))

    def port_models():
        model = SynthesizerTrn(N_VOCAB, N_MELS, cfg.model, SEG)
        model.load_state_dict(state_dict_from_jax_params(params_g, jcfg.model), strict=True)
        for m in model.modules():
            if isinstance(m, Dropout):
                m.p = 0.0  # the flows' pre_transformer has the reference's fixed 0.1
        mpd = MultiPeriodDiscriminator(periods=PERIODS)
        mpd.load_state_dict(mpd_state_dict_from_jax_params(params_d, PERIODS), strict=True)
        return model.train(), mpd

    # one jitted JAX step; its first generator forward (the D step's, outside
    # any gradient transform) is returned beside the step's results
    tx = _recording(jtrain.make_optimizer(jcfg, steps_per_epoch=1000))
    state = jtrain.TrainState(step=jnp.zeros((), jnp.int32), params_g=params_g,
                              opt_g=tx.init(params_g), params_d=params_d,
                              opt_d=tx.init(params_d))

    class FirstForward:
        def __init__(self):
            self.out = []

        def apply(self, *args, **kw):
            self.out.append(jmodel.apply(*args, **kw))
            return self.out[-1]

    def step_and_forward(state, batch, key):
        first = FirstForward()
        result = jtrain.make_train_step(jcfg, first, jmpd, tx)(state, batch, key)
        return first.out[0], result

    with patched_jax(table, u):
        fwd, (new_state, metrics) = jax.jit(step_and_forward)(state, jb, jax.random.PRNGKey(0))
    step = jax.tree.map(np.asarray, dict(metrics=metrics, params_g=new_state.params_g,
                                         params_d=new_state.params_d,
                                         grads_g=new_state.opt_g[1], grads_d=new_state.opt_d[1]))
    return dict(cfg=cfg, jcfg=jcfg, fwd=jax.tree.map(np.asarray, fwd), jmpd=jmpd, batch=batch,
                params_d=params_d, ids=ids, port_noise=port_noise, port_models=port_models,
                step=step)


def _torch_batch(batch):
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32 else v)
            for k, v in batch.items()}


def _close(a, b, atol=ATOL, rtol=RTOL, **kw):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol, **kw)


# ---------------------------------------------------------------- modules


def test_mpd_outputs_and_feature_maps_match_jax(setup):
    s = setup
    _, mpd = s["port_models"]()
    rng = np.random.default_rng(3)
    # 71 samples: the period discriminator pads by reflection
    y, y_hat = ((rng.standard_normal((B, 71, 1)) * 0.3).astype(np.float32) for _ in range(2))
    want = jax.jit(s["jmpd"].apply)({"params": s["params_d"]}, jnp.asarray(y), jnp.asarray(y_hat))
    with torch.no_grad():
        got = mpd(_tc(y), _tc(y_hat))
    for outs_g, outs_w in zip(got[:2], want[:2]):
        for a, b in zip(outs_g, outs_w):
            _close(a.numpy(), b, atol=1e-4)
    for fms_g, fms_w in zip(got[2:], want[2:]):
        for fm_g, fm_w in zip(fms_g, fms_w):
            for a, b in zip(fm_g, fm_w):  # torch [B, C, ...] vs JAX [B, ..., C]
                _close(np.moveaxis(a.numpy(), 1, -1), b, atol=1e-4)


# ---------------------------------------------------------------- training forward


def test_training_forward_matches_jax(setup):
    """Against the JAX step's own first generator forward."""
    s = setup
    model, _ = s["port_models"]()
    b = _torch_batch(s["batch"])
    with torch.no_grad():
        got = model(b["x"], b["x_lengths"], b["spec"], b["spec_lengths"],
                    mas_noise_scale=0.01, **s["port_noise"])
    want = s["fwd"]
    o, l_length, attn, ids, x_mask, y_mask, latents, dur = got
    np.testing.assert_array_equal(attn.numpy(), want[2])
    np.testing.assert_array_equal(ids.numpy(), want[3])
    np.testing.assert_array_equal(ids.numpy(), s["ids"])
    np.testing.assert_array_equal(x_mask.numpy(), want[4])
    np.testing.assert_array_equal(y_mask.numpy(), want[5])
    _close(o.numpy(), want[0], atol=1e-4)
    _close(l_length.numpy(), want[1], atol=1e-4)
    for a, w in zip(latents, want[6]):
        _close(a.numpy(), w)
    for a, w in zip(dur, want[7]):
        _close(a.numpy(), w)
    assert attn.sum() > 0 and (attn.sum(2) <= 1).all()


# ---------------------------------------------------------------- whole train step


@pytest.fixture(scope="module")
def step_pair(setup):
    """The JAX step of `setup` beside one port step from the same state."""
    s = setup
    model, mpd = s["port_models"]()
    cfg = s["cfg"]
    pstate = vits2_train.create_train_state(cfg, model, mpd)
    recorded = {}
    for name, opt in (("g", pstate.opt_g), ("d", pstate.opt_d)):
        def record(grads, apply=True, _opt=opt, _name=name, _step=opt.step):
            recorded[_name] = [g.clone() for g in grads]
            return _step(grads, apply)
        opt.step = record
    params0 = {"g": [p.detach().clone() for p in pstate.opt_g.params],
               "d": [p.detach().clone() for p in pstate.opt_d.params]}
    metrics = vits2_train.train_step(cfg, pstate, _torch_batch(s["batch"]),
                                     **s["port_noise"])
    return dict(jax=s["step"], metrics=metrics, state=pstate, grads=recorded, params0=params0)


def test_train_step_loss_terms_match_jax(step_pair):
    jm, pm = step_pair["jax"]["metrics"], step_pair["metrics"]
    assert pm["nonfinite"] == 0.0 == float(jm["nonfinite"])
    assert step_pair["state"].step == 1
    for k in ("loss/g/total", "loss/g/gen", "loss/g/fm", "loss/g/mel", "loss/g/dur",
              "loss/g/kl", "loss/d/total"):
        np.testing.assert_allclose(pm[k], float(jm[k]), rtol=1e-4, err_msg=k)
    for k in ("grad_norm_g", "grad_norm_d"):
        np.testing.assert_allclose(pm[k], float(jm[k]), rtol=1e-3, err_msg=k)


def _check_grads(port, jax_sd, names):
    total = np.sqrt(sum(float(np.sum(np.square(jax_sd[n].numpy()))) for n in names))
    assert total > 0
    for n, g in zip(names, port):
        want = jax_sd[n].numpy()
        err = float(np.linalg.norm(g.numpy() - want))
        bound = 1e-3 * float(np.linalg.norm(want)) + 1e-6 * total
        assert err <= bound, f"{n}: |g - g_jax| {err:.3e} > {bound:.3e}"


def test_train_step_gradients_match_jax(step_pair, setup):
    s = setup
    model, mpd = step_pair["state"].model, step_pair["state"].mpd
    names_g = [n for n, _ in model.named_parameters() if ".post_transformer." not in n]
    names_d = [n for n, _ in mpd.named_parameters()]
    _check_grads(step_pair["grads"]["g"],
                 state_dict_from_jax_params(step_pair["jax"]["grads_g"], s["jcfg"].model),
                 names_g)
    _check_grads(step_pair["grads"]["d"],
                 mpd_state_dict_from_jax_params(step_pair["jax"]["grads_d"], PERIODS), names_d)


def test_adamw_matches_optax_on_the_same_gradients(step_pair, setup):
    """The port's AdamW, fed JAX's gradients from the same parameters, lands
    on JAX's updated parameters."""
    s, j = setup, step_pair["jax"]
    model, mpd = step_pair["state"].model, step_pair["state"].mpd
    for key, names, grads_sd, new_sd in (
            ("g", [n for n, _ in model.named_parameters() if ".post_transformer." not in n],
             state_dict_from_jax_params(j["grads_g"], s["jcfg"].model),
             state_dict_from_jax_params(j["params_g"], s["jcfg"].model)),
            ("d", [n for n, _ in mpd.named_parameters()],
             mpd_state_dict_from_jax_params(j["grads_d"], PERIODS),
             mpd_state_dict_from_jax_params(j["params_d"], PERIODS))):
        params = [p.clone() for p in step_pair["params0"][key]]
        t = s["cfg"].train
        opt = vits2_train.AdamW(params, t.learning_rate, t.betas, t.eps, t.lr_decay, 1000)
        opt.step([grads_sd[n] for n in names])
        for n, p in zip(names, params):
            np.testing.assert_allclose(p.numpy(), new_sd[n].numpy(), rtol=0, atol=1e-6,
                                       err_msg=n)


def test_nonfinite_step_keeps_parameters_bit_identical(setup):
    s = setup
    model, mpd = s["port_models"]()
    cfg = s["cfg"]
    state = vits2_train.create_train_state(cfg, model, mpd)
    batch = _torch_batch(s["batch"])
    batch["wav"][0] = float("nan")  # both losses: D sees the real slice, G's fm too
    before = [p.detach().clone() for p in list(model.parameters()) + list(mpd.parameters())]
    metrics = vits2_train.train_step(cfg, state, batch, **s["port_noise"])
    assert metrics["nonfinite"] == 1.0 and state.step == 0
    assert state.opt_g.count == 1 and state.opt_d.count == 1
    after = list(model.parameters()) + list(mpd.parameters())
    assert all(torch.equal(a, b) for a, b in zip(before, after))


def test_deferred_options_raise():
    """Spectral norm is not ported; the step orders, grad_accum, the
    duration discriminators (tests/test_torch_vits2_train_options.py),
    multi-speaker training (tests/test_torch_vits2_multispeaker_train.py)
    and bf16 (tests/test_torch_vits2_bf16_train.py) are."""
    cfg = _configs(True)[1]
    c = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, use_spectral_norm=True))
    with pytest.raises(NotImplementedError):
        vits2_train.check_supported(c)
    for train_kw, model_kw in ((dict(step_order="lightning"), {}), (dict(grad_accum=2), {}),
                               (dict(use_bf16=True), {}),
                               ({}, dict(use_duration_discriminator=True)),
                               ({}, dict(n_speakers=4, gin_channels=8))):
        vits2_train.check_supported(dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, **train_kw),
            model=dataclasses.replace(cfg.model, **model_kw)))
    with pytest.raises(NotImplementedError, match="spectral norm"):
        MultiPeriodDiscriminator(use_spectral_norm=True)
