"""Multi-speaker VITS2 training: the port (torch_tts_tpu_torch) against the
JAX package.

The tiny config of tests/test_torch_vits2_train.py made multi-speaker
(4 speakers, gin_channels 8, the speaker-conditioned text encoder with
three layers so that its conditioning before layer 2 runs, one pre_conv
flow, the deterministic duration predictor), random weights from a numpy
seed carried across by the port's converters with strict=True, the same
batch with two speaker ids, and the same noise (`jax.random.normal` /
`uniform` patched to numpy-seeded arrays, the JAX Dropout the identity).
The jitted JAX `ddp` and `lightning` steps and the JAX eval step compile
in threads as soon as each is traced.

- One whole step in each order from the same state: every loss term
  within rtol 1e-4; every G and D gradient tensor within 1e-3 of its JAX
  norm (plus 1e-6 of the global norm); the speaker parameters (`emb_g`,
  `spk_emb_linear`, `dec.cond`, `dp.cond` and every WN `cond_layer`)
  among them with non-zero gradients.
- The eval step with the batch's speakers against the JAX
  `make_eval_step` (rtol 1e-4).
- The shipped multi-speaker config builds and passes `check_supported`,
  and chip_smoke.py's dataclass copy of it equals it.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_vits2_train import (AUDIO_KW, B, HOP, MODEL_KW, N_MELS, N_VOCAB, PERIODS, SEG, T_X,
                                    T_Y, X_LENGTHS, Y_LENGTHS, _check_grads, _recording, _t, _tc,
                                    _torch_batch, patched_jax, random_params)
from torch_tts_tpu.core.config import AudioConfig as JAudio
from torch_tts_tpu.core.config import VITS2Config as JConfig
from torch_tts_tpu.core.config import VITS2ModelConfig as JModelConfig
from torch_tts_tpu.core.config import VITS2TrainConfig as JTrainConfig
from torch_tts_tpu.models.vits2 import MultiPeriodDiscriminator as JaxMPD
from torch_tts_tpu.models.vits2 import SynthesizerTrn as JaxSynth
from torch_tts_tpu.train import vits2_train as jtrain
from torch_tts_tpu_torch.core.config import AudioConfig, VITS2Config, VITS2ModelConfig
from torch_tts_tpu_torch.core.config import VITS2TrainConfig, load_vits2_config
from torch_tts_tpu_torch.models.vits2.convert import (mpd_state_dict_from_jax_params,
                                                      state_dict_from_jax_params)
from torch_tts_tpu_torch.models.vits2.discriminators import MultiPeriodDiscriminator
from torch_tts_tpu_torch.models.vits2.model import SynthesizerTrn
from torch_tts_tpu_torch.ops.layers import Dropout
from torch_tts_tpu_torch.train import vits2_train

SPEAKERS, G = 4, 8
SIDS = (3, 1)
MS_KW = dict(MODEL_KW, use_sdp=False, flow_n_flows=1, n_layers=3, n_speakers=SPEAKERS,
             gin_channels=G, use_spk_conditioned_encoder=True)
ORDERS = ("ddp", "lightning")
LOSSES = ("loss/g/total", "loss/g/gen", "loss/g/fm", "loss/g/mel", "loss/g/dur", "loss/g/kl",
          "loss/d/total")
SPEAKER_PARAMS = ("emb_g.weight", "enc_p.encoder.spk_emb_linear.weight", "dec.cond.weight",
                  "dp.cond.weight", "enc_q.enc.cond_layer.weight_v",
                  "flow.flows.0.enc.cond_layer.weight_v")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while this module runs: under pytest-xdist a thread
    per core in every worker oversubscribes the cores, which slowed the
    port's tests about twofold and took CPU from the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(step_order="ddp"):
    return (JConfig(audio=JAudio(**AUDIO_KW), model=JModelConfig(**MS_KW),
                    train=JTrainConfig(step_order=step_order)),
            VITS2Config(audio=AudioConfig(**AUDIO_KW), model=VITS2ModelConfig(**MS_KW),
                        train=VITS2TrainConfig(step_order=step_order)))


@pytest.fixture(scope="module")
def setup():
    """Random G and MPD weights, a batch with two speakers and the noise;
    both jitted JAX steps (with a recording optimizer that keeps the
    gradients) and the JAX eval step, each compiled in a thread as soon as
    it is traced under the patched noise."""
    rng = np.random.default_rng(17)
    batch = {
        "x": rng.integers(1, N_VOCAB, (B, T_X)).astype(np.int32),
        "x_lengths": np.asarray(X_LENGTHS, np.int32),
        "spec": rng.standard_normal((B, T_Y, N_MELS)).astype(np.float32),
        "spec_lengths": np.asarray(Y_LENGTHS, np.int32),
        "wav": (rng.standard_normal((B, T_Y * HOP, 1)) * 0.1).astype(np.float32),
        "sid": np.asarray(SIDS, np.int32),
    }
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    rngs = {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1),
            "dropout": jax.random.PRNGKey(2)}
    jmpd = JaxMPD(periods=PERIODS)
    wav_seg = jnp.zeros((B, MODEL_KW["segment_size"], 1))
    params_d = random_params(jax.eval_shape(lambda: jmpd.init(rngs, wav_seg, wav_seg)["params"]),
                             rng)
    jcfg, _ = _configs()
    jmodel = JaxSynth(n_vocab=N_VOCAB, spec_channels=N_MELS, segment_frames=SEG, cfg=jcfg.model)
    params_g = random_params(jax.eval_shape(lambda: jmodel.init(
        rngs, jb["x"], jb["x_lengths"], jb["spec"], jb["spec_lengths"], sid=jb["sid"])["params"]),
        rng)
    D = MODEL_KW["inter_channels"]
    eps = rng.standard_normal((B, T_Y, D)).astype(np.float32)
    mas = rng.standard_normal((B, T_Y, T_X)).astype(np.float32)
    u = rng.uniform(size=B).astype(np.float32)
    ids = (u * np.maximum(np.asarray(Y_LENGTHS) - SEG + 1, 1)).astype(np.int32)
    table = {(B, T_Y, D): [eps], (B, T_Y, T_X): [mas]}

    pending = {}
    with ThreadPoolExecutor(len(ORDERS) + 1) as ex:
        with patched_jax(table, u):
            for order in ORDERS:
                jc, _ = _configs(order)
                tx = _recording(jtrain.make_optimizer(jc, steps_per_epoch=1000))
                state = jtrain.TrainState(step=jnp.zeros((), jnp.int32), params_g=params_g,
                                          opt_g=tx.init(params_g), params_d=params_d,
                                          opt_d=tx.init(params_d))
                args = (state, jb, jax.random.PRNGKey(0))
                step = jtrain.make_train_step(jc, jmodel, jmpd, tx)
                pending[order] = ex.submit(jax.jit(step).lower(*args).compile), args
            args = (params_g, jb, jax.random.PRNGKey(0))
            lowered = jax.jit(jtrain.make_eval_step(jcfg, jmodel)).lower(*args)
            pending["eval"] = ex.submit(lowered.compile), args
        jax_runs = {}
        for key, (fut, args) in pending.items():
            res = fut.result()(*args)
            if key == "eval":
                jax_runs[key] = jax.tree.map(np.asarray, res)
            else:
                new, metrics = res
                jax_runs[key] = jax.tree.map(np.asarray, dict(
                    metrics=metrics, grads_g=new.opt_g[1], grads_d=new.opt_d[1]))
    return dict(batch=batch, jcfg=jcfg, params_g=params_g, params_d=params_d, jax=jax_runs,
                port_noise=dict(eps=_tc(eps), mas_noise=_t(mas), ids_slice=_t(ids)))


def _port_models(s, cfg):
    model = SynthesizerTrn(N_VOCAB, N_MELS, cfg.model, SEG)
    model.load_state_dict(state_dict_from_jax_params(s["params_g"], s["jcfg"].model), strict=True)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0  # the flows' pre_transformer has the reference's fixed 0.1
    mpd = MultiPeriodDiscriminator(periods=PERIODS)
    mpd.load_state_dict(mpd_state_dict_from_jax_params(s["params_d"], PERIODS), strict=True)
    return model.train(), mpd


@pytest.fixture(scope="module", params=ORDERS)
def step_pair(setup, request):
    """The JAX step of `setup` in one order beside one port step from the
    same state."""
    s, order = setup, request.param
    _, cfg = _configs(order)
    pstate = vits2_train.create_train_state(cfg, *_port_models(s, cfg))
    recorded = {}
    for name in ("g", "d"):
        opt = getattr(pstate, f"opt_{name}")

        def record(grads, apply=True, _name=name, _step=opt.step):
            recorded[_name] = [g.clone() for g in grads]
            return _step(grads, apply)
        opt.step = record
    metrics = vits2_train.train_step(cfg, pstate, _torch_batch(s["batch"]), **s["port_noise"])
    return dict(jax=s["jax"][order], metrics=metrics, state=pstate, grads=recorded)


def test_multispeaker_step_loss_terms_match_jax(step_pair):
    jm, pm = step_pair["jax"]["metrics"], step_pair["metrics"]
    assert pm["nonfinite"] == 0.0 == float(jm["nonfinite"])
    assert step_pair["state"].step == 1
    for k in LOSSES:
        np.testing.assert_allclose(pm[k], float(jm[k]), rtol=1e-4, err_msg=k)
    for k in ("grad_norm_g", "grad_norm_d"):
        np.testing.assert_allclose(pm[k], float(jm[k]), rtol=1e-3, err_msg=k)


def test_multispeaker_step_gradients_match_jax(step_pair, setup):
    st, j = step_pair["state"], step_pair["jax"]
    names = st.opt_g.names
    _check_grads(step_pair["grads"]["g"],
                 state_dict_from_jax_params(j["grads_g"], setup["jcfg"].model), names)
    _check_grads(step_pair["grads"]["d"], mpd_state_dict_from_jax_params(j["grads_d"], PERIODS),
                 st.opt_d.names)
    grads = dict(zip(names, step_pair["grads"]["g"]))
    for n in SPEAKER_PARAMS:
        assert float(grads[n].abs().max()) > 0, n
    # only the two speakers of the batch have an embedding gradient
    used = grads["emb_g.weight"].abs().sum(1) > 0
    assert used.tolist() == [i in SIDS for i in range(SPEAKERS)]


def test_multispeaker_eval_step_matches_jax(setup):
    s, want = setup, setup["jax"]["eval"]
    _, cfg = _configs()
    model = _port_models(s, cfg)[0]
    got = vits2_train.eval_step(cfg, model, _torch_batch(s["batch"]),
                                eps=s["port_noise"]["eps"], ids_slice=s["port_noise"]["ids_slice"])
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-4, err_msg=k)
    # another speaker gives another loss: the sids reached the model
    other = dict(_torch_batch(s["batch"]), sid=torch.tensor([0, 2]))
    moved = vits2_train.eval_step(cfg, model, other, eps=s["port_noise"]["eps"],
                                  ids_slice=s["port_noise"]["ids_slice"])
    assert moved["eval/loss_mel"] != got["eval/loss_mel"]


def test_shipped_multispeaker_config_builds_and_is_supported():
    """configs/vits2-multispeaker.yaml: no raise in `check_supported` or the
    model's constructor (built on the meta device: no memory, no init); and
    chip_smoke.py's copy of it (the card has no PyYAML) equals it."""
    import importlib.util
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1]
    cfg = load_vits2_config(str(root / "configs" / "vits2-multispeaker.yaml"))
    assert cfg.model.n_speakers == 109 and cfg.model.gin_channels == 256
    spec = importlib.util.spec_from_file_location("chip_smoke", root / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert chip_smoke.multispeaker_config() == cfg
    vits2_train.check_supported(cfg)
    with torch.device("meta"):
        model = SynthesizerTrn(100, cfg.posterior_channels, cfg.model, cfg.segment_frames)
    assert model.emb_g.weight.shape == (109, 256)
    assert model.enc_p.encoder.spk_emb_linear.weight.shape == (192, 256)
    assert model.dec.cond.weight.shape == (512, 256, 1)
    assert model.enc_q.enc.cond_layer.weight_v.shape == (2 * 192 * 16, 256, 1)
    # bf16 training is ported (tests/test_torch_vits2_bf16_configs.py runs it multi-speaker)
    vits2_train.check_supported(dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, use_bf16=True)))
