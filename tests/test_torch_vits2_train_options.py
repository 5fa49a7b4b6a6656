"""VITS2 training options of the port (torch_tts_tpu_torch) against the JAX
package: the duration discriminators, the `lightning` step order,
grad_accum and the eval step.

The tiny LJSpeech-shaped config, weights, batch and noise of
tests/test_torch_vits2_train.py (deterministic duration predictor, dropout
off, noise injected by patching `jax.random.normal` / `uniform`), with one
pre_conv flow where that file has two (each flow adds about 4 s to each
JAX step's compile), loaded into both packages through the port's
converters with strict=True.

- Each duration discriminator's forward against the JAX module (rtol 1e-4,
  atol 1e-5).
- One whole step in the `lightning` order with `dur_disc_2`, and one `ddp`
  step with `dur_disc_1`, each from the same state as the jitted JAX step:
  every loss term, `loss/dur_disc` included, within rtol 1e-4; every G, D
  and duration-discriminator gradient tensor within 1e-3 of its JAX norm
  (plus 1e-6 of the global norm).
- grad_accum = 2 at the optimizer level against optax.MultiSteps(adamw)
  fed the same gradients through the JAX `_guarded_update` rule, 6
  micro-steps with a non-finite micro-batch off a window's boundary and
  one on it: parameters within 1e-6 after every micro-step, the update and
  schedule counts equal.
- The eval step against the jitted JAX `make_eval_step` (rtol 1e-4).
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_vits2_train import (AUDIO_KW, B, HOP, MODEL_KW, N_MELS, N_VOCAB, PERIODS, SEG, T_X,
                                    T_Y, X_LENGTHS, Y_LENGTHS, _check_grads, _recording, _t, _tc,
                                    _torch_batch, patched_jax, random_params)
from torch_tts_tpu.core.config import AudioConfig as JAudio
from torch_tts_tpu.core.config import VITS2Config as JConfig
from torch_tts_tpu.core.config import VITS2ModelConfig as JModelConfig
from torch_tts_tpu.core.config import VITS2TrainConfig as JTrainConfig
from torch_tts_tpu.models.vits2 import DurationDiscriminatorV1 as JaxDurV1
from torch_tts_tpu.models.vits2 import DurationDiscriminatorV2 as JaxDurV2
from torch_tts_tpu.models.vits2 import MultiPeriodDiscriminator as JaxMPD
from torch_tts_tpu.models.vits2 import SynthesizerTrn as JaxSynth
from torch_tts_tpu.train import vits2_train as jtrain
from torch_tts_tpu_torch.core.config import AudioConfig, VITS2Config, VITS2ModelConfig
from torch_tts_tpu_torch.core.config import VITS2TrainConfig
from torch_tts_tpu_torch.models.vits2.convert import (dur_disc_state_dict_from_jax_params,
                                                      mpd_state_dict_from_jax_params,
                                                      state_dict_from_jax_params)
from torch_tts_tpu_torch.models.vits2.discriminators import (MultiPeriodDiscriminator,
                                                             build_duration_discriminator)
from torch_tts_tpu_torch.models.vits2.model import SynthesizerTrn
from torch_tts_tpu_torch.ops.layers import Dropout
from torch_tts_tpu_torch.train import vits2_train

H = MODEL_KW["hidden_channels"]
JAX_DUR = {"dur_disc_1": JaxDurV1, "dur_disc_2": JaxDurV2}
LOSSES = ("loss/g/total", "loss/g/gen", "loss/g/fm", "loss/g/mel", "loss/g/dur", "loss/g/kl",
          "loss/d/total", "loss/dur_disc")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while this module runs: under pytest-xdist a thread
    per core in every worker oversubscribes the cores, which slowed the
    port's tests about twofold and took CPU from the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(step_order="ddp", kind="dur_disc_1", **train_kw):
    mkw = dict(MODEL_KW, use_sdp=False, flow_n_flows=1, use_duration_discriminator=True,
               duration_discriminator_type=kind)
    tkw = dict(step_order=step_order, **train_kw)
    return (JConfig(audio=JAudio(**AUDIO_KW), model=JModelConfig(**mkw),
                    train=JTrainConfig(**tkw)),
            VITS2Config(audio=AudioConfig(**AUDIO_KW), model=VITS2ModelConfig(**mkw),
                        train=VITS2TrainConfig(**tkw)))


def _dur_inputs(rng):
    hx = rng.standard_normal((B, T_X, H)).astype(np.float32)
    x_mask = (np.arange(T_X)[None, :, None] < np.array(X_LENGTHS)[:, None, None])
    x_mask = x_mask.astype(np.float32)
    dur_r, dur_hat = ((rng.standard_normal((B, T_X, 1)) * x_mask).astype(np.float32)
                      for _ in range(2))
    return hx, x_mask, dur_r, dur_hat


@pytest.fixture(scope="module")
def setup():
    """Random G, MPD and both duration discriminators' weights, a batch and
    the noise, as tests/test_torch_vits2_train.py draws them."""
    rng = np.random.default_rng(11)
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
    jmpd = JaxMPD(periods=PERIODS)
    wav_seg = jnp.zeros((B, MODEL_KW["segment_size"], 1))
    params_d = random_params(jax.eval_shape(lambda: jmpd.init(rngs, wav_seg, wav_seg)["params"]),
                             rng)
    jcfg, _ = _configs()
    jmodel = JaxSynth(n_vocab=N_VOCAB, spec_channels=N_MELS, segment_frames=SEG, cfg=jcfg.model)
    params_g = random_params(jax.eval_shape(lambda: jmodel.init(
        rngs, jb["x"], jb["x_lengths"], jb["spec"], jb["spec_lengths"])["params"]), rng)
    dummy = tuple(map(jnp.asarray, _dur_inputs(rng)))
    params_dur = {k: random_params(jax.eval_shape(lambda c=c: c(H).init(rngs, *dummy)["params"]),
                                   rng) for k, c in JAX_DUR.items()}
    D = MODEL_KW["inter_channels"]
    eps = rng.standard_normal((B, T_Y, D)).astype(np.float32)
    mas = rng.standard_normal((B, T_Y, T_X)).astype(np.float32)
    u = rng.uniform(size=B).astype(np.float32)
    ids = (u * np.maximum(np.asarray(Y_LENGTHS) - SEG + 1, 1)).astype(np.int32)
    return dict(batch=batch, jb=jb, jmpd=jmpd, jmodel=jmodel, params_g=params_g,
                params_d=params_d, params_dur=params_dur, u=u,
                table={(B, T_Y, D): [eps], (B, T_Y, T_X): [mas]},
                port_noise=dict(eps=_tc(eps), mas_noise=_t(mas), ids_slice=_t(ids)))


def _port_models(s, cfg, jcfg, kind):
    model = SynthesizerTrn(N_VOCAB, N_MELS, cfg.model, SEG)
    model.load_state_dict(state_dict_from_jax_params(s["params_g"], jcfg.model), strict=True)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0  # the flows' pre_transformer has the reference's fixed 0.1
    mpd = MultiPeriodDiscriminator(periods=PERIODS)
    mpd.load_state_dict(mpd_state_dict_from_jax_params(s["params_d"], PERIODS), strict=True)
    dd = build_duration_discriminator(kind, H)
    dd.load_state_dict(dur_disc_state_dict_from_jax_params(s["params_dur"][kind], kind),
                       strict=True)
    return model.train(), mpd, dd


@pytest.mark.parametrize("kind", ["dur_disc_1", "dur_disc_2"])
def test_duration_discriminator_forward_matches_jax(setup, kind):
    hx, x_mask, dur_r, dur_hat = _dur_inputs(np.random.default_rng(7))
    want = jax.jit(JAX_DUR[kind](H).apply)({"params": setup["params_dur"][kind]},
                                           *map(jnp.asarray, (hx, x_mask, dur_r, dur_hat)))
    dd = build_duration_discriminator(kind, H)
    dd.load_state_dict(dur_disc_state_dict_from_jax_params(setup["params_dur"][kind], kind),
                       strict=True)
    got = dd(*map(_tc, (hx, x_mask, dur_r, dur_hat)))
    assert len(got) == 2
    for a, b in zip(got, want):
        assert a.shape == b.shape == (B, T_X, 1)
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-4, atol=1e-5)
    x = _tc(hx).requires_grad_()
    dd(x, *map(_tc, (x_mask, dur_r, dur_hat)))[1].sum().backward()
    assert x.grad is None  # hx is detached inside, as the JAX stop_gradient


STEPS = (("lightning", "dur_disc_2"), ("ddp", "dur_disc_1"))


@pytest.fixture(scope="module")
def jax_runs(setup):
    """Both jitted JAX steps (each from the same state, with a recording
    optimizer that keeps the gradients) and the JAX eval step, each traced
    under the patched noise. Each compiles in a thread as soon as it is
    traced, beside the next one's trace (XLA compiles outside the GIL;
    these compiles are this file's largest cost)."""
    s = setup
    pending = {}
    with ThreadPoolExecutor(3) as ex:
        with patched_jax(s["table"], s["u"]):
            for order, kind in STEPS:
                jcfg, _ = _configs(order, kind)
                tx = _recording(jtrain.make_optimizer(jcfg, steps_per_epoch=1000))
                pd = s["params_dur"][kind]
                state = jtrain.TrainState(step=jnp.zeros((), jnp.int32), params_g=s["params_g"],
                                          opt_g=tx.init(s["params_g"]), params_d=s["params_d"],
                                          opt_d=tx.init(s["params_d"]), params_dur=pd,
                                          opt_dur=tx.init(pd))
                step = jtrain.make_train_step(jcfg, s["jmodel"], s["jmpd"], tx,
                                              dur_disc=JAX_DUR[kind](H))
                args = (state, s["jb"], jax.random.PRNGKey(0))
                pending[order, kind] = ex.submit(jax.jit(step).lower(*args).compile), args
            jcfg, _ = _configs()
            args = (s["params_g"], s["jb"], jax.random.PRNGKey(0))
            lowered = jax.jit(jtrain.make_eval_step(jcfg, s["jmodel"])).lower(*args)
            pending["eval"] = ex.submit(lowered.compile), args
        out = {}
        for key, (fn, args) in pending.items():
            res = fn.result()(*args)
            if key == "eval":
                out[key] = jax.tree.map(np.asarray, res)
            else:
                new, metrics = res
                out[key] = jax.tree.map(np.asarray, dict(
                    metrics=metrics, grads_g=new.opt_g[1], grads_d=new.opt_d[1],
                    grads_dur=new.opt_dur[1]))
    return out


@pytest.fixture(scope="module", params=STEPS, ids=["lightning-dur_disc_2", "ddp-dur_disc_1"])
def step_pair(setup, jax_runs, request):
    """The JAX step of `jax_runs` beside one port step from the same state."""
    s = setup
    order, kind = request.param
    jcfg, cfg = _configs(order, kind)
    model, mpd, dd = _port_models(s, cfg, jcfg, kind)
    pstate = vits2_train.create_train_state(cfg, model, mpd, dur_disc=dd)
    recorded = {}
    for name in ("g", "d", "dur"):
        opt = getattr(pstate, f"opt_{name}")

        def record(grads, apply=True, _name=name, _step=opt.step):
            recorded[_name] = [g.clone() for g in grads]
            return _step(grads, apply)
        opt.step = record
    metrics = vits2_train.train_step(cfg, pstate, _torch_batch(s["batch"]), **s["port_noise"])
    return dict(kind=kind, jcfg=jcfg, jax=jax_runs[order, kind], metrics=metrics, state=pstate,
                grads=recorded)


def test_option_step_loss_terms_match_jax(step_pair):
    jm, pm = step_pair["jax"]["metrics"], step_pair["metrics"]
    assert pm["nonfinite"] == 0.0 == float(jm["nonfinite"])
    assert step_pair["state"].step == 1
    assert set(pm) == {k for k in jm} | {"nonfinite"}
    for k in LOSSES:
        np.testing.assert_allclose(pm[k], float(jm[k]), rtol=1e-4, err_msg=k)
    for k in ("grad_norm_g", "grad_norm_d", "grad_norm_dur_disc"):
        np.testing.assert_allclose(pm[k], float(jm[k]), rtol=1e-3, err_msg=k)


def test_option_step_gradients_match_jax(step_pair):
    st, j, kind = step_pair["state"], step_pair["jax"], step_pair["kind"]
    _check_grads(step_pair["grads"]["g"],
                 state_dict_from_jax_params(j["grads_g"], step_pair["jcfg"].model),
                 st.opt_g.names)
    _check_grads(step_pair["grads"]["d"], mpd_state_dict_from_jax_params(j["grads_d"], PERIODS),
                 st.opt_d.names)
    _check_grads(step_pair["grads"]["dur"],
                 dur_disc_state_dict_from_jax_params(j["grads_dur"], kind), st.opt_dur.names)
    assert len(st.opt_dur.names) == (12 if kind == "dur_disc_1" else 20)


def test_grad_accum_matches_optax_multisteps():
    """k = 2 over 6 micro-steps; micro-step 2 (a window's first) has a
    non-finite loss, micro-step 5 (a window's last) a non-finite gradient."""
    rng = np.random.default_rng(5)
    shapes = {"a": (4, 3), "b": (7,)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(6)]
    grads[5]["b"][3] = np.inf
    losses = [1.0, 1.0, np.nan, 1.0, 1.0, 1.0]
    jcfg, cfg = _configs(grad_accum=2, lr_decay=0.5, learning_rate=0.01)
    tx = jtrain.make_optimizer(jcfg, steps_per_epoch=4)  # transition every 2 updates

    @jax.jit
    def guarded(loss, g, opt, p):  # the JAX `_guarded_update` rule
        ok = jnp.isfinite(loss) & jnp.isfinite(jtrain.global_norm(g))
        g = jax.tree.map(lambda x: jnp.where(ok, x, jnp.zeros_like(x)), g)
        upd, opt = tx.update(g, opt, p)
        upd = jax.tree.map(lambda u: u * ok.astype(u.dtype), upd)
        return optax.apply_updates(p, upd), opt

    jp, jopt = params, tx.init(params)
    tp = [torch.from_numpy(params[k].copy()) for k in shapes]
    t = cfg.train
    opt = vits2_train.AdamW(tp, t.learning_rate, t.betas, t.eps, t.lr_decay, 4 // 2, accum=2)
    for i, (loss, g) in enumerate(zip(losses, grads)):
        jp, jopt = guarded(jnp.float32(loss), g, jopt, jp)
        ok, _ = vits2_train._guarded_update(cfg, opt, torch.tensor(loss, dtype=torch.float32),
                                            [torch.from_numpy(g[k].copy()) for k in shapes])
        assert ok == (i not in (2, 5))
        for k, p in zip(shapes, tp):
            np.testing.assert_allclose(p.numpy(), np.asarray(jp[k]), rtol=0, atol=1e-6,
                                       err_msg=f"micro-step {i}: {k}")
        assert opt.mini_step == int(jopt.mini_step)
    assert opt.count == int(jopt.gradient_step) == int(jopt.inner_opt_state[2].count) == 3
    assert opt.lr() == pytest.approx(t.learning_rate * 0.5)
    assert not np.array_equal(np.asarray(jp["a"]), params["a"])


def test_eval_step_matches_jax(setup, jax_runs):
    s, want = setup, jax_runs["eval"]
    jcfg, cfg = _configs()
    model = _port_models(s, cfg, jcfg, "dur_disc_1")[0]
    before = [p.clone() for p in model.parameters()]
    got = vits2_train.eval_step(cfg, model, _torch_batch(s["batch"]),
                                eps=s["port_noise"]["eps"], ids_slice=s["port_noise"]["ids_slice"])
    assert set(got) == set(want) == {"eval/loss_mel", "eval/loss_kl", "eval/loss_dur"}
    for k in got:
        np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-4, err_msg=k)
    assert model.training and all(torch.equal(a, b) for a, b in zip(before, model.parameters()))


def test_unported_options_raise():
    for kw in (dict(use_native_loader=True), dict(use_mesh=True)):
        from torch_tts_tpu_torch.train.vits2_trainer import VITS2Trainer

        with pytest.raises(NotImplementedError):
            VITS2Trainer(_configs()[1], "/nonexistent", None, **kw)
    cfg = _configs()[1]
    with pytest.raises(NotImplementedError, match="bf16"):
        vits2_train.check_supported(dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, use_bf16=True)))
