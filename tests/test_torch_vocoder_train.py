"""Vocoder training (`train/vocoder_train.py`, `cli/vocoder_train.py`) and
`tacotron_infer --vocoder`: the port against the JAX package.

The tiny HiFi-GAN of tests/test_torch_vocoder.py and a two-period MPD
(periods 2 and 3 beside the scale discriminator, full width), numpy-seeded
flax parameters carried across by the port's converters; one batch of two
8-frame segments (256 samples at hop 32). The JAX step runs jitted with
each optimizer chained after a transformation that keeps the gradients in
its state, so the test reads JAX's gradients; both steps compile at once
in two threads.

Held, for the recon-only step (L1 mel x 45 + L1 wave) and the GAN step
(D, then G through the updated D), as the VITS2 step tests hold theirs:
every loss term within rtol 1e-4; every gradient tensor within 1e-3 of its
JAX norm (plus 1e-6 of the global norm); the port's AdamW (b1 0.8, b2
0.99, weight decay 0.01, smooth decay) fed JAX's gradients lands on JAX's
updated parameters within 1e-6. `make_mel_fn` within 1e-5 (the [0, 1]
domain). The smooth schedule against optax over three updates. The CLI on
a synthetic corpus (one clip at 16 kHz, resampled): two recon-only steps
(the full MPD's AdamW takes seconds a step on the CPU) with a checkpoint
and the artifact each, a resume for a third step, then the
Tacotron CLI with `--vocoder` on the artifact, and its refusal of an
artifact whose hop the config does not have.
"""

import dataclasses
import json
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import optax
import pytest
import torch
from scipy.io import wavfile

import jax
import jax.numpy as jnp

from test_torch_vits2_infer import random_params
from test_torch_vocoder import AUDIO, GEN_KWARGS, M, jax_generator_params
from torch_tts_tpu.audio.frontend import AudioFrontend as JaxFrontend
from torch_tts_tpu.core import config as jcfg
from torch_tts_tpu.models.vits2 import MultiPeriodDiscriminator as JaxMPD
from torch_tts_tpu.ops.hifigan import Generator as JaxGenerator
from torch_tts_tpu.train import vocoder_train as jtrain
from torch_tts_tpu_torch.audio.frontend import AudioFrontend
from torch_tts_tpu_torch.cli import tacotron_infer, vocoder_train as vcli
from torch_tts_tpu_torch.core import config as tcfg
from torch_tts_tpu_torch.infer import vocoder
from torch_tts_tpu_torch.models.tacotron import build_tacotron
from torch_tts_tpu_torch.models.vits2.convert import (generator_state_dict_from_jax_params,
                                                      mpd_state_dict_from_jax_params)
from torch_tts_tpu_torch.models.vits2.discriminators import MultiPeriodDiscriminator
from torch_tts_tpu_torch.train import vits2_train
from torch_tts_tpu_torch.train import vocoder_train as vt

PERIODS = (2, 3)
LR, DECAY = 2e-4, 0.999
SEG, HOP, BATCH = 8, 32, 2
SHIFT, SCALE = vocoder.REF_MEL_SHIFT, vocoder.REF_MEL_SCALE


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while this module runs: under pytest-xdist a thread
    per core in every worker oversubscribes the cores, which slowed the
    port's tests about twofold and took CPU from the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _recorder():
    """Passes the gradients on and keeps them as its state."""
    return optax.GradientTransformation(lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
                                        lambda g, s, p=None: (g, g))


def _jax_tx():
    sched = optax.exponential_decay(LR, 1000, DECAY)
    return optax.chain(_recorder(), optax.adamw(sched, b1=0.8, b2=0.99, weight_decay=0.01))


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(21)
    params_g = jax_generator_params(GEN_KWARGS, M, seed=8)
    mpd = JaxMPD(periods=PERIODS)
    y0 = jnp.zeros((1, SEG * HOP, 1))
    params_d = random_params(jax.eval_shape(lambda: mpd.init(
        {"params": jax.random.PRNGKey(1)}, y0, y0)["params"]), rng)
    wav = np.clip(0.3 * rng.standard_normal((BATCH, SEG * HOP)), -1, 1)
    batch = {"wav": wav.astype(np.float32), "mel": rng.random((BATCH, SEG, M)).astype(np.float32)}
    fe = JaxFrontend(jcfg.TacotronAudioConfig(**AUDIO))
    gen = JaxGenerator(**GEN_KWARGS)
    runs = {}

    def run(mode):
        gan = mode == "gan"
        tx_g, tx_d = _jax_tx(), _jax_tx() if gan else None
        state = jtrain.VocoderTrainState(
            step=jnp.zeros((), jnp.int32), params_g=params_g, opt_g=tx_g.init(params_g),
            params_d=params_d if gan else None, opt_d=tx_d.init(params_d) if gan else None)
        step = jtrain.make_vocoder_train_step(
            gen, jtrain.make_mel_fn(fe), tx_g, mpd=mpd if gan else None, tx_d=tx_d,
            mel_shift=SHIFT, mel_scale=SCALE, c_mel=45.0, c_wav=0.0 if gan else 1.0)
        new, metrics = jax.jit(step)(state, {k: jnp.asarray(v) for k, v in batch.items()})
        runs[mode] = dict(params_g=new.params_g, grads_g=new.opt_g[0],
                          params_d=new.params_d if gan else None,
                          grads_d=new.opt_d[0] if gan else None,
                          metrics={k: float(v) for k, v in metrics.items()})

    with ThreadPoolExecutor(2) as ex:
        list(ex.map(run, ("recon", "gan")))  # raises a thread's error
    return dict(params_g=params_g, params_d=params_d, batch=batch, jax=runs)


def _port_state(s, gan: bool):
    gen = vocoder.build_generator(GEN_KWARGS, M, fuse_mrf=False)
    gen.load_state_dict(generator_state_dict_from_jax_params(s["params_g"], (3,)), strict=True)
    state = vt.VocoderTrainState(0, gen, vt.make_optimizer(gen.named_parameters(), LR, DECAY))
    if gan:
        mpd = MultiPeriodDiscriminator(periods=PERIODS)
        mpd.load_state_dict(mpd_state_dict_from_jax_params(s["params_d"], PERIODS), strict=True)
        state.mpd, state.opt_d = mpd, vt.make_optimizer(mpd.named_parameters(), LR, DECAY)
    return state


@pytest.fixture(scope="module", params=["recon", "gan"])
def step_pair(request, setup):
    mode, s = request.param, setup
    state = _port_state(s, mode == "gan")
    recorded, params0 = {}, {}
    for key in ("opt_g", "opt_d"):
        opt = getattr(state, key)
        if opt is None:
            continue
        params0[key] = [p.detach().clone() for p in opt.params]

        def record(grads, apply=True, _key=key, _step=opt.step):
            recorded[_key] = [g.detach().clone() for g in grads]
            return _step(grads, apply)
        opt.step = record
    fe = AudioFrontend(tcfg.TacotronAudioConfig(**AUDIO), device="cpu")
    metrics = vt.vocoder_train_step(
        state, {k: torch.from_numpy(v) for k, v in s["batch"].items()}, vt.make_mel_fn(fe),
        mel_shift=SHIFT, mel_scale=SCALE, c_mel=45.0, c_wav=0.0 if mode == "gan" else 1.0)
    return dict(mode=mode, state=state, metrics=metrics, grads=recorded, params0=params0,
                jax=s["jax"][mode])


def _converted(tree, key):
    if key == "opt_g":
        return generator_state_dict_from_jax_params(tree, (3,))
    return mpd_state_dict_from_jax_params(tree, PERIODS)


def test_step_losses_match_jax(step_pair):
    pm, jm = step_pair["metrics"], step_pair["jax"]["metrics"]
    assert sorted(pm) == sorted(jm)
    assert ("loss/d/total" in pm) == (step_pair["mode"] == "gan") == ("loss/g/wav" not in pm)
    for k in jm:
        np.testing.assert_allclose(pm[k], jm[k], rtol=1e-4, err_msg=k)
    assert step_pair["state"].step == 1


def test_step_gradients_match_jax(step_pair):
    j = step_pair["jax"]
    for key, net in (("opt_g", "grads_g"), ("opt_d", "grads_d")):
        if key not in step_pair["grads"]:
            continue
        want_sd = _converted(j[net], key)
        names = getattr(step_pair["state"], key).names
        total = np.sqrt(sum(float(np.sum(np.square(want_sd[n].numpy()))) for n in names))
        assert total > 0
        for n, g in zip(names, step_pair["grads"][key]):
            want = want_sd[n].numpy()
            err = float(np.linalg.norm(g.numpy() - want))
            bound = 1e-3 * float(np.linalg.norm(want)) + 1e-6 * total
            assert err <= bound, f"{key} {n}: |g - g_jax| {err:.3e} > {bound:.3e}"


def test_adamw_on_jax_gradients_gives_jax_parameters(step_pair):
    j = step_pair["jax"]
    for key, net, par in (("opt_g", "grads_g", "params_g"), ("opt_d", "grads_d", "params_d")):
        if key not in step_pair["params0"]:
            continue
        names = getattr(step_pair["state"], key).names
        grads, new = _converted(j[net], key), _converted(j[par], key)
        params = [p.clone() for p in step_pair["params0"][key]]
        vt.make_optimizer(zip(names, params), LR, DECAY).step([grads[n] for n in names])
        for n, p in zip(names, params):
            np.testing.assert_allclose(p.numpy(), new[n].numpy(), rtol=0, atol=1e-6, err_msg=n)


def test_make_mel_fn_matches_jax(setup):
    wav = setup["batch"]["wav"]
    want = np.asarray(jax.jit(jtrain.make_mel_fn(JaxFrontend(jcfg.TacotronAudioConfig(**AUDIO))))(
        jnp.asarray(wav)))
    fe = AudioFrontend(tcfg.TacotronAudioConfig(**AUDIO), device="cpu")
    got = vt.make_mel_fn(fe)(torch.from_numpy(wav)).numpy()
    assert got.shape == want.shape == (BATCH, SEG + 1, M)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_smooth_schedule_matches_optax():
    rng = np.random.default_rng(2)
    p0 = rng.standard_normal(7).astype(np.float32)
    grads = [rng.standard_normal(7).astype(np.float32) for _ in range(3)]
    tx = optax.adamw(optax.exponential_decay(1e-2, 2, 0.5), b1=0.8, b2=0.99, weight_decay=0.01)
    p, st = jnp.asarray(p0), None
    st = tx.init(p)
    for g in grads:
        upd, st = tx.update(jnp.asarray(g), st, p)
        p = optax.apply_updates(p, upd)
    mine = torch.from_numpy(p0.copy())
    opt = vits2_train.AdamW([mine], 1e-2, (0.8, 0.99), 1e-8, 0.5, 2, staircase=False)
    for g in grads:
        opt.step([torch.from_numpy(g)])
    np.testing.assert_allclose(mine.numpy(), np.asarray(p), rtol=0, atol=1e-6)
    assert opt.lr() == pytest.approx(1e-2 * 0.5 ** 1.5)


def _taco_cfg(**audio):
    return tcfg.TacotronConfig(
        audio=tcfg.TacotronAudioConfig(**dict(AUDIO, **audio)), text=tcfg.TacotronTextConfig(),
        model=tcfg.TacotronModelConfig(dim_emb=16, dim_out=16, r=2, dim_pre=8, dim_att=16,
                                       dim_rnn=(16, 16), postnet_dim_hidden=16,
                                       postnet_num_layers=2))


def _write_cfg(cfg, path):
    path.write_text(json.dumps({k: dataclasses.asdict(getattr(cfg, k))
                                for k in ("audio", "text", "model")}))
    return str(path)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    d = tmp_path_factory.mktemp("vocoder")
    (d / "wavs").mkdir()
    rng = np.random.default_rng(3)
    for i, sr in enumerate((8000, 8000, 16000)):
        t = np.arange(int(0.4 * sr)) / sr
        w = 0.4 * np.sin(2 * np.pi * (150 + 40 * i) * t) + 0.02 * rng.standard_normal(t.size)
        wavfile.write(str(d / "wavs" / f"c{i}.wav"), sr, np.round(w * 32767).astype(np.int16))
    cfg_path = _write_cfg(_taco_cfg(), d / "taco.json")
    argv = [str(d / "wavs"), cfg_path, "--run-dir", str(d / "run"), "--batch-size", "2",
            "--seg-frames", "8", "--upsample-initial-channel", "32", "--log-interval", "1",
            "--ckpt-interval", "1", "--no-gan", "--device", "cpu"]
    first = vcli.main(argv + ["--steps", "2"])
    second = vcli.main(argv + ["--steps", "3"])
    return dict(dir=d, cfg_path=cfg_path, first=first, second=second)


def test_vocoder_cli_trains_checkpoints_and_resumes(trained):
    d, first, second = trained["dir"], trained["first"], trained["second"]
    assert first.step == 2 and second.step == 3 and second.mpd is None
    assert second.opt_g.count == 3
    assert sorted(p.name for p in (d / "run").iterdir()) == [
        "ckpt_1.pt", "ckpt_2.pt", "ckpt_3.pt", "vocoder.pt"]
    voc = vocoder.load_vocoder(str(d / "run" / "vocoder.pt"), device="cpu")
    assert voc.gen_kwargs["upsample_rates"] == (8, 4) == tuple(vcli.hop_rates(32))
    for k, v in second.model.state_dict().items():
        torch.testing.assert_close(voc.generator.state_dict()[k], v, rtol=0, atol=0)
    assert vcli.hop_rates(256) == [8, 8, 4] and vcli.hop_rates(300) == [5, 5, 4, 3]


def test_tacotron_infer_with_the_vocoder(trained, tmp_path):
    cfg = _taco_cfg()
    ckpt = tmp_path / "t.pth"
    torch.save({"model": build_tacotron(cfg, seed=1, device="cpu").state_dict()}, ckpt)
    art = str(trained["dir"] / "run" / "vocoder.pt")
    argv = ["hello there.", trained["cfg_path"], "-m", str(ckpt), "-o", str(tmp_path / "o.wav"),
            "--max-steps", "10", "--device", "cpu", "--vocoder", art]
    wav, mel = tacotron_infer.main(argv)
    assert wav.shape == (mel.shape[0] * HOP,) and np.isfinite(wav).all()
    want = vocoder.load_vocoder(art, device="cpu").synth(mel[None].numpy())[0]
    np.testing.assert_allclose(wav, want / np.abs(want).max() * 0.9, rtol=0, atol=1e-6)
    bad = _write_cfg(_taco_cfg(hop_length=64), tmp_path / "bad.json")
    with pytest.raises(SystemExit, match="hop"):
        tacotron_infer.main([argv[0], bad] + argv[2:])
