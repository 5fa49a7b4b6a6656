"""Tacotron-2 (Taco2Prod) inference of the port, module by module against
the JAX package: the LSTM zoneout cell, the packed BiLSTM and
reverse_padded on ragged lengths, the attention and the PreNet, mel_inv
and Griffin-Lim, the config loader, the variants that are not ported
(training is ported, tests/test_torch_tacotron_train*.py; `decode_chunk`,
tests/test_torch_taco_chunk.py),
and the CLI on the CPU (`--vocoder`: tests/test_torch_vocoder_train.py;
the whole model: tests/test_torch_tacotron.py, whose helpers these tests
share).
"""

import dataclasses
import json
import unittest.mock as mock
import wave

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_tacotron import ATOL, RTOL, _cfgs, _np
from torch_tts_tpu.audio.frontend import AudioFrontend as JaxFrontend
from torch_tts_tpu.core import config as jcfg
from torch_tts_tpu.ops import rnn as jrnn
from torch_tts_tpu.ops import tacotron_attention as jatt
from torch_tts_tpu.ops import tacotron_blocks as jblocks
from torch_tts_tpu_torch.audio.frontend import AudioFrontend, m_rev
from torch_tts_tpu_torch.cli import tacotron_infer
from torch_tts_tpu_torch.core import config as tcfg
from torch_tts_tpu_torch.models.tacotron import build_tacotron
from torch_tts_tpu_torch.ops import rnn as trnn
from torch_tts_tpu_torch.ops import tacotron_attention as tatt
from torch_tts_tpu_torch.ops import tacotron_blocks as tblocks


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while this module runs: under pytest-xdist a thread
    per core in every worker oversubscribes the cores, which slowed the
    port's tests about twofold and took CPU from the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lstm_params(rng, I, H, bias=True):
    p = {"w_ih": rng.standard_normal((I, 4 * H)).astype(np.float32) * 0.3,
         "w_hh": rng.standard_normal((H, 4 * H)).astype(np.float32) * 0.3}
    if bias:
        p["b_ih"] = rng.standard_normal(4 * H).astype(np.float32) * 0.1
        p["b_hh"] = rng.standard_normal(4 * H).astype(np.float32) * 0.1
    return p


def _load_cell(cell, p):
    with torch.no_grad():
        cell.weight_ih.copy_(torch.from_numpy(p["w_ih"].T))
        cell.weight_hh.copy_(torch.from_numpy(p["w_hh"].T))
        cell.bias_ih.copy_(torch.from_numpy(p["b_ih"]))
        cell.bias_hh.copy_(torch.from_numpy(p["b_hh"]))
    return cell


def test_lstm_zoneout_cell_matches_flax():
    rng = np.random.default_rng(0)
    I, H = 7, 9
    p = _lstm_params(rng, I, H)
    x, h, c = (rng.standard_normal(s).astype(np.float32) for s in ((3, I), (3, H), (3, H)))
    (jh, jc), _ = jrnn.LSTMZoneoutCell(H, p_zoneout=0.1).apply(
        {"params": {"cell": p}}, (jnp.asarray(h), jnp.asarray(c)), jnp.asarray(x), True)
    cell = _load_cell(trnn.LSTMZoneoutCell(I, H, 0.1), p)
    with torch.no_grad():
        th, tc = cell((torch.from_numpy(h), torch.from_numpy(c)), torch.from_numpy(x))
    np.testing.assert_allclose(th.numpy(), _np(jh), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tc.numpy(), _np(jc), rtol=RTOL, atol=ATOL)


def test_bilstm_and_reverse_padded_match_flax_on_ragged_lengths():
    rng = np.random.default_rng(1)
    Bb, T, I, H = 3, 9, 5, 6
    x = rng.standard_normal((Bb, T, I)).astype(np.float32)
    lengths = np.array([9, 4, 6])
    h0, c0 = (rng.standard_normal((Bb, 2 * H)).astype(np.float32) for _ in range(2))
    pf, pb = _lstm_params(rng, I, H, bias=False), _lstm_params(rng, I, H, bias=False)
    ys, _ = jrnn.BiLSTM(H, use_bias=False).apply(
        {"params": {"fwd": {"cell": pf}, "bwd": {"cell": pb}}}, jnp.asarray(x), jnp.asarray(lengths),
        jnp.asarray(h0), jnp.asarray(c0))
    mod = trnn.BiLSTM(I, H, bias=False)
    with torch.no_grad():
        for p, sfx in ((pf, ""), (pb, "_reverse")):
            getattr(mod.rnn, f"weight_ih_l0{sfx}").copy_(torch.from_numpy(p["w_ih"].T))
            getattr(mod.rnn, f"weight_hh_l0{sfx}").copy_(torch.from_numpy(p["w_hh"].T))
        got, _ = mod(torch.from_numpy(x), torch.from_numpy(lengths), torch.from_numpy(h0),
                     torch.from_numpy(c0))
    np.testing.assert_allclose(got.numpy(), _np(ys), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(
        trnn.reverse_padded(torch.from_numpy(x), torch.from_numpy(lengths)).numpy(),
        _np(jrnn.reverse_padded(jnp.asarray(x), jnp.asarray(lengths))))


def test_attention_and_prenet_match_flax():
    rng = np.random.default_rng(2)
    Bb, L, D, Din = 3, 10, 8, 12
    memory = rng.standard_normal((Bb, L, D)).astype(np.float32)
    w = rng.random((Bb, L)).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    x = rng.standard_normal((Bb, Din)).astype(np.float32)
    qk = rng.standard_normal((Din, D)).astype(np.float32) * 0.4
    want = jatt.StepwiseMonotonicAttention(D).apply(
        {"params": {"query_layer": {"kernel": qk}}}, jnp.asarray(x), jnp.asarray(w), jnp.asarray(memory))
    att = tatt.StepwiseMonotonicAttention(Din, D)
    with torch.no_grad():
        att.query_layer.weight.copy_(torch.from_numpy(qk.T))
        got = att(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(memory))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.sum(1).numpy(), 1.0, rtol=1e-5)

    P = 6
    pp = {"fc1": {"kernel": rng.standard_normal((Din, P)).astype(np.float32), "bias": np.zeros(P, np.float32) + 0.1},
          "fc2": {"kernel": rng.standard_normal((P, P)).astype(np.float32), "bias": np.zeros(P, np.float32) - 0.1}}
    key = jax.random.PRNGKey(3)
    want = jblocks.PreNet(P, dim_hidden=P, always_dropout=True).apply(
        {"params": pp}, jnp.asarray(x), True, rng=key)
    masks = [torch.from_numpy(np.array(jax.random.bernoulli(jax.random.fold_in(key, j), 0.5, (Bb, P))))
             for j in (1, 2)]
    pre = tblocks.PreNet(Din, P, dim_hidden=P)
    with torch.no_grad():
        for layer, name in zip(pre.layers, ("fc1", "fc2")):
            layer.weight.copy_(torch.from_numpy(pp[name]["kernel"].T))
            layer.bias.copy_(torch.from_numpy(pp[name]["bias"]))
        got = pre(torch.from_numpy(x), masks)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=RTOL, atol=ATOL)


def test_mel_inv_and_griffin_lim_match_jax():
    cfg_j, cfg_t = _cfgs(jcfg, 1).audio, _cfgs(tcfg, 1).audio
    rng = np.random.default_rng(4)
    mel_net = rng.random((30, 20)).astype(np.float32) * 0.6 + 0.2
    fj, ft = JaxFrontend(cfg_j), AudioFrontend(cfg_t, device="cpu")
    d_db = jax.jit(fj.mel_inv)(jnp.asarray(mel_net) * 100.0 - 100.0)
    got_db = ft.mel_inv(m_rev(torch.from_numpy(mel_net)))
    np.testing.assert_allclose(got_db.numpy(), _np(d_db), rtol=RTOL, atol=1e-3)  # dB
    phases = rng.random(d_db.shape).astype(np.float32) * (2 * np.pi)
    with mock.patch.object(jax.random, "uniform", lambda *a, **k: jnp.asarray(phases)):
        want = _np(jax.jit(lambda d: fj.decode(d, n_iter=4))(d_db))
    got = ft.decode(torch.from_numpy(np.array(d_db, np.float32)), n_iter=4, phases=torch.from_numpy(phases)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_config_loader_matches_jax(tmp_path):
    path = "configs/tacotron-ljspeech.yaml"
    assert dataclasses.asdict(tcfg.load_tacotron_config(path)) == dataclasses.asdict(
        jcfg.load_tacotron_config(path))
    cfg = _cfgs(tcfg, 2)
    p = tmp_path / "c.json"
    p.write_text(json.dumps({k: dataclasses.asdict(getattr(cfg, k)) for k in ("audio", "text", "model")}))
    assert tcfg.load_tacotron_config(str(p)) == cfg


def test_unported_variants_raise():
    base = tcfg.TacotronConfig()
    for upd in (dict(decoder_type="tacotron2"), dict(encoder_type="tacotron1"), dict(style_dim_vae=4),
                dict(postnet_type="tacotron1")):
        cfg = dataclasses.replace(base, model=dataclasses.replace(base.model, **upd))
        with pytest.raises(NotImplementedError):
            build_tacotron(cfg, device="cpu")
    tiny = _cfgs(tcfg, 1)
    model = build_tacotron(tiny, device="cpu")
    with pytest.raises(ValueError, match="draws or a generator"):
        model(torch.zeros(1, 3, dtype=torch.int64), torch.tensor([3]))
    with pytest.raises(ValueError, match="generator"):
        model.infer(torch.ones(1, 3, dtype=torch.int64), torch.tensor([3]), max_steps=2)


def test_cli_writes_wav_on_cpu(tmp_path):
    cfg = _cfgs(tcfg, 2)
    model = build_tacotron(cfg, seed=0, device="cpu")
    ckpt, cfg_path, out = tmp_path / "t.pth", tmp_path / "c.json", tmp_path / "o.wav"
    torch.save({"model": model.state_dict()}, ckpt)
    cfg_path.write_text(json.dumps({k: dataclasses.asdict(getattr(cfg, k)) for k in ("audio", "text", "model")}))
    argv = ["hello there.", str(cfg_path), "-m", str(ckpt), "-o", str(out), "--max-steps", "12",
            "--griffin-lim-iters", "2", "--device", "cpu"]
    wav, mel = tacotron_infer.main(argv)
    assert mel.shape[0] % 2 == 0 and 2 <= mel.shape[0] <= 24 and np.isfinite(wav).all()
    with wave.open(str(out)) as f:
        assert (f.getnchannels(), f.getsampwidth(), f.getframerate()) == (1, 2, cfg.audio.sample_rate)
        assert f.getnframes() == wav.size
    for flag in ("--ref", "--plot"):
        with pytest.raises(SystemExit, match="not ported"):
            tacotron_infer.main(argv + [flag, "x"])
