"""Tacotron-2 inference: the port (torch_tts_tpu_torch) against the JAX package.

A small Taco2Prod config (dim_emb = dim_out = 32, dim_rnn = (48, 32),
dim_pre = 16, postnet 32 x 3, 20 mel bins), r = 1 and r = 2. Weights and
batch statistics come from a numpy seed (the statistics far from 0 and 1,
the stop bias at the -2 threshold, so stop lengths differ per item); one
JAX init per r, shared by the module's tests, converted with the port's
converter and loaded with strict=True. The PreNet's dropout masks of the
JAX decoder (keys fold_in(fold_in(dropout_key, t), j), j = 1, 2) are
replayed with jax.random.bernoulli and handed to the port.

Tolerances: per module fp32 rtol 1e-4 / atol 1e-5; whole inference on a
ragged B=3 batch: y, y_post and the attention w within 1e-4, stop lengths
equal; Griffin-Lim (two FFT libraries, 4 iterations) within 1e-4 of the
waveform's peak.
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

from torch_tts_tpu.audio.frontend import AudioFrontend as JaxFrontend
from torch_tts_tpu.core import config as jcfg
from torch_tts_tpu.kernels.taco_step import weights_from_cell_params
from torch_tts_tpu.models.tacotron import build_tacotron as jax_build
from torch_tts_tpu.models.tacotron.convert import export_torch_state_dict
from torch_tts_tpu.models.tacotron.model import Tacotron as JaxTacotron
from torch_tts_tpu.ops import rnn as jrnn
from torch_tts_tpu.ops import tacotron_attention as jatt
from torch_tts_tpu.ops import tacotron_blocks as jblocks
from torch_tts_tpu_torch.audio.frontend import AudioFrontend, m_rev
from torch_tts_tpu_torch.cli import tacotron_infer
from torch_tts_tpu_torch.core import config as tcfg
from torch_tts_tpu_torch.kernels.taco_step import weights_from_state_dict
from torch_tts_tpu_torch.models.tacotron import build_tacotron
from torch_tts_tpu_torch.models.tacotron.convert import state_dict_from_jax_params
from torch_tts_tpu_torch.models.tacotron.model import Tacotron
from torch_tts_tpu_torch.ops import rnn as trnn
from torch_tts_tpu_torch.ops import tacotron_attention as tatt
from torch_tts_tpu_torch.ops import tacotron_blocks as tblocks

RTOL, ATOL, MODEL_ATOL = 1e-4, 1e-5, 1e-4
ALPHABET = "#abcdefghijklmnopqrstuvwxyz .,"
STEPS = 20
B, L_TEXT, LENGTHS = 3, 11, (11, 8, 5)


def _cfgs(pkg, r):
    return pkg.TacotronConfig(
        audio=pkg.TacotronAudioConfig(num_mels=20, win_length=256, hop_length=64),
        text=pkg.TacotronTextConfig(alphabet=ALPHABET),
        model=pkg.TacotronModelConfig(dim_emb=32, dim_out=32, r=r, dim_pre=16, dim_att=16,
                                      dim_rnn=(48, 32), postnet_dim_hidden=32, postnet_num_layers=3))


def _fill(tree, rng, stats=False):
    def fill(path, x):
        name = path[-1].key
        n = rng.standard_normal(x.shape)
        if stats:
            return (0.3 * n if name == "mean" else 0.5 + rng.random(x.shape)).astype(np.float32)
        if name == "scale":
            return (1 + 0.1 * n).astype(np.float32)
        if name in ("kernel", "w_ih", "w_hh", "embedding"):
            return (n / np.sqrt(x.shape[0] if x.ndim == 2 else np.prod(x.shape[:-1]))).astype(np.float32)
        return (0.2 * n).astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, tree)


def _ids(rng):
    ids = rng.integers(1, len(ALPHABET) + 1, (B, L_TEXT))
    for b, n in enumerate(LENGTHS):
        ids[b, n:] = 0
    return ids


@pytest.fixture(scope="module", params=[1, 2], ids=["r1", "r2"])
def pair(request):
    """(JAX model, its variables, the port model on the CPU, ids, lengths, r)."""
    r = request.param
    rng = np.random.default_rng(10 + r)
    jm = jax_build(_cfgs(jcfg, r))
    ids = _ids(rng)
    x_dummy = jnp.zeros((B, 2 * r, 20))
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2)}, jnp.asarray(ids), jnp.asarray(LENGTHS), x_dummy,
        train=True, deterministic=False))
    params = _fill(shapes["params"], rng)
    params["decoder"]["fc_stop"]["bias"] = np.full((r,), -2.0, np.float32)
    variables = {"params": params, "batch_stats": _fill(shapes["batch_stats"], rng, stats=True)}
    tm = Tacotron(_cfgs(tcfg, r), 1 + len(ALPHABET))
    sd = state_dict_from_jax_params(variables["params"], variables["batch_stats"], _cfgs(tcfg, r))
    tm.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, strict=True)
    return jm, variables, tm.eval(), ids, np.asarray(LENGTHS), r


def _np(x):
    return np.asarray(x, np.float32)


def test_converter_matches_export_torch_state_dict(pair):
    jm, variables, tm, *_ , r = pair
    ours = state_dict_from_jax_params(variables["params"], variables["batch_stats"], _cfgs(tcfg, r))
    theirs = export_torch_state_dict(variables["params"], variables["batch_stats"], _cfgs(jcfg, r))
    assert sorted(ours) == sorted(theirs) == sorted(tm.state_dict())
    for k in theirs:
        np.testing.assert_array_equal(np.asarray(ours[k]), np.asarray(theirs[k]), err_msg=k)


def test_step_weights_match_weights_from_cell_params(pair):
    _, variables, tm, *_ = pair
    p = variables["params"]["decoder"]
    want = weights_from_cell_params(p["cell"], p)
    got = weights_from_state_dict(tm.state_dict())
    for name, a, b in zip(want._fields, got, want):
        np.testing.assert_allclose(a.numpy(), _np(b), rtol=0, atol=1e-7, err_msg=name)


def test_encoder_matches_flax(pair):
    jm, variables, tm, ids, lengths, _ = pair
    want, _ = jax.jit(lambda v, c, cl: jm.apply(v, c, cl, method=JaxTacotron.encode))(
        variables, jnp.asarray(ids), jnp.asarray(lengths))
    with torch.no_grad():
        got = tm.encoder(torch.from_numpy(ids), torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=RTOL, atol=ATOL)


def test_postnet_matches_flax(pair):
    jm, variables, tm, *_ = pair
    y = np.random.default_rng(3).standard_normal((2, 17, 20)).astype(np.float32)
    want = jax.jit(lambda v, y: jm.apply(v, y, method=JaxTacotron.apply_postnet))(variables, jnp.asarray(y))
    with torch.no_grad():
        got = tm.postnet(torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=RTOL, atol=ATOL)


def replay_prenet_masks(key, steps, B, P):
    """The JAX decoder's PreNet keep masks, [steps, 2, B, P]."""
    def per_step(kt):
        return jnp.stack([jax.random.bernoulli(jax.random.fold_in(kt, j), 0.5, (B, P)) for j in (1, 2)])
    keys = jax.vmap(lambda t: jax.random.fold_in(key, t))(jnp.arange(steps))
    return np.array(jax.jit(jax.vmap(per_step))(keys))


def test_inference_matches_jax(pair):
    jm, variables, tm, ids, lengths, r = pair
    kd = jax.random.PRNGKey(7)
    y, y_post, s, aux = jax.jit(lambda v, c, cl: jm.apply(v, c, cl, max_steps=STEPS, dropout_key=kd))(
        variables, jnp.asarray(ids), jnp.asarray(lengths))
    masks = torch.from_numpy(replay_prenet_masks(kd, STEPS, B, 16))
    gy, gyp, gs, gaux = tm.infer(torch.from_numpy(ids), torch.from_numpy(lengths), max_steps=STEPS,
                                 prenet_masks=masks)
    assert gy.shape == (B, STEPS * r, 20) and gaux["w"].shape == (B, STEPS, L_TEXT)
    for name, a, b in (("y", gy, y), ("y_post", gyp, y_post), ("s", gs, s), ("w", gaux["w"], aux["w"])):
        np.testing.assert_allclose(a.numpy(), _np(b), rtol=MODEL_ATOL, atol=MODEL_ATOL, err_msg=name)
    want_stop = np.asarray(aux["stop_lengths"])
    np.testing.assert_array_equal(gaux["stop_lengths"].numpy(), want_stop)
    assert len(set(want_stop.tolist())) > 1  # the items stop at different steps
    # the JAX model lets attention move into the padding (its cmask is unused)
    assert float(gaux["w"][2, :, LENGTHS[2]:].sum()) > 0


def test_step_inputs_replace_the_previous_frame(pair):
    """Feeding each step the frame the free-running decode gave it
    reproduces the free-running decode."""
    *_, tm, ids, lengths, r = pair
    masks = torch.from_numpy(replay_prenet_masks(jax.random.PRNGKey(1), STEPS, B, 16))
    x, xl = torch.from_numpy(ids), torch.from_numpy(lengths)
    y, *_ = tm.infer(x, xl, max_steps=STEPS, prenet_masks=masks)
    prev = torch.cat([torch.zeros(B, 1, 20), y.reshape(B, STEPS, r, 20)[:, :-1, -1]], 1)
    y2, *_ = tm.infer(x, xl, max_steps=STEPS, prenet_masks=masks, step_inputs=prev)
    torch.testing.assert_close(y2, y, rtol=0, atol=0)


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
    with pytest.raises(NotImplementedError):
        model(torch.zeros(1, 3, dtype=torch.int64), torch.tensor([3]))
    with pytest.raises(NotImplementedError):
        model.decode_chunk()
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
    for flag in ("--vocoder", "--ref", "--plot"):
        with pytest.raises(SystemExit, match="not ported"):
            tacotron_infer.main(argv + [flag, "x"])
