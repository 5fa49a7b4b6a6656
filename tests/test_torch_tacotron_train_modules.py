"""Tacotron training, module by module: the port against the JAX package.

BatchNorm on batch statistics (output, gradients and the running update
against flax's, affine and not); the zoneout cell and the stepwise
monotonic attention in training mode, given the draws JAX made (recorded
by `recorded` of tests/test_torch_tacotron_train.py), the attention's
gradient included; `Encoder2` and `MelPostnet` in training mode with
their dropout (the tiny config of that file); every loss function of
`models/tacotron/losses.py`, each mel loss order masked and not, and the
gradients of `tacotron_loss`.

Tolerances: fp32 rtol 1e-4 / atol 1e-5 (losses and their gradients
rtol 1e-5); running statistics atol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_tacotron_modules import _load_cell, _lstm_params
from test_torch_tacotron_train import (jax_variables, make_batch, port_model, recorded,
                                       tiny_cfg, torch_batch)
from torch_tts_tpu.core import config as jcfg
from torch_tts_tpu.models.tacotron import losses as jlosses
from torch_tts_tpu.models.tacotron.model import Tacotron as JaxTacotron
from torch_tts_tpu.ops import rnn as jrnn
from torch_tts_tpu.ops import tacotron_attention as jatt
from torch_tts_tpu.ops import tacotron_blocks as jblocks
from torch_tts_tpu_torch.core import config as tcfg
from torch_tts_tpu_torch.models.tacotron import losses as tlosses
from torch_tts_tpu_torch.models.tacotron.convert import state_dict_from_jax_params
from torch_tts_tpu_torch.ops import rnn as trnn
from torch_tts_tpu_torch.ops import tacotron_attention as tatt
from torch_tts_tpu_torch.ops import tacotron_blocks as tblocks

RTOL, ATOL, STATS_ATOL, LOSS_RTOL = 1e-4, 1e-5, 1e-5, 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=RTOL, atol=ATOL, err_msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=err_msg)


@pytest.mark.parametrize("affine", [True, False], ids=["affine", "no_affine"])
def test_batchnorm_batch_statistics_match_flax(affine):
    """Output, the gradients of a weighted sum (to x, scale and bias) and the
    running update 0.9 * running + 0.1 * batch (biased variance), over
    batch x time, padding frames included."""
    rng = np.random.default_rng(0)
    C = 6
    x = (rng.standard_normal((3, 7, C)) * 2 + 1).astype(np.float32)
    r = rng.standard_normal(x.shape).astype(np.float32)
    stats = {"mean": (0.3 * rng.standard_normal(C)).astype(np.float32),
             "var": (0.5 + rng.random(C)).astype(np.float32)}
    params = {"scale": (1 + 0.1 * rng.standard_normal(C)).astype(np.float32),
              "bias": (0.2 * rng.standard_normal(C)).astype(np.float32)} if affine else {}
    bn = jblocks.BatchNorm(use_scale=affine, use_bias=affine)

    def f(p, x):
        y, mut = bn.apply({"params": {"BatchNorm_0": p}, "batch_stats": {"BatchNorm_0": stats}},
                          x, use_running_average=False, mutable=["batch_stats"])
        return jnp.sum(y * r), (y, mut["batch_stats"]["BatchNorm_0"])

    (_, (y, new)), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(params, x)
    mod = tblocks.BatchNorm(C, affine=affine)
    with torch.no_grad():
        mod.running_mean.copy_(_t(stats["mean"]))
        mod.running_var.copy_(_t(stats["var"]))
        if affine:
            mod.weight.copy_(_t(params["scale"]))
            mod.bias.copy_(_t(params["bias"]))
    xt = _t(x).requires_grad_(True)
    got = mod(xt, batch_stats=True)
    (got * _t(r)).sum().backward()
    _close(got, y)
    _close(xt.grad, gx)
    if affine:
        _close(mod.weight.grad, gp["scale"])
        _close(mod.bias.grad, gp["bias"])
    _close(mod.running_mean, new["mean"], rtol=0, atol=STATS_ATOL)
    _close(mod.running_var, new["var"], rtol=0, atol=STATS_ATOL)
    assert int(mod.num_batches_tracked) == 1


def test_zoneout_cell_training_masks_match_flax():
    """deterministic=False: the previous h or c where JAX's uniform((H,)) < p
    (one mask for h, one for c, shared over the batch)."""
    rng = np.random.default_rng(1)
    I, H, p_z = 7, 64, 0.3
    p = _lstm_params(rng, I, H)
    x, h, c = (rng.standard_normal(s).astype(np.float32) for s in ((3, I), (3, H), (3, H)))
    cell = jrnn.LSTMZoneoutCell(H, p_zoneout=p_z)
    with recorded() as record:
        fn = jax.jit(lambda k: cell.apply({"params": {"cell": p}}, (h, c), x, False,
                                          rngs={"dropout": k})[0])
        jh, jc = fn(jax.random.PRNGKey(4))
        jax.effects_barrier()
    masks = torch.stack([_t(v) < np.float32(p_z) for _, v in record])
    assert [n for n, _ in record] == ["uniform", "uniform"] and masks.shape == (2, H)
    assert 0 < int(masks.sum()) < 2 * H
    tcell = _load_cell(trnn.LSTMZoneoutCell(I, H, p_z), p)
    with torch.no_grad():
        th, tc = tcell((_t(h), _t(c)), _t(x), masks)
    _close(th, jh)
    _close(tc, jc)
    assert torch.equal(th[:, masks[0]], _t(h)[:, masks[0]])


def test_attention_sigmoid_noise_and_gradient_match_flax():
    """deterministic=False adds 1.0 * JAX's normal draws to the energies;
    the gradients through the sink position's write match jax.grad."""
    rng = np.random.default_rng(2)
    Bb, L, D, Din = 3, 10, 8, 12
    memory = rng.standard_normal((Bb, L, D)).astype(np.float32)
    w = rng.random((Bb, L)).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    x = rng.standard_normal((Bb, Din)).astype(np.float32)
    qk = (rng.standard_normal((Din, D)) * 0.4).astype(np.float32)
    r = rng.standard_normal((Bb, L)).astype(np.float32)
    att = jatt.StepwiseMonotonicAttention(D)

    def f(qk, x, memory):
        out = att.apply({"params": {"query_layer": {"kernel": qk}}}, x, w, memory,
                        deterministic=False, rngs={"noise": jax.random.PRNGKey(5)})
        return jnp.sum(out * r), out

    with recorded() as record:
        fn = jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True))
        (_, want), grads = fn(qk, x, memory)
        jax.effects_barrier()
    assert [n for n, _ in record] == ["normal"]
    tat = tatt.StepwiseMonotonicAttention(Din, D)
    with torch.no_grad():
        tat.query_layer.weight.copy_(_t(qk.T))
    xt, mt = _t(x).requires_grad_(True), _t(memory).requires_grad_(True)
    got = tat(xt, _t(w), mt, noise=_t(record[0][1]))
    (got * _t(r)).sum().backward()
    _close(got, want)
    _close(tat.query_layer.weight.grad, grads[0].T)
    _close(xt.grad, grads[1])
    _close(mt.grad, grads[2])
    with torch.no_grad():
        plain = tat(_t(x), _t(w), _t(memory))
    assert float((plain - got.detach()).abs().max()) > 1e-3  # the noise moved the weights


@pytest.fixture(scope="module")
def tiny():
    rng = np.random.default_rng(3)
    batch = make_batch(rng)
    jm, variables = jax_variables(tiny_cfg(jcfg), batch, rng)
    return jm, variables, batch


def _stats_close(model, prefix, new_stats, variables):
    stats = jax.tree.map(np.asarray, {**variables["batch_stats"], **new_stats})
    want = state_dict_from_jax_params(variables["params"], stats, tiny_cfg(tcfg))
    names = [k for k in want if k.startswith(prefix) and k.endswith(("running_mean",
                                                                     "running_var"))]
    assert names
    sd = model.state_dict()
    for k in names:
        _close(sd[k], want[k], rtol=0, atol=STATS_ATOL, err_msg=k)


def test_encoder2_training_mode_matches_flax(tiny):
    """train=True, deterministic=False: BN batch statistics, then Dropout(0.1)
    over [B, T, 2 dim_emb] (JAX's mask) before the BiLSTM."""
    jm, variables, batch = tiny
    with recorded() as record:
        fn = jax.jit(lambda v, c, cl: jm.apply(
            v, c, cl, method=lambda m, c, cl: m.encoder(c, cl, train=True, deterministic=False),
            mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(6)}))
        want, mut = fn(variables, batch["c"], batch["c_lengths"])
        jax.effects_barrier()
    assert [(n, v.shape) for n, v in record] == [("bernoulli", (3, 11, 32))]
    model = port_model(variables)
    b = torch_batch(batch)
    got = model.encoder(b["c"], b["c_lengths"], batch_stats=True, dropout_mask=_t(record[0][1]))
    _close(got, want)
    _stats_close(model, "encoder.", mut["batch_stats"], variables)


def test_mel_postnet_training_mode_matches_flax(tiny):
    """train=True, deterministic=False: BN batch statistics and Dropout(0.1)
    after each ISRU, a mask a layer."""
    jm, variables, _ = tiny
    y = np.random.default_rng(4).standard_normal((2, 17, 20)).astype(np.float32)
    with recorded() as record:
        fn = jax.jit(lambda v, y: jm.apply(
            v, y, method=lambda m, y: m.postnet(y, train=True, deterministic=False),
            mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(7)}))
        want, mut = fn(variables, y)
        jax.effects_barrier()
    assert [(n, v.shape) for n, v in record] == [("bernoulli", (2, 17, 16))] * 2
    model = port_model(variables)
    got = model.postnet(_t(y), batch_stats=True, dropout_masks=[_t(v) for _, v in record])
    _close(got, want)
    _stats_close(model, "postnet.", mut["batch_stats"], variables)
    with torch.no_grad():  # eval: no dropout, running statistics
        ev = port_model(variables).postnet(_t(y))
    _close(ev, jm.apply(variables, y, method=JaxTacotron.apply_postnet))


def _loss_inputs(rng):
    B, T, D = 3, 9, 5
    y = rng.random((B, T, D)).astype(np.float32)
    x = rng.random((B, T + 2, D)).astype(np.float32)  # longer than y, as the loss allows
    xmask = np.arange(T + 2)[None, :] < np.array([11, 7, 4])[:, None]
    w = rng.random((B, 4, 6)).astype(np.float32)
    w /= w.sum(-1, keepdims=True)
    s = rng.standard_normal((B, T, 1)).astype(np.float32) * 3
    return y, x, xmask, w, s


@pytest.mark.parametrize("order", [0, 1, 2])
def test_mel_loss_fn_matches_jax(order):
    """Each order, masked and not; order 0's volume is a constant for the
    gradient (stop_gradient in JAX, detach here)."""
    y, x, xmask, *_ = _loss_inputs(np.random.default_rng(5))
    x = x[:, : y.shape[1]]
    m = xmask[:, : y.shape[1], None].astype(np.float32)
    for mask in (m, None):
        want, (gy, gx) = jax.value_and_grad(
            lambda y, x: jlosses.mel_loss_fn(y, x, mask, order), argnums=(0, 1))(
            jnp.asarray(y), jnp.asarray(x))
        yt, xt = _t(y).requires_grad_(True), _t(x).requires_grad_(True)
        got = tlosses.mel_loss_fn(yt, xt, None if mask is None else _t(mask), order)
        got.backward()
        what = f"order {order}, mask {mask is not None}"
        _close(got, want, rtol=LOSS_RTOL, atol=0, err_msg=what)
        _close(yt.grad, gy, rtol=LOSS_RTOL, err_msg=what)
        _close(xt.grad, gx, rtol=LOSS_RTOL, err_msg=what)


def test_alignment_and_stop_losses_match_jax():
    _, _, xmask, w, s = _loss_inputs(np.random.default_rng(6))
    for name in ("alignment_max_loss", "alignment_std_loss"):
        want, gw = jax.value_and_grad(getattr(jlosses, name))(w)
        wt = _t(w).requires_grad_(True)
        got = getattr(tlosses, name)(wt)
        got.backward()
        _close(got, want, rtol=LOSS_RTOL, atol=0, err_msg=name)
        _close(wt.grad, gw, rtol=LOSS_RTOL, err_msg=name)
    mask = xmask[:, : s.shape[1]]
    want, gs = jax.value_and_grad(lambda s: jlosses.stop_bce_loss(s, mask))(s[..., 0])
    st = _t(s[..., 0]).requires_grad_(True)
    got = tlosses.stop_bce_loss(st, _t(mask))
    got.backward()
    _close(got, want, rtol=LOSS_RTOL, atol=0)
    _close(st.grad, gs, rtol=LOSS_RTOL)


def test_tacotron_loss_matches_jax():
    """The mix and every metric, and the gradients to y, y_post, s and w
    (targets longer than the outputs, trimmed; unmasked differences)."""
    y, x, xmask, w, s = _loss_inputs(np.random.default_rng(7))
    y_post = y + 0.1
    kl = np.float32(0.0)

    def f(y, y_post, s, w):
        return jlosses.tacotron_loss(y, y_post, s, x, xmask, w, kl)

    (want, wm), grads = jax.value_and_grad(f, argnums=(0, 1, 2, 3), has_aux=True)(y, y_post, s, w)
    ins = [_t(a).requires_grad_(True) for a in (y, y_post, s, w)]
    got, gm = tlosses.tacotron_loss(ins[0], ins[1], ins[2], _t(x), _t(xmask), ins[3],
                                    torch.zeros(()))
    got.backward()
    assert set(gm) == set(wm)
    for k in wm:
        _close(gm[k], wm[k], rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    for name, t, g in zip(("y", "y_post", "s", "w"), ins, grads):
        _close(t.grad, g, rtol=LOSS_RTOL, atol=1e-7, err_msg=name)
