"""The Tacotron streaming surface (`Tacotron.encode`, `decode_init`,
`decode_chunk`, `apply_postnet`): the port against the JAX package, and a
chunked decode against the whole one in the port.

The small Taco2Prod config of tests/test_torch_tacotron.py at r = 2 (one
JAX init, numpy-seeded weights and batch statistics, the stop bias at the
threshold so that the items stop at different groups), converted and
loaded with strict=True, on a ragged B=3 batch. The JAX decoder's PreNet
masks (fold_in(fold_in(key, t), j)) are replayed for every global step and
each chunk gets the slice of its steps.

Tolerances: encode and the postnet fp32 rtol 1e-4 / atol 1e-5; the JAX
Tacotron's chunked mel (chunks of 4 from decode_init) within 1e-5, its
attention within 1e-5, the per-group stop flags equal; in the port, a
chunked decode (chunks of 3 and of 7, the last overhanging the steps) and
the whole decode exactly equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_tacotron import (ALPHABET, ATOL, B, LENGTHS, RTOL, _cfgs, _fill, _ids, _np,
                                 replay_prenet_masks)
from torch_tts_tpu.core import config as jcfg
from torch_tts_tpu.models.tacotron import build_tacotron as jax_build
from torch_tts_tpu.models.tacotron.model import Tacotron as JaxTacotron
from torch_tts_tpu_torch.core import config as tcfg
from torch_tts_tpu_torch.kernels import taco_step as ts
from torch_tts_tpu_torch.models.tacotron.convert import state_dict_from_jax_params
from torch_tts_tpu_torch.models.tacotron.model import Tacotron

R, STEPS, K_JAX, P = 2, 16, 4, 16
CHUNK_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while this module runs: under pytest-xdist a thread
    per core in every worker oversubscribes the cores, which slowed the
    port's tests about twofold and took CPU from the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(12)
    jm = jax_build(_cfgs(jcfg, R))
    ids = _ids(rng)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2)}, jnp.asarray(ids), jnp.asarray(LENGTHS),
        jnp.zeros((B, 2 * R, 20)), train=True, deterministic=False))
    params = _fill(shapes["params"], rng)
    params["decoder"]["fc_stop"]["bias"] = np.full((R,), -2.0, np.float32)
    variables = {"params": params, "batch_stats": _fill(shapes["batch_stats"], rng, stats=True)}
    tm = Tacotron(_cfgs(tcfg, R), 1 + len(ALPHABET))
    sd = state_dict_from_jax_params(variables["params"], variables["batch_stats"], _cfgs(tcfg, R))
    tm.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, strict=True)
    kd = jax.random.PRNGKey(11)
    masks = replay_prenet_masks(kd, STEPS, B, P)
    return dict(jm=jm, variables=variables, tm=tm.eval(), ids=ids, lengths=np.asarray(LENGTHS),
                kd=kd, masks=torch.from_numpy(masks))


def _x(p):
    return torch.from_numpy(p["ids"]), torch.from_numpy(p["lengths"])


def test_encode_matches_jax(pair):
    p = pair
    mem, mmask = jax.jit(lambda v, c, cl: p["jm"].apply(v, c, cl, method=JaxTacotron.encode))(
        p["variables"], jnp.asarray(p["ids"]), jnp.asarray(p["lengths"]))
    got_mem, got_mask = p["tm"].encode(*_x(p))
    np.testing.assert_allclose(got_mem.numpy(), _np(mem), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(mmask))


def test_apply_postnet_matches_jax(pair):
    p = pair
    y = np.random.default_rng(4).standard_normal((2, 23, 20)).astype(np.float32)
    want = jax.jit(lambda v, y: p["jm"].apply(v, y, method=JaxTacotron.apply_postnet))(
        p["variables"], jnp.asarray(y))
    got = p["tm"].apply_postnet(torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=RTOL, atol=ATOL)


def _jax_chunks(p):
    jm, v = p["jm"], p["variables"]
    mem, mmask = jm.apply(v, jnp.asarray(p["ids"]), jnp.asarray(p["lengths"]),
                          method=JaxTacotron.encode)
    chunk = jax.jit(lambda v, mem, mm, carry, t0: jm.apply(
        v, mem, mm, carry, t0, p["kd"], K_JAX, method=JaxTacotron.decode_chunk))
    carry = jm.apply(v, mem, method=JaxTacotron.decode_init)
    ys, flags, ws = [], [], []
    for t0 in range(0, STEPS, K_JAX):
        carry, y, stopped, w = chunk(v, mem, mmask, carry, jnp.asarray(t0, jnp.int32))
        ys.append(_np(y))
        flags.append(np.asarray(stopped))
        ws.append(_np(w))
    return np.concatenate(ys, 1), np.concatenate(flags, 1), np.concatenate(ws, 1)


def test_decode_chunk_matches_jax(pair):
    p = pair
    want_y, want_flags, want_w = _jax_chunks(p)
    tm = p["tm"]
    mem, _ = tm.encode(*_x(p))
    carry = tm.decode_init(mem)
    ys, flags, ws = [], [], []
    for t0 in range(0, STEPS, K_JAX):
        carry, y, stopped, w = tm.decode_chunk(mem, carry, p["masks"][t0:t0 + K_JAX])
        assert y.shape == (B, K_JAX * R, 20) and stopped.shape == (B, K_JAX)
        ys.append(y.numpy())
        flags.append(stopped.numpy())
        ws.append(w.numpy())
    np.testing.assert_allclose(np.concatenate(ys, 1), want_y, rtol=0, atol=CHUNK_ATOL)
    np.testing.assert_allclose(np.concatenate(ws, 1), want_w, rtol=0, atol=CHUNK_ATOL)
    np.testing.assert_array_equal(np.concatenate(flags, 1), want_flags)
    # the items stop at different groups (one never does)
    stops = [int(np.argmax(f)) + 1 if f.any() else STEPS for f in want_flags]
    assert len(set(stops)) > 1


@pytest.mark.parametrize("K", [3, 7])
def test_chunked_decode_equals_the_whole_decode(pair, K):
    """Chunks from decode_init, each with its steps' masks, give the whole
    decode's frames, attention and stop lengths exactly (the last chunk
    overhangs the steps; its overhang has all-keep masks)."""
    p, tm = pair, pair["tm"]
    x, xl = _x(p)
    y, _, s, aux = tm.infer(x, xl, max_steps=STEPS, prenet_masks=p["masks"])
    n = -(-STEPS // K) * K
    masks = torch.cat([p["masks"], torch.ones_like(p["masks"][:n - STEPS])])
    mem, _ = tm.encode(x, xl)
    carry = tm.decode_init(mem)
    ys, flags, ws = [], [], []
    for t0 in range(0, n, K):
        carry, yc, stopped, w = tm.decode_chunk(mem, carry, masks[t0:t0 + K])
        ys.append(yc)
        flags.append(stopped)
        ws.append(w)
    torch.testing.assert_close(torch.cat(ys, 1)[:, :STEPS * R], y, rtol=0, atol=0)
    torch.testing.assert_close(torch.cat(ws, 1)[:, :STEPS], aux["w"], rtol=0, atol=0)
    flags = torch.cat(flags, 1)[:, :STEPS]
    first = torch.where(flags.any(1), torch.argmax(flags.int(), 1) + 1, STEPS)
    torch.testing.assert_close(first, aux["stop_lengths"], rtol=0, atol=0)


def test_streamed_weights_are_packed_once_per_model(pair, monkeypatch):
    """The kernel path's packed weights are made once and reused, and made
    again after a state dict load or an in-place change of a parameter."""
    tm = Tacotron(_cfgs(tcfg, R), 1 + len(ALPHABET))
    tm.load_state_dict(pair["tm"].state_dict())
    dec = tm.decoder
    calls = []
    real = ts.pack_streamed
    monkeypatch.setattr(ts, "pack_streamed", lambda *a, **k: calls.append(1) or real(*a, **k))
    first = dec.packed_weights()
    assert dec.packed_weights() is first and len(calls) == 1
    tm.load_state_dict(pair["tm"].state_dict())
    assert dec._packed is None
    again = dec.packed_weights()
    assert again is not first and len(calls) == 2
    torch.testing.assert_close(again.att_w, first.att_w, rtol=0, atol=0)
    with torch.no_grad():
        dec.fc_stop.bias.add_(1.0)
    assert dec.packed_weights() is not again and len(calls) == 3
    assert dec.packed_weights().stop_b[0] == pair["tm"].decoder.fc_stop.bias[0] + 1.0
