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
waveform's peak (these module tests: tests/test_torch_tacotron_modules.py,
split off so that no port test file queues ahead of the suite's longest
under `--dist loadfile`).
"""


import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_tts_tpu.core import config as jcfg
from torch_tts_tpu.kernels.taco_step import weights_from_cell_params
from torch_tts_tpu.models.tacotron import build_tacotron as jax_build
from torch_tts_tpu.models.tacotron.convert import export_torch_state_dict
from torch_tts_tpu.models.tacotron.model import Tacotron as JaxTacotron
from torch_tts_tpu_torch.core import config as tcfg
from torch_tts_tpu_torch.kernels.taco_step import weights_from_state_dict
from torch_tts_tpu_torch.models.tacotron import build_tacotron
from torch_tts_tpu_torch.models.tacotron.convert import state_dict_from_jax_params
from torch_tts_tpu_torch.models.tacotron.model import Tacotron

RTOL, ATOL, MODEL_ATOL = 1e-4, 1e-5, 1e-4
ALPHABET = "#abcdefghijklmnopqrstuvwxyz .,"
STEPS = 20
B, L_TEXT, LENGTHS = 3, 11, (11, 8, 5)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while this module runs: under pytest-xdist a thread
    per core in every worker oversubscribes the cores, which slowed the
    port's tests about twofold and took CPU from the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
