"""VITS2 training modules of the port against the JAX package: the spline
transform, the SDP's NLL, the mel spectrogram, the MPD's names and
shapes, the losses, segment slicing and the port's dropout (rtol 1e-4,
atol 1e-5 unless said). The training forward and the whole step:
tests/test_torch_vits2_train.py, whose helpers these tests share.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_vits2_train import B, HOP, N_MELS, _close, _t, _tc, patched_jax, random_params
from torch_tts_tpu.audio import mel as jmel
from torch_tts_tpu.core import masks as jmasks
from torch_tts_tpu.models.vits2 import MultiPeriodDiscriminator as JaxMPD
from torch_tts_tpu.models.vits2 import losses as jlosses
from torch_tts_tpu.ops import splines as jsplines
from torch_tts_tpu_torch.audio import mel
from torch_tts_tpu_torch.core import masks
from torch_tts_tpu_torch.models.vits2 import losses
from torch_tts_tpu_torch.models.vits2.convert import (mpd_state_dict_from_jax_params,
                                                      state_dict_from_jax_params)
from torch_tts_tpu_torch.models.vits2.discriminators import MultiPeriodDiscriminator
from torch_tts_tpu_torch.ops import splines
from torch_tts_tpu_torch.ops.layers import Dropout, set_dropout_generator


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while this module runs: under pytest-xdist a thread
    per core in every worker oversubscribes the cores, which slowed the
    port's tests about twofold and took CPU from the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("inverse", [False, True])
def test_spline_transform_matches_jax(inverse):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((3, 17)) * 3).astype(np.float32)  # some outside the tails
    w, h = (rng.standard_normal((3, 17, 10)).astype(np.float32) for _ in range(2))
    d = rng.standard_normal((3, 17, 9)).astype(np.float32)
    got = splines.piecewise_rational_quadratic_transform(*map(_t, (x, w, h, d)), inverse=inverse)
    want = jax.jit(functools.partial(jsplines.piecewise_rational_quadratic_transform,
                                     inverse=inverse))(*map(jnp.asarray, (x, w, h, d)))
    for a, b in zip(got, want):
        _close(a.numpy(), b)


def test_sdp_nll_matches_jax():
    """The SDP's training direction (the NLL of given durations, through
    the posterior and main spline flows) with the same e_q noise."""
    from torch_tts_tpu.models.vits2.model import StochasticDurationPredictor as JaxSDP
    from torch_tts_tpu_torch.models.vits2.model import StochasticDurationPredictor

    rng = np.random.default_rng(6)
    H, T = 8, 11
    hx = rng.standard_normal((B, T, H)).astype(np.float32)
    x_mask = (np.arange(T)[None, :, None] < np.array([T, 7])[:, None, None]).astype(np.float32)
    w = (rng.integers(1, 5, (B, T, 1)) * x_mask).astype(np.float32)
    e_q = rng.standard_normal((B, T, 2)).astype(np.float32)
    jsdp = JaxSDP(H, 192, 3, 0.0, 4)
    args = tuple(map(jnp.asarray, (hx, x_mask, w)))
    shapes = jax.eval_shape(lambda: jsdp.init({"params": jax.random.PRNGKey(0),
                                               "noise": jax.random.PRNGKey(1)}, *args))
    params = random_params(shapes["params"], rng)
    with patched_jax({(B, T, 2): [e_q]}, np.zeros(0, np.float32)):
        want = jax.jit(lambda p: jsdp.apply({"params": p}, *args,
                                            rngs={"noise": jax.random.PRNGKey(1)}))(params)
    sdp = StochasticDurationPredictor(H, 192, 3, 4)
    sdp.load_state_dict(state_dict_from_jax_params(params), strict=True)
    with torch.no_grad():
        got = sdp(_tc(hx), _tc(x_mask), w=_tc(w), noise=_tc(e_q))
    _close(got.numpy(), want, atol=1e-4)


def test_mel_spectrogram_matches_jax():
    wav = (np.random.default_rng(2).standard_normal((2, 640)) * 0.3).astype(np.float32)
    args = (32, N_MELS, 8000, HOP, 32)
    got = mel.mel_spectrogram(torch.from_numpy(wav), *args)
    want = jmel.mel_spectrogram(jnp.asarray(wav), *args)
    assert got.shape == want.shape == (2, 640 // HOP, N_MELS)
    _close(got.numpy(), want, atol=1e-4)
    np.testing.assert_allclose(mel.mel_filterbank(8000, 32, N_MELS),
                               jmel.mel_filterbank(8000, 32, N_MELS))


def test_mpd_names_and_shapes_match_the_jax_exporter():
    """Default periods: the converter gives the JAX exporter's names and
    shapes, and they load into the default MPD with strict=True."""
    from torch_tts_tpu.models.vits2.convert import export_mpd_torch_state_dict

    wav = jnp.zeros((1, 64, 1))
    shapes = jax.eval_shape(lambda: JaxMPD().init(jax.random.PRNGKey(0), wav, wav)["params"])
    params = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    got = mpd_state_dict_from_jax_params(params)
    want = export_mpd_torch_state_dict(params)
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    MultiPeriodDiscriminator().load_state_dict(got, strict=True)


def test_losses_match_jax():
    rng = np.random.default_rng(4)
    outs_r = [rng.standard_normal((B, n)).astype(np.float32) for n in (5, 7)]
    outs_g = [rng.standard_normal((B, n)).astype(np.float32) for n in (5, 7)]
    fm_r = [[rng.standard_normal((B, 3, n)).astype(np.float32) for n in (4, 6)]] * 2
    fm_g = [[rng.standard_normal((B, 3, n)).astype(np.float32) for n in (4, 6)]] * 2
    tl = lambda xs: [_t(x) for x in xs]  # noqa: E731
    jl = lambda xs: [jnp.asarray(x) for x in xs]  # noqa: E731
    for a, b in zip(losses.discriminator_loss(tl(outs_r), tl(outs_g)),
                    jlosses.discriminator_loss(jl(outs_r), jl(outs_g))):
        _close(a.numpy(), b)
    for a, b in zip(losses.generator_loss(tl(outs_g)), jlosses.generator_loss(jl(outs_g))):
        _close(a.numpy(), b)
    _close(losses.feature_loss([tl(f) for f in fm_r], [tl(f) for f in fm_g]).numpy(),
           jlosses.feature_loss([jl(f) for f in fm_r], [jl(f) for f in fm_g]))
    z_p, logs_q, m_p, logs_p = (rng.standard_normal((B, 9, 4)).astype(np.float32) * 0.5
                                for _ in range(4))
    zm = (np.arange(9)[None, :, None] < np.array([9, 5])[:, None, None]).astype(np.float32)
    _close(losses.kl_loss(*map(_t, (z_p, logs_q, m_p, logs_p, zm))).numpy(),
           jlosses.kl_loss(*map(jnp.asarray, (z_p, logs_q, m_p, logs_p, zm))))


def test_segment_slicing_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 20, 4)).astype(np.float32)
    ids = np.array([0, 7, 15], np.int32)  # the last window runs past T: clamped
    want = jmasks.slice_segments(jnp.asarray(x), jnp.asarray(ids), 8)
    np.testing.assert_array_equal(masks.slice_segments(_t(x), _t(ids), 8).numpy(), want)
    np.testing.assert_array_equal(
        masks.slice_segments(_t(x).transpose(1, 2), _t(ids), 8, dim=2).transpose(1, 2).numpy(),
        want)
    seg, got_ids = masks.rand_slice_segments(_t(x), torch.tensor([20, 9, 3]), 8,
                                             generator=torch.Generator().manual_seed(0))
    assert got_ids.dtype == torch.int32 and (got_ids >= 0).all()
    assert (got_ids <= torch.clamp(torch.tensor([20, 9, 3]) - 8, min=0)).all()


def test_dropout_draws_from_its_generator():
    drop = Dropout(0.5).train()
    x = torch.ones(4, 64)
    with pytest.raises(ValueError):
        drop(x)
    set_dropout_generator(drop, torch.Generator().manual_seed(3))
    a = drop(x)
    set_dropout_generator(drop, torch.Generator().manual_seed(3))
    assert torch.equal(a, drop(x))
    assert set(a.unique().tolist()) == {0.0, 2.0}
    assert torch.equal(drop.eval()(x), x)
