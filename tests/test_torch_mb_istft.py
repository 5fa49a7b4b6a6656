"""The MB-iSTFT decoder's head and generator, and the ResBlock2 HiFi-GAN
generator: the port (torch_tts_tpu_torch) against the JAX package.

Small widths, as tests/test_mb_istft.py: the trunk upsamples x4 (2 * 2),
the iSTFT x4 (n_fft 16, hop 4) and the PQMF x4, a hop of 64. Inputs and
weights from a numpy seed; the weights carried into the port by its
converter with strict=True. Each JAX reference is jitted once and compiled
in a thread.

Tolerances: the PQMF, the overlap-add and the inverse STFT within 1e-5
abs (a sum of at most 63 products, or exact sums); the generators within
rtol 1e-4 and 1e-5 * max |JAX| abs (the MB-iSTFT output is not bounded:
exp of log-magnitudes up to 6 multiplies the trunk's errors); the
HiFi-GAN ResBlock2 waveform within 1e-4 abs (tanh output).
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_tts_tpu.ops import hifigan as jhifigan
from torch_tts_tpu.ops import mb_istft as jmb
from torch_tts_tpu_torch.core.config import VITS2ModelConfig
from torch_tts_tpu_torch.models.vits2.convert import state_dict_from_jax_params
from torch_tts_tpu_torch.ops import hifigan, mb_istft

HEAD_ATOL = 1e-5
GEN_RTOL, GEN_REL_ATOL = 1e-4, 1e-5
WAVE_ATOL = 1e-4
B, C_IN, T, GIN = 2, 8, 10, 4
LENGTHS = (10, 7)
GEN_KW = dict(resblock_kernel_sizes=(3, 5), resblock_dilation_sizes=((1, 3), (1, 2)),
              upsample_rates=(2, 2), upsample_initial_channel=32, upsample_kernel_sizes=(4, 4))
MB_KW = dict(subbands=4, istft_n_fft=16, istft_hop=4)


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
    """Seeded weights of a sensible scale for every leaf of a flax tree."""
    def fill(path, s):
        name = path[-1].key
        n = rng.standard_normal(s.shape)
        if name in ("scale", "g"):
            return (1 + 0.1 * n).astype(np.float32)
        if name in ("kernel", "v"):
            return (n / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        return (0.2 * n).astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, shapes)


def _cl(t):
    """[B, C, T] torch -> [B, T, C] numpy."""
    return t.transpose(1, 2).numpy()


def _tc(a):
    """[B, T, C] numpy -> [B, C, T] torch."""
    return torch.from_numpy(np.ascontiguousarray(a)).transpose(1, 2)


# (name, resblock, masked); the names say which generator
GENERATORS = (
    ("mb_masked", "1", True), ("mb_unmasked", "1", False), ("mb_resblock2", "2", True),
    ("hifigan_resblock2_masked", "2", True), ("hifigan_resblock2_unmasked", "2", False),
)


def _jax_generator(name, resblock):
    if name.startswith("mb"):
        return jmb.MultiBandISTFTGenerator(resblock=resblock, gin_channels=GIN, **GEN_KW,
                                           **MB_KW)
    return jhifigan.Generator(resblock=resblock, gin_channels=GIN, **GEN_KW)


def _port_generator(name, resblock, params):
    if name.startswith("mb"):
        dec = mb_istft.MultiBandISTFTGenerator(C_IN, resblock, gin_channels=GIN, fuse_mrf=True,
                                               **GEN_KW, **MB_KW)
    else:
        dec = hifigan.Generator(C_IN, resblock, gin_channels=GIN, fuse_mrf=True, **GEN_KW)
    cfg = VITS2ModelConfig(use_transformer_flows=False,
                           resblock_kernel_sizes=GEN_KW["resblock_kernel_sizes"])
    dec.load_state_dict(state_dict_from_jax_params(params, cfg), strict=True)
    return dec.eval()


@pytest.fixture(scope="module")
def refs():
    """Inputs, the generators' weights and every JAX reference."""
    rng = np.random.default_rng(21)
    x = rng.standard_normal((B, T, C_IN)).astype(np.float32)
    g = rng.standard_normal((B, 1, GIN)).astype(np.float32)
    mask = (np.arange(T)[None, :, None] < np.asarray(LENGTHS)[:, None, None]).astype(np.float32)
    wave = (rng.standard_normal((B, 256, 1)) * 0.3).astype(np.float32)
    sub = rng.standard_normal((B, 64, 4)).astype(np.float32)
    frames = rng.standard_normal((3, 7, 16)).astype(np.float32)
    # magnitudes up to e^2 and phases on every bin, so bins 0 and n/2 have
    # imaginary parts that the inverse real FFT must ignore
    mag = np.exp(rng.standard_normal((3, 20, 9)) * 0.7).astype(np.float32)
    phase = (rng.uniform(-np.pi, np.pi, (3, 20, 9))).astype(np.float32)
    data = dict(x=x, g=g, mask=mask, wave=wave, sub=sub, frames=frames, mag=mag, phase=phase)

    pq = jmb.PQMF(4)
    calls = {"analysis": (pq.analysis, (wave,)), "synthesis": (pq.synthesis, (sub,)),
             "overlap_add": (lambda f: jmb.overlap_add(f, 3), (frames,)),
             "inverse_stft": (lambda m, p: jmb.inverse_stft(m, p, 16, 4), (mag, phase))}
    params = {}
    for name, resblock, masked in GENERATORS:
        jgen = _jax_generator(name, resblock)
        params[name] = random_params(jax.eval_shape(lambda m=jgen: m.init(
            jax.random.PRNGKey(0), jnp.asarray(x), g=jnp.asarray(g))["params"]), rng)
        args = (params[name], x, g) + ((mask,) if masked else ())
        calls[name] = (lambda p, a, gg, *m, _j=jgen: _j.apply(
            {"params": p}, a, g=gg, x_mask=m[0] if m else None), args)
    with ThreadPoolExecutor(len(calls)) as ex:
        pending = {n: (ex.submit(jax.jit(fn).lower(*args).compile), args)
                   for n, (fn, args) in calls.items()}
        out = {n: np.asarray(fut.result()(*args)) for n, (fut, args) in pending.items()}
    return dict(data=data, params=params, jax=out)


def test_pqmf_analysis_matches_jax(refs):
    d = refs["data"]
    got = mb_istft.PQMF(4).analysis(_tc(d["wave"]))
    assert got.shape == (B, 4, 64)
    np.testing.assert_allclose(_cl(got), refs["jax"]["analysis"], rtol=0, atol=HEAD_ATOL)


def test_pqmf_synthesis_matches_jax(refs):
    """The synthesis filters reversed in time for conv_transpose1d; without
    the reversal the two differ by orders of magnitude more."""
    d = refs["data"]
    pq = mb_istft.PQMF(4)
    got = pq.synthesis(_tc(d["sub"]))
    assert got.shape == (B, 1, 256)
    np.testing.assert_allclose(_cl(got), refs["jax"]["synthesis"], rtol=0, atol=HEAD_ATOL)
    pq.synthesis_weight = pq.synthesis_weight.flip(-1)
    assert np.abs(_cl(pq.synthesis(_tc(d["sub"]))) - refs["jax"]["synthesis"]).max() > 1e-2
    assert "synthesis_weight" not in pq.state_dict()


def test_overlap_add_matches_jax(refs):
    got = mb_istft.overlap_add(torch.from_numpy(refs["data"]["frames"]), 3)
    assert got.shape == (3, 6 * 3 + 16)
    np.testing.assert_allclose(got.numpy(), refs["jax"]["overlap_add"], rtol=0, atol=HEAD_ATOL)


def test_inverse_stft_matches_jax_with_imaginary_edge_bins(refs):
    d = refs["data"]
    mag, phase = torch.from_numpy(d["mag"]), torch.from_numpy(d["phase"])
    got = mb_istft.inverse_stft(mag, phase, 16, 4)
    assert got.shape == (3, 80)
    want = refs["jax"]["inverse_stft"]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=HEAD_ATOL)
    # the edge bins' imaginary parts are there, and the JAX irfft ignores
    # them: the same spectrum with each edge bin replaced by its real part
    # (magnitude |re|, phase 0 or pi) gives the same waveform
    assert float((mag[..., [0, -1]] * torch.sin(phase[..., [0, -1]])).abs().max()) > 0.1
    turned = phase.clone()
    turned[..., [0, -1]] = torch.where(torch.cos(turned[..., [0, -1]]) >= 0, 0.0, np.pi)
    mag2 = mag.clone()
    mag2[..., [0, -1]] = mag[..., [0, -1]] * torch.cos(phase[..., [0, -1]]).abs()
    np.testing.assert_allclose(mb_istft.inverse_stft(mag2, turned, 16, 4).numpy(), want,
                               rtol=0, atol=HEAD_ATOL)


@pytest.mark.parametrize("name,resblock,masked", GENERATORS, ids=[g[0] for g in GENERATORS])
def test_generator_matches_jax(refs, name, resblock, masked):
    """Both generators with a speaker embedding, masked (ragged lengths) and
    unmasked; MB-iSTFT with ResBlock1 and ResBlock2 banks, HiFi-GAN with
    ResBlock2."""
    d = refs["data"]
    dec = _port_generator(name, resblock, refs["params"][name])
    with torch.no_grad():
        got = dec(_tc(d["x"]), x_mask=_tc(d["mask"]) if masked else None, g=_tc(d["g"]))
    want = refs["jax"][name]
    hop = 64 if name.startswith("mb") else 4
    assert got.shape == (B, 1, T * hop) and want.shape == (B, T * hop, 1)
    if name.startswith("mb"):
        np.testing.assert_allclose(_cl(got), want, rtol=GEN_RTOL,
                                   atol=GEN_REL_ATOL * float(np.abs(want).max()))
        assert float(np.abs(want).max()) > 1.0  # no tanh: the yardstick is relative
    else:
        np.testing.assert_allclose(_cl(got), want, rtol=0, atol=WAVE_ATOL)
    if masked and name.startswith("mb"):  # masked at sample rate, unlike HiFi-GAN's
        assert float(got[1, 0, LENGTHS[1] * hop:].abs().max()) == 0.0
    if resblock == "2":
        from torch_tts_tpu.models.vits2.convert import export_torch_state_dict

        assert all(isinstance(b, hifigan.ResBlock2) for b in dec.resblocks)
        want = export_torch_state_dict(refs["params"][name], VITS2ModelConfig(
            use_transformer_flows=False, resblock_kernel_sizes=GEN_KW["resblock_kernel_sizes"]))
        assert set(dec.state_dict()) == set(want)
        assert "resblocks.0.convs.1.weight_v" in want
