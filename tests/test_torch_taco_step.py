"""The Taco2Prod step (kernels/taco_step.py): the port against the JAX package.

The same numpy-seeded weights, state and inputs go through the JAX
`taco_step_ref`, `taco_step_fused(interpret=True)` and
`taco_step_streamed(interpret=True, n_tile=128)` and through the port's
`taco_step_plain`, `taco_step_fused` and `taco_step_streamed` on CPU
tensors (which take the plain version). fp32 at rtol/atol 1e-5, as the JAX
package's own kernel tests; 4*H spans several 128-column tiles. With bf16
LSTM matrices the port keeps its activations fp32 and is held at 1e-5
against the JAX reference given the same bf16-rounded weights in fp32, and
at the JAX bf16 test's tolerance (rtol 0.1, atol 0.05) against the JAX
streamed kernel, which also rounds its activations to bf16.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_tts_tpu.kernels import taco_step as jts
from torch_tts_tpu_torch.kernels import taco_step as ts

RTOL = ATOL = 1e-5
B, L, DMEL, P, DC, H1, H2, R = 2, 12, 10, 8, 16, 96, 64, 2


def _inputs(seed=0, B=B, ragged=False):
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.standard_normal(s) * 0.3).astype(np.float32)  # noqa: E731
    wts = dict(
        prenet_w1=f(DMEL, P), prenet_b1=f(P), prenet_w2=f(P, P), prenet_b2=f(P),
        att_w_ih=f(P + DC, 4 * H1), att_w_hh=f(H1, 4 * H1), att_b=f(4 * H1), query_w=f(H1, DC),
        dec_w_ih=f(H1 + DC, 4 * H2), dec_w_hh=f(H2, 4 * H2), dec_b=f(4 * H2),
        mel_w=f(H2 + DC, R * DMEL), mel_b=f(R * DMEL), stop_w=f(H2 + DC, R), stop_b=f(R))
    w0 = np.zeros((B, L), np.float32)
    w0[:, :3] = (0.5, 0.3, 0.2)
    state = dict(w=w0, ctx=f(B, DC), h_att=f(B, H1), c_att=f(B, H1), h_dec=f(B, H2), c_dec=f(B, H2))
    mmask = np.ones((B, L), np.float32)
    if ragged:
        mmask[1, L - 4:] = 0
    return f(B, DMEL), state, f(B, L, DC), mmask, wts


_ref = jax.jit(jts.taco_step_ref)


def _jax(y_in, state, memory, mmask, wts):
    return (jnp.asarray(y_in), jts.TacoStepState(**{k: jnp.asarray(v) for k, v in state.items()}),
            jnp.asarray(memory), jnp.asarray(mmask),
            jts.TacoStepWeights(**{k: jnp.asarray(v) for k, v in wts.items()}))


def _torch(y_in, state, memory, mmask, wts):
    t = torch.from_numpy
    return (t(y_in), ts.TacoStepState(**{k: t(v) for k, v in state.items()}), t(memory), t(mmask),
            ts.TacoStepWeights(**{k: t(v) for k, v in wts.items()}))


def _assert_step_close(got, want, rtol=RTOL, atol=ATOL):
    y, s, st = got
    yj, sj, stj = want
    for name, a, b in [("y", y, yj), ("s", s, sj)] + list(zip(ts.TacoStepState._fields, st, stj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b, np.float32), rtol=rtol, atol=atol,
                                   err_msg=name)


@pytest.mark.parametrize("ragged", [False, True])
def test_plain_matches_jax_ref(ragged):
    args = _inputs(1, ragged=ragged)
    _assert_step_close(ts.taco_step_plain(*_torch(*args)), _ref(*_jax(*args)))


@pytest.mark.parametrize("entry", ["fused", "streamed"])
def test_entry_points_match_the_jax_kernels(entry):
    args = _inputs(2)
    if entry == "fused":
        want = jax.jit(lambda *a: jts.taco_step_fused(*a, interpret=True))(*_jax(*args))
        got = ts.taco_step_fused(*_torch(*args))
    else:
        want = jax.jit(lambda *a: jts.taco_step_streamed(*a, n_tile=128, interpret=True))(*_jax(*args))
        y_in, state, memory, mmask, wts = _torch(*args)
        got = ts.taco_step_streamed(y_in, state, memory, mmask, ts.pack_streamed(wts), n_tile=128)
    _assert_step_close(got, want)
    np.testing.assert_allclose(got[2].w.sum(-1).numpy(), 1.0, rtol=1e-5)


def test_streamed_bf16_matrices():
    args = _inputs(3)
    y_in, state, memory, mmask, wts = _torch(*args)
    packed = ts.pack_streamed(wts, torch.bfloat16)
    assert packed.att_w.dtype == packed.dec_w.dtype == torch.bfloat16
    got = ts.taco_step_streamed(y_in, state, memory, mmask, packed, n_tile=128)
    # the JAX reference on the same bf16-rounded matrices, widened to fp32
    rounded = dict(args[4])
    for k in ("att_w_ih", "att_w_hh", "dec_w_ih", "dec_w_hh"):
        rounded[k] = np.asarray(jnp.asarray(rounded[k]).astype(jnp.bfloat16).astype(jnp.float32))
    _assert_step_close(got, _ref(*_jax(*args[:4], rounded)))
    # the JAX bf16 kernel rounds activations too: its own bf16 tolerance
    jw = _jax(*args)
    wts16 = jw[4]._replace(**{k: getattr(jw[4], k).astype(jnp.bfloat16)
                              for k in ("att_w_ih", "att_w_hh", "dec_w_ih", "dec_w_hh")})
    want = jax.jit(lambda *a: jts.taco_step_streamed(*a, n_tile=128, interpret=True))(*jw[:4], wts16)
    _assert_step_close(got, want, rtol=0.1, atol=0.05)


def test_prenet_masks_extend_the_contract():
    """Masks of all ones scale each PreNet layer by 1 / keep; None is the
    TPU contract (no dropout); the masks reach the same result on every
    entry point."""
    y_in, state, memory, mmask, wts = _torch(*_inputs(4))
    g = torch.Generator().manual_seed(0)
    masks = (torch.rand(B, P, generator=g) < 0.5, torch.rand(B, P, generator=g) < 0.5)
    base = ts.taco_step_plain(y_in, state, memory, mmask, wts, prenet_masks=masks)
    streamed = ts.taco_step_streamed(y_in, state, memory, mmask, ts.pack_streamed(wts), n_tile=128,
                                     prenet_masks=masks)
    fused = ts.taco_step_fused(y_in, state, memory, mmask, wts, prenet_masks=masks)
    for other in (streamed, fused):
        for a, b in zip(other[:2] + tuple(other[2]), base[:2] + tuple(base[2])):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    no_drop = ts.taco_step_plain(y_in, state, memory, mmask, wts)
    assert not torch.allclose(base[0], no_drop[0])
    ones = (torch.ones(B, P, dtype=torch.bool),) * 2
    scaled = wts._replace(prenet_w2=wts.prenet_w2 * 2, prenet_b2=wts.prenet_b2,
                          att_w_ih=torch.cat([wts.att_w_ih[:P] * 2, wts.att_w_ih[P:]]))
    torch.testing.assert_close(ts.taco_step_plain(y_in, state, memory, mmask, wts, prenet_masks=ones)[0],
                               ts.taco_step_plain(y_in, state, memory, mmask, scaled)[0],
                               rtol=1e-5, atol=1e-5)


def test_streamed_checks_n_tile_and_devices():
    y_in, state, memory, mmask, wts = _torch(*_inputs(5))
    packed = ts.pack_streamed(wts)
    with pytest.raises(ValueError, match="n_tile"):
        ts.taco_step_streamed(y_in, state, memory, mmask, packed, n_tile=512)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        ts.pack_streamed(wts, torch.float16)
    meta = [t.to("meta") for t in (y_in, memory, mmask)]
    with pytest.raises(ValueError, match="device"):
        ts.taco_step_fused(meta[0], state, meta[1], meta[2], wts)
    with pytest.raises(ValueError, match="device"):
        ts.taco_step_streamed(meta[0], state, meta[1], meta[2], packed, n_tile=128)


def test_plain_path_launches_nothing_on_the_cpu():
    before = (ts.taco_step_fused.launches, ts.taco_step_streamed.launches)
    y_in, state, memory, mmask, wts = _torch(*_inputs(6))
    ts.taco_step_fused(y_in, state, memory, mmask, wts)
    ts.taco_step_streamed(y_in, state, memory, mmask, ts.pack_streamed(wts), n_tile=128)
    assert (ts.taco_step_fused.launches, ts.taco_step_streamed.launches) == before


def test_kernel_wrapper_checks_inputs_before_launching():
    """prepare_cuda validates every shape and the widths before it builds
    or launches anything (here it never reaches the build); a batch above
    8 rows passes the checks."""
    y_in, state, memory, mmask, wts = _torch(*_inputs(7))
    small, big = ts.launch_args(wts)
    bad_state = state._replace(c_dec=state.c_dec[:, :-1])
    with pytest.raises(ValueError, match="shape"):
        ts.prepare_cuda(y_in, bad_state, memory, mmask, None, small, big, 0.1)
    with pytest.raises(ValueError, match="shape"):
        ts.prepare_cuda(y_in, state, memory, mmask[:, :-1], None, small, big, 0.1)
    for rows in (9, 16):  # any batch: the wrapper launches once per group of 8 rows
        big_batch = _torch(*_inputs(7, B=rows))
        assert ts.check_step_args(*big_batch[:4], None, *ts.launch_args(big_batch[4]))[0] == rows
    masks = (torch.ones(B, P), torch.ones(B, P + 1))
    with pytest.raises(ValueError, match="shape"):
        ts.prepare_cuda(y_in, state, memory, mmask, masks, small, big, 0.1)
    with pytest.raises(ValueError, match="fp32 or all bf16"):
        ts.prepare_cuda(y_in, state, memory, mmask, None, small, [big[0].bfloat16(), *big[1:]], 0.1)


def test_row_groups_give_the_whole_batch():
    """The wrapper's grouping on its plain path: B=17 in groups of at most 8
    rows (one kernel launch each on the card) gives the whole batch's step,
    since rows are independent (to fp32 rounding: the CPU's matrix products
    sum in another order at another row count)."""
    assert ts.row_groups(16) == [(0, 8), (8, 16)]
    assert ts.row_groups(17) == [(0, 8), (8, 16), (16, 17)]
    y_in, state, memory, mmask, wts = _torch(*_inputs(8, B=17, ragged=True))
    whole = ts.taco_step_plain(y_in, state, memory, mmask, wts)
    parts = [ts.taco_step_plain(y_in[a:b], ts.TacoStepState(*(t[a:b] for t in state)), memory[a:b],
                                mmask[a:b], wts) for a, b in ts.row_groups(17)]
    for i, got in enumerate(zip(*[p[:2] + tuple(p[2]) for p in parts])):
        torch.testing.assert_close(torch.cat(got), (whole[:2] + tuple(whole[2]))[i], rtol=1e-6, atol=1e-6)


def test_gate_sums_split_into_off_chain_and_on_chain_parts():
    """The kernel's order of the LSTM sums: each gate sum is the part that
    depends only on the previous state ([ctx, h_att] through the ctx rows of
    att_w_ih and att_w_hh; h_dec through dec_w_hh), computed at launch,
    plus the part on this step's chain (x_pre rows; [h_att', ctx'] through
    dec_w_ih). Replayed step by step, it gives the plain step."""
    y_in, state, memory, mmask, wts = _torch(*_inputs(9, ragged=True))
    g = torch.Generator().manual_seed(1)
    masks = (torch.rand(B, P, generator=g) < 0.5, torch.rand(B, P, generator=g) < 0.5)
    want = ts.taco_step_plain(y_in, state, memory, mmask, wts, prenet_masks=masks)

    def cell(gates, h, c, b, pz=0.1):
        i, f, gg, o = (gates + b).chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        return pz * h + (1 - pz) * h_new, pz * c + (1 - pz) * c_new

    att_off = state.ctx @ wts.att_w_ih[P:] + state.h_att @ wts.att_w_hh
    dec_off = state.h_dec @ wts.dec_w_hh
    keep = 1 - ts.PRENET_DROPOUT
    x1 = torch.where(masks[0], torch.relu(y_in @ wts.prenet_w1 + wts.prenet_b1) / keep, 0.0)
    x_pre = torch.where(masks[1], torch.relu(x1 @ wts.prenet_w2 + wts.prenet_b2) / keep, 0.0)
    h_att, c_att = cell(x_pre @ wts.att_w_ih[:P] + att_off, state.h_att, state.c_att, wts.att_b)
    e = torch.einsum("bld,bd->bl", memory, h_att @ wts.query_w)
    e[:, -1] = 1e4
    p = (1 + (e / 2) / torch.sqrt(1 + (e / 2) ** 2)) / 2
    w = (state.w * p + torch.nn.functional.pad(state.w * (1 - p), (1, 0))[:, :-1]) * mmask
    ctx = torch.einsum("bl,bld->bd", w, memory)
    h_dec, c_dec = cell(torch.cat([h_att, ctx], -1) @ wts.dec_w_ih + dec_off, state.h_dec,
                        state.c_dec, wts.dec_b)
    out = torch.cat([h_dec, ctx], -1)
    y = torch.nn.functional.leaky_relu(out @ wts.mel_w + wts.mel_b, 0.01)
    s = out @ wts.stop_w + wts.stop_b
    for a, b in zip((y, s, w, ctx, h_att, c_att, h_dec, c_dec), want[:2] + tuple(want[2])):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_pack_streamed_is_tile_major():
    """pack_streamed lays each 8-unit tile's rows out contiguously: element
    [u // 8, k, gate * 8 + u % 8] is W[k, gate * H + u]; the plain path gets
    the JAX layout back exactly."""
    _, _, _, _, wts = _torch(*_inputs(10))
    packed = ts.pack_streamed(wts)
    w = torch.cat([wts.att_w_ih, wts.att_w_hh])
    assert packed.att_w.shape == (H1 // 8, P + DC + H1, 32) and packed.att_w.is_contiguous()
    for u, k, g in ((0, 0, 0), (13, 5, 2), (H1 - 1, P + DC + H1 - 1, 3)):
        assert packed.att_w[u // 8, k, g * 8 + u % 8] == w[k, g * H1 + u]
    back = ts._unpacked(packed)
    for f in ("att_w_ih", "att_w_hh", "dec_w_ih", "dec_w_hh"):
        assert torch.equal(getattr(back, f), getattr(wts, f))
