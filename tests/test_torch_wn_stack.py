"""Port of the fused WN stack (torch_tts_tpu_torch/kernels/wn_stack.py and
ops/wavenet.py) against the JAX package.

- The plain PyTorch group equals the Pallas forward kernel run in interpret
  mode over several tiles and `wn_group_ref`, with and without
  conditioning (fp32, rtol 1e-4, atol 1e-5).
- The port's WN(fused=True), whose weights are collected from the same
  modules as the layerwise path (final layer's residual half zero-padded),
  equals the JAX WN(fused=True) and the port's own layerwise WN, also over
  several chained groups.
- Gradients: the plain group's backward (autograd through
  `wn_group_plain`, the plain version beside the backward kernel) equals
  the Pallas backward kernel in interpret mode over several tiles and
  `jax.vjp(wn_group_ref)`, with and without conditioning; a 16-layer
  `wn_stack` (four chained groups) gives JAX's gradients (rtol 1e-4,
  atol 1e-5).
- A CPU tensor takes the plain version and launches nothing (the kernels on
  a card: tests/test_torch_cuda_kernels.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_tts_tpu.kernels.wn_stack import (_wn_group_pallas, _wn_group_pallas_bwd,
                                            wn_group_ref)
from torch_tts_tpu.kernels.wn_stack import wn_stack as jax_wn_stack
from torch_tts_tpu.ops.wavenet import WN as JaxWN
from torch_tts_tpu_torch.kernels.wn_stack import (wn_group, wn_group_backward,
                                                  wn_group_backward_plain, wn_group_plain,
                                                  wn_stack)
from torch_tts_tpu_torch.models.vits2.convert import state_dict_from_jax_params
from torch_tts_tpu_torch.kernels.mrf_fused import split_tf32
from torch_tts_tpu_torch.ops.wavenet import WN, fused_wn_default

RTOL, ATOL = 1e-4, 1e-5


def _group_inputs(rng, B=2, T=57, H=8, L=3, k=5, with_gl=True):
    x = rng.standard_normal((B, T, H)).astype(np.float32)
    mask = (np.arange(T)[None, :, None] < np.array([T, T - 9])[:B, None, None]).astype(np.float32)
    gl = rng.standard_normal((B, L, 2 * H)).astype(np.float32) if with_gl else None
    w_in = (rng.standard_normal((L, k, H, 2 * H)) * 0.3).astype(np.float32)
    b_in = (rng.standard_normal((L, 2 * H)) * 0.1).astype(np.float32)
    w_rs = (rng.standard_normal((L, H, 2 * H)) * 0.3).astype(np.float32)
    b_rs = (rng.standard_normal((L, 2 * H)) * 0.1).astype(np.float32)
    w_rs[-1, :, :H] = 0.0
    b_rs[-1, :H] = 0.0
    return x, mask, gl, w_in, b_in, w_rs, b_rs


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("with_gl", [False, True])
@pytest.mark.parametrize("T,tile", [(57, 16), (30, 128)])
def test_plain_group_matches_pallas_interpret_and_ref(T, tile, with_gl):
    args = _group_inputs(np.random.default_rng(0), T=T, with_gl=with_gl)
    x_out, skip = wn_group_plain(*map(_t, args))
    for ref in (_wn_group_pallas(*map(_j, args), tile=tile, interpret=True),
                wn_group_ref(*map(_j, args))):
        np.testing.assert_allclose(x_out.numpy(), np.asarray(ref[0]), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(skip.numpy(), np.asarray(ref[1]), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("gin", [0, 6])
@pytest.mark.parametrize("L", [4, 6])
def test_fused_wn_matches_jax(L, gin):
    rng = np.random.default_rng(1)
    B, T, H = 2, 41, 16
    x = rng.standard_normal((B, T, H)).astype(np.float32)
    mask = (np.arange(T)[None, :, None] < np.array([T, 30])[:, None, None]).astype(np.float32)
    g = rng.standard_normal((B, 1, gin)).astype(np.float32) if gin else None
    jwn = JaxWN(H, 5, 1, L, gin_channels=gin, fused=True)
    params = jwn.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask), g=_j(g))["params"]
    ref = jwn.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask), g=_j(g))

    wn = WN(H, 5, 1, L, gin_channels=gin, fused=True)
    wn.load_state_dict(state_dict_from_jax_params(params), strict=True)
    xt, mt = torch.from_numpy(x).transpose(1, 2), torch.from_numpy(mask).transpose(1, 2)
    gt = None if g is None else torch.from_numpy(g).transpose(1, 2)
    with torch.no_grad():
        out = wn.eval()(xt, mt, g=gt)
        wn.fused = False
        layerwise = wn(xt, mt, g=gt)
    np.testing.assert_allclose(out.transpose(1, 2).numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out.numpy(), layerwise.numpy(), rtol=RTOL, atol=ATOL)


def test_fused_default_reads_env(monkeypatch):
    """fused=None follows TTS_FUSED_WN at call time when it is set, with no
    shape gate: the B=1, L=4 flow shape takes the stack path when the env
    asks for it. Unset, the default is the fused group on a CUDA device and
    the layerwise path on the CPU."""
    calls = []
    monkeypatch.setattr("torch_tts_tpu_torch.ops.wavenet.wn_stack",
                        lambda *a, **k: calls.append(1) or wn_group_plain(*a)[1])
    wn = WN(8, 5, 1, 4).eval()
    x, m = torch.randn(1, 8, 10), torch.ones(1, 1, 10)
    monkeypatch.setenv("TTS_FUSED_WN", "0")
    wn(x, m)
    assert not calls
    assert not fused_wn_default(torch.device("cuda"))
    monkeypatch.setenv("TTS_FUSED_WN", "1")
    wn(x, m)
    assert calls == [1]
    monkeypatch.delenv("TTS_FUSED_WN")
    wn(x, m)
    assert calls == [1]
    assert fused_wn_default(torch.device("cuda")) and not fused_wn_default(torch.device("cpu"))


GRAD_NAMES = ("d_x", "d_gl", "d_w_in", "d_b_in", "d_w_rs", "d_b_rs")


@pytest.mark.parametrize("T,tile,with_gl", [(57, 16, True), (30, 128, False)])
def test_plain_group_gradients_match_pallas_bwd_and_vjp(T, tile, with_gl):
    rng = np.random.default_rng(10 + T)
    args = _group_inputs(rng, T=T, with_gl=with_gl)
    d_xo, d_sk = (rng.standard_normal(args[0].shape).astype(np.float32) for _ in range(2))
    got = wn_group_backward(*map(_t, args), _t(d_xo), _t(d_sk))
    x, mask, gl, w_in, b_in, w_rs, b_rs = map(_j, args)
    pallas = _wn_group_pallas_bwd(x, mask, gl, w_in, b_in, w_rs, b_rs, _j(d_xo), _j(d_sk),
                                  tile=tile, interpret=True)
    if with_gl:
        _, vjp = jax.vjp(lambda x_, g_, a, b, c, d: wn_group_ref(x_, mask, g_, a, b, c, d),
                         x, gl, w_in, b_in, w_rs, b_rs)
        ref = vjp((_j(d_xo), _j(d_sk)))
    else:
        _, vjp = jax.vjp(lambda x_, a, b, c, d: wn_group_ref(x_, mask, None, a, b, c, d),
                         x, w_in, b_in, w_rs, b_rs)
        ref = vjp((_j(d_xo), _j(d_sk)))
        ref = (ref[0], None) + tuple(ref[1:])
    for name, g, p, r in zip(GRAD_NAMES, got, pallas, ref):
        if not with_gl and name == "d_gl":
            assert g is None and r is None
            continue
        np.testing.assert_allclose(g.numpy(), np.asarray(p), rtol=RTOL, atol=ATOL, err_msg=name)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=RTOL, atol=ATOL, err_msg=name)


def test_sixteen_layer_stack_gradients_match_jax():
    """Four chained groups, as enc_q's WN: gradients of x, gl and every
    weight through `wn_stack` equal JAX's through its custom_vjp chain."""
    rng = np.random.default_rng(4)
    B, T, H, L = 2, 33, 8, 16
    x, mask, gl, w_in, b_in, w_rs, b_rs = _group_inputs(rng, B=B, T=T, H=H, L=L)
    w_in, w_rs = w_in * 0.5, w_rs * 0.5
    cot = rng.standard_normal((B, T, H)).astype(np.float32)
    ins = [x, gl, w_in, b_in, w_rs, b_rs]

    def jloss(x_, g_, a, b, c, d):
        return jnp.sum(jax_wn_stack(x_, jnp.asarray(mask), g_, a, b, c, d) * cot)

    want = jax.jit(jax.grad(jloss, argnums=tuple(range(6))))(*map(jnp.asarray, ins))
    tins = [torch.from_numpy(a).requires_grad_() for a in ins]
    out = wn_stack(tins[0], torch.from_numpy(mask), *tins[1:])
    (out * torch.from_numpy(cot)).sum().backward()
    for t, w in zip(tins, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


def test_backward_plain_is_autograd_of_plain_group():
    args = tuple(map(_t, _group_inputs(np.random.default_rng(6), B=1, T=12)))
    d_xo, d_sk = torch.randn(1, 12, 8), torch.randn(1, 12, 8)
    before = wn_group_backward.launches
    got = wn_group_backward(*args, d_xo, d_sk)
    assert wn_group_backward.launches == before
    for a, b in zip(got, wn_group_backward_plain(*args, d_xo, d_sk)):
        assert torch.equal(a, b)


def test_cpu_tensor_takes_plain_version():
    args = tuple(map(_t, _group_inputs(np.random.default_rng(2), B=1, T=20)))
    before = wn_group.launches
    out = wn_group(*args)
    assert wn_group.launches == before
    for a, b in zip(out, wn_group_plain(*args)):
        assert torch.equal(a, b)


def test_pick_tile_fills_the_card():
    from torch_tts_tpu_torch.kernels.wn_stack import pick_tile

    assert pick_tile(1, 1024, 132) == 16  # 64 CTAs: the most a 16-frame tile gives
    assert pick_tile(8, 1024, 132) == 64  # 128 CTAs already fill half the SMs
    assert pick_tile(4, 1024, 132) == 32
    assert pick_tile(1, 5, 132) == 16


def _mm_3xtf32(a, b):
    """a @ b as the backward kernel's tensor cores form it: small terms first."""
    (ah, al), (bh, bl) = split_tf32(a), split_tf32(b)
    return al @ bh + ah @ bl + ah @ bh


def _shift(a, s):
    """out[:, t] = a[:, t + s] inside [0, T), zero outside."""
    out = torch.zeros_like(a)
    T = a.shape[1]
    lo, hi = max(0, -s), min(T, T - s)
    if lo < hi:
        out[:, lo:hi] = a[:, lo + s:hi + s]
    return out


def _replay_backward(x, mask, gl, w_in, b_in, w_rs, b_rs, d_xo, d_sk, mm):
    """The backward kernel's algorithm on the CPU: the saving forward, then
    per layer in reverse the four products (each through `mm`) and the bias
    sums as products with a row of ones, per batch item for the weights."""
    B, T, H = x.shape
    L, k = w_in.shape[:2]
    p = (k - 1) // 2
    xs, x_ins = [], []
    for i in range(L):  # the saving forward (fp32)
        xs.append(x)
        x_in = sum(_shift(x, t - p) @ w_in[i, t] for t in range(k)) + b_in[i]
        if gl is not None:
            x_in = x_in + gl[:, i][:, None]
        x_ins.append(x_in)
        rs = (torch.tanh(x_in[..., :H]) * torch.sigmoid(x_in[..., H:])) @ w_rs[i] + b_rs[i]
        x = (x + rs[..., :H]) * mask
    ones = torch.ones(1, T)
    d, out = d_xo, {"d_w_in": [], "d_b_in": [], "d_w_rs": [], "d_b_rs": [], "d_gl": []}
    for i in reversed(range(L)):
        d_rs = torch.cat([d * mask, d_sk * mask], -1)
        t = torch.tanh(x_ins[i][..., :H])
        s = torch.sigmoid(x_ins[i][..., H:])
        d_acts = mm(d_rs.reshape(-1, 2 * H), w_rs[i].t()).reshape(B, T, H)
        d_xin = torch.cat([d_acts * s * (1 - t * t), d_acts * t * s * (1 - s)], -1)
        acts = t * s
        d = d_rs[..., :H] + mm(torch.cat([_shift(d_xin, p - tau) for tau in range(k)], -1)
                               .reshape(-1, k * 2 * H),
                               w_in[i].permute(0, 2, 1).reshape(k * 2 * H, H)).reshape(B, T, H)
        a_in = torch.cat([_shift(xs[i], tau - p) for tau in range(k)], -1)  # [B, T, k H]
        parts_in = [mm(torch.cat([a_in[b].t(), ones], 0), d_xin[b]) for b in range(B)]
        parts_rs = [mm(torch.cat([acts[b].t(), ones], 0), d_rs[b]) for b in range(B)]
        part_in, part_rs = sum(parts_in), sum(parts_rs)
        out["d_w_in"].insert(0, part_in[:-1].reshape(k, H, 2 * H))
        out["d_b_in"].insert(0, part_in[-1])
        out["d_gl"].insert(0, torch.stack([q[-1] for q in parts_in]))
        out["d_w_rs"].insert(0, part_rs[:-1])
        out["d_b_rs"].insert(0, part_rs[-1])
    stack = {n: torch.stack(v) for n, v in out.items()}
    return (d, stack["d_gl"].transpose(0, 1) if gl is not None else None, stack["d_w_in"],
            stack["d_b_in"], stack["d_w_rs"], stack["d_b_rs"])


def test_backward_replay_in_3xtf32_matches_plain():
    """The backward kernel's products replayed in 3xTF32 (every product and
    bias sum split into hi and lo TF32 parts) stay within 1e-5 of autograd
    through the plain group; with the hi parts alone (1xTF32) they do not."""
    args = tuple(map(_t, _group_inputs(np.random.default_rng(7), B=2, T=21, H=8, L=2)))
    d_xo, d_sk = (torch.from_numpy(np.random.default_rng(8).standard_normal((2, 21, 8))
                                   .astype(np.float32)) for _ in range(2))
    want = wn_group_backward_plain(*args, d_xo, d_sk)
    got = _replay_backward(*args, d_xo, d_sk, _mm_3xtf32)
    for name, g, w in zip(GRAD_NAMES, got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5, msg=name)
    one = _replay_backward(*args, d_xo, d_sk, lambda a, b: split_tf32(a)[0] @ split_tf32(b)[0])
    assert max(float((g - w).abs().max()) for g, w in zip(one, want)) > 1e-4
