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
- In tests/test_torch_wn_stack_kernel.py: the forward and backward
  kernels' products replayed in 3xTF32 on the CPU stay within 1e-5 of the
  plain group, where 1xTF32 does not; the forward's planner picks its
  window and cluster size as stated; a CPU tensor takes the plain version
  and launches nothing (the kernels on a card:
  tests/test_torch_cuda_kernels.py).
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
from torch_tts_tpu_torch.kernels.wn_stack import supports, wn_group_backward, wn_group_plain, wn_stack
from torch_tts_tpu_torch.models.vits2.convert import state_dict_from_jax_params
from torch_tts_tpu_torch.ops.wavenet import WN, fused_wn_default

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while this module runs: under pytest-xdist a thread
    per core in every worker oversubscribes the cores, which slowed the
    port's tests about twofold and took CPU from the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    """At H = 192, a width the kernels take (`wn_stack.supports`), so the
    port's WN takes its fused path (on the CPU the plain group)."""
    rng = np.random.default_rng(1)
    B, T, H = 2, 41, 192
    assert supports(H, 5)
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
    the layerwise path on the CPU. At H = 192, a width the kernels take
    (`wn_stack.supports`; another width takes the layerwise path whatever
    the env says)."""
    calls = []
    monkeypatch.setattr("torch_tts_tpu_torch.ops.wavenet.wn_stack",
                        lambda *a, **k: calls.append(1) or wn_group_plain(*a)[1])
    wn = WN(192, 5, 1, 4).eval()
    x, m = torch.randn(1, 192, 10), torch.ones(1, 1, 10)
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
