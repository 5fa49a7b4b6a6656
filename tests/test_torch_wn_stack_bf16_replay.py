"""The bf16 WN kernels' rounding plan (csrc/wn_stack_bf16.cu) replayed on the
CPU, and the wrapper's helpers for them.

The replay runs the kernels' arithmetic: every product in fp32 over bf16
operands; the residual x, the skip sums, the pre-activation x_in and d_x
between layers in fp32; the weight gradients split by batch item into fp32
partials summed in item order. A plan says where each operand is rounded to
bf16: `NEW` stores what only the tensor cores read in bf16 (the saved x_i,
acts, d_xin, d_x m and d_sk m), `LOAD` (the earlier kernels') keeps them in
fp32 and rounds each operand as a product loads it.

- Both plans against the JAX package's bf16 `wn_group_ref` and `jax.vjp`
  of it (every op in bf16), within 2^-5 of each output's peak: the
  tolerance chip_smoke.py and tests/test_torch_cuda_kernels.py hold the
  kernels to against the plain version in bf16.
- The two plans give the same bits: storing the operands in bf16 moves no
  product.
- The wrapper's bf16 helpers: the save dtypes, the backward's workspace and
  the forward's plan.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_tts_tpu.kernels.wn_stack import wn_group_ref
from torch_tts_tpu_torch.kernels import wn_stack as wn

TOL = 2.0 ** -5  # of each output's peak
H, B, T = 8, 2, 21
GRADS = ("d_x", "d_gl", "d_w_in", "d_b_in", "d_w_rs", "d_b_rs")
CASES = (  # L, k, with_gl, the items' lengths
    (3, 5, True, (21, 13)),
    (2, 3, False, (21, 13)),
    (2, 5, False, (21, 21)),
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while this module runs: under pytest-xdist a thread
    per core in every worker oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Plan:
    def __init__(self, name, store, load):
        self.name, self.store, self.load = name, store, load


NEW = _Plan("new", lambda t: t.bfloat16(), lambda t: t.float())
LOAD = _Plan("load", lambda t: t, lambda t: t.bfloat16().float())


def _inputs(case):
    """Seeded bf16 inputs and cotangents of one case (numpy, then rounded)."""
    L, k, with_gl, lengths = case
    rng = np.random.default_rng(100 + 10 * L + k)
    f = lambda *s, scale=1.0: torch.from_numpy((rng.standard_normal(s) * scale)
                                               .astype(np.float32)).bfloat16()
    mask = torch.from_numpy((np.arange(T)[None, :, None] < np.array(lengths)[:, None, None])
                            .astype(np.float32)).bfloat16()
    w_rs, b_rs = f(L, H, 2 * H, scale=0.3), f(L, 2 * H, scale=0.1)
    w_rs[-1, :, :H], b_rs[-1, :H] = 0, 0
    args = (f(B, T, H), mask, f(B, L, 2 * H) if with_gl else None, f(L, k, H, 2 * H, scale=0.3),
            f(L, 2 * H, scale=0.1), w_rs, b_rs)
    return args, f(B, T, H), f(B, T, H)


def _jax_ref(x, mask, gl, w_in, b_in, w_rs, b_rs, d_xo, d_sk):
    """wn_group_ref and its vjp on bf16 arrays -> (x_out, skip), the six gradients."""
    if gl is None:
        out, vjp = jax.vjp(lambda x_, a, b, c, d: wn_group_ref(x_, mask, None, a, b, c, d),
                           x, w_in, b_in, w_rs, b_rs)
        g = vjp((d_xo, d_sk))
        return out, (g[0], None) + tuple(g[1:])
    out, vjp = jax.vjp(lambda x_, g_, a, b, c, d: wn_group_ref(x_, mask, g_, a, b, c, d),
                       x, gl, w_in, b_in, w_rs, b_rs)
    return out, vjp((d_xo, d_sk))


_JAX_REF = jax.jit(_jax_ref)


@functools.lru_cache(maxsize=None)
def _jax_case(i):
    args, d_xo, d_sk = _inputs(CASES[i])
    to_j = lambda t: None if t is None else jnp.asarray(t.float().numpy(), jnp.bfloat16)
    out, grads = _JAX_REF(*map(to_j, args), to_j(d_xo), to_j(d_sk))
    as_t = lambda a: None if a is None else torch.from_numpy(np.asarray(a, np.float32))
    return tuple(map(as_t, out)), tuple(map(as_t, grads))


def _shift(a, s):
    """out[:, t] = a[:, t + s] inside [0, T), zero outside."""
    out = torch.zeros_like(a)
    lo, hi = max(0, -s), min(a.shape[1], a.shape[1] - s)
    if lo < hi:
        out[:, lo:hi] = a[:, lo + s:hi + s]
    return out


def _ordered_sum(parts):
    total = torch.zeros_like(parts[0])
    for q in parts:
        total = total + q
    return total


def _replay_forward(x, mask, gl, w_in, b_in, w_rs, b_rs, plan):
    """The forward kernel's arithmetic -> x_out, skip (bf16), the saves
    (x_i as stored, x_in fp32)."""
    L, k = w_in.shape[:2]
    p, m, xr = (k - 1) // 2, mask.float(), x.float()
    skip = torch.zeros(B * T, H)
    saves_x, saves_xin = [], []
    for i in range(L):
        xs = plan.store(xr)
        saves_x.append(xs)
        a = torch.cat([_shift(plan.load(xs), t - p) for t in range(k)], -1).reshape(-1, k * H)
        bias = b_in[i].float() + (0 if gl is None else gl[:, i].float()[:, None])
        x_in = (a @ w_in[i].float().reshape(k * H, 2 * H)).reshape(B, T, 2 * H) + bias
        saves_xin.append(x_in)
        acts = plan.store(torch.tanh(x_in[..., :H]) * torch.sigmoid(x_in[..., H:]))
        rs = plan.load(acts).reshape(-1, H) @ w_rs[i].float()
        xr = (xr + (rs[:, :H] + b_rs[i, :H].float()).reshape(B, T, H)) * m
        skip = skip + rs[:, H:]
    bias = _ordered_sum([b_rs[i, H:].float() for i in range(L)])
    return (xr.bfloat16(), ((skip + bias).reshape(B, T, H) * m).bfloat16(), saves_x, saves_xin)


def _replay_backward(x, mask, gl, w_in, b_in, w_rs, b_rs, d_xo, d_sk, saves, plan):
    """The backward kernel's arithmetic from the forward's saves -> the six
    gradients (bf16) and the stored intermediates' dtypes."""
    L, k = w_in.shape[:2]
    p, m, (saves_x, saves_xin) = (k - 1) // 2, mask.float(), saves
    ones = torch.ones(1, T)
    dskm = plan.store(d_sk.float() * m)
    d = d_xo.float()
    dxm = plan.store(d * m)
    out = {n: [None] * L for n in ("d_w_in", "d_b_in", "d_w_rs", "d_b_rs", "d_gl")}
    for i in reversed(range(L)):
        d_rs = torch.cat([plan.load(dxm), plan.load(dskm)], -1)
        d_acts = (d_rs.reshape(-1, 2 * H) @ w_rs[i].float().t()).reshape(B, T, H)
        t, s = torch.tanh(saves_xin[i][..., :H]), torch.sigmoid(saves_xin[i][..., H:])
        d_xin = plan.store(torch.cat([d_acts * s * (1 - t * t), d_acts * t * s * (1 - s)], -1))
        acts = plan.store(t * s)
        stored = {"d_xin": d_xin.dtype, "acts": acts.dtype, "d_x_m": dxm.dtype,
                  "d_sk_m": dskm.dtype}
        a = torch.cat([_shift(plan.load(d_xin), p - tau) for tau in range(k)], -1)
        d = d * m + (a.reshape(-1, k * 2 * H)
                     @ w_in[i].float().permute(0, 2, 1).reshape(k * 2 * H, H)).reshape(B, T, H)
        a_in = torch.cat([_shift(plan.load(saves_x[i]), tau - p) for tau in range(k)], -1)
        parts_in = [torch.cat([a_in[z].t(), ones], 0) @ plan.load(d_xin)[z] for z in range(B)]
        parts_rs = [torch.cat([plan.load(acts)[z].t(), ones], 0) @ d_rs[z] for z in range(B)]
        sum_in, sum_rs = _ordered_sum(parts_in), _ordered_sum(parts_rs)
        out["d_w_in"][i], out["d_b_in"][i] = sum_in[:-1].reshape(k, H, 2 * H), sum_in[-1]
        out["d_w_rs"][i], out["d_b_rs"][i] = sum_rs[:-1], sum_rs[-1]
        out["d_gl"][i] = torch.stack([q[-1] for q in parts_in])
        dxm = plan.store(d * m)
    st = {n: torch.stack(v).bfloat16() for n, v in out.items()}
    d_gl = st["d_gl"].transpose(0, 1).contiguous() if gl is not None else None
    return (d.bfloat16(), d_gl, st["d_w_in"], st["d_b_in"], st["d_w_rs"], st["d_b_rs"]), stored


def _replay(case, plan):
    args, d_xo, d_sk = _inputs(case)
    x_out, skip, saves_x, saves_xin = _replay_forward(*args, plan)
    grads, stored = _replay_backward(*args, d_xo, d_sk, (saves_x, saves_xin), plan)
    return (x_out, skip), grads, stored, (saves_x[0].dtype, saves_xin[0].dtype)


def _assert_peak_close(name, got, want):
    err = float((got.float() - want.float()).abs().max())
    peak = float(want.float().abs().max())
    assert err <= TOL * peak, f"{name}: max abs error {err:.3e} > {TOL:.2e} x {peak:.3e}"


@pytest.mark.parametrize("case", range(len(CASES)))
def test_forward_replay_matches_jax_bf16_ref(case):
    """x_out and skip of both plans against JAX's bf16 wn_group_ref."""
    want, _ = _jax_case(case)
    for plan in (NEW, LOAD):
        got = _replay(CASES[case], plan)[0]
        for name, g, w in zip(("x_out", "skip"), got, want):
            assert g.dtype == torch.bfloat16
            _assert_peak_close(f"{plan.name} {name}", g, w)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_backward_replay_matches_jax_bf16_vjp(case):
    """The six gradients of both plans against jax.vjp of the bf16 reference."""
    _, want = _jax_case(case)
    for plan in (NEW, LOAD):
        got = _replay(CASES[case], plan)[1]
        for name, g, w in zip(GRADS, got, want):
            if w is None:
                assert g is None
                continue
            assert g.dtype == torch.bfloat16 and g.shape == w.shape
            _assert_peak_close(f"{plan.name} {name}", g, w)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_bf16_stores_give_the_load_rounding_plans_bits(case):
    """Storing x_i, acts, d_xin, d_x m and d_sk m in bf16 gives the same
    bits as keeping them in fp32 and rounding each operand as it is loaded;
    the new plan keeps them in the dtypes the wrapper says."""
    new, load = _replay(CASES[case], NEW), _replay(CASES[case], LOAD)
    for a, b in zip((*new[0], *new[1]), (*load[0], *load[1])):
        assert (a is None and b is None) or torch.equal(a, b)
    assert set(load[2].values()) == {torch.float32}
    buffers = {name: dt for name, dt, _ in wn.backward_buffers(B, T, H, CASES[case][1],
                                                                torch.bfloat16)}
    assert new[2] == {n: buffers[n] for n in new[2]} == dict.fromkeys(new[2], torch.bfloat16)
    assert new[3] == wn.save_dtypes(torch.bfloat16) and load[3] == (torch.float32,) * 2


def test_save_dtypes_and_backward_workspace():
    """Saves: x_i in the tensors' dtype, x_in fp32. The backward's scratch:
    d_x between layers and the partials in fp32 in both variants (two sets
    in bf16), the bf16 variant's operands in bf16; B T 4H + B (k H + 1) 2H
    + B (H + 1) 2H floats in fp32, B (k H + 1) 2H + B (H + 1) 2H more in
    bf16."""
    assert wn.save_dtypes(torch.float32) == (torch.float32, torch.float32)
    assert wn.save_dtypes(torch.bfloat16) == (torch.bfloat16, torch.float32)
    for b, t, h, k in ((8, 1000, 192, 5), (3, 77, 192, 3), (1, 5, 192, 15)):
        parts = b * (k * h + 1) * 2 * h + b * (h + 1) * 2 * h
        assert wn.backward_workspace(b, t, h, k) == b * t * 4 * h + parts
        assert wn.backward_workspace(b, t, h, k, torch.bfloat16) == b * t * 4 * h + 2 * parts
    bufs = wn.backward_buffers(8, 1000, 192, 5, torch.bfloat16)
    assert [n for n, _, _ in bufs] == ["d_x", "part_in", "part_rs", "d_xin", "acts", "d_x_m",
                                       "d_sk_m"]
    assert {n: dt for n, dt, _ in bufs}["d_x"] == torch.float32
    assert {n: s for n, _, s in bufs}["part_in"] == (2, 8, 5 * 192 + 1, 384)
    # every buffer starts on a 16-byte boundary, as the kernel's tensor maps
    # and vector loads need
    offset = 0
    for _, dt, shape in bufs:
        assert offset % 16 == 0
        offset += int(np.prod(shape)) * (4 if dt == torch.float32 else 2)
    assert offset == 4 * wn.backward_workspace(8, 1000, 192, 5, torch.bfloat16)


def test_plan_forward_bf16():
    """128-row windows in 3-CTA clusters: T0 = 128 - 2 L (k - 1) / 2 frames
    (112 at the posterior encoder's k=5, L=4: a halo share of 12.5%),
    B ceil(T / T0) tiles, for every k the contract takes; a halo that
    leaves no frames raises; the fp32 plans keep their 64-row window."""
    p = wn.plan_forward_bf16(8, 1000, 5, 4)
    assert (p.cluster, p.frames, p.tiles, p.window, p.ctas) == (3, 112, 72, 128, 216)
    assert p.halo_share == 0.125
    assert wn.plan_forward_bf16(1, 5, 3, 1).tiles == 1
    for k in range(1, wn.MAX_TAPS + 1, 2):
        assert wn.plan_forward_bf16(2, 300, k, 4).frames == 128 - 4 * (k - 1)
    with pytest.raises(ValueError):
        wn.plan_forward_bf16(1, 100, 15, 10)  # 2 x 10 x 7 halo rows leave none of 128
    assert wn.plan_forward(8, 1000, 5, 4, one_wave=30).window == wn.WINDOW == 64
