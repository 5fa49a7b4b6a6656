"""The WN stack kernels' contract on the CPU (the JAX parity of the plain
group and of the WN module: tests/test_torch_wn_stack.py, whose helpers
these tests share): the plain backward is autograd of the plain group, a
CPU tensor takes the plain version, the forward's cluster plan, and the
CUDA kernels' products replayed in 3xTF32 (`_replay_forward`,
`_replay_backward`) against the plain version.
"""

import numpy as np
import pytest
import torch

from test_torch_wn_stack import GRAD_NAMES, _group_inputs, _t
from torch_tts_tpu_torch.kernels.mrf_fused import split_tf32
from torch_tts_tpu_torch.kernels.wn_stack import (wn_group, wn_group_backward,
                                                  wn_group_backward_plain, wn_group_plain)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while this module runs: under pytest-xdist a thread
    per core in every worker oversubscribes the cores, which slowed the
    port's tests about twofold and took CPU from the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def test_plan_forward_splits_wider_when_one_wave_holds_the_grid():
    """The forward's planner: 64-row windows (a halo share of at most 25%
    at the flows' k=5, L=4); 4-CTA clusters when every tile fits in one
    wave of them (the H100 holds 30 at once: B=1, T=1024 gives 88 CTAs),
    3-CTA clusters over several waves, and 4-CTA clusters where the 3-CTA
    CTA does not fit in shared memory; a halo that leaves no frames
    raises."""
    from torch_tts_tpu_torch.kernels.wn_stack import (SMEM_BYTES, forward_smem_bytes,
                                                      plan_forward)

    p = plan_forward(1, 1024, 5, 4, one_wave=30)
    assert (p.cluster, p.frames, p.tiles, p.ctas) == (4, 48, 22, 88)
    assert p.halo_share <= 0.25
    assert plan_forward(1, 1024, 5, 4).cluster == 3  # no occupancy given: several waves
    assert plan_forward(8, 1000, 5, 4, one_wave=30).ctas == 8 * 21 * 3
    for k in (3, 5, 9, 11, 13, 15):
        p = plan_forward(2, 300, k, 4)
        assert p.frames == 64 - 8 * (k - 1) // 2 and forward_smem_bytes(p.cluster, k) <= SMEM_BYTES
    assert plan_forward(2, 300, 13, 4).cluster == 4  # the 3-CTA CTA does not fit k=13
    with pytest.raises(ValueError):
        plan_forward(1, 100, 15, 5)  # 2 x 5 x 7 halo rows leave none of 64


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


def _replay_forward(x, mask, gl, w_in, b_in, w_rs, b_rs, mm):
    """The forward kernel's algorithm on the CPU: per layer the k-tap conv
    as one product over the taps' shifted inputs and the 1x1 as another
    (each through `mm`), the gate on the conv's columns; the skip half's
    products summed over the layers before the summed biases and the mask."""
    B, T, H = x.shape
    L, k = w_in.shape[:2]
    p = (k - 1) // 2
    skip = torch.zeros(B * T, H)
    for i in range(L):
        a_conv = torch.cat([_shift(x, t - p) for t in range(k)], -1).reshape(-1, k * H)
        x_in = mm(a_conv, w_in[i].reshape(k * H, 2 * H)) + b_in[i]
        if gl is not None:
            x_in = x_in + gl[:, i].repeat_interleave(T, 0)
        acts = torch.tanh(x_in[:, :H]) * torch.sigmoid(x_in[:, H:])
        rs = mm(acts, w_rs[i])
        x = (x + (rs[:, :H] + b_rs[i, :H]).reshape(B, T, H)) * mask
        skip = skip + rs[:, H:]
    return x, (skip + b_rs[:, H:].sum(0)).reshape(B, T, H) * mask


def test_forward_replay_in_3xtf32_matches_plain():
    """The forward kernel's products replayed in 3xTF32 stay within 1e-5 of
    the plain group, with conditioning and ragged lengths; with the hi parts
    alone (1xTF32) they do not."""
    args = tuple(map(_t, _group_inputs(np.random.default_rng(9), B=2, T=21, H=8, L=3)))
    want = wn_group_plain(*args)
    got = _replay_forward(*args, _mm_3xtf32)
    for name, g, w in zip(("x_out", "skip"), got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5, msg=name)
    one = _replay_forward(*args, lambda a, b: split_tf32(a)[0] @ split_tf32(b)[0])
    assert max(float((g - w).abs().max()) for g, w in zip(one, want)) > 1e-4
