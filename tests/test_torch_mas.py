"""Monotonic alignment search: the port (torch_tts_tpu_torch/kernels/mas.py)
against the JAX package, with exact equality.

`maximum_path_plain` (the port of `maximum_path_scan`, the plain version
beside the CUDA kernel) equals the JAX scan and the Pallas kernel run in
interpret mode on the same pre-masked inputs: variable lengths, ties
(integer-valued neg_cent), t_x = 1 and t_y = t_x. The `maximum_path`
wrapper's masking (lengths from the mask, MAX_NEG outside it, path times
the mask) equals the JAX wrapper's, and a CPU tensor launches nothing (the
kernel on a card: tests/test_torch_cuda_kernels.py). The kernel's
algorithm (its move-bit layout and its warp-wide backtrack) replayed on the
CPU gives the plain version's path exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_tts_tpu.kernels import mas as jmas
from torch_tts_tpu.kernels.mas_pallas import maximum_path_pallas
from torch_tts_tpu_torch.kernels.mas import (MAX_NEG, cols_per_lane, maximum_path,
                                             maximum_path_plain)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while this module runs: under pytest-xdist a thread
    per core in every worker oversubscribes the cores, which slowed the
    port's tests about twofold and took CPU from the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(rng, B, T_y, T_x, ties=False, t_ys=None, t_xs=None):
    nc = rng.standard_normal((B, T_y, T_x)) * 3
    if ties:
        nc = np.round(nc)
    nc = nc.astype(np.float32)
    if t_ys is None:
        t_ys = rng.integers(T_y // 2, T_y + 1, B)
        t_ys[0] = T_y
    if t_xs is None:
        t_xs = np.minimum(rng.integers(1, T_x + 1, B), t_ys)
        t_xs[0] = T_x
    t_ys, t_xs = np.asarray(t_ys, np.int32), np.asarray(t_xs, np.int32)
    mask = ((np.arange(T_y)[None, :, None] < t_ys[:, None, None])
            & (np.arange(T_x)[None, None, :] < t_xs[:, None, None])).astype(np.float32)
    return nc, mask, t_ys, t_xs


B, T_Y, T_X = 4, 40, 13  # one shape for every case: JAX compiles the scan and the kernel once
CASES = {
    "ragged": dict(),
    "ties": dict(ties=True),
    "t_x=1": dict(t_ys=[40, 5, 17, 1], t_xs=[1, 1, 1, 1]),
    "t_y=t_x": dict(ties=True, t_ys=[13, 9, 4, 1], t_xs=[13, 9, 4, 1]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_equals_jax_scan_and_pallas_interpret(case):
    nc, mask, t_ys, t_xs = _batch(np.random.default_rng(len(case)), B, T_Y, T_X, **CASES[case])
    masked = np.where(mask > 0, nc, jmas.MAX_NEG).astype(np.float32)
    got = maximum_path_plain(torch.from_numpy(masked), torch.from_numpy(t_ys),
                             torch.from_numpy(t_xs)).numpy()
    scan = np.asarray(jmas.maximum_path_scan(jnp.asarray(masked), jnp.asarray(t_ys),
                                             jnp.asarray(t_xs)))
    pallas = np.asarray(maximum_path_pallas(jnp.asarray(masked), jnp.asarray(t_ys),
                                            jnp.asarray(t_xs), interpret=True))
    np.testing.assert_array_equal(got, scan)
    np.testing.assert_array_equal(got * mask, pallas * mask)
    # one frame per row inside each item, nothing past t_y
    np.testing.assert_array_equal((got * mask).sum(2),
                                  (np.arange(nc.shape[1])[None] < t_ys[:, None]).astype(np.float32))


@pytest.mark.parametrize("ties", [False, True])
def test_wrapper_masks_like_the_jax_wrapper(ties):
    nc, mask, _, _ = _batch(np.random.default_rng(5), B, T_Y, T_X, ties=ties)
    before = maximum_path.launches
    got = maximum_path(torch.from_numpy(nc), torch.from_numpy(mask))
    assert maximum_path.launches == before
    want = np.asarray(jmas.maximum_path(jnp.asarray(nc), jnp.asarray(mask), use_pallas=False))
    np.testing.assert_array_equal(got.numpy(), want)
    assert MAX_NEG == jmas.MAX_NEG


def _replay_kernel(nc, ty, tx):
    """csrc/mas.cu's algorithm for one item -> the path's index per row
    [ty]. The DP in fp32 over rows padded with MAX_NEG to 32 CPL columns
    (lane l owns columns l CPL .. l CPL + CPL - 1); the move bit of (y, x)
    is bit y % 32 of word [y / 32][x % CPL][x / CPL]. The backtrack takes
    one 32-row block at a time from the top: lane d reads the word of
    column X - d (X the block's entry column) and adds the forced move at
    row y = x; 32 ballots turn the words into t[r], whose bit d says the
    walk moves at row r when it is d columns left of X."""
    neg = np.float32(MAX_NEG)
    cpl = cols_per_lane(nc.shape[1])
    rows = np.full((nc.shape[0], 32 * cpl), neg, np.float32)
    rows[:, :nc.shape[1]] = nc
    x = np.arange(32 * cpl)
    bits = np.zeros(-(-nc.shape[0] // 32) * cpl * 32, np.int64)
    v = np.where(x == 0, rows[0], neg)
    for y in range(1, ty):
        left = np.concatenate([[neg], v[:-1]])
        moved = x[v < left]
        np.bitwise_or.at(bits, ((y >> 5) * cpl + moved % cpl) * 32 + moved // cpl, 1 << (y & 31))
        v = np.maximum(rows[y] + np.maximum(np.where(x == y, neg, v), left), neg)
    rec = np.zeros(ty, np.int64)
    X = max(tx - 1, 0)
    for blk in range((ty - 1) >> 5, -1, -1):
        y0 = blk * 32
        t = [0] * 32
        for d in range(32):
            xd = X - d
            if xd > 0:
                m = int(bits[(blk * cpl + xd % cpl) * 32 + xd // cpl])
                if y0 <= xd < y0 + 32:
                    m |= 1 << (xd - y0)
                for r in range(32):
                    t[r] |= (m >> r & 1) << d
        d = 0
        for r in range(min(ty - 1 - y0, 31), -1, -1):
            rec[y0 + r] = X - d
            d += t[r] >> d & 1
        X -= d
    return rec


@pytest.mark.parametrize("T_y,T_x,ties", [
    (70, 20, False),   # one column a lane
    (45, 45, True),    # two, T_x not a multiple of 32
    (150, 192, True),  # six (the train shape's T_x), rows over five blocks
    (40, 500, False),  # sixteen
])
def test_kernel_replay_equals_plain(T_y, T_x, ties):
    nc, mask, t_ys, t_xs = _batch(np.random.default_rng(T_y + T_x), 3, T_y, T_x, ties=ties)
    masked = np.where(mask > 0, nc, MAX_NEG).astype(np.float32)
    want = maximum_path_plain(torch.from_numpy(masked), torch.from_numpy(t_ys),
                              torch.from_numpy(t_xs)).numpy()
    got = np.zeros_like(want)
    for b in range(3):
        rec = _replay_kernel(masked[b], int(t_ys[b]), int(t_xs[b]))
        got[b, np.arange(len(rec)), rec] = 1
    np.testing.assert_array_equal(got, want)
