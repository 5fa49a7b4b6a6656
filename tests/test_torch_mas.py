"""Monotonic alignment search: the port (torch_tts_tpu_torch/kernels/mas.py)
against the JAX package, with exact equality.

`maximum_path_plain` (the port of `maximum_path_scan`, the plain version
beside the CUDA kernel) equals the JAX scan and the Pallas kernel run in
interpret mode on the same pre-masked inputs: variable lengths, ties
(integer-valued neg_cent), t_x = 1 and t_y = t_x. The `maximum_path`
wrapper's masking (lengths from the mask, MAX_NEG outside it, path times
the mask) equals the JAX wrapper's, and a CPU tensor launches nothing (the
kernel on a card: tests/test_torch_cuda_kernels.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_tts_tpu.kernels import mas as jmas
from torch_tts_tpu.kernels.mas_pallas import maximum_path_pallas
from torch_tts_tpu_torch.kernels.mas import MAX_NEG, maximum_path, maximum_path_plain


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
