"""LLTM gated cell: the port (torch_tts_tpu_torch/kernels/gated_cell.py)
against the JAX package, at the JAX kernel test's size (B=4, I=6, H=8) and
at the PyTorch extension tutorial's (B=16, I=32, H=128).

- `lltm_ref` and the kernel contract's plain forward (`new_h`, `new_cell`
  and the raw `gates`) against the JAX `lltm_ref` and the Pallas kernel
  `_lltm_fwd_pallas` run in interpret mode: rtol 1e-5, atol 1e-6 (fp32, the
  gate product summed in another order);
- `lltm`'s analytic backward against `jax.grad` of the JAX `lltm` (its
  `custom_vjp`), all five gradients, rtol 1e-4, atol 1e-5 (the JAX kernel
  test's tolerance); also against autograd of the port's `lltm_ref`;
- the backward returns None for inputs that need no gradient;
- `kernel_args`, the card path's input rule: bf16, fp16 and strided inputs
  become the contiguous fp32 tensors that the JAX wrapper casts its inputs
  to before its kernel, and the plain forward on them matches the Pallas
  kernel on the same bf16 inputs (rtol 1e-5, atol 1e-6); complex input
  raises; gradients keep each leaf's dtype;
- the plain forward at B=512, I=32, H=128 against the JAX `lltm_ref`.

The kernel itself runs on a card: tests/test_torch_cuda_kernels.py.
"""

import functools
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_tts_tpu.kernels import gated_cell as jgc
from torch_tts_tpu_torch.kernels import gated_cell as gc

FWD_RTOL, FWD_ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
SHAPES = [(4, 6, 8), (16, 32, 128)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while this module runs: under pytest-xdist a thread
    per core in every worker oversubscribes the cores, which slowed the
    port's tests about twofold and took CPU from the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, I, H):
    rng = np.random.default_rng(B * 1000 + H)
    return [rng.standard_normal((B, I)).astype(np.float32),
            (rng.standard_normal((3 * H, H + I)) * 0.3).astype(np.float32),
            (rng.standard_normal((3 * H,)) * 0.1).astype(np.float32),
            rng.standard_normal((B, H)).astype(np.float32),
            rng.standard_normal((B, H)).astype(np.float32)]


def _loss(h, c, sin):
    return (h ** 2).sum() + sin(c).sum()


@pytest.mark.parametrize("B,I,H", SHAPES)
def test_forward_and_gates_match_jax(B, I, H):
    args = _inputs(B, I, H)
    # the JAX functions under jax.jit: one compile instead of one per op
    new_h, new_c, gates = (np.asarray(a) for a in jax.jit(functools.partial(
        jgc._lltm_fwd_pallas, interpret=True))(*map(jnp.asarray, args)))
    ref_h, ref_c = (np.asarray(a) for a in jax.jit(jgc.lltm_ref)(*map(jnp.asarray, args)))
    targs = list(map(torch.from_numpy, args))
    got = [t.numpy() for t in gc.lltm_forward_plain(*targs)]
    for a, b in zip(got, (new_h, new_c, gates)):
        np.testing.assert_allclose(a, b, rtol=FWD_RTOL, atol=FWD_ATOL)
    for a, b in zip(gc.lltm_ref(*targs), (ref_h, ref_c)):
        np.testing.assert_allclose(a.numpy(), b, rtol=FWD_RTOL, atol=FWD_ATOL)
    before = gc.lltm.launches
    for a, b in zip(gc.lltm(*targs), (ref_h, ref_c)):
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=FWD_RTOL, atol=FWD_ATOL)
    assert gc.lltm.launches == before  # the CPU takes the plain forward


@pytest.mark.parametrize("B,I,H", SHAPES)
def test_gradients_match_jax(B, I, H):
    args = _inputs(B, I, H)
    want = jax.jit(jax.grad(lambda *a: _loss(*jgc.lltm(*a), jnp.sin),
                            argnums=(0, 1, 2, 3, 4)))(*map(jnp.asarray, args))
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    _loss(*gc.lltm(*ts), torch.sin).backward()
    refs = [torch.from_numpy(a).requires_grad_() for a in args]
    _loss(*gc.lltm_ref(*refs), torch.sin).backward()
    for t, r, w in zip(ts, refs, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=GRAD_RTOL, atol=GRAD_ATOL)
        np.testing.assert_allclose(t.grad.numpy(), r.grad.numpy(), rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_backward_honours_needs_input_grad():
    x, weights, bias, old_h, old_cell = map(torch.from_numpy, _inputs(4, 6, 8))
    _, new_cell, gates = gc.lltm_forward_plain(x, weights, bias, old_h, old_cell)
    ctx = types.SimpleNamespace(
        saved_tensors=(torch.cat([old_h, x], dim=1), gates, new_cell, weights),
        needs_input_grad=(False, True, False, False, False))
    grads = gc._LLTMFunction.backward(ctx, torch.ones_like(old_h), torch.ones_like(old_cell))
    assert [g is None for g in grads] == [True, False, True, True, True]
    weights.requires_grad_()
    new_h, new_c = gc.lltm(x, weights, bias, old_h, old_cell)
    (new_h.sum() + new_c.sum()).backward()
    torch.testing.assert_close(weights.grad, grads[1])


def _bf16_inputs(B, I, H, T=3):
    """bf16 inputs with x a strided view x_seq[:, 1] of a [B, T, I]
    sequence, as the tutorial's loop passes it; numpy and JAX arrays of the
    same bf16 values."""
    args = _inputs(B, I, H)
    x_seq = np.repeat(args[0][:, None], T, axis=1) * np.arange(1, T + 1, dtype=np.float32)[:, None]
    targs = [torch.from_numpy(a).to(torch.bfloat16) for a in [x_seq] + args[1:]]
    jargs = [jnp.asarray(a).astype(jnp.bfloat16) for a in [x_seq] + args[1:]]
    return [targs[0][:, 1]] + targs[1:], [jargs[0][:, 1]] + jargs[1:]


def test_kernel_args_cast_like_the_jax_kernel():
    """The card path's input rule, checked on the CPU: every input is cast
    to a contiguous fp32 tensor, as the JAX wrapper casts before its kernel,
    and the plain forward on the cast inputs gives what the Pallas kernel
    gives on the same bf16 inputs, fp32 outputs included."""
    targs, jargs = _bf16_inputs(16, 32, 128)
    assert not targs[0].is_contiguous()
    got = gc.kernel_args(*targs)
    for a, t in zip(got, targs):
        assert a.dtype == torch.float32 and a.is_contiguous()
        assert torch.equal(a, t.float())
    fp16 = gc.kernel_args(*(t.to(torch.float16) for t in targs))
    assert all(a.dtype == torch.float32 and a.is_contiguous() for a in fp16)
    f32 = list(map(torch.from_numpy, _inputs(4, 6, 8)))
    assert all(a.data_ptr() == t.data_ptr() for a, t in zip(gc.kernel_args(*f32), f32))
    want = jax.jit(functools.partial(jgc._lltm_fwd_pallas, interpret=True))(*jargs)
    for a, b in zip(gc.lltm_forward_plain(*got), want):
        assert b.dtype == jnp.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=FWD_RTOL, atol=FWD_ATOL)


def test_kernel_args_refuses_complex_and_misshapen_input():
    args = list(map(torch.from_numpy, _inputs(4, 6, 8)))
    for i in range(5):
        bad = list(args)
        bad[i] = bad[i].to(torch.complex64)
        with pytest.raises(ValueError, match="real"):
            gc.kernel_args(*bad)
    with pytest.raises(ValueError, match="x \\[B, I\\]"):
        gc.kernel_args(args[0], args[1][:, 1:], *args[2:])


def test_gradients_keep_each_leafs_dtype():
    """bf16 leaves get bf16 gradients, as jax.grad of the JAX `lltm` gives
    (autograd casts each gradient of the Function to its input's dtype)."""
    targs, _ = _bf16_inputs(4, 6, 8)
    leaves = [t.detach().clone().requires_grad_() for t in targs]
    _loss(*gc.lltm(*leaves), torch.sin).backward()
    for leaf in leaves:
        assert leaf.grad.dtype == torch.bfloat16 and bool(torch.isfinite(leaf.grad).all())


def test_forward_at_a_large_batch_matches_jax():
    """B=512, I=32, H=128: a batch whose [h, x] rows do not fit one CTA's
    shared memory (the card's kernel tiles B)."""
    args = _inputs(512, 32, 128)
    want = jax.jit(jgc.lltm_ref)(*map(jnp.asarray, args))
    for a, b in zip(gc.lltm_ref(*map(torch.from_numpy, args)), want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=FWD_RTOL, atol=FWD_ATOL)
