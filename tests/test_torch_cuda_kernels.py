"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Imports no jax, so it runs where only torch is installed; every test skips
without CUDA. On the card, from the repository root:

    python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py

TF32 is off, so both sides compute in fp32; they differ only in summation
order (rtol 1e-4, atol 1e-4). MAS must equal its plain version exactly. WN
gradients: per tensor, max |kernel - plain| <= 1e-4 * max |plain| + 1e-5
(sums over up to B*T frames in another order).
"""

import pytest
import torch

from torch_tts_tpu_torch.kernels.mas import MAX_NEG, maximum_path, maximum_path_plain
from torch_tts_tpu_torch.kernels.mrf_fused import dilated_offsets, mrf_fused, mrf_plain
from torch_tts_tpu_torch.kernels.wn_stack import (
    wn_group, wn_group_backward, wn_group_backward_plain, wn_group_plain, wn_stack)

RTOL, ATOL = 1e-4, 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(g, device, *shape, scale=1.0):
    return (torch.randn(shape, generator=g) * scale).to(device)


def _blocks(g, device, C, kernel_sizes, dil=(1, 3, 5)):
    return tuple(
        tuple(tuple((dilated_offsets(k, dd), _randn(g, device, k * C, C, scale=0.5 / (k * C) ** 0.5),
                     _randn(g, device, C, scale=0.1)) for dd in (d, 1)) for d in dil)
        for k in kernel_sizes)


@pytest.mark.cuda
@pytest.mark.parametrize("C,T,kernel_sizes", [
    (128, 3001, (3, 7, 11)), (64, 517, (3, 7, 11)), (32, 9000, (3, 7, 11)),
    (128, 40, (11,)), (32, 333, (3, 5)),
])
def test_mrf_kernel_matches_plain(cuda_device, C, T, kernel_sizes):
    g = torch.Generator().manual_seed(C + T)
    blocks = _blocks(g, cuda_device, C, kernel_sizes)
    x = _randn(g, cuda_device, 2, T, C)
    before = mrf_fused.launches
    out = mrf_fused(x, blocks)
    assert mrf_fused.launches == before + 1
    torch.testing.assert_close(out, mrf_plain(x, blocks), rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_mrf_rejects_unsupported_input(cuda_device):
    g = torch.Generator().manual_seed(0)
    blocks = _blocks(g, cuda_device, 16, (3,))
    with pytest.raises(ValueError):
        mrf_fused(_randn(g, cuda_device, 1, 50, 16), blocks)
    blocks = _blocks(g, cuda_device, 32, (3,))
    with pytest.raises(ValueError):
        mrf_fused(_randn(g, cuda_device, 1, 50, 32).double(), blocks)


def _wn_args(g, device, B, T, H, L, k=5, with_gl=False):
    lengths = torch.tensor([T - 13 * i for i in range(B)])
    mask = (torch.arange(T)[None, :] < lengths[:, None]).float()[:, :, None].to(device)
    w_rs = _randn(g, device, L, H, 2 * H, scale=0.5 / H ** 0.5)
    b_rs = _randn(g, device, L, 2 * H, scale=0.1)
    w_rs[-1, :, :H] = 0
    b_rs[-1, :H] = 0
    gl = _randn(g, device, B, L, 2 * H) if with_gl else None
    return (_randn(g, device, B, T, H), mask, gl,
            _randn(g, device, L, k, H, 2 * H, scale=0.5 / (k * H) ** 0.5),
            _randn(g, device, L, 2 * H, scale=0.1), w_rs, b_rs)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,L,with_gl", [
    (1, 1024, 192, 4, False), (3, 77, 192, 4, True), (2, 500, 192, 3, True), (2, 5, 192, 2, False),
])
def test_wn_kernel_matches_plain(cuda_device, B, T, H, L, with_gl):
    g = torch.Generator().manual_seed(B * T + H)
    args = _wn_args(g, cuda_device, B, T, H, L, with_gl=with_gl)
    before = wn_group.launches
    out = wn_group(*args)
    assert wn_group.launches == before + 1
    for a, b in zip(out, wn_group_plain(*args)):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_wn_stack_chains_groups(cuda_device):
    g = torch.Generator().manual_seed(7)
    args = _wn_args(g, cuda_device, 2, 300, 192, 16, with_gl=True)
    x, mask, gl, w_in, b_in, w_rs, b_rs = args
    skip = wn_stack(*args)
    ref, xr = None, x
    for s in range(0, 16, 4):
        xr, sk = wn_group_plain(xr, mask, gl[:, s:s + 4], w_in[s:s + 4], b_in[s:s + 4],
                                w_rs[s:s + 4], b_rs[s:s + 4])
        ref = sk if ref is None else ref + sk
    torch.testing.assert_close(skip, ref, rtol=RTOL, atol=ATOL)


def _assert_grad_close(name, got, want):
    err = float((got - want).abs().max())
    bound = 1e-4 * float(want.abs().max()) + 1e-5
    assert err <= bound, f"{name}: max abs error {err:.3e} > {bound:.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,L,with_gl", [(2, 300, 4, True), (3, 77, 3, False), (1, 5, 2, True)])
def test_wn_backward_kernel_matches_autograd_of_plain(cuda_device, B, T, L, with_gl):
    g = torch.Generator().manual_seed(B * T + L)
    args = _wn_args(g, cuda_device, B, T, 192, L, with_gl=with_gl)
    d_xo, d_sk = _randn(g, cuda_device, B, T, 192), _randn(g, cuda_device, B, T, 192)
    before = wn_group_backward.launches
    got = wn_group_backward(*args, d_xo, d_sk)
    assert wn_group_backward.launches == before + 1
    want = wn_group_backward_plain(*args, d_xo, d_sk)
    for name, a, b in zip(("d_x", "d_gl", "d_w_in", "d_b_in", "d_w_rs", "d_b_rs"), got, want):
        if b is None:
            assert a is None
            continue
        _assert_grad_close(name, a, b)


@pytest.mark.cuda
def test_wn_group_autograd_runs_the_backward_kernel(cuda_device):
    g = torch.Generator().manual_seed(3)
    args = [a.requires_grad_() if a is not None and i != 1 else a
            for i, a in enumerate(_wn_args(g, cuda_device, 2, 128, 192, 4, with_gl=True))]
    before = (wn_group.launches, wn_group_backward.launches)
    x_out, skip = wn_group(*args)
    (x_out.square().sum() + skip.sum()).backward()
    assert (wn_group.launches, wn_group_backward.launches) == (before[0] + 1, before[1] + 1)
    ref = [a.detach().clone().requires_grad_() if a is not None and i != 1 else a
           for i, a in enumerate(args)]
    xr, sr = wn_group_plain(*ref)
    (xr.square().sum() + sr.sum()).backward()
    for i, (a, b) in enumerate(zip(args, ref)):
        if i != 1:
            _assert_grad_close(f"arg {i}", a.grad, b.grad)


def _mas_batch(g, device, B, T_y, T_x, ties=False):
    t_ys = torch.randint(T_y // 2, T_y + 1, (B,), generator=g)
    t_xs = torch.minimum(torch.randint(1, T_x + 1, (B,), generator=g), t_ys)
    t_ys[0], t_xs[0] = T_y, T_x
    nc = torch.randn(B, T_y, T_x, generator=g) * 3
    if ties:
        nc = torch.round(nc)
    mask = ((torch.arange(T_y)[None, :, None] < t_ys[:, None, None])
            & (torch.arange(T_x)[None, None, :] < t_xs[:, None, None])).float()
    return nc.to(device), mask.to(device), t_ys.to(device), t_xs.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T_y,T_x,ties", [
    (8, 1000, 192, False), (8, 1000, 192, True), (3, 70, 33, True), (2, 9, 1, False),
    (2, 300, 300, True), (1, 20000, 64, False),
])
def test_mas_kernel_equals_plain(cuda_device, B, T_y, T_x, ties):
    g = torch.Generator().manual_seed(T_y + T_x)
    nc, mask, t_ys, t_xs = _mas_batch(g, cuda_device, B, T_y, T_x, ties)
    before = maximum_path.launches
    path = maximum_path(nc, mask)
    assert maximum_path.launches == before + 1
    masked = torch.where(mask > 0, nc, torch.full((), MAX_NEG, device=nc.device))
    want = maximum_path_plain(masked, t_ys, t_xs) * mask
    assert torch.equal(path, want)
    assert torch.equal(path.sum(dim=2), (torch.arange(T_y, device=nc.device)[None, :]
                                        < t_ys[:, None]).float())
