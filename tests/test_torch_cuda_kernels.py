"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Imports no jax, so it runs where only torch is installed; every test skips
without CUDA. On the card, from the repository root:

    python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py

TF32 is off, so both sides compute in fp32; they differ only in summation
order (rtol 1e-4, atol 1e-4). MAS must equal its plain version exactly. The
log-mel of the STFT+mel kernel is held within 1e-3 abs of its plain version
(the log turns a small mel value's relative error into an absolute one). WN
gradients: per tensor, max |kernel - plain| <= 1e-4 * max |plain| + 1e-5
(sums over up to B*T frames in another order). The Taco2Prod step with
bf16 LSTM matrices is held against the plain step given the same
bf16-rounded matrices in fp32, so its tolerance stays the fp32 one. The
bf16 WN kernels: within 2^-5 of the output's peak of their plain versions in
bf16 (which round after every op), and within 2^-6 of the fp32 plain
versions on the same bf16 values.
"""

import pytest
import torch

from torch_tts_tpu_torch.kernels import gated_cell as gc
from torch_tts_tpu_torch.kernels import stft
from torch_tts_tpu_torch.kernels import taco_step as ts
from torch_tts_tpu_torch.kernels.mas import MAX_NEG, maximum_path, maximum_path_plain
from torch_tts_tpu_torch.kernels.mrf_fused import dilated_offsets, mrf_fused, mrf_plain
from torch_tts_tpu_torch.kernels import mas, wn_stack as wn
from torch_tts_tpu_torch.kernels.wn_stack import (
    wn_group, wn_group_backward, wn_group_backward_plain, wn_group_plain, wn_stack)

RTOL, ATOL = 1e-4, 1e-4
MEL_ATOL = 1e-3


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


def _plain_layer_saves(x, mask, gl, w_in, b_in, w_rs, b_rs):
    """Each layer's input [L, B, T, H] and pre-activation [L, B, T, 2H] of
    the plain group, as the saving forward writes them."""
    L, k, H = w_in.shape[0], w_in.shape[1], x.shape[-1]
    xc, m = x.transpose(1, 2).contiguous(), mask.transpose(1, 2)
    xs, x_ins = [], []
    for i in range(L):
        xs.append(xc.transpose(1, 2))
        x_in = torch.nn.functional.conv1d(xc, w_in[i].permute(2, 1, 0), b_in[i], padding=(k - 1) // 2)
        if gl is not None:
            x_in = x_in + gl[:, i, :, None]
        x_ins.append(x_in.transpose(1, 2))
        acts = torch.tanh(x_in[:, :H]) * torch.sigmoid(x_in[:, H:])
        rs = torch.nn.functional.conv1d(acts, w_rs[i].t()[:, :, None], b_rs[i])
        xc = (xc + rs[:, :H]) * m
    return torch.stack(xs), torch.stack(x_ins)


WN_FORWARD_CASES = (
    (2, 1000, 4, 5),  # ragged lengths, per-layer gl, the train shape's T
    (3, 77, 4, 5),    # T not a multiple of the tile's 48 frames
    (2, 5, 4, 5),     # T shorter than the halo (8 frames a side)
    (2, 300, 4, 15),  # the widest kernel the contract takes
)


@pytest.mark.cuda
@pytest.mark.parametrize("cluster,B,T,L,k", [
    (cluster, *case) for cluster in wn.FORWARD_CLUSTERS for case in WN_FORWARD_CASES
    if wn.forward_smem_bytes(cluster, case[3]) <= wn.SMEM_BYTES])
def test_wn_forward_plans_with_gl_and_ragged_lengths(cuda_device, cluster, B, T, L, k):
    """Each cluster size that fits, with per-layer conditioning and ragged
    lengths, against the plain group; the saving variant's x_i and x_in
    against the plain group's layer inputs and pre-activations."""
    frames = wn.WINDOW - 2 * L * ((k - 1) // 2)
    g = torch.Generator().manual_seed(B * T + k)
    args = _wn_args(g, cuda_device, B, T, 192, L, k=k, with_gl=True)
    want = wn_group_plain(*args)
    want_x, want_xin = _plain_layer_saves(*args)
    p = wn.ForwardPlan(cluster, frames, B * -(-T // frames))
    for save in (False, True):
        x_out, skip, saved = wn._forward_cuda(*args, save=save, plan=p)
        torch.testing.assert_close(x_out, want[0], rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(skip, want[1], rtol=RTOL, atol=ATOL)
        if save:
            torch.testing.assert_close(saved[0], want_x, rtol=RTOL, atol=ATOL)
            torch.testing.assert_close(saved[1], want_xin, rtol=RTOL, atol=ATOL)


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
def test_wn_backward_kernel_is_deterministic(cuda_device):
    """Split-K in a fixed order, no atomics: two runs at the train shape
    give the same bits."""
    g = torch.Generator().manual_seed(5)
    args = _wn_args(g, cuda_device, 8, 1000, 192, 4, with_gl=True)
    d_xo, d_sk = _randn(g, cuda_device, 8, 1000, 192), _randn(g, cuda_device, 8, 1000, 192)
    first = wn_group_backward(*args, d_xo, d_sk)
    again = wn_group_backward(*args, d_xo, d_sk)
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    for name, a, b in zip(("d_x", "d_gl", "d_w_in", "d_b_in", "d_w_rs", "d_b_rs"), first,
                          wn_group_backward_plain(*args, d_xo, d_sk)):
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


BF16_RTOL = 2.0 ** -5  # of the peak: the bf16 kernels against their plain versions in bf16
BF16_FP32_RTOL = 2.0 ** -6  # ... and against the fp32 plain versions on the same bf16 values


def _bf16(args):
    return tuple(None if a is None else a.bfloat16().contiguous() for a in args)


def _widened(args):
    return tuple(None if a is None else a.float() for a in args)


def _assert_peak_close(name, got, want, rtol):
    err = float((got.float() - want.float()).abs().max())
    peak = float(want.float().abs().max())
    assert err <= rtol * peak, f"{name}: max abs error {err:.3e} > {rtol:.2e} x {peak:.3e}"


# the bf16 kernels' cases: the train shape with ragged lengths, T not a
# multiple of the window's 112 frames, T shorter than the halo, the widest
# kernel, B=1, k=3 and 7, a one-layer group
WN_BF16_CASES = (
    (2, 1000, 4, 5), (3, 77, 4, 5), (2, 5, 4, 5), (2, 300, 4, 15), (1, 300, 4, 5),
    (2, 130, 1, 3), (1, 200, 3, 7),
)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,L,k", WN_BF16_CASES)
def test_wn_bf16_forward_matches_plain(cuda_device, B, T, L, k):
    """The bf16 forward (its one plan, gl, ragged lengths, with and without
    saves) against the plain group in bf16 and the fp32 plain group on the
    same bf16 values; bf16 outputs, the saves in `save_dtypes` (x_i bf16,
    x_in fp32), a bf16 launch count, the same bits twice; another plan
    raises."""
    g = torch.Generator().manual_seed(B * T + k + 1)
    args = _bf16(_wn_args(g, cuda_device, B, T, 192, L, k=k, with_gl=True))
    want, want32 = wn_group_plain(*args), wn_group_plain(*_widened(args))
    want_x, want_xin = _plain_layer_saves(*_widened(args))
    for save in (False, True):
        before = (wn_group.launches, wn_group.launches_bf16)
        x_out, skip, saved = wn._forward_cuda(*args, save=save)
        assert (wn_group.launches, wn_group.launches_bf16) == (before[0], before[1] + 1)
        for name, a, b, b32 in zip(("x_out", "skip"), (x_out, skip), want, want32):
            assert a.dtype == torch.bfloat16
            _assert_peak_close(name, a, b, BF16_RTOL)
            _assert_peak_close(name + " (fp32 plain)", a, b32, BF16_FP32_RTOL)
        again = wn._forward_cuda(*args, save=save)
        assert torch.equal(x_out, again[0]) and torch.equal(skip, again[1])
        if save:
            assert (saved[0].dtype, saved[1].dtype) == wn.save_dtypes(torch.bfloat16)
            _assert_peak_close("x_i", saved[0], want_x, BF16_FP32_RTOL)
            _assert_peak_close("x_in", saved[1], want_xin, BF16_FP32_RTOL)
            assert torch.equal(saved[0], again[2][0]) and torch.equal(saved[1], again[2][1])
    with pytest.raises(ValueError):
        wn._forward_cuda(*args, save=False, plan=wn.ForwardPlan(4, 48, B * -(-T // 48)))


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,L,k,with_gl", [
    (8, 1000, 4, 5, True), (3, 77, 3, 5, False), (1, 5, 2, 5, True), (1, 300, 4, 3, True),
    (2, 130, 1, 7, False)])
def test_wn_bf16_backward_matches_plain(cuda_device, B, T, L, k, with_gl):
    """The bf16 backward against autograd of the plain group in bf16 and in
    fp32 on the same values; every gradient bf16; the same bits twice."""
    g = torch.Generator().manual_seed(B * T + L + 1)
    args = _bf16(_wn_args(g, cuda_device, B, T, 192, L, k=k, with_gl=with_gl))
    d_xo, d_sk = (_randn(g, cuda_device, B, T, 192).bfloat16() for _ in range(2))
    before = (wn_group_backward.launches, wn_group_backward.launches_bf16)
    got = wn_group_backward(*args, d_xo, d_sk)
    assert (wn_group_backward.launches, wn_group_backward.launches_bf16) == (
        before[0], before[1] + 1)
    want = wn_group_backward_plain(*args, d_xo, d_sk)
    want32 = wn_group_backward_plain(*_widened(args), d_xo.float(), d_sk.float())
    again = wn_group_backward(*args, d_xo, d_sk)
    for name, a, b, b32, a2 in zip(("d_x", "d_gl", "d_w_in", "d_b_in", "d_w_rs", "d_b_rs"),
                                   got, want, want32, again):
        if b is None:
            assert a is None
            continue
        assert a.dtype == torch.bfloat16 and torch.equal(a, a2)
        _assert_peak_close(name, a, b, BF16_RTOL)
        _assert_peak_close(name + " (fp32 plain)", a, b32, BF16_FP32_RTOL)


@pytest.mark.cuda
def test_wn_bf16_autograd_and_refusals(cuda_device):
    """A bf16 group under autograd runs both bf16 kernels; wn_stack casts
    the weights to x's dtype; a mix of dtypes or fp16 at the kernel raises."""
    g = torch.Generator().manual_seed(11)
    args = [a.requires_grad_() if a is not None and i != 1 else a
            for i, a in enumerate(_bf16(_wn_args(g, cuda_device, 2, 128, 192, 4, with_gl=True)))]
    before = (wn_group.launches_bf16, wn_group_backward.launches_bf16)
    x_out, skip = wn_group(*args)
    (x_out.float().square().sum() + skip.float().sum()).backward()
    assert (wn_group.launches_bf16, wn_group_backward.launches_bf16) == (
        before[0] + 1, before[1] + 1)
    assert all(a.grad.dtype == torch.bfloat16 for i, a in enumerate(args) if i != 1)
    plain = _wn_args(g, cuda_device, 2, 64, 192, 4)
    mixed = (plain[0].bfloat16(), *plain[1:])
    with pytest.raises(ValueError):
        wn_group(*mixed)
    with pytest.raises(ValueError):
        wn_group(*(None if a is None else a.half() for a in plain))
    out = wn_stack(plain[0], *_bf16(plain[1:]))
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, wn_stack(plain[0], *_widened(_bf16(plain[1:]))),
                               rtol=RTOL, atol=ATOL)


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


@pytest.mark.cuda
@pytest.mark.parametrize("B,T_y,T_x,ties", [
    (2, 700, 512, True),    # the widest text the kernel takes
    (3, 1000, 192, False),  # rows far past the three-slot, 96-row ring
    (2, 1300, 511, True),   # T_x not a multiple of 4: four-byte copies
])
def test_mas_kernel_long_text_and_rows_past_the_ring(cuda_device, B, T_y, T_x, ties):
    g = torch.Generator().manual_seed(T_y * T_x)
    nc, mask, t_ys, t_xs = _mas_batch(g, cuda_device, B, T_y, T_x, ties)
    masked = torch.where(mask > 0, nc, torch.full((), MAX_NEG, device=nc.device))
    assert torch.equal(maximum_path(nc, mask), maximum_path_plain(masked, t_ys, t_xs) * mask)


@pytest.mark.cuda
@pytest.mark.parametrize("n_rows,T_x", [(1000, 192), (77, 33)])
def test_mas_chain_probe_walks_a_monotonic_path(cuda_device, n_rows, T_x):
    """The chain probe runs the kernel's DP and backtrack steps: its path
    starts at token 0, ends at the last one and advances by 0 or 1."""
    g = torch.Generator().manual_seed(n_rows)
    before = maximum_path.launches
    rec = mas.chain_probe((torch.randn(32, T_x, generator=g) * 3).to(cuda_device), n_rows).long()
    assert maximum_path.launches == before
    steps = rec[1:] - rec[:-1]
    assert int(rec[0]) == 0 and int(rec[-1]) == T_x - 1
    assert bool(((steps == 0) | (steps == 1)).all())


def _taco_inputs(g, device, B, L, H, ragged):
    D_mel, P, Dc, r = 80, 256, 512, 1
    u = lambda *shape, fan: (torch.rand(shape, generator=g) * 2 - 1).mul(fan ** -0.5).to(device)  # noqa: E731
    wts = ts.TacoStepWeights(
        prenet_w1=u(D_mel, P, fan=D_mel), prenet_b1=u(P, fan=D_mel), prenet_w2=u(P, P, fan=P),
        prenet_b2=u(P, fan=P), att_w_ih=u(P + Dc, 4 * H, fan=H), att_w_hh=u(H, 4 * H, fan=H),
        att_b=u(4 * H, fan=H), query_w=u(H, Dc, fan=H), dec_w_ih=u(H + Dc, 4 * H, fan=H),
        dec_w_hh=u(H, 4 * H, fan=H), dec_b=u(4 * H, fan=H), mel_w=u(H + Dc, r * D_mel, fan=H + Dc),
        mel_b=u(r * D_mel, fan=H + Dc), stop_w=u(H + Dc, r, fan=H + Dc), stop_b=u(r, fan=H + Dc))
    w = torch.softmax(torch.randn(B, L, generator=g) * 3, dim=1).to(device)
    state = ts.TacoStepState(w, _randn(g, device, B, Dc, scale=0.3), *(
        _randn(g, device, B, H, scale=0.3) for _ in range(4)))
    mmask = torch.ones(B, L, device=device)
    if ragged:
        mmask[-1, L // 2:] = 0
    masks = tuple((torch.rand(B, P, generator=g) < 0.5).to(device) for _ in range(2))
    return _randn(g, device, B, D_mel, scale=0.5), state, _randn(g, device, B, L, Dc, scale=0.5), mmask, wts, masks


def _assert_step_close(got, want):
    for a, b in zip(got[:2] + tuple(got[2]), want[:2] + tuple(want[2])):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,H,entry,ragged", [
    (1, 57, 320, "fused", False), (8, 160, 320, "fused", True), (3, 9, 1024, "fused", False),
    (16, 160, 320, "fused", True), (1, 160, 1024, "fp32", False), (8, 200, 1024, "fp32", True),
    (9, 160, 1024, "fp32", True), (16, 160, 1024, "fp32", False), (5, 33, 1024, "bf16", True),
    (1, 160, 1024, "bf16", False), (8, 160, 1024, "bf16", False), (9, 160, 1024, "bf16", False),
    (16, 160, 1024, "bf16", True),
])
def test_taco_step_kernel_matches_plain(cuda_device, B, L, H, entry, ragged):
    """With and without PreNet masks; B > 8 as groups of at most 8 rows,
    one launch each."""
    g = torch.Generator().manual_seed(B * L + H)
    y_in, state, memory, mmask, wts, masks = _taco_inputs(g, cuda_device, B, L, H, ragged)
    n = len(ts.row_groups(B))
    if entry == "fused":
        before = ts.taco_step_fused.launches
        got = ts.taco_step_fused(y_in, state, memory, mmask, wts, prenet_masks=masks)
        assert ts.taco_step_fused.launches == before + n
        want = ts.taco_step_fused_via_plain(y_in, state, memory, mmask, wts, prenet_masks=masks)
        unmasked = (ts.taco_step_fused(y_in, state, memory, mmask, wts),
                    ts.taco_step_fused_via_plain(y_in, state, memory, mmask, wts))
    else:
        packed = ts.pack_streamed(wts, torch.bfloat16 if entry == "bf16" else torch.float32)
        before = ts.taco_step_streamed.launches
        got = ts.taco_step_streamed(y_in, state, memory, mmask, packed, prenet_masks=masks)
        assert ts.taco_step_streamed.launches == before + n
        want = ts.taco_step_streamed_via_plain(y_in, state, memory, mmask, packed, prenet_masks=masks)
        unmasked = (ts.taco_step_streamed(y_in, state, memory, mmask, packed),
                    ts.taco_step_streamed_via_plain(y_in, state, memory, mmask, packed))
    _assert_step_close(got, want)
    # without masks: the TPU contract
    _assert_step_close(*unmasked)


@pytest.mark.cuda
def test_taco_step_streamed_on_styled_ragged_memory(cuda_device):
    """A VAE model's memory at B=8: the encoder's output, zero past each of
    eight ragged text lengths, plus a style row per item added at every
    position (so not zero in the padding); the model's all-ones mask. Ten
    steps of the kernel, each from the plain version's state, against the
    plain version."""
    B, L, H = 8, 160, 1024
    g = torch.Generator().manual_seed(20)
    y_in, state, memory, _, wts, masks = _taco_inputs(g, cuda_device, B, L, H, False)
    lengths = torch.tensor([160, 141, 122, 103, 84, 65, 46, 27], device=cuda_device)
    inside = (torch.arange(L, device=cuda_device)[None, :] < lengths[:, None])[..., None]
    memory = memory * inside + torch.tanh(_randn(g, cuda_device, B, 1, memory.shape[-1],
                                                 scale=1.0))
    assert float(memory[-1, 27:].abs().min()) > 0
    packed = ts.pack_streamed(wts, torch.float32)
    ones = torch.ones(B, L, device=cuda_device)
    before = ts.taco_step_streamed.launches
    for _ in range(10):
        got = ts.taco_step_streamed(y_in, state, memory, ones, packed, prenet_masks=masks)
        want = ts.taco_step_streamed_via_plain(y_in, state, memory, ones, packed,
                                               prenet_masks=masks)
        _assert_step_close(got, want)
        y_in, state = want[0][:, -80:], want[2]
    assert ts.taco_step_streamed.launches == before + 10


@pytest.mark.cuda
def test_taco_step_launches_in_turn_agree(cuda_device):
    """The kernel's dependency counters carry over from launch to launch:
    twenty prepared launches back to back, then one more, give the same
    outputs as the first."""
    g = torch.Generator().manual_seed(11)
    y_in, state, memory, mmask, wts, masks = _taco_inputs(g, cuda_device, 9, 160, 1024, True)
    launch, out = ts.prepare_cuda(y_in, state, memory, mmask, masks, *ts.launch_args(wts), 0.1)
    assert launch() == 2
    first = [t.clone() for t in out[:2] + tuple(out[2])]
    for _ in range(20):
        launch()
    launch()
    for a, b in zip(first, out[:2] + tuple(out[2])):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_taco_step_rejects_unsupported_input(cuda_device):
    g = torch.Generator().manual_seed(0)
    y_in, state, memory, mmask, wts, _ = _taco_inputs(g, cuda_device, 2, 20, 36, False)
    with pytest.raises(ValueError, match="multiples of 8"):
        ts.taco_step_fused(y_in, state, memory, mmask, wts)


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,n_fft,hop,n_mels,sr", [
    (8, 8192, 1024, 256, 80, 22050), (8, 220500, 1024, 256, 80, 22050),
    (3, 12345, 1024, 256, 80, 22050), (2, 4000, 256, 64, 20, 8000), (1, 999, 512, 100, 128, 16000),
    (3, 7001, 256, 128, 40, 16000), (5, 3000, 512, 160, 64, 16000), (1, 30000, 2048, 512, 128, 44100),
])
def test_stft_mel_kernel_matches_plain(cuda_device, B, L, n_fft, hop, n_mels, sr):
    """The chip shapes, then every n_fft the kernel's radix plans differ in
    (256: a radix-2 stage last, 512, 2048) with other hops and mel counts,
    and frame counts that leave the last CTA of 4 frames ragged (3 x 48,
    1 x 9, 3 x 54, 5 x 18, 1 x 58); a 1-D waveform gives the same numbers as
    its row of the batch."""
    g = torch.Generator().manual_seed(L)
    y = _randn(g, cuda_device, B, L, scale=0.3)
    before = stft.mel_spectrogram_fused.launches
    out = stft.mel_spectrogram_fused(y, n_fft, n_mels, sr, hop, n_fft)
    assert stft.mel_spectrogram_fused.launches == before + 1
    pad = (n_fft - hop) // 2
    assert out.shape == (B, 1 + (L + 2 * pad - n_fft) // hop, n_mels)
    torch.testing.assert_close(out, stft.mel_spectrogram_plain(y, n_fft, n_mels, sr, hop, n_fft),
                               rtol=0, atol=MEL_ATOL)
    torch.testing.assert_close(stft.mel_spectrogram_fused(y[0], n_fft, n_mels, sr, hop, n_fft),
                               out[0], rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("n_fft,hop", [(1024, 256), (256, 64)])
def test_stft_mel_kernel_weights_bin_0_and_nyquist(cuda_device, n_fft, hop):
    """A mel basis gives bin 0 and the Nyquist bin no weight; a basis of
    U(0, 1) weights on every bin (full ranges) holds the two-for-one
    split's edge bins, both from Z[0]."""
    g = torch.Generator().manual_seed(n_fft)
    y = _randn(g, cuda_device, 3, 5001, scale=0.3)
    window, twiddles, _, _ = stft._kernel_constants(n_fft, 16000, 80, 0.0, None, cuda_device)
    basis = torch.rand(80, n_fft // 2 + 1, generator=g)
    ranges = torch.from_numpy(stft._mel_ranges(basis.numpy())).to(cuda_device)
    basis = basis.to(cuda_device)
    torch.testing.assert_close(stft._launch(y, n_fft, hop, window, twiddles, basis, ranges),
                               stft._log_mel_plain(y, n_fft, hop, basis.t()), rtol=0, atol=MEL_ATOL)


@pytest.mark.cuda
def test_stft_mel_auto_dispatch(cuda_device):
    """The kernel beat the torch.stft mel on the H100 at every size measured
    (8 x 2048 to 8 x 220,500 samples), so the threshold is 0 and every call
    on the card launches it, down to one short clip."""
    assert stft.AUTO_MIN_FRAMES == 0
    for i, (B, L) in enumerate(((8, 2048), (8, 8192), (8, 65536), (1, 1000))):
        y = _randn(torch.Generator().manual_seed(i), cuda_device, B, L, scale=0.3)
        before = stft.mel_spectrogram_fused.launches
        out = stft.mel_spectrogram_auto(y, 1024, 80, 22050, 256, 1024)
        assert stft.mel_spectrogram_fused.launches == before + 1
        torch.testing.assert_close(out, stft.mel_spectrogram_plain(y, 1024, 80, 22050, 256, 1024),
                                   rtol=0, atol=MEL_ATOL)


@pytest.mark.cuda
def test_stft_mel_rejects_a_gradient_and_bad_n_fft(cuda_device):
    y = torch.zeros(2, 8192, device=cuda_device, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        stft.mel_spectrogram_fused(y, 1024, 80, 22050, 256, 1024)
    for n_fft in (768, 128, 4096):
        with pytest.raises(ValueError, match="power of two"):
            stft.mel_spectrogram_fused(y.detach(), n_fft, 80, 22050, 200, n_fft)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_stft_mel_kernel_casts_half_precision(cuda_device, dtype):
    """A bf16 or fp16 waveform is cast to fp32, as the JAX kernel casts: the
    kernel's log-mel equals the one of the fp32 cast, bit for bit, and its
    plain version within MEL_ATOL."""
    y = _randn(torch.Generator().manual_seed(2), cuda_device, 8, 8192, scale=0.3).to(dtype)
    before = stft.mel_spectrogram_fused.launches
    out = stft.mel_spectrogram_fused(y, 1024, 80, 22050, 256, 1024)
    assert stft.mel_spectrogram_fused.launches == before + 1
    assert out.dtype == torch.float32
    assert torch.equal(out, stft.mel_spectrogram_fused(y.float(), 1024, 80, 22050, 256, 1024))
    torch.testing.assert_close(out, stft.mel_spectrogram_plain(y.float(), 1024, 80, 22050, 256, 1024),
                               rtol=0, atol=MEL_ATOL)


@pytest.mark.cuda
def test_default_synthesizer_runs_both_inference_kernels(cuda_device, monkeypatch):
    """With the port's defaults (fuse_mrf on, TTS_FUSED_WN unset) inference
    on the card launches the MRF bank and the WN group kernels."""
    from torch_tts_tpu_torch.core.config import VITS2Config
    from torch_tts_tpu_torch.models.vits2 import build_synthesizer
    from torch_tts_tpu_torch.text import symbols

    monkeypatch.delenv("TTS_FUSED_WN", raising=False)
    model = build_synthesizer(VITS2Config(), len(symbols), seed=0, device=cuda_device)
    g = torch.Generator().manual_seed(0)
    x = torch.randint(1, len(symbols), (2, 40), generator=g).to(cuda_device)
    lengths = torch.tensor([40, 31], device=cuda_device)
    before = (mrf_fused.launches, wn_group.launches)
    audio = model.infer(x, lengths, max_frames=256,
                        generator=torch.Generator(device=cuda_device).manual_seed(0))[0]
    torch.cuda.synchronize()
    assert bool(torch.isfinite(audio).all())
    assert mrf_fused.launches > before[0] and wn_group.launches > before[1]


@pytest.mark.cuda
def test_narrow_synthesizer_runs_on_the_card_defaults(cuda_device, monkeypatch):
    """A VITS2 at widths the kernels do not take everywhere (hidden 128, a
    16-channel last decoder stage) runs `infer` on the card's defaults: the
    model sends the WN stacks and that stage to their plain paths, the other
    stages to the MRF kernel, and the audio matches the plain path's."""
    import dataclasses

    from torch_tts_tpu_torch.core.config import VITS2Config
    from torch_tts_tpu_torch.models.vits2 import build_synthesizer
    from torch_tts_tpu_torch.text import symbols

    monkeypatch.delenv("TTS_FUSED_WN", raising=False)
    base = VITS2Config()
    cfg = dataclasses.replace(base, model=dataclasses.replace(
        base.model, hidden_channels=128, upsample_initial_channel=256))
    model = build_synthesizer(cfg, len(symbols), seed=0, device=cuda_device)
    g = torch.Generator().manual_seed(0)
    x = torch.randint(1, len(symbols), (2, 40), generator=g).to(cuda_device)
    lengths = torch.tensor([40, 31], device=cuda_device)

    def run():
        return model.infer(x, lengths, max_frames=256,
                           generator=torch.Generator(device=cuda_device).manual_seed(0))

    before = (mrf_fused.launches, wn_group.launches)
    out = run()
    torch.cuda.synchronize()
    assert mrf_fused.launches > before[0] and wn_group.launches == before[1]
    model.dec.fuse_mrf = False
    ref = run()
    assert torch.equal(out[4], ref[4])
    assert float((out[0] - ref[0]).abs().max()) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("B", [9, 16])
def test_tacotron_decodes_more_than_eight_rows(cuda_device, B):
    """Tacotron inference at B > 8 on the card: the step kernel in groups of
    at most 8 rows, against the plain path (the cell module) given the
    kernel path's frames as every step's input, within chip_smoke's 1e-3."""
    from torch_tts_tpu_torch.core.config import TacotronConfig
    from torch_tts_tpu_torch.models.tacotron import build_tacotron

    model = build_tacotron(TacotronConfig(), seed=0, device=cuda_device)
    g = torch.Generator().manual_seed(B)
    lengths = torch.randint(20, 60, (B,), generator=g)
    x = torch.randint(1, 40, (B, int(lengths.max())), generator=g)
    x = (x * (torch.arange(x.shape[1])[None] < lengths[:, None])).to(cuda_device)
    lengths, S = lengths.to(cuda_device), 40

    def run(kernel, step_inputs=None):
        model.decoder.use_kernel = kernel
        gen = torch.Generator(device=cuda_device).manual_seed(1)
        with torch.no_grad():
            return model.infer(x, lengths, max_steps=S, generator=gen, step_inputs=step_inputs)

    before = ts.taco_step_streamed.launches
    y_k, _, s_k, aux_k = run(True)
    assert ts.taco_step_streamed.launches == before + S * len(ts.row_groups(B))
    r, D = model.decoder.r, model.decoder.dim_mel
    frames = torch.cat([torch.zeros(B, 1, D, device=cuda_device),
                        y_k.reshape(B, S, r, D)[:, :-1, -1]], 1)
    y_p, _, s_p, aux_p = run(False, frames)
    model.decoder.use_kernel = True
    for a, b in ((y_k, y_p), (s_k, s_p), (aux_k["w"], aux_p["w"])):
        assert float((a - b).abs().max()) <= 1e-3


def _lltm_inputs(g, device, B, I, H):
    s = H ** -0.5
    return [_randn(g, device, B, I), _randn(g, device, 3 * H, H + I, scale=s),
            _randn(g, device, 3 * H, scale=s), _randn(g, device, B, H), _randn(g, device, B, H)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,I,H", [(16, 32, 128), (5, 7, 13), (40, 3, 1), (1, 1, 33),
                                   (512, 32, 128), (64, 256, 1024), (16, 0, 128), (3, 0, 5)])
def test_lltm_kernel_matches_plain(cuda_device, B, I, H):
    """The tutorial's shape, odd H, more rows than a warp has lanes, the
    two large shapes (many row groups; K over many ring slots), I = 0."""
    g = torch.Generator().manual_seed(B * 100 + H)
    args = _lltm_inputs(g, cuda_device, B, I, H)
    before = gc.lltm.launches
    got = gc._lltm_forward_cuda(*args)
    assert gc.lltm.launches == before + 1
    for a, b in zip(got, gc.lltm_forward_plain(*args)):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=1e-5)
    leaves = [a.clone().requires_grad_() for a in args]
    new_h, new_c = gc.lltm(*leaves)
    assert gc.lltm.launches == before + 2
    (new_h.sum() + new_c.sum()).backward()
    refs = [a.clone().requires_grad_() for a in args]
    ref_h, ref_c = gc.lltm_ref(*refs)
    (ref_h.sum() + ref_c.sum()).backward()
    torch.testing.assert_close(new_h, ref_h, rtol=0, atol=1e-5)
    torch.testing.assert_close(new_c, ref_c, rtol=0, atol=1e-5)
    for i, (a, b) in enumerate(zip(leaves, refs)):
        assert a.grad.shape == b.grad.shape
        if b.grad.numel():  # x [B, 0] at I = 0
            _assert_grad_close(f"lltm grad {i}", a.grad, b.grad)


@pytest.mark.cuda
def test_lltm_takes_bf16_and_strided_inputs(cuda_device):
    """What the TPU kernel takes: bf16 inputs and x a strided view of a
    [B, T, I] sequence give fp32 outputs equal to the plain forward on the
    inputs cast to fp32, one launch a call, and gradients in each leaf's
    dtype (within bf16's rounding of the fp32 plain gradients)."""
    g = torch.Generator().manual_seed(11)
    B, I, H = 16, 32, 128
    args = _lltm_inputs(g, cuda_device, B, I, H)
    seq = _randn(g, cuda_device, B, 3, I)
    half = [seq[:, 1].bfloat16()] + [a.bfloat16() for a in args[1:]]
    strided = [seq[:, 1]] + args[1:]
    assert not strided[0].is_contiguous()
    for inputs in (half, strided):
        before = gc.lltm.launches
        got = gc._lltm_forward_cuda(*inputs)
        assert gc.lltm.launches == before + 1
        assert all(t.dtype == torch.float32 for t in got)
        for a, b in zip(got, gc.lltm_forward_plain(*(t.float() for t in inputs))):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
    leaves = [t.detach().clone().requires_grad_() for t in half]
    new_h, new_c = gc.lltm(*leaves)
    assert new_h.dtype == new_c.dtype == torch.float32
    (new_h.sum() + new_c.sum()).backward()
    refs = [t.detach().float().requires_grad_() for t in half]
    ref_h, ref_c = gc.lltm_ref(*refs)
    (ref_h.sum() + ref_c.sum()).backward()
    for leaf, ref in zip(leaves, refs):
        assert leaf.grad.dtype == torch.bfloat16
        torch.testing.assert_close(leaf.grad, ref.grad.bfloat16(), rtol=1e-2, atol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("B,I,H", [(16, 32, 128), (64, 256, 1024)])
def test_lltm_kernel_repeats_its_bits(cuda_device, B, I, H):
    """K is split over a cluster and summed in a fixed order: the same
    inputs give the same bits twice."""
    args = _lltm_inputs(torch.Generator().manual_seed(B + H), cuda_device, B, I, H)
    for a, b in zip(gc._lltm_forward_cuda(*args), gc._lltm_forward_cuda(*args)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("B,C,T,N,k,d,pad,phases", [
    (1, 192, 1024, 512, 7, 1, (3, 3), 1), (2, 256, 777, 256, 11, 5, (25, 25), 1),
    (1, 512, 300, 2048, 3, 1, (1, 1), 8), (3, 256, 129, 1024, 5, 1, (2, 2), 4),
    (2, 32, 1000, 32, 3, 3, (3, 3), 1), (1, 64, 50, 96, 3, 1, (2, 0), 2),
    (1, 80, 64, 96, 7, 1, (3, 3), 1), (2, 81, 100, 48, 3, 2, (2, 2), 2), (2, 1, 33, 8, 3, 1, (1, 1), 1),
])
def test_int8_kernels_match_plain(cuda_device, B, C, T, N, k, d, pad, phases):
    """The quantizer gives the plain version's x_q and s_x exactly; the
    int8 conv its output bit for bit (exact int32 sums, the same fp32
    epilogue), ragged rows, columns and asymmetric padding included, and
    C_in off the 32-channel K step (rows padded with zeros); contiguous
    unpadded x_q and w_q too (copied into padded rows)."""
    from torch_tts_tpu_torch.kernels import int8_conv
    from torch_tts_tpu_torch.ops import quant

    g = torch.Generator().manual_seed(B * T + N)
    x = _randn(g, cuda_device, B, C, T, scale=0.3)
    w_q, s_w = quant.conv_weights(_randn(g, cuda_device, N, C, k, scale=0.05))
    bias = _randn(g, cuda_device, N // phases)
    with torch.no_grad():
        x_q, s_x = int8_conv.quantize_act(x)
        x_qp, s_xp = int8_conv.quantize_act_plain(x)
        assert torch.equal(x_q, x_qp) and float(s_x) == float(s_xp)
        for b in (bias, None):
            y = int8_conv.int8_conv1d(x_q, s_x, w_q, s_w, b, pad, d, phases)
            want = int8_conv.int8_conv1d_plain(x_q, s_x, w_q, s_w, b, pad, d, phases)
            torch.testing.assert_close(y, want, rtol=0, atol=0)
            y2 = int8_conv.int8_conv1d(x_qp, s_xp, w_q.contiguous(), s_w, b, pad, d, phases)
            torch.testing.assert_close(y2, want, rtol=0, atol=0)


@pytest.mark.cuda
def test_int8_conv_raises_on_a_shape_it_does_not_take(cuda_device):
    """k * C_in past the kernel's int32 bound (4095 channels, padded to
    4096, times 33 taps): on the card the quantized conv raises (no plain
    version on a CUDA tensor) and launches no conv. C_in = 80 is taken
    (test_int8_kernels_match_plain)."""
    from torch_tts_tpu_torch.kernels import int8_conv
    from torch_tts_tpu_torch.ops import quant

    g = torch.Generator().manual_seed(80)
    x = _randn(g, cuda_device, 1, 4095, 40)
    w = _randn(g, cuda_device, 16, 4095, 33, scale=0.05)
    assert not int8_conv.supports(4095, 16, 33, 1) and int8_conv.supports(80, 96, 7, 1)
    before = int8_conv.int8_conv1d.launches
    with torch.no_grad(), pytest.raises(ValueError, match="not taken by the kernel"):
        quant.int8_conv1d(x, w, padding=(16, 16))
    assert int8_conv.int8_conv1d.launches == before


def _op_case(name, device):
    """(operator, its arguments on `device`, the plain version's output,
    the wrapper whose launch count it adds to) for one `tts::` operator."""
    from torch_tts_tpu_torch.kernels import int8_conv, mrf_fused as mrf
    from torch_tts_tpu_torch.ops import quant

    g = torch.Generator().manual_seed(len(name))
    if name == "mrf_fused":
        blocks = _blocks(g, device, 32, (3, 5))
        x = _randn(g, device, 2, 333, 32)
        return (torch.ops.tts.mrf_fused, (x, *mrf.flatten_blocks(blocks)),
                mrf_plain(x, blocks), mrf_fused)
    if name == "wn_group":
        args = _wn_args(g, device, 2, 300, 192, 4, 5, with_gl=True)
        return torch.ops.tts.wn_group, args, wn_group_plain(*args), wn_group
    x = _randn(g, device, 2, 81, 100, scale=0.3)
    mask = (torch.arange(100, device=device) < 90).float().expand(2, 1, 100).contiguous()
    if name == "quantize_act":
        return (torch.ops.tts.quantize_act, (x, 0.1, mask),
                int8_conv.quantize_act_plain(x, 0.1, mask), int8_conv.quantize_act)
    x_q, s_x = int8_conv.quantize_act(x, 0.1, mask)
    w_q, s_w = quant.conv_weights(_randn(g, device, 48, 81, 3, scale=0.05))
    res = _randn(g, device, 2, 24, 200)
    args = (x_q, s_x, w_q, s_w, _randn(g, device, 24), [1, 1], 1, 2, res)
    return (torch.ops.tts.int8_conv1d, args, int8_conv.int8_conv1d_plain(
        x_q, s_x, w_q, s_w, args[4], (1, 1), 1, 2, res), int8_conv.int8_conv1d)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mrf_fused", "wn_group", "quantize_act", "int8_conv1d"])
def test_tts_operator_matches_plain_and_its_fake(cuda_device, name):
    """Each `tts::` operator on CUDA tensors launches its kernel once and
    equals the plain version (the int8 pair bit for bit); its fake function
    gives the real output's shapes, dtypes and strides (the quantizer's x_q
    is a view of rows padded to 32 channels)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    op, args, want, wrapper = _op_case(name, cuda_device)
    before = wrapper.launches
    with torch.no_grad():
        got = op(*args)
    assert wrapper.launches == before + 1
    exact = name in ("quantize_act", "int8_conv1d")
    for a, b in zip(*((t if isinstance(t, tuple) else (t,)) for t in (got, want))):
        torch.testing.assert_close(a, b, rtol=0 if exact else RTOL, atol=0 if exact else ATOL)
    mode = FakeTensorMode()
    with mode:
        fake = op(*(mode.from_tensor(a) if isinstance(a, torch.Tensor)
                    else [mode.from_tensor(t) for t in a] if isinstance(a, list) and a
                    and isinstance(a[0], torch.Tensor) else a for a in args))
    for f, r in zip(*((t if isinstance(t, tuple) else (t,)) for t in (fake, got))):
        assert (f.shape, f.dtype, f.stride(), f.device) == (r.shape, r.dtype, r.stride(),
                                                             r.device)


@pytest.mark.cuda
def test_tts_operators_raise_on_cuda_tensors_they_do_not_take(cuda_device):
    """On the card an operator raises (no plain fallback): fp64 x for the
    MRF bank, the WN group and the quantizer, a stride-1 int8 conv whose
    k * C_in passes the kernel's bound."""
    for name in ("mrf_fused", "wn_group", "quantize_act"):
        op, args, _, wrapper = _op_case(name, cuda_device)
        before = wrapper.launches
        with torch.no_grad(), pytest.raises(ValueError):
            op(args[0].double(), *args[1:])
        assert wrapper.launches == before
    x_q = torch.zeros(1, 40, 4095, dtype=torch.int8, device=cuda_device)
    w_q = torch.zeros(16, 33, 4095, dtype=torch.int8, device=cuda_device)
    with torch.no_grad(), pytest.raises(ValueError, match="not taken by the kernel"):
        torch.ops.tts.int8_conv1d(x_q, torch.ones((), device=cuda_device), w_q,
                                  torch.ones(16, device=cuda_device), None, [16, 16], 1, 1, None)
