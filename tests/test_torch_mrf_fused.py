"""Port of the fused MRF bank (torch_tts_tpu_torch/kernels/mrf_fused.py)
against the JAX package.

- The plain PyTorch version equals the Pallas kernel run in interpret mode
  over several windows (fp32, rtol 1e-4, atol 1e-5).
- The CUDA kernel's launch plan (per ResBlock1 iteration: buffers, tile,
  halo, rows computed per conv, epilogue), replayed window by window on the
  CPU with never-computed rows poisoned with NaN, equals the plain version:
  every row a conv reads was computed. The same replay with every product
  in 3xTF32 (`split_tf32`, the kernel's split) stays within 1e-5 of it,
  where 1xTF32 does not; `split_tf32` rounds as cvt.rna does.
- The port's Generator(fuse_mrf=True) equals the JAX Generator(fuse_mrf=True)
  on the same weights, unmasked and masked.
- A CPU tensor takes the plain version and launches nothing (the kernel on
  a card: tests/test_torch_cuda_kernels.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_tts_tpu.kernels import mrf_fused as jax_mrf
from torch_tts_tpu.ops.hifigan import Generator as JaxGenerator
from torch_tts_tpu_torch.core.config import VITS2ModelConfig
from torch_tts_tpu_torch.kernels.mrf_fused import (
    ADD,
    ADD_DIV,
    DIV,
    SMEM_BYTES,
    STORE,
    dilated_offsets,
    mrf_fused,
    mrf_plain,
    plan_mrf,
    ring_bytes,
    rows_per_pass,
    split_tf32,
    window_bytes,
)
from torch_tts_tpu_torch.models.vits2.convert import state_dict_from_jax_params
from torch_tts_tpu_torch.ops.hifigan import Generator

RTOL, ATOL = 1e-4, 1e-5


def _rand_blocks(rng, C, kernel_sizes=(3, 7), dil=(1, 3, 5)):
    """numpy blocks in mrf_fused's (offsets, w [k*C, C], b [C]) form, scaled
    so activations stay of order one through the bank."""
    blocks = []
    for k in kernel_sizes:
        scale = 0.5 / np.sqrt(k * C)
        iters = []
        for d in dil:
            iters.append(tuple(
                (dilated_offsets(k, dd),
                 (rng.standard_normal((k * C, C)) * scale).astype(np.float32),
                 (rng.standard_normal(C) * scale).astype(np.float32))
                for dd in (d, 1)))
        blocks.append(tuple(iters))
    return tuple(blocks)


def _convert(blocks, fn):
    return tuple(tuple(tuple((o, fn(w), fn(b)) for o, w, b in it) for it in blk)
                 for blk in blocks)


@pytest.mark.parametrize("T,tile", [(50, 16), (16, 64)])
def test_plain_matches_pallas_interpret(T, tile):
    rng = np.random.default_rng(0)
    C = 32
    blocks = _rand_blocks(rng, C)
    x = rng.standard_normal((2, T, C)).astype(np.float32)
    ref = jax_mrf.mrf_fused(jnp.asarray(x), _convert(blocks, jnp.asarray), tile=tile,
                            interpret=True)
    out = mrf_plain(torch.from_numpy(x), _convert(blocks, torch.from_numpy))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def _mm_3xtf32(a, b):
    """a @ b as the kernel's tensor cores form it: small terms first."""
    (ah, al), (bh, bl) = split_tf32(a), split_tf32(b)
    return al @ bh + ah @ bl + ah @ bh


def _replay_plan(x, blocks, launches, mm=torch.matmul):
    """The CUDA kernel's algorithm on the CPU: launch by launch over the
    buffers {0: x, 1: out, 2, 3: scratch}, per tile a window of
    T0 + 2*halo rows; each conv computes exactly its planned rows (each tap
    one product `mm`); rows not (re)computed are NaN, so reading one shows
    in the output."""
    B, T, C = x.shape
    nan = float("nan")
    bufs = {0: x, 1: torch.full_like(x, nan), 2: torch.full_like(x, nan),
            3: torch.full_like(x, nan)}
    for ln in launches:
        bi, it = ln.convs
        convs = blocks[bi][it]
        W = ln.T0 + 2 * ln.halo
        src, dst = bufs[ln.src], bufs[ln.dst].clone()
        for t0 in range(0, T, ln.T0):
            pos = torch.arange(t0 - ln.halo, t0 - ln.halo + W)
            inside = (pos >= 0) & (pos < T)
            valid = inside.to(x.dtype)[None, :, None]
            xb = torch.zeros(B, W, C)
            xb[:, inside] = src[:, pos[inside]]
            tb = torch.full((B, W, C), nan)
            for j, ((offs, w, b), (lo, hi)) in enumerate(zip(convs, ln.ranges)):
                inp = torch.nn.functional.leaky_relu(xb, 0.1) if j == 0 else tb
                assert lo + min(offs) >= 0 and hi - 1 + max(offs) < W
                y = sum(mm(inp[:, lo + o:hi + o], w[t * C:(t + 1) * C]) for t, o in enumerate(offs))
                y = (y + b) * valid[:, lo:hi]
                if j == 0:
                    tb[:, lo:hi] = torch.nn.functional.leaky_relu(y, 0.1)
                else:
                    new = torch.full_like(xb, nan)
                    new[:, lo:hi] = xb[:, lo:hi] + y
                    xb = new
            n = min(ln.T0, T - t0)
            v = xb[:, ln.halo:ln.halo + n]
            old = dst[:, t0:t0 + n]
            dst[:, t0:t0 + n] = {STORE: v, ADD: old + v, ADD_DIV: (old + v) / ln.div,
                                 DIV: v / ln.div}[ln.mode]
        bufs[ln.dst] = dst
    return bufs[1]


def _smem(rows):
    """Shared memory of the weight ring and two windows of `rows` rows at C=64."""
    return ring_bytes(64) + window_bytes(rows, 64)


@pytest.mark.parametrize("T,smem,n_blocks", [(70, _smem(100), 3), (9, _smem(100), 3),
                                             (900, _smem(400), 3), (77, SMEM_BYTES, 1),
                                             (200, _smem(150), 2)])
def test_kernel_plan_replay_matches_plain(T, smem, n_blocks):
    rng = np.random.default_rng(1)
    C = 64
    blocks = _convert(_rand_blocks(rng, C, kernel_sizes=(3, 7, 11)[-n_blocks:]),
                      torch.from_numpy)
    x = torch.from_numpy(rng.standard_normal((2, T, C)).astype(np.float32))
    launches = plan_mrf([[(it[0][0], it[1][0]) for it in blk] for blk in blocks], C, T,
                        smem_bytes=smem)
    assert len(launches) == 3 * n_blocks
    if T > 9 and smem < SMEM_BYTES:
        assert any(ln.T0 < T for ln in launches), "the plan should need several tiles"
    out = _replay_plan(x, blocks, launches)
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), mrf_plain(x, blocks).numpy(), rtol=RTOL, atol=ATOL)


def test_plan_fits_shared_memory_at_decoder_shapes():
    """At the LJSpeech bank the C=128/64/32 stages get tiles whose two
    padded window buffers fit the 227 KB of shared memory beside the weight
    ring, the first conv reads the whole window and the last computes
    exactly the tile, and the planner executes at most 1.1 rows per output
    row and conv in passes of 128 (C=128) or 256 rows."""
    offs = [[(dilated_offsets(k, d), dilated_offsets(k, 1)) for d in (1, 3, 5)]
            for k in (3, 7, 11)]
    for C, T in ((128, 65536), (64, 131072), (32, 262144)):
        rows = rows_per_pass(C)
        assert rows == (128 if C == 128 else 256)
        for ln in plan_mrf(offs, C, T, n_sm=132):
            W = ln.T0 + 2 * ln.halo
            assert ring_bytes(C) + window_bytes(W, C) <= SMEM_BYTES and ln.T0 >= 8
            bi, it = ln.convs
            r0 = max(abs(o) for o in offs[bi][it][0])
            assert ln.ranges[0] == (r0, W - r0)
            assert ln.ranges[-1] == (ln.halo, ln.halo + ln.T0)
            executed = sum(-(-(hi - lo) // rows) * rows for lo, hi in ln.ranges)
            assert executed <= 1.1 * 2 * ln.T0, (C, ln)


def test_split_tf32_rounds_as_cvt_rna():
    """hi is x rounded half away from zero to 11 significant bits (bit for
    bit, against frexp), lo the same rounding of x - hi; ties included."""
    rng = np.random.default_rng(4)
    x = (rng.standard_normal(4096) * 10.0 ** rng.integers(-8, 8, 4096)).astype(np.float32)
    ties = np.array([1 + 2 ** -11, 1 + 3 * 2 ** -11, -(1 + 2 ** -11), (1.5 + 2 ** -11) * 2 ** -20],
                    np.float32)
    x = np.concatenate([x, ties, -ties, [0.0, 1.0, -2.5]]).astype(np.float32)

    def rna(v):
        m, e = np.frexp(np.abs(v).astype(np.float64))  # |v| = m 2^e, m in [0.5, 1)
        return (np.sign(v) * np.floor(m * 2 ** 11 + 0.5) * np.exp2(e - 11)).astype(np.float32)

    hi, lo = split_tf32(torch.from_numpy(x))
    np.testing.assert_array_equal(hi.numpy(), rna(x))
    np.testing.assert_array_equal(lo.numpy(), rna((x - hi.numpy()).astype(np.float32)))
    assert (hi.numpy().view(np.int32) & 0x1FFF == 0).all()
    assert hi[4096:4100].tolist() == [1 + 2 ** -10, 1 + 2 ** -9, -(1 + 2 ** -10),
                                      (1.5 + 2 ** -10) * 2 ** -20]


def test_kernel_plan_replay_in_3xtf32_matches_plain():
    """The plan replayed with every product in 3xTF32 stays within 1e-5 of
    the fp32 plain version over a three-block bank; with the hi parts alone
    (1xTF32) it does not."""
    rng = np.random.default_rng(5)
    C, T = 32, 90
    blocks = _convert(_rand_blocks(rng, C, kernel_sizes=(3, 7, 11)), torch.from_numpy)
    x = torch.from_numpy(rng.standard_normal((1, T, C)).astype(np.float32))
    launches = plan_mrf([[(it[0][0], it[1][0]) for it in blk] for blk in blocks], C, T,
                        smem_bytes=ring_bytes(C) + window_bytes(100, C))
    want = mrf_plain(x, blocks).numpy()
    np.testing.assert_allclose(_replay_plan(x, blocks, launches, _mm_3xtf32).numpy(), want,
                               rtol=RTOL, atol=ATOL)
    one = _replay_plan(x, blocks, launches, lambda a, b: split_tf32(a)[0] @ split_tf32(b)[0])
    assert float(np.abs(one.numpy() - want).max()) > 10 * ATOL


GEN_KW = dict(
    resblock_kernel_sizes=(3, 7),
    resblock_dilation_sizes=((1, 3, 5), (1, 3, 5)),
    upsample_rates=(4, 2),
    upsample_initial_channel=64,
    upsample_kernel_sizes=(8, 4),
)


@pytest.fixture(scope="module")
def generator_pair():
    rng = np.random.default_rng(2)
    jgen = JaxGenerator(resblock="1", fuse_mrf=True, pack_narrow=False, **GEN_KW)
    x = rng.standard_normal((2, 24, 8)).astype(np.float32)
    params = jgen.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = jax.tree.map(
        lambda p: np.asarray(p) + (0.05 * rng.standard_normal(p.shape)).astype(np.float32),
        params)
    cfg = VITS2ModelConfig(use_transformer_flows=False, **GEN_KW)
    gen = Generator(8, "1", fuse_mrf=True, **GEN_KW)
    gen.load_state_dict(state_dict_from_jax_params(params, cfg), strict=True)
    return jgen, params, gen.eval(), x


@pytest.mark.parametrize("masked", [False, True])
def test_generator_fuse_mrf_matches_jax(generator_pair, masked):
    jgen, params, gen, x = generator_pair
    mask = (np.arange(24)[None, :] < np.array([24, 15])[:, None]).astype(np.float32)
    jmask = jnp.asarray(mask[:, :, None]) if masked else None
    ref = jgen.apply({"params": params}, jnp.asarray(x), x_mask=jmask)
    with torch.no_grad():
        tmask = torch.from_numpy(mask[:, None, :]) if masked else None
        out = gen(torch.from_numpy(x).transpose(1, 2), x_mask=tmask)
    np.testing.assert_allclose(out.transpose(1, 2).numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)


def test_cpu_tensor_takes_plain_version():
    rng = np.random.default_rng(3)
    blocks = _convert(_rand_blocks(rng, 32, kernel_sizes=(3,)), torch.from_numpy)
    x = torch.from_numpy(rng.standard_normal((1, 20, 32)).astype(np.float32))
    before = mrf_fused.launches
    out = mrf_fused(x, blocks)
    assert mrf_fused.launches == before
    assert torch.equal(out, mrf_plain(x, blocks))


def test_training_forward_keeps_the_plain_convolutions(generator_pair, monkeypatch):
    """fuse_mrf is the port's default; the bank takes the kernel only when no
    gradient is needed (the kernel has no backward): a training forward
    under autograd never reaches mrf_fused, an inference one does."""
    from torch_tts_tpu_torch.ops import hifigan

    assert VITS2ModelConfig().fuse_mrf
    _, _, gen, x = generator_pair
    calls = []
    real = hifigan.mrf_fused
    monkeypatch.setattr(hifigan, "mrf_fused", lambda *a: calls.append(1) or real(*a))
    xt = torch.from_numpy(x).transpose(1, 2)
    gen.train()
    try:
        gen(xt).sum().backward()
    finally:
        gen.eval()
        gen.zero_grad(set_to_none=True)
    assert not calls
    with torch.no_grad():
        gen(xt)
    assert len(calls) == len(GEN_KW["upsample_rates"])
