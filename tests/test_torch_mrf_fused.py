"""Port of the fused MRF bank (torch_tts_tpu_torch/kernels/mrf_fused.py)
against the JAX package.

- The plain PyTorch version equals the Pallas kernel run in interpret mode
  over several windows (fp32, rtol 1e-4, atol 1e-5).
- In tests/test_torch_mrf_fused_kernel.py: the CUDA kernel's launch plan
  (per ResBlock1 iteration: buffers, tile,
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
from torch_tts_tpu_torch.kernels.mrf_fused import dilated_offsets, mrf_fused, mrf_plain
from torch_tts_tpu_torch.models.vits2.convert import state_dict_from_jax_params
from torch_tts_tpu_torch.ops.hifigan import Generator

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
    # seeded weights of the init's shapes (running the init itself would
    # take the Pallas kernel through interpret mode once more)
    shapes = jax.eval_shape(lambda: jgen.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])

    def fill(path, s):
        n = rng.standard_normal(s.shape)
        name = path[-1].key
        if name == "g":
            return (1 + 0.1 * n).astype(np.float32)
        if name in ("kernel", "v"):
            return (n / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        return (0.05 * n).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(fill, shapes)
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
    under autograd never reaches mrf_fused, an inference one does, at each
    stage whose width the kernel takes (`supports`: the 32-channel stage,
    not the 16-channel one)."""
    from torch_tts_tpu_torch.kernels.mrf_fused import supports
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
    widths = [GEN_KW["upsample_initial_channel"] >> (i + 1)
              for i in range(len(GEN_KW["upsample_rates"]))]
    assert len(calls) == sum(map(supports, widths)) == 1
