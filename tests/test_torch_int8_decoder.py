"""The int8 decoders (`quantize_decoder`): the port's HiFi-GAN `Generator`
and `MultiBandISTFTGenerator` with `quant_int8` against the JAX package's,
on the CPU.

Tiny generators with random weights from a numpy seed, carried over by the
port's converter (strict=True), the same latents, speaker embedding (gin 8)
and masks. The HiFi-GAN trunk has a 128-channel and a 64-channel stage, so
`pack_narrow` changes which stage is int8: with it, the 64-channel stage
stays fp (JAX runs it lane-packed, the port through its fp bank); without
it, both are int8. Each JAX generator is jitted once (masked and unmasked
in one program) and compiled in a thread pool as soon as it is traced.

Tolerance: the error's L2 norm within DEC_REL_L2 of the output's, its
largest sample within DEC_MAX of the peak (measured up to 3.9e-4 and
7.2e-4). On the same fp32 inputs both quantizers give the same bits and
the int32 sums are exact, but the fp32 steps between them differ by ulps
(the weight norm's summation order; XLA fuses the dequantize's multiply
and add): about one int8 weight in 10^4 moves by one step, and an
activation that sits on a rounding boundary can flip, each moving an
output by about one quantization step (s_x * s_w) and the next layers'
roundings with it.

Also held: the int8 policy (which convs are int8, per stage) equals JAX's
for both `pack_narrow` settings at the shipped LJSpeech and MB-iSTFT
widths (JAX traced abstractly, the port built on the meta device); the
count of int8 weights that differ from JAX's (at most a handful, each by
one); new weights after an int8 forward (load_state_dict, an in-place
update) give the new weights' output; the state dict with and without
quantization; the refusals under autograd and in training.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_vits2_infer import random_params
from torch_tts_tpu.ops import quant as jquant
from torch_tts_tpu.ops.hifigan import Generator as JGenerator
from torch_tts_tpu.ops.mb_istft import MultiBandISTFTGenerator as JMBGenerator
from torch_tts_tpu_torch.core.config import VITS2Config, VITS2ModelConfig
from torch_tts_tpu_torch.models.vits2.convert import generator_state_dict_from_jax_params
from torch_tts_tpu_torch.ops.hifigan import Generator, ResBlock1, ResBlock2, int8_stages
from torch_tts_tpu_torch.ops.layers import Conv1d, ConvTranspose1d
from torch_tts_tpu_torch.ops.mb_istft import MultiBandISTFTGenerator
from torch_tts_tpu_torch.train import vits2_train

B, T, D, GIN = 2, 12, 8, 8
LENGTHS = (12, 7)
DEC_REL_L2, DEC_MAX = 2e-3, 1e-2
HIFI = dict(upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4), upsample_initial_channel=256,
            resblock_kernel_sizes=(3, 5))
DILATIONS = {"1": ((1, 2), (1, 3)), "2": ((1, 2), (2, 3))}
MB = dict(upsample_rates=(2,), upsample_kernel_sizes=(4,), upsample_initial_channel=256,
          resblock_kernel_sizes=(3, 5), resblock_dilation_sizes=((1, 2), (1, 3)),
          subbands=4, istft_n_fft=16, istft_hop=4)
CASES = [("1", True), ("1", False), ("2", True), ("2", False)]
CASE_IDS = ["resblock1_pack", "resblock1_nopack", "resblock2_pack", "resblock2_nopack"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while this module runs: under pytest-xdist a thread
    per core in every worker oversubscribes the cores, which slowed the
    port's tests about twofold and took CPU from the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_hifi(resblock, pack):
    return JGenerator(resblock=resblock, resblock_dilation_sizes=DILATIONS[resblock],
                      gin_channels=GIN, pack_narrow=pack, quant_int8=True, **HIFI)


def _port_hifi(resblock, pack, quant_int8=True):
    return Generator(D, resblock, resblock_dilation_sizes=DILATIONS[resblock], fuse_mrf=True,
                     gin_channels=GIN, quant_int8=quant_int8, pack_narrow=pack,
                     **HIFI).eval()


def _jax_mb():
    return JMBGenerator(gin_channels=GIN, quant_int8=True, **MB)


def _port_mb():
    kw = dict(MB, istft_n_fft=MB["istft_n_fft"], istft_hop=MB["istft_hop"])
    return MultiBandISTFTGenerator(D, fuse_mrf=True, gin_channels=GIN, quant_int8=True,
                                   **kw).eval()


@pytest.fixture(scope="module")
def refs():
    """Per generator: two seeded parameter sets, and the JAX outputs
    (unmasked, masked) for each."""
    rng = np.random.default_rng(41)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    g = rng.standard_normal((B, 1, GIN)).astype(np.float32)
    mask = (np.arange(T)[None, :, None] < np.asarray(LENGTHS)[:, None, None]).astype(np.float32)
    gens = {case: _jax_hifi(*case) for case in CASES}
    gens["mb"] = _jax_mb()
    jobs = {}
    for key, gen in gens.items():
        shapes = jax.eval_shape(lambda _g=gen: _g.init(jax.random.PRNGKey(0), x, g)["params"])
        params = [random_params(shapes, rng) for _ in range(2)]

        def run(p, a, gg, m, _g=gen):
            return _g.apply({"params": p}, a, gg), _g.apply({"params": p}, a * m, gg, x_mask=m)
        jobs[key] = (jax.jit(run).lower(params[0], x, g, mask), params)
    with ThreadPoolExecutor(len(jobs)) as ex:
        compiled = {k: ex.submit(low.compile) for k, (low, _) in jobs.items()}
        out = {}
        for key, (_, params) in jobs.items():
            fn = compiled[key].result()
            out[key] = dict(params=params, jax=[jax.tree.map(np.asarray, fn(p, x, g, mask))
                                                for p in params])
    return dict(x=x, g=g, mask=mask, gens=gens, out=out)


def _t(a):
    return torch.from_numpy(np.array(a))


def _load(model, params, n_kernels=2):
    model.load_state_dict(generator_state_dict_from_jax_params(params, (0,) * n_kernels),
                          strict=True)
    return model


def _run(model, refs):
    """(unmasked, masked) port outputs, channels-last numpy."""
    x, g, m = (_t(refs[k]).transpose(1, 2) for k in ("x", "g", "mask"))
    with torch.inference_mode():
        return [o.transpose(1, 2).numpy() for o in (model(x, g=g), model(x * m, x_mask=m, g=g))]


def _close(got, want):
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert np.linalg.norm(a - b) <= DEC_REL_L2 * np.linalg.norm(b)
        np.testing.assert_allclose(a, b, rtol=0, atol=DEC_MAX * float(np.abs(b).max()))


def _int8_layers(gen):
    """The generator's int8 convs in forward order."""
    order, nk = [gen.conv_pre], gen.num_kernels
    for i, up in enumerate(gen.ups):
        order.append(up)
        for block in gen.resblocks[i * nk:(i + 1) * nk]:
            order += ([c for pair in zip(block.convs1, block.convs2) for c in pair]
                      if isinstance(block, ResBlock1) else list(block.convs))
    return [m for m in order if m.quant is not None and (isinstance(m, Conv1d) or m.subpixel)]


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_hifigan_int8_generator_matches_jax(refs, case):
    """Unmasked and masked (ragged lengths), with g; both parameter sets
    through one module, loaded after an int8 forward, so the cached int8
    weights must follow the new parameters."""
    model = _port_hifi(*case)
    for params, want in zip(refs["out"][case]["params"], refs["out"][case]["jax"]):
        _close(_run(_load(model, params), refs), want)
    pack = case[1]
    assert [m.quant for m in model.ups] == ["int8", None if pack else "int8"]
    banks = [b.quant for b in model.resblocks]
    assert banks == ["int8", "int8"] + ([None, None] if pack else ["int8", "int8"])


def test_mbistft_int8_generator_matches_jax(refs):
    """Every trunk conv int8 (conv_pre, the x2 subpixel transposed conv, the
    bank); the iSTFT / PQMF head fp. No tanh: relative to the peak."""
    model = _port_mb()
    assert len(_int8_layers(model)) == 1 + 1 + 2 * 2 * 2
    for params, want in zip(refs["out"]["mb"]["params"], refs["out"]["mb"]["jax"]):
        _close(_run(_load(model, params), refs), want)


@contextmanager
def _recording_jax_int8():
    """Record the kernel shape of every JAX `int8_conv1d` call, in order."""
    calls, orig = [], jquant.int8_conv1d

    def rec(x, kernel, bias, **kw):
        calls.append(tuple(kernel.shape))
        return orig(x, kernel, bias, **kw)
    jquant.int8_conv1d = rec
    try:
        yield calls
    finally:
        jquant.int8_conv1d = orig


def _port_int8_shapes(model):
    """The port's int8 convs in forward order as JAX kernel shapes [k, C_in,
    N] (a subpixel dense kernel's N counts every phase)."""
    shapes = []
    for m in _int8_layers(model):
        w = m.subpixel_weight() if isinstance(m, ConvTranspose1d) else m.effective_weight()
        shapes.append((w.shape[2], w.shape[1], w.shape[0]))
    return shapes


@pytest.mark.parametrize("pack", [True, False], ids=["pack_narrow", "no_pack"])
def test_int8_policy_matches_jax_at_the_shipped_widths(pack):
    """configs/vits2-ljspeech.yaml's decoder (512 channels, x8 x8 x2 x2)
    and the MB-iSTFT trunk: the int8 convs, in order, equal JAX's calls
    (abstract trace, no compile); the LJSpeech one holds 39 with
    pack_narrow (conv_pre, up_0, up_1 and the C=256 and C=128 banks) and
    77 without."""
    c = VITS2ModelConfig()
    x, g = jnp.zeros((1, 4, 192)), None
    jgen = JGenerator(resblock_kernel_sizes=c.resblock_kernel_sizes,
                      resblock_dilation_sizes=c.resblock_dilation_sizes,
                      upsample_rates=c.upsample_rates,
                      upsample_initial_channel=c.upsample_initial_channel,
                      upsample_kernel_sizes=c.upsample_kernel_sizes, pack_narrow=pack,
                      quant_int8=True)
    jmb = JMBGenerator(upsample_rates=(4, 4), upsample_kernel_sizes=(16, 16), quant_int8=True)
    with torch.device("meta"):
        port = Generator(192, "1", c.resblock_kernel_sizes, c.resblock_dilation_sizes,
                         c.upsample_rates, c.upsample_initial_channel, c.upsample_kernel_sizes,
                         quant_int8=True, pack_narrow=pack)
        port_mb = MultiBandISTFTGenerator(192, upsample_rates=(4, 4),
                                          upsample_kernel_sizes=(16, 16), quant_int8=True)
    for jg, pg in ((jgen, port), (jmb, port_mb)):
        with _recording_jax_int8() as calls:
            jax.eval_shape(lambda _j=jg: _j.init_with_output(jax.random.PRNGKey(0), x, g))
        assert _port_int8_shapes(pg) == calls
    assert len(calls) == 39  # MB-iSTFT: 1 + 2 + 2 x 18, whatever pack_narrow
    n = len(_port_int8_shapes(port))
    assert n == (39 if pack else 77)
    assert int8_stages(512, (8, 8, 2, 2), (16, 16, 4, 4), pack) == (
        [(True, True)] * 2 + [(not pack, not pack)] * 2)


def test_int8_weights_differ_from_jax_by_at_most_one_step(refs):
    """Every int8 conv of the unpacked ResBlock1 generator: the port's int8
    weights against JAX's, made by JAX's weight norm and quantizer under
    jit (as its decoder runs) from the same v and g. Reports the count."""
    case = ("1", False)
    model = _load(_port_hifi(*case), refs["out"][case]["params"][0])
    _run(model, refs)  # makes and caches every layer's int8 weights

    @jax.jit
    def jax_int8(v, g):  # JAX Conv1d / ConvTranspose1d weight norm, [k, ., normed axis]
        norm = jnp.sqrt(jnp.sum(v * v, axis=(0, 1), keepdims=True))
        return v * (g.reshape((1, 1, -1)) / jnp.maximum(norm, 1e-12))

    differ, total = 0, 0
    for m in _int8_layers(model):
        if hasattr(m, "weight_v"):  # the converter's inverse: [k, ., normed axis]
            kern = np.asarray(jax_int8(m.weight_v.detach().numpy().transpose(2, 1, 0),
                                       m.weight_g.detach().numpy().reshape(-1)))
        else:  # conv_pre: a plain kernel
            kern = m.weight.detach().numpy().transpose(2, 1, 0)
        if isinstance(m, ConvTranspose1d):  # JAX `_subpixel`'s DK from [k, out, in]
            _, _, a = m._subpixel_taps()
            a, k, u = a.numpy(), kern.shape[0], m.stride
            kg = kern[np.clip(a, 0, k - 1).reshape(-1)].reshape(*a.shape, *kern.shape[1:])
            kg = kg * ((a >= 0) & (a < k))[..., None, None]
            kern = kg.transpose(0, 3, 1, 2).reshape(a.shape[0], kern.shape[2], -1)
        want = np.asarray(jax.jit(jquant.quantize_weight_per_channel)(kern)[0])
        if isinstance(m, ConvTranspose1d):  # columns (r, o) -> the port's rows o * u + r
            c_out = want.shape[2] // u
            want = want.reshape(*want.shape[:2], u, c_out).transpose(3, 2, 0, 1)
            want = want.reshape(c_out * u, *kern.shape[:2])
        else:
            want = want.transpose(2, 0, 1)  # [k, in, out] -> [out, k, in]
        got = m._q8[1].numpy()
        assert got.shape == want.shape
        d = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert d.max() <= 1
        differ += int((d > 0).sum())
        total += d.size
    print(f"int8 weights differing from JAX's: {differ} of {total}")
    assert differ <= max(5, total // 10_000)


@pytest.fixture(scope="module")
def _forwarded(refs):
    """The unpacked ResBlock1 generator after one int8 forward (its int8
    weights cached)."""
    case = ("1", False)
    model = _load(_port_hifi(*case), refs["out"][case]["params"][0])
    _run(model, refs)
    return model


def test_an_in_place_update_after_an_int8_forward_is_seen(refs, _forwarded):
    """weight_g scaled in place (the int8 weights keep, their scales double
    for that conv): the output is a fresh module's on the new weights."""
    model = _forwarded
    before = _run(model, refs)[0]
    with torch.no_grad():
        model.conv_pre.weight.mul_(2.0)
        model.resblocks[0].convs1[0].weight_g.mul_(0.5)
    after = _run(model, refs)[0]
    fresh = _port_hifi("1", False)
    fresh.load_state_dict(model.state_dict(), strict=True)
    np.testing.assert_array_equal(after, _run(fresh, refs)[0])
    assert np.abs(after - before).max() > 1e-3


def test_state_dict_is_the_fp_decoders(refs):
    """quant_int8 adds no parameter, buffer or name: one state dict loads
    strictly into both, and the fp decoder computes within the int8
    error of the int8 one."""
    case = ("1", True)
    params = refs["out"][case]["params"][0]
    q, fp = _load(_port_hifi(*case), params), _port_hifi(*case, quant_int8=False)
    assert {k: v.shape for k, v in q.state_dict().items()} == {
        k: v.shape for k, v in fp.state_dict().items()}
    fp.load_state_dict(q.state_dict(), strict=True)
    a, b = _run(q, refs)[0], _run(fp, refs)[0]
    assert 0 < np.abs(a - b).max() < 0.1 * np.abs(b).max()


def test_int8_decoder_refuses_autograd_and_training(refs):
    """A forward that would need a gradient raises; the train step's
    `check_supported` refuses quantize_decoder (inference only)."""
    model = _port_hifi("1", True)
    x = torch.zeros(1, D, 4)
    with pytest.raises(RuntimeError, match="inference only"):
        model(x)
    with torch.no_grad():
        assert model(x).shape == (1, 1, 16)
    for block in (ResBlock1(32, quant="int8"), ResBlock2(32, quant="int8")):
        with pytest.raises(RuntimeError, match="inference only"):
            block(torch.zeros(1, 32, 4))
    cfg = VITS2Config()
    vits2_train.check_supported(cfg)
    with pytest.raises(ValueError, match="inference-only"):
        vits2_train.check_supported(dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, quantize_decoder=True)))
