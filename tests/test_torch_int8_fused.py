"""The int8 decoder's fused call path: the activation quantizer that forms
leaky_relu(x) * mask as it reads x, the int8 conv that adds a residual in
its epilogue, and the layers, resblocks and decoders that pass them raw
tensors (`kernels/int8_conv.py`, `ops/layers.py`, `ops/hifigan.py`,
`ops/mb_istft.py`), against the JAX package on the CPU.

Inputs and weights from a numpy seed, fp32. Each JAX reference is jitted
once and compiled in a thread pool as soon as it is traced.

- `quantize_act_plain(x, slope, mask)` against jitted JAX
  `quantize_act_dynamic(leaky_relu(x) * mask)`: x_q and s_x bit for bit,
  with -0.0, fully masked frames and values on rounding halves.
- `int8_conv1d_plain(..., residual=x)` against eager JAX `int8_conv1d(...)
  + x` on JAX's own x_q, s_x, w_q and s_w: bit for bit (eager JAX rounds
  the dequantize's multiply, the bias and the residual each once, as the
  port does; under jit XLA fuses them, an ulp away).
- An int8 ResBlock1 and ResBlock2, masked and unmasked, and a small int8
  HiFi-GAN and MB-iSTFT decode: within the int8 tolerances of
  `test_torch_int8_decoder.py` (an activation on a rounding boundary flips
  with an ulp of the weight norm), with every int8 conv's input formed by
  the quantizer (slope and mask passed, no activation tensor in between)
  and every residual added by the conv.
- The fp route of the layers applies the pre-activation and the residual
  with the torch ops of before, bit for bit.
- The conv kernel's tile plan (`conv_tile`) covers every int8 conv of both
  shipped decoders at B = 1 and 8, the 128-frame patch window included,
  and spreads the window's convs over more CTAs than 128 x 128 tiles do.
"""

import math
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax

from test_torch_vits2_infer import random_params
from torch_tts_tpu.ops import quant as jquant
from torch_tts_tpu.ops.hifigan import Generator as JGenerator
from torch_tts_tpu.ops.hifigan import ResBlock1 as JResBlock1
from torch_tts_tpu.ops.hifigan import ResBlock2 as JResBlock2
from torch_tts_tpu.ops.layers import leaky_relu as jleaky_relu
from torch_tts_tpu.ops.mb_istft import MultiBandISTFTGenerator as JMBGenerator
from torch_tts_tpu_torch.core.config import VITS2ModelConfig
from torch_tts_tpu_torch.kernels import int8_conv
from torch_tts_tpu_torch.models.vits2.convert import generator_state_dict_from_jax_params
from torch_tts_tpu_torch.ops.hifigan import Generator, ResBlock1, ResBlock2
from torch_tts_tpu_torch.ops.layers import Conv1d, ConvTranspose1d, leaky_relu
from torch_tts_tpu_torch.ops.mb_istft import MultiBandISTFTGenerator

B, T, C, D, GIN = 2, 16, 64, 8, 8
LENGTHS = (16, 9)
DEC_REL_L2, DEC_MAX = 2e-3, 1e-2  # test_torch_int8_decoder.py's
BLOCKS = {"1": (JResBlock1, ResBlock1, (3, (1, 3))), "2": (JResBlock2, ResBlock2, (5, (1, 2)))}
HIFI = dict(resblock="1", resblock_kernel_sizes=(3, 5), resblock_dilation_sizes=((1, 2), (1, 3)),
            upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4), upsample_initial_channel=128,
            pack_narrow=False)  # every stage int8
MB = dict(upsample_rates=(2,), upsample_kernel_sizes=(4,), upsample_initial_channel=128,
          resblock_kernel_sizes=(3, 5), resblock_dilation_sizes=((1, 2), (1, 3)),
          subbands=4, istft_n_fft=16, istft_hop=4)
PRE = {"lrelu": (0.1, False), "mask": (None, True), "lrelu_mask": (0.1, True)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while this module runs: under pytest-xdist a thread
    per core in every worker oversubscribes the cores, which slowed the
    port's tests about twofold and took CPU from the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _masked_input(rng):
    """x [B, T, C] with -0.0, values that land on rounding halves (s_x = 1:
    max |v| = 127 on a kept frame), and a mask that drops item 1's last
    frames whole."""
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    x[0, 0, :8] = [127.0, 2.5, 3.5, -0.0, -25.0, -35.0, 0.5, -5.0]  # lrelu: -2.5, -3.5, -0.5
    x[0, 1, :4] = [-0.0, 0.0, -0.0, 1.5]
    x[1, LENGTHS[1]:] = np.where(x[1, LENGTHS[1]:] >= 0, 126.0, -126.0)  # masked frames
    mask = (np.arange(T)[None, :, None] < np.asarray(LENGTHS)[:, None, None]).astype(np.float32)
    return x, mask


def _block_params(kind, jparams):
    """A flax ResBlock's params -> the port's block state dict."""
    names = ([(f"conv1_{j}", f"convs1.{j}") for j in range(2)]
             + [(f"conv2_{j}", f"convs2.{j}") for j in range(2)]) if kind == "1" else [
        (f"conv_{j}", f"convs.{j}") for j in range(2)]
    sd = {}
    for jname, pname in names:
        p = jparams[jname]
        sd[f"{pname}.weight_v"] = _t(np.asarray(p["v"]).transpose(2, 1, 0))
        sd[f"{pname}.weight_g"] = _t(p["g"]).reshape(-1, 1, 1)
        sd[f"{pname}.bias"] = _t(p["bias"])
    return sd


@pytest.fixture(scope="module")
def refs():
    """Inputs, seeded parameters and every JAX reference."""
    rng = np.random.default_rng(19)
    x, mask = _masked_input(rng)
    z = rng.standard_normal((B, T, D)).astype(np.float32)
    g = rng.standard_normal((B, 1, GIN)).astype(np.float32)
    jobs, params = {}, {}

    def add(key, fn, *args):
        jobs[key] = (jax.jit(fn).lower(*args), args)

    for name, (slope, masked) in PRE.items():
        def pre_q(a, m, _s=slope, _m=masked):
            v = jleaky_relu(a, _s) if _s is not None else a
            return jquant.quantize_act_dynamic(v * m if _m else v)
        add(("quant", name), pre_q, x, mask)
    for kind, (jcls, _, (k, dils)) in BLOCKS.items():
        block = jcls(C, k, dils, quant="int8")
        shapes = jax.eval_shape(lambda _b=block: _b.init(jax.random.PRNGKey(0), x)["params"])
        params[kind] = random_params(shapes, rng)
        add(("block", kind),
            lambda p, a, m, _b=block: (_b.apply({"params": p}, a),
                                       _b.apply({"params": p}, a * m, x_mask=m)),
            params[kind], x, mask)
    gens = {"hifigan": JGenerator(gin_channels=GIN, quant_int8=True, **HIFI),
            "mbistft": JMBGenerator(gin_channels=GIN, quant_int8=True, **MB)}
    for key, gen in gens.items():
        shapes = jax.eval_shape(lambda _g=gen: _g.init(jax.random.PRNGKey(0), z, g)["params"])
        params[key] = random_params(shapes, rng)
        add(("gen", key),
            lambda p, a, gg, m, _g=gen: (_g.apply({"params": p}, a, gg),
                                         _g.apply({"params": p}, a * m, gg, x_mask=m)),
            params[key], z, g, mask)
    with ThreadPoolExecutor(4) as ex:
        futs = {key: (ex.submit(low.compile), args) for key, (low, args) in jobs.items()}
        out = {key: jax.tree.map(np.asarray, fut.result()(*args))
               for key, (fut, args) in futs.items()}
    return dict(x=x, mask=mask, z=z, g=g, params=params, jax=out)


@contextmanager
def _recording():
    """Record the arguments of every quantizer and conv call (the wrappers,
    which the CPU runs as their plain versions)."""
    seen = {"quant": [], "conv": []}
    real_q, real_c = int8_conv.quantize_act, int8_conv.int8_conv1d

    def quant(x, slope=None, mask=None):
        seen["quant"].append((slope, mask is not None))
        return real_q(x, slope, mask)

    def conv(*args, residual=None, **kw):
        seen["conv"].append(residual is not None)
        return real_c(*args, residual=residual, **kw)

    int8_conv.quantize_act, int8_conv.int8_conv1d = quant, conv
    try:
        yield seen
    finally:
        int8_conv.quantize_act, int8_conv.int8_conv1d = real_q, real_c


def _close(got, want):
    assert got.shape == want.shape
    assert np.linalg.norm(got - want) <= DEC_REL_L2 * np.linalg.norm(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=DEC_MAX * float(np.abs(want).max()))


@pytest.mark.parametrize("pre", list(PRE))
def test_fused_quantizer_matches_jax_bit_for_bit(refs, pre):
    """x_q and s_x of the pre-activated tensor, from the plain version and
    from the wrapper (the CPU's dispatch): equal to JAX's, ties rounded half
    to even, -0.0 and the masked frames' zeros to 0."""
    slope, masked = PRE[pre]
    x = _t(refs["x"]).transpose(1, 2)  # [B, C, T]
    mask = _t(refs["mask"]).transpose(1, 2) if masked else None  # [B, 1, T]
    want_q, want_s = refs["jax"][("quant", pre)]
    for q, s in (int8_conv.quantize_act_plain(x, slope, mask),
                 int8_conv.quantize_act(x, slope, mask)):
        np.testing.assert_array_equal(q.numpy(), want_q)  # [B, T, C] both
        assert s.dim() == 0 and float(s) == float(want_s)
    assert float(want_s) == np.float32(127.0) * np.float32(1.0 / 127.0)  # the ties are exact
    row = want_q[0, 0, :8].tolist()
    assert row[:4] == [127, 2, 4, 0]
    assert row[4:6] == ([-2, -4] if slope is not None else [-25, -35])
    if masked:
        assert not want_q[1, LENGTHS[1]:].any()


def test_conv_residual_matches_eager_jax_bit_for_bit():
    """int8_conv1d_plain with a residual (and the wrapper on the CPU) on
    JAX's own quantized operands: the eager JAX conv plus the residual."""
    rng = np.random.default_rng(23)
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    res = rng.standard_normal((B, T, 48)).astype(np.float32)
    bias = (0.2 * rng.standard_normal(48)).astype(np.float32)
    for k, d in ((3, 1), (7, 3)):
        kern = (rng.standard_normal((k, C, 48)) / np.sqrt(k * C)).astype(np.float32)
        pad = ((k - 1) * d // 2,) * 2
        x_q, s_x = jquant.quantize_act_dynamic(x)
        w_q, s_w = jquant.quantize_weight_per_channel(kern)
        args = (_t(x_q), _t(s_x), _t(np.asarray(w_q).transpose(2, 0, 1)), _t(s_w))
        for b in (bias, None):
            want = np.asarray(jquant.int8_conv1d(x, kern, b, padding=pad, dilation=d) + res)
            b_t = None if b is None else _t(b)
            r_t = _t(res).transpose(1, 2).contiguous()
            got = int8_conv.int8_conv1d_plain(*args, b_t, pad, d, residual=r_t)
            np.testing.assert_array_equal(got.transpose(1, 2).numpy(), want)
            got = int8_conv.int8_conv1d(*args, b_t, pad, d, residual=r_t)
            np.testing.assert_array_equal(got.transpose(1, 2).numpy(), want)
    with pytest.raises(RuntimeError, match="inference only"):
        int8_conv.int8_conv1d(*args, None, pad, d, residual=r_t.clone().requires_grad_())
    with pytest.raises(RuntimeError, match="inference only"):
        int8_conv.quantize_act(_t(x).transpose(1, 2), 0.1,
                               torch.ones(B, 1, T, requires_grad=True))


@pytest.mark.parametrize("kind", list(BLOCKS), ids=["resblock1", "resblock2"])
def test_int8_resblocks_on_the_fused_path_match_jax(refs, kind):
    """Unmasked and masked: every conv quantizes lrelu(x) (* mask) in its
    quantizer, and each block's last conv of a dilation adds the residual
    in its epilogue."""
    _, cls, (k, dils) = BLOCKS[kind]
    block = cls(C, k, dils, quant="int8").eval()
    block.load_state_dict(_block_params(kind, refs["params"][kind]), strict=True)
    x, m = _t(refs["x"]).transpose(1, 2), _t(refs["mask"]).transpose(1, 2)
    with torch.inference_mode(), _recording() as seen:
        got = [block(x).transpose(1, 2).numpy(), block(x * m, m).transpose(1, 2).numpy()]
    for a, b in zip(got, refs["jax"][("block", kind)]):
        _close(a, b)
    n = len(seen["quant"]) // 2
    assert n == (4 if kind == "1" else 2)
    assert seen["quant"] == [(0.1, False)] * n + [(0.1, True)] * n
    assert seen["conv"] == ([False, True] * 2 if kind == "1" else [True] * 2) * 2


@pytest.mark.parametrize("which", ["hifigan", "mbistft"])
def test_int8_decoders_on_the_fused_path_match_jax(refs, which):
    """A small int8 HiFi-GAN (every stage int8) and MB-iSTFT decode, with g,
    unmasked and masked: conv_pre quantizes x (* mask), every transposed
    conv and resblock conv lrelu(x) (* mask); no int8 conv's input is
    formed before it."""
    if which == "hifigan":
        model = Generator(D, fuse_mrf=True, gin_channels=GIN, quant_int8=True, **HIFI).eval()
    else:
        model = MultiBandISTFTGenerator(D, fuse_mrf=True, gin_channels=GIN, quant_int8=True,
                                        **MB).eval()
    model.load_state_dict(generator_state_dict_from_jax_params(refs["params"][which], (0, 0)),
                          strict=True)
    z, g, m = (_t(refs[k]).transpose(1, 2) for k in ("z", "g", "mask"))
    with torch.inference_mode(), _recording() as seen:
        got = [model(z, g=g), model(z * m, x_mask=m, g=g)]
    for a, b in zip(got, refs["jax"][("gen", which)]):
        _close(a.transpose(1, 2).numpy(), b)
    n = len(seen["quant"]) // 2
    ups = len(model.ups)
    assert seen["quant"][0] == (None, False) and seen["quant"][n] == (None, True)
    assert seen["quant"][1:n] == [(0.1, False)] * (n - 1)
    assert seen["quant"][n + 1:] == [(0.1, True)] * (n - 1)
    assert sum(seen["conv"]) == 2 * (n - 1 - ups) // 2  # conv2 of each dilation, twice


def test_fp_route_applies_the_pre_activation_and_residual_as_before():
    """Without quant the layers and blocks compute exactly what they did
    with the activation, mask and residual written out in torch ops."""
    torch.manual_seed(3)
    x, r = torch.randn(B, C, T), torch.randn(B, 32, T)
    m = (torch.arange(T)[None, None, :] < torch.tensor(LENGTHS)[:, None, None]).float()
    conv = Conv1d(C, 32, 5, padding=4, dilation=2, weight_norm=True)
    tconv = ConvTranspose1d(C, 32, 4, stride=2, padding=1)
    with torch.no_grad():
        want = F.conv1d(leaky_relu(x) * m, conv.effective_weight(), conv.bias, padding=4,
                        dilation=2) + r
        assert torch.equal(conv(x, 0.1, m, residual=r), want)
        assert torch.equal(conv(x), F.conv1d(x, conv.effective_weight(), conv.bias, padding=4,
                                             dilation=2))
        want = F.conv_transpose1d(leaky_relu(x) * m, tconv.effective_weight(), tconv.bias,
                                  stride=2, padding=1)
        assert torch.equal(tconv(x, 0.1, m), want)
        block1, block2 = ResBlock1(C, 3, (1, 3)), ResBlock2(C, 3, (1, 3))
        for c in (*block1.convs1, *block1.convs2, *block2.convs):
            c.weight_g.uniform_(0.5, 1.5)
        y = x
        for c1, c2 in zip(block1.convs1, block1.convs2):
            xt = F.conv1d(leaky_relu(y) * m, c1.effective_weight(), c1.bias,
                          padding=c1.padding[0], dilation=c1.dilation)
            xt = F.conv1d(leaky_relu(xt) * m, c2.effective_weight(), c2.bias,
                          padding=c2.padding[0])
            y = xt + y
        assert torch.equal(block1(x, m), y * m)
        y = x
        for c in block2.convs:
            y = F.conv1d(leaky_relu(y) * m, c.effective_weight(), c.bias, padding=c.padding[0],
                         dilation=c.dilation) + y
        assert torch.equal(block2(x, m), y * m)


def _int8_conv_shapes(model, frames):
    """(C_in, N, taps, dilation, padding, phases, T, T_out) of every int8
    conv of a decoder built on the meta device, in forward order, for a
    decode of `frames` latent frames."""
    out, t = [], frames

    def conv(m, T_in):
        w = m.weight_v if hasattr(m, "weight_v") else m.weight
        if isinstance(m, ConvTranspose1d):  # the subpixel dense conv: w [in, out, k]
            q_max, q_min, a = m._subpixel_taps()
            c_in, n, k, d, pad, ph = (w.shape[0], w.shape[1] * m.stride, a.shape[0], 1,
                                      (q_max, -q_min), m.stride)
        else:  # w [out, in, k]
            c_in, n, k, d, pad, ph = (w.shape[1], w.shape[0], m.kernel_size, m.dilation,
                                      m.padding, 1)
        T_out = T_in + pad[0] + pad[1] - d * (k - 1)
        out.append((c_in, n, k, d, tuple(pad), ph, T_in, T_out))

    if model.conv_pre.quant is not None:
        conv(model.conv_pre, t)
    nk = model.num_kernels
    for i, (up, u) in enumerate(zip(model.ups, model.upsample_rates)):
        if up.quant is not None:
            conv(up, t)
        t *= u
        for block in model.resblocks[i * nk:(i + 1) * nk]:
            if block.quant is None:
                continue
            convs = (list(block.convs1) + list(block.convs2) if isinstance(block, ResBlock1)
                     else list(block.convs))
            for c in convs:
                conv(c, t)
    return out


def test_conv_tile_plan_covers_every_decoder_shape():
    """Every int8 conv of configs/vits2-ljspeech.yaml's decoder (with and
    without pack_narrow) and of the MB-iSTFT trunk, at B = 1 and 8, at
    1024 and 1001 frames and the stream's 128-frame patch window, on
    cards of 132 and 114 SMs: the tile is one of the kernel's, its columns
    hold whole phase groups, its grid covers every output row and column,
    and a grid that 128 x 128 tiles leave short of the SMs takes smaller
    tiles (the window's conv_pre, up_0 and up_1 no longer on 1-8 CTAs)."""
    c = VITS2ModelConfig()
    with torch.device("meta"):
        models = [Generator(192, "1", c.resblock_kernel_sizes, c.resblock_dilation_sizes,
                            c.upsample_rates, c.upsample_initial_channel,
                            c.upsample_kernel_sizes, quant_int8=True, pack_narrow=pack)
                  for pack in (True, False)]
        models.append(MultiBandISTFTGenerator(192, upsample_rates=(4, 4),
                                              upsample_kernel_sizes=(16, 16), quant_int8=True))
    seen = set()
    for model in models:
        for frames in (128, 1001, 1024):
            shapes = _int8_conv_shapes(model, frames)
            assert len(shapes) in (39, 77)
            for Bq in (1, 8):
                for sms in (132, 114):
                    for c_in, n, k, d, pad, ph, t_in, t_out in shapes:
                        assert int8_conv.supports(c_in, n, k, d)
                        bm, bn, bn_eff, tiles = int8_conv.conv_tile(Bq, t_out, n, ph, sms)
                        assert (bm, bn) in int8_conv.CONV_TILES
                        assert 1 <= bn_eff <= bn and (bn_eff % ph == 0 or ph % bn_eff == 0)
                        mt, nt = math.ceil(t_out / bm), math.ceil(n / bn_eff)
                        assert tiles == Bq * mt * nt < 2 ** 31
                        assert mt * bm >= t_out > (mt - 1) * bm and nt * bn_eff >= n
                        big = Bq * math.ceil(t_out / 128) * math.ceil(n / 128)
                        assert (bm, bn) == (128, 128) or big < sms
                        if big < sms:
                            assert tiles > big
                        seen.add((bm, bn))
    assert seen == set(int8_conv.CONV_TILES)
    window = _int8_conv_shapes(models[0], 128)
    for c_in, n, k, d, pad, ph, t_in, t_out in window[:2] + window[20:21]:  # conv_pre, up_0, up_1
        assert int8_conv.conv_tile(1, t_out, n, ph, 132)[3] >= 16
    assert int8_conv.tile_columns(128, 3) == 126 and int8_conv.tile_columns(64, 160) == 40
