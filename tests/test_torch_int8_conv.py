"""The int8 ops (`ops/quant.py`, `kernels/int8_conv.py`) and the int8
layers (`ops/layers.py`, `quant="int8"`): the port against the JAX
package's `torch_tts_tpu/ops/quant.py` on the CPU.

Inputs from a numpy seed, fp32. Each JAX reference is jitted once and
compiled in a thread pool as soon as it is traced.

- The two quantizers on shared inputs: int8 values and scales equal bit
  for bit to the jitted JAX functions (the same max; the scale as XLA
  computes max / 127 under jit, times fp32(1 / 127); IEEE division by the
  scale and half-to-even rounding), including exact ties and an all-zero
  channel.
- `int8_conv1d` for k in {3, 7, 11} x dilation in {1, 3, 5}, with and
  without bias: within 1e-6 of the output's peak. The int32 sums are exact
  on both sides; XLA contracts the epilogue's multiply and add into one
  rounding, the port rounds each (as its CUDA kernel does), so the two
  differ by an ulp.
- The plain conv against an int64 numpy reference, bit for bit, with the
  subpixel phases' interleave and the bias per output channel.
- `Conv1d(quant="int8")` and `ConvTranspose1d(quant="int8")` (the subpixel
  route at HiFi-GAN's, MB-iSTFT's and a narrow stage's geometry; another
  geometry stays fp) with weight-normed weights carried over: within 1e-5
  of the peak. The two packages normalise the weights in another summation
  order; an ulp there can move one int8 weight by one step, which moves
  an output by about s_x * s_w.
- The wrappers refuse a gradient and a stride other than 1; the shape gate.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax

from torch_tts_tpu.ops import quant as jquant
from torch_tts_tpu.ops.layers import Conv1d as JConv1d
from torch_tts_tpu.ops.layers import ConvTranspose1d as JConvTranspose1d
from torch_tts_tpu_torch.kernels import int8_conv
from torch_tts_tpu_torch.ops import quant
from torch_tts_tpu_torch.ops.layers import Conv1d, ConvTranspose1d

B, T, C_IN, C_OUT = 2, 24, 64, 48
KS, DILATIONS = (3, 7, 11), (1, 3, 5)
CONV_RTOL = 1e-6  # of the peak: one ulp from the epilogue's rounding
LAYER_RTOL = 1e-5  # of the peak: a weight-norm ulp may move one int8 weight
# transposed convs (k, stride, padding): HiFi-GAN's 8x stage, MB-iSTFT's 4x,
# a 2x narrow stage; all on the subpixel geometry k - u - 2p = 0
SUBPIXEL = ((16, 8, 4), (16, 4, 6), (4, 2, 1))
DILATED = (5, 2, 1)  # k - u - 2p = 1: the input-dilated route, fp


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while this module runs: under pytest-xdist a thread
    per core in every worker oversubscribes the cores, which slowed the
    port's tests about twofold and took CPU from the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _wn_params(rng, shape, out_axis):
    """Weight-normed params of a scale a decoder has: v, g (the norm of v
    over every axis but out_axis, times 1 + noise), bias."""
    v = (rng.standard_normal(shape) / np.sqrt(np.prod(shape) / shape[out_axis]))
    axes = tuple(i for i in range(len(shape)) if i != out_axis)
    g = np.sqrt((v * v).sum(axis=axes)) * (1 + 0.1 * rng.standard_normal(shape[out_axis]))
    return {"v": v.astype(np.float32), "g": g.astype(np.float32)}


@pytest.fixture(scope="module")
def refs():
    """Inputs, weights and every JAX reference, compiled in threads."""
    rng = np.random.default_rng(31)
    x = rng.standard_normal((B, T, C_IN)).astype(np.float32)
    w = {k: (rng.standard_normal((k, C_IN, C_OUT)) / np.sqrt(k * C_IN)).astype(np.float32)
         for k in KS}
    bias = (0.2 * rng.standard_normal(C_OUT)).astype(np.float32)
    conv_p = dict(_wn_params(rng, (7, C_IN, C_OUT), 2), bias=bias)
    tconv_p = {}
    for k, u, p in SUBPIXEL + (DILATED,):
        c_out = C_IN // 2
        tconv_p[(k, u, p)] = dict(_wn_params(rng, (k, c_out, C_IN), 2),
                                  bias=(0.2 * rng.standard_normal(c_out)).astype(np.float32))

    jobs = {}

    def add(key, fn, *args):
        jobs[key] = (jax.jit(fn).lower(*args), args)

    for k in KS:
        def convs(a, kern, b, _k=k):
            return [jquant.int8_conv1d(a, kern, bb, padding=((_k - 1) * d // 2,) * 2, dilation=d)
                    for d in DILATIONS for bb in (b, None)]
        add(("conv", k), convs, x, w[k], bias)
    layer = JConv1d(C_OUT, 7, padding=9, dilation=3, weight_norm=True, quant="int8")
    add("layer", lambda p, a: layer.apply({"params": p}, a), conv_p, x)
    for (k, u, p), params in tconv_p.items():
        tl = JConvTranspose1d(C_IN // 2, k, stride=u, padding=p, weight_norm=True, quant="int8")
        add(("tconv", k, u, p), lambda pp, a, _tl=tl: _tl.apply({"params": pp}, a), params, x)
    with ThreadPoolExecutor(4) as ex:
        futs = {key: (ex.submit(lowered.compile), args) for key, (lowered, args) in jobs.items()}
        out = {key: jax.tree.map(np.asarray, fut.result()(*args))
               for key, (fut, args) in futs.items()}
    return dict(x=x, w=w, bias=bias, conv_p=conv_p, tconv_p=tconv_p, jax=out)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol):
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * float(np.abs(want).max()))


def test_weight_quantizer_matches_jax_bit_for_bit(refs):
    """Per output channel; a zero channel takes the 1e-12 floor."""
    for k in KS:
        kern = refs["w"][k].copy()
        kern[..., 5] = 0.0
        w_q, s_w = jax.jit(jquant.quantize_weight_per_channel)(kern)
        # the port keeps the output channel on dim 0: [out, in, k]
        p_q, p_s = quant.quantize_weight_per_channel(_t(kern.transpose(2, 1, 0)))
        assert p_q.dtype == torch.int8 and p_s.dtype == torch.float32
        np.testing.assert_array_equal(p_q.numpy().transpose(2, 1, 0), np.asarray(w_q))
        np.testing.assert_array_equal(p_s.numpy(), np.asarray(s_w))
        assert float(p_s[5]) == np.float32(1e-12) / np.float32(127.0)
        w_k, s_k = quant.conv_weights(_t(kern.transpose(2, 1, 0)))
        np.testing.assert_array_equal(w_k.numpy(), np.asarray(w_q).transpose(2, 0, 1))
        np.testing.assert_array_equal(s_k.numpy(), np.asarray(s_w))


def test_activation_quantizer_matches_jax_bit_for_bit(refs):
    """One scale over the whole tensor; exact ties round half to even; the
    kernel's plain version is the same values channels-last."""
    x = refs["x"]
    ties = x.copy()
    ties[0, 0, :8] = [127.0, 2.5, 3.5, -0.5, -1.5, 0.5, 126.5, -127.0]  # s_x = 1
    ties[1] = np.clip(ties[1], -100, 100)
    for a in (x, ties, np.zeros_like(x)):
        x_q, s_x = jax.jit(jquant.quantize_act_dynamic)(a)
        p_q, p_s = quant.quantize_act_dynamic(_t(a))
        np.testing.assert_array_equal(p_q.numpy(), np.asarray(x_q))
        assert p_s.dim() == 0 and float(p_s) == float(s_x)
        k_q, k_s = int8_conv.quantize_act_plain(_t(a).transpose(1, 2))  # [B, C, T] in
        np.testing.assert_array_equal(k_q.numpy(), np.asarray(x_q))  # [B, T, C] out
        assert k_q.is_contiguous() and float(k_s) == float(s_x)
    assert list(np.asarray(jquant.quantize_act_dynamic(ties)[0])[0, 0, :8]) == [
        127, 2, 4, 0, -2, 0, 126, -127]


@pytest.mark.parametrize("k", KS)
def test_int8_conv1d_matches_jax(refs, k):
    x = _t(refs["x"]).transpose(1, 2)  # the port's [B, C, T]
    w = _t(refs["w"][k].transpose(2, 1, 0))  # [out, in, k]
    want = iter(refs["jax"][("conv", k)])
    for d in DILATIONS:
        for b in (_t(refs["bias"]), None):
            got = quant.int8_conv1d(x, w, b, padding=((k - 1) * d // 2,) * 2, dilation=d)
            ref = next(want)
            assert got.shape == (B, C_OUT, T) and got.dtype == torch.float32
            _close(got.transpose(1, 2).numpy(), ref, CONV_RTOL)


def test_plain_conv_is_exact_integer_arithmetic():
    """int8_conv1d_plain against int64 sums in numpy: the same bits, with
    phases interleaved into the output and bias per output channel."""
    rng = np.random.default_rng(3)
    Bq, Tq, C, N, k, d, phases, pad = 2, 9, 32, 12, 3, 2, 4, (3, 1)
    x_q = rng.integers(-127, 128, (Bq, Tq, C)).astype(np.int8)
    w_q = rng.integers(-127, 128, (N, k, C)).astype(np.int8)
    s_x, s_w = np.float32(0.013), rng.uniform(1e-3, 1e-2, N).astype(np.float32)
    bias = rng.standard_normal(N // phases).astype(np.float32)
    T_out = Tq + pad[0] + pad[1] - d * (k - 1)
    xp = np.pad(x_q.astype(np.int64), ((0, 0), pad, (0, 0)))
    acc = sum(xp[:, j * d:j * d + T_out] @ w_q[:, j].astype(np.int64).T for j in range(k))
    y = acc.astype(np.float32) * (s_x * s_w)  # [B, T_out, N], column n = o * phases + r
    want = (y.reshape(Bq, T_out, N // phases, phases) + bias[:, None]).transpose(0, 2, 1, 3)
    got = int8_conv.int8_conv1d_plain(_t(x_q), torch.tensor(s_x), _t(w_q), _t(s_w), _t(bias),
                                      pad, d, phases)
    np.testing.assert_array_equal(got.numpy(), want.reshape(Bq, N // phases, T_out * phases))
    got = int8_conv.int8_conv1d(_t(x_q), torch.tensor(s_x), _t(w_q), _t(s_w), None, pad, d)
    np.testing.assert_array_equal(got.numpy(), y.transpose(0, 2, 1))


def test_conv1d_layer_int8_matches_jax(refs):
    """A weight-normed, dilated Conv1d with quant="int8"; its state dict is
    the fp layer's."""
    p = refs["conv_p"]
    layer = Conv1d(C_IN, C_OUT, 7, padding=9, dilation=3, weight_norm=True, quant="int8")
    sd = {"weight_v": _t(p["v"].transpose(2, 1, 0)), "weight_g": _t(p["g"]).reshape(-1, 1, 1),
          "bias": _t(p["bias"])}
    layer.load_state_dict(sd, strict=True)
    assert set(layer.state_dict()) == set(Conv1d(C_IN, C_OUT, 7, weight_norm=True).state_dict())
    with torch.inference_mode():
        got = layer(_t(refs["x"]).transpose(1, 2))
    _close(got.transpose(1, 2).numpy(), refs["jax"]["layer"], LAYER_RTOL)


@pytest.mark.parametrize("geometry", SUBPIXEL + (DILATED,),
                         ids=["hifigan_x8", "mbistft_x4", "narrow_x2", "dilated_fp"])
def test_conv_transpose_int8_matches_jax(refs, geometry):
    """The subpixel route's dense kernel, one scale per (channel, phase)
    column, phases interleaved, bias after; the dilated geometry stays fp
    in both packages."""
    k, u, pad = geometry
    p = refs["tconv_p"][geometry]
    layer = ConvTranspose1d(C_IN, C_IN // 2, k, stride=u, padding=pad, quant="int8")
    layer.load_state_dict({"weight_v": _t(p["v"].transpose(2, 1, 0)),
                           "weight_g": _t(p["g"]).reshape(-1, 1, 1), "bias": _t(p["bias"])},
                          strict=True)
    assert layer.subpixel == (geometry != DILATED)
    x = _t(refs["x"]).transpose(1, 2)
    with torch.inference_mode():
        got = layer(x)
        if layer.subpixel:  # the dense kernel's stride-1 conv is the transposed conv, in fp
            fp = torch.nn.functional.conv_transpose1d(x, layer.effective_weight(), layer.bias,
                                                      stride=u, padding=pad)
            q_max, q_min, _ = layer._subpixel_taps()
            dense = torch.nn.functional.conv1d(
                torch.nn.functional.pad(x, (q_max, -q_min)), layer.subpixel_weight())
            dense = dense.reshape(B, C_IN // 2, u, T).permute(0, 1, 3, 2).reshape(B, -1, T * u)
            _close((dense + layer.bias[:, None]).numpy(), fp.numpy(), 1e-5)
    want = refs["jax"][("tconv", k, u, pad)]
    assert got.shape == (B, C_IN // 2, want.shape[1])
    _close(got.transpose(1, 2).numpy(), want, LAYER_RTOL)


def test_int8_wrappers_refuse_a_gradient_and_a_stride():
    x = torch.randn(1, 32, 10, requires_grad=True)
    with pytest.raises(RuntimeError, match="inference only"):
        int8_conv.quantize_act(x)
    with torch.no_grad():
        x_q, s_x = int8_conv.quantize_act(x)
    w_q = torch.zeros(8, 3, 32, dtype=torch.int8)
    s_w = torch.ones(8, requires_grad=True)
    with pytest.raises(RuntimeError, match="inference only"):
        int8_conv.int8_conv1d(x_q, s_x, w_q, s_w, None, (1, 1))
    with pytest.raises(ValueError, match="stride"):
        int8_conv.int8_conv1d(x_q, s_x, w_q, s_w.detach(), None, (1, 1), stride=2)
    layer = Conv1d(32, 8, 3, padding=1, weight_norm=True, quant="int8")
    with pytest.raises(RuntimeError, match="inference only"):
        layer(torch.randn(1, 32, 10))  # its parameters need a gradient
    with pytest.raises(ValueError, match="stride"):
        quant.int8_conv1d(x.detach(), torch.zeros(8, 32, 3), stride=2)
    for kw in (dict(groups=2), dict(stride=2)):
        with pytest.raises(ValueError, match="grouped or strided"):
            Conv1d(32, 8, 3, quant="int8", **kw)


def test_supports_takes_every_decoder_shape():
    """The int8 convs of the shipped configs (C_in; columns incl. phases;
    taps) are taken, and so is a C_in off the 32-byte K step (padded to
    it); a K whose int32 sums could overflow (counted at the padded width),
    or no dilation, is not. conv_weights packs w_q's rows at the padded
    width with zeros past C_in, which `padded_rows` reads in place; a
    tensor with rows C_in apart is copied into such a buffer."""
    shipped = [(192, 512, 7), (512, 8 * 256, 3), (256, 8 * 128, 3), (512, 4 * 256, 5),
               (256, 4 * 128, 5), (128, 2 * 64, 3), (64, 2 * 32, 3)]
    shipped += [(c, c, k) for c in (256, 128, 64, 32) for k in KS]
    for c_in, n, k in shipped:
        for d in DILATIONS:
            assert int8_conv.supports(c_in, n, k, d), (c_in, n, k, d)
    for c_in in (1, 16, 48, 80, 81):
        assert int8_conv.supports(c_in, 16, 3, 1), c_in
    assert not int8_conv.supports(4096, 16, 33, 1)
    assert not int8_conv.supports(4095, 16, 33, 1)  # 4096 padded channels x 33 taps
    assert int8_conv.supports(4095, 16, 32, 1)
    assert not int8_conv.supports(64, 16, 3, 0)
    assert [int8_conv.padded_channels(c) for c in (1, 32, 33, 80, 81, 96)] == [
        32, 32, 64, 96, 96, 96]
    g = torch.Generator().manual_seed(81)
    w_q, s_w = quant.conv_weights(torch.randn(24, 81, 7, generator=g))
    assert w_q.shape == (24, 7, 81) and w_q.stride() == (7 * 96, 96, 1)
    assert int8_conv.padded_rows(w_q) is w_q
    base = w_q.as_strided((24, 7, 96), (7 * 96, 96, 1))
    assert torch.equal(base[..., 81:], torch.zeros(24, 7, 15, dtype=torch.int8))
    np.testing.assert_array_equal(w_q.numpy(), quant.quantize_weight_per_channel(
        torch.randn(24, 81, 7, generator=torch.Generator().manual_seed(81)))[0].numpy()
        .transpose(0, 2, 1))
    dense = w_q.contiguous()
    copy = int8_conv.padded_rows(dense)
    assert copy is not dense and copy.stride() == w_q.stride() and torch.equal(copy, dense)
    assert torch.equal(copy.as_strided((24, 7, 96), (7 * 96, 96, 1))[..., 81:],
                       torch.zeros(24, 7, 15, dtype=torch.int8))
