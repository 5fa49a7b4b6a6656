"""Export (`infer/export.py`, `infer/vocoder.export_vocoder`, `cli/export.py`),
the kernels' `tts::` operators and the TTSB files: the port against the JAX
package, on the CPU.

Tiny VITS2 models whose flows have H = 192 (so, with TTS_FUSED_WN=1 while
the port exports, the flows' WN groups are `tts::wn_group` nodes) and whose
decoders have a ResBlock1 stage of C in {32, 64, 128} (a `tts::mrf_fused`
node): HiFi-GAN, MB-iSTFT, multi-speaker, and the int8 decoder (one int8
stage, one fp stage). Random weights from a numpy seed, loaded into both
through the port's converter with strict=True. The JAX side is the JAX
package's own export (`export_vits2_infer` -> `load_exported(...).call`),
each program compiled in a thread as soon as it is traced.

- Exported programs against JAX's at scales (0, 1, 0), where both
  packages' noise draws are multiplied by zero (JAX's threefry stream has
  no torch counterpart; the JAX savedmodel test does the same): y_lengths
  exactly, the waveform within 1e-4 (MB-iSTFT audio has no tanh: 1e-4 of
  its peak when that exceeds 1). The int8 model by the error-norm criterion
  of tests/test_torch_int8_infer.py (an activation on a rounding boundary
  flips by an int8 step; 2e-2 of the waveform's L2 norm).
- Exported programs against the port's eager `infer` at nonzero scales,
  after the same `torch.manual_seed` (`DEFAULT_RNG`): within 1e-6.
- The `.pt2` files round-trip (the HiFi-GAN and int8 programs and the
  vocoder's are saved and loaded back before they run), and the graphs
  hold the operators.
- The vocoder's program against JAX's `export_vocoder_stablehlo` on the
  same msgpack artifact: within 1e-5.
- TTSB files byte for byte both ways; `cli/export.py` on the CPU; each
  operator's fake function against its real output (shape, dtype, strides).
"""

import dataclasses
import json
import os
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import jax
import jax.numpy as jnp

from test_torch_vits2_infer import random_params
from torch_tts_tpu.core.config import VITS2ModelConfig as JaxModelConfig
from torch_tts_tpu.infer import artifacts as jart
from torch_tts_tpu.infer import export as jexport
from torch_tts_tpu.infer import vocoder as jvoc
from torch_tts_tpu.models.vits2 import SynthesizerTrn as JaxSynth
from torch_tts_tpu.ops.hifigan import Generator as JaxGenerator
from torch_tts_tpu_torch.cli import export as export_cli
from torch_tts_tpu_torch.core.config import VITS2Config, VITS2ModelConfig
from torch_tts_tpu_torch.infer import artifacts, export, vocoder
from torch_tts_tpu_torch.kernels import int8_conv, mrf_fused, wn_stack
from torch_tts_tpu_torch.models.vits2 import build_synthesizer
from torch_tts_tpu_torch.models.vits2.convert import state_dict_from_jax_params
from torch_tts_tpu_torch.models.vits2.model import DEFAULT_RNG, SynthesizerTrn
from torch_tts_tpu_torch.text import symbols

N_VOCAB, SPEC_CH, T_TEXT, N_TEXT, MAX_FRAMES = 20, 12, 24, 19, 160
WAVE_ATOL, EAGER_ATOL, VOC_ATOL, WAVE_REL_L2 = 1e-4, 1e-6, 1e-5, 2e-2
NOISY = (0.667, 1.0, 0.8)
BASE = dict(inter_channels=8, hidden_channels=192, filter_channels=16, n_heads=2, n_layers=1,
            kernel_size=3, p_dropout=0.0, resblock="1", resblock_kernel_sizes=(3, 5),
            resblock_dilation_sizes=((1, 3), (1, 3)), upsample_rates=(4, 2),
            upsample_initial_channel=64, upsample_kernel_sizes=(8, 4),
            use_transformer_flows=True, transformer_flow_type="pre_conv", segment_size=64,
            fuse_mrf=True, posterior_wn_layers=1, flow_n_flows=2)
CONFIGS = {
    "hifigan": {},  # stages of 32 (the MRF kernel's) and 16 channels
    "mb_istft": dict(decoder_type="mb_istft", upsample_rates=(4,), upsample_kernel_sizes=(16,),
                     upsample_initial_channel=256, subbands=4, gen_istft_n_fft=16,
                     gen_istft_hop_size=4),
    "multispeaker": dict(n_speakers=3, gin_channels=16, use_spk_conditioned_encoder=True,
                         n_layers=3),  # the speaker enters before layer 2
    # stage 0 (128 channels) int8, stage 1 (64) fp as pack_narrow_convs keeps it
    "int8": dict(quantize_decoder=True, pack_narrow_convs=True, upsample_initial_channel=256),
}
GEN_KWARGS = dict(resblock="1", resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),),
                  upsample_rates=(4, 4, 2), upsample_initial_channel=64,
                  upsample_kernel_sizes=(8, 8, 4))
VOC_MELS, VOC_SR, VOC_FRAMES = 20, 8000, 24
ROUND_TRIP = ("hifigan", "int8")  # VITS2 programs saved to .pt2 and loaded back (and the vocoder)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while this module runs: under pytest-xdist a thread
    per core in every worker oversubscribes the cores, which slowed the
    port's tests about twofold and took CPU from the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(rng, multispeaker):
    ids = np.zeros((1, T_TEXT), np.int32)
    ids[0, :N_TEXT] = rng.integers(1, N_VOCAB, N_TEXT)
    args = [ids, np.asarray([N_TEXT], np.int32)]
    return args, (np.asarray([2], np.int32) if multispeaker else None)


def _torch_args(args, scales, sid):
    out = [torch.from_numpy(a) for a in args] + [torch.tensor(scales, dtype=torch.float32)]
    return out + ([torch.from_numpy(sid)] if sid is not None else [])


@pytest.fixture(scope="module")
def progs(tmp_path_factory):
    """Per config the port's model and exported program (also saved as
    .pt2) and JAX's exported program's outputs at scales (0, 1, 0); the
    vocoder's pair."""
    tmp = tmp_path_factory.mktemp("export")
    rng = np.random.default_rng(21)
    out, pending = {}, {}
    with ThreadPoolExecutor(len(CONFIGS) + 1) as ex:
        for name, kw in CONFIGS.items():
            jcfg = JaxModelConfig(**{**BASE, **kw})
            jmodel = JaxSynth(n_vocab=N_VOCAB, spec_channels=SPEC_CH, segment_frames=4, cfg=jcfg)
            ms = jcfg.n_speakers > 1
            extra = {"sid": jnp.asarray([1])} if ms else {}
            rngs = {k: jax.random.PRNGKey(i) for i, k in enumerate(("params", "noise", "dropout"))}
            shapes = jax.eval_shape(lambda: jmodel.init(
                rngs, jnp.ones((1, 5), jnp.int32), jnp.asarray([5]), jnp.zeros((1, 16, SPEC_CH)),
                jnp.asarray([16]), **extra)["params"])
            params = random_params(shapes, rng)
            args, sid = _inputs(rng, ms)
            jargs = [params, *map(jnp.asarray, args), jnp.asarray([0.0, 1.0, 0.0], jnp.float32)]
            jargs += [jnp.asarray(sid)] if ms else []
            exported = jexport.load_exported(jexport.export_vits2_infer(
                jmodel, params, max_text_len=T_TEXT, max_frames=MAX_FRAMES, multispeaker=ms))
            pending[name] = (ex.submit(jax.jit(exported.call).lower(*jargs).compile), jargs)

            model = SynthesizerTrn(N_VOCAB, SPEC_CH, VITS2ModelConfig(**{**BASE, **kw}))
            model.load_state_dict(state_dict_from_jax_params(params, jcfg), strict=True)
            # saved and loaded back where ROUND_TRIP says (a load takes seconds)
            path = str(tmp / f"{name}.pt2") if name in ROUND_TRIP else None
            with mock.patch.dict(os.environ, {"TTS_FUSED_WN": "1"}):
                program = export.export_vits2_infer(model, max_text_len=T_TEXT,
                                                    max_frames=MAX_FRAMES, multispeaker=ms,
                                                    path=path, device="cpu")
            out[name] = dict(model=model.eval(), args=args, sid=sid, program=(
                export.load_exported(path) if path else program.module().requires_grad_(False)))

        # the vocoder: one JAX msgpack artifact, read by both packages
        vshapes = jax.eval_shape(lambda: JaxGenerator(**GEN_KWARGS).init(
            {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 8, VOC_MELS)))["params"])
        art = str(tmp / "vocoder.msgpack")
        jvoc.save_vocoder(art, random_params(vshapes, rng), gen_kwargs=GEN_KWARGS,
                          sample_rate=VOC_SR, num_mels=VOC_MELS)
        mel = rng.random((1, VOC_FRAMES, VOC_MELS)).astype(np.float32)
        vexp = jexport.load_exported(jvoc.export_vocoder_stablehlo(jvoc.load_vocoder(art),
                                                                   VOC_FRAMES))
        pending["vocoder"] = (ex.submit(jax.jit(vexp.call).lower(jnp.asarray(mel)).compile),
                              [jnp.asarray(mel)])
        vpath = str(tmp / "vocoder.pt2")
        vocoder.export_vocoder(vocoder.load_vocoder(art, device="cpu"), VOC_FRAMES, path=vpath,
                               device="cpu")
        out["vocoder"] = dict(program=export.load_exported(vpath), mel=mel)
        for name, (fut, jargs) in pending.items():
            out[name]["jax"] = jax.tree.map(np.asarray, fut.result()(*jargs))
    return out


@pytest.mark.parametrize("name", ["hifigan", "mb_istft", "multispeaker"])
def test_exported_vits2_matches_jax(progs, name):
    p = progs[name]
    audio, y_lengths = p["program"](*_torch_args(p["args"], (0.0, 1.0, 0.0), p["sid"]))
    want_audio, want_lengths = p["jax"]
    assert audio.shape == want_audio.shape == (1, MAX_FRAMES * (audio.shape[1] // MAX_FRAMES), 1)
    np.testing.assert_array_equal(y_lengths.numpy(), want_lengths)
    assert 0 < int(y_lengths[0]) < MAX_FRAMES
    atol = WAVE_ATOL * max(1.0, float(np.abs(want_audio).max()))
    np.testing.assert_allclose(audio.numpy(), want_audio, rtol=0, atol=atol)


def test_exported_int8_matches_jax(progs):
    p = progs["int8"]
    audio, y_lengths = p["program"](*_torch_args(p["args"], (0.0, 1.0, 0.0), None))
    want_audio, want_lengths = p["jax"]
    np.testing.assert_array_equal(y_lengths.numpy(), want_lengths)
    assert audio.shape == want_audio.shape
    rel = float(np.linalg.norm(audio.numpy() - want_audio) / np.linalg.norm(want_audio))
    assert rel <= WAVE_REL_L2, rel


def test_exported_programs_match_eager_infer(progs):
    """Nonzero scales: the program draws the SDP's noise, then the prior's,
    from the default generator, as `infer(..., generator=DEFAULT_RNG)`."""
    for name in CONFIGS:
        p = progs[name]
        torch.manual_seed(7)
        audio, y_lengths = p["program"](*_torch_args(p["args"], NOISY, p["sid"]))
        torch.manual_seed(7)
        sid = None if p["sid"] is None else torch.from_numpy(p["sid"])
        want, _, _, _, want_lengths = p["model"].infer(
            torch.from_numpy(p["args"][0]), torch.from_numpy(p["args"][1]), sid=sid,
            noise_scale=NOISY[0], length_scale=NOISY[1], noise_scale_w=NOISY[2],
            max_frames=MAX_FRAMES, generator=DEFAULT_RNG)
        torch.testing.assert_close(y_lengths, want_lengths, rtol=0, atol=0)
        torch.testing.assert_close(audio, want, rtol=0, atol=EAGER_ATOL)


def test_programs_hold_the_operators(progs):
    """The graphs, of the programs loaded back from .pt2 files (ROUND_TRIP)
    and of the others, call the `tts::` operators."""
    want = {"hifigan": {"mrf_fused", "wn_group"}, "mb_istft": {"mrf_fused", "wn_group"},
            "multispeaker": {"mrf_fused", "wn_group"},
            "int8": {"mrf_fused", "wn_group", "quantize_act", "int8_conv1d"},
            "vocoder": {"mrf_fused"}}
    for name, ops in want.items():
        seen = {str(n.target).split(".")[1] for n in progs[name]["program"].graph.nodes
                if n.op == "call_function" and str(n.target).startswith("tts.")}
        assert seen == ops, (name, seen)
    counts = {}
    for n in progs["int8"]["program"].graph.nodes:
        counts[str(n.target)] = counts.get(str(n.target), 0) + 1
    # every int8 conv is one quantizer and one conv
    assert counts["tts.quantize_act.default"] == counts["tts.int8_conv1d.default"] > 0


def test_exported_vocoder_matches_jax(progs):
    p = progs["vocoder"]
    wav = p["program"](torch.from_numpy(p["mel"]))
    assert wav.shape == p["jax"].shape == (1, VOC_FRAMES * 32)
    np.testing.assert_allclose(wav.numpy(), p["jax"], rtol=0, atol=VOC_ATOL)


def test_ttsb_files_are_byte_identical_both_ways(tmp_path):
    rng = np.random.default_rng(3)
    tensors = [rng.standard_normal((3, 4)).astype(np.float32),
               rng.integers(-9, 9, (2, 1, 5)).astype(np.int32),
               np.asarray(1.5, np.float32), np.zeros((0, 3), np.int32),
               rng.standard_normal(7).astype(np.float32)[::2]]
    ours, theirs = tmp_path / "port.ttsb", tmp_path / "jax.ttsb"
    artifacts.write_ttsb(str(ours), tensors)
    jart.write_ttsb(str(theirs), tensors)
    assert ours.read_bytes() == theirs.read_bytes()
    for got in (artifacts.read_ttsb(str(theirs)), jart.read_ttsb(str(ours))):
        assert len(got) == len(tensors)
        for a, b in zip(got, tensors):
            b = np.ascontiguousarray(b)  # as written: a 0-d array goes as [1]
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    (tmp_path / "bad").write_bytes(b"NOPE")
    with pytest.raises(ValueError):
        artifacts.read_ttsb(str(tmp_path / "bad"))


def test_export_cli_on_the_cpu(tmp_path):
    """A multi-speaker run's G.pth through `cli/export.py --device cpu`: the
    program takes a sid (detected from n_speakers) and equals eager `infer`."""
    model_kw = {**BASE, **CONFIGS["multispeaker"], "hidden_channels": 16}
    cfg = dataclasses.replace(VITS2Config(), model=VITS2ModelConfig(**model_kw)).check()
    model = build_synthesizer(cfg, len(symbols), seed=3, device="cpu")
    torch.save({"model": model.state_dict()}, tmp_path / "G_5.pth")
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(json.dumps({"model": model_kw, "data": {"n_speakers": 3}}))
    out = tmp_path / "vits2.pt2"
    export_cli.main(["-c", str(cfg_path), "-m", str(tmp_path / "G_5.pth"), "-o", str(out),
                     "--max-text-len", "16", "--max-frames", "40", "--device", "cpu"])
    program = export.load_exported(str(out))
    ids = torch.zeros(1, 16, dtype=torch.int32)
    ids[0, :11] = torch.arange(3, 14)
    args = (ids, torch.tensor([11], dtype=torch.int32), torch.tensor(NOISY),
            torch.tensor([1], dtype=torch.int32))
    torch.manual_seed(2)
    audio, y_lengths = program(*args)
    torch.manual_seed(2)
    want, _, _, _, want_lengths = model.infer(ids, args[1], sid=args[3], noise_scale=NOISY[0],
                                              length_scale=NOISY[1], noise_scale_w=NOISY[2],
                                              max_frames=40, generator=DEFAULT_RNG)
    assert torch.equal(y_lengths, want_lengths)
    torch.testing.assert_close(audio, want, rtol=0, atol=EAGER_ATOL)
    with pytest.raises(SystemExit):  # no savedmodel format in the port
        export_cli.main(["-c", str(cfg_path), "-m", str(tmp_path), "-o", str(out),
                         "--format", "savedmodel"])


def _same_layout(fake, real):
    for f, r in zip(fake, real):
        assert (f.shape, f.dtype, f.stride()) == (r.shape, r.dtype, r.stride())


def test_operator_fakes_give_the_real_layout():
    """On CPU tensors, each operator's fake function against its output; on
    fake CUDA tensors the quantizer's x_q is the card's padded-row view."""
    g = torch.Generator().manual_seed(0)
    C, T = 32, 40
    x = torch.randn(2, T, C, generator=g)
    blocks = tuple(tuple(((mrf_fused.dilated_offsets(k, d), torch.randn(k * C, C, generator=g)
                           * 0.1, torch.randn(C, generator=g)),
                          (mrf_fused.dilated_offsets(k, 1), torch.randn(k * C, C, generator=g)
                           * 0.1, torch.randn(C, generator=g))) for d in (1, 3))
                   for k in (3, 5))
    H, L, k = 192, 2, 5
    wn_args = [torch.randn(2, T, H, generator=g), torch.ones(2, T, 1), None,
               torch.randn(L, k, H, 2 * H, generator=g) * 0.01, torch.zeros(L, 2 * H),
               torch.randn(L, H, 2 * H, generator=g) * 0.01, torch.zeros(L, 2 * H)]
    xq_in, mask = torch.randn(2, 40, T, generator=g), torch.ones(2, 1, T)
    x_q, s_x = int8_conv.quantize_act(xq_in, 0.1, mask)
    w_q = torch.randint(-127, 128, (24, 3, 40), dtype=torch.int8, generator=g)
    conv = (x_q, s_x, w_q, torch.rand(24, generator=g), torch.randn(24, generator=g), [1, 1], 1,
            1, None)
    subpixel = (x_q, s_x, w_q, conv[3], conv[4][:8], [1, 1], 1, 3, torch.randn(2, 8, 3 * T))
    flat = mrf_fused.flatten_blocks(blocks)
    calls = [(torch.ops.tts.mrf_fused, (x, *flat)), (torch.ops.tts.wn_group, wn_args),
             (torch.ops.tts.quantize_act, (xq_in, 0.1, mask)),
             (torch.ops.tts.int8_conv1d, conv), (torch.ops.tts.int8_conv1d, subpixel)]
    with torch.no_grad():
        real = [op(*args) for op, args in calls]
    torch.testing.assert_close(real[0], mrf_fused.mrf_plain(x, blocks))
    torch.testing.assert_close(real[1], wn_stack.wn_group_plain(*wn_args))
    mode = FakeTensorMode()
    for (op, args), r in zip(calls, real):
        with mode:
            fargs = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else
                     [mode.from_tensor(t) for t in a] if isinstance(a, list) and a
                     and isinstance(a[0], torch.Tensor) else a for a in args]
            f = op(*fargs)
        _same_layout(f if isinstance(f, tuple) else (f,), r if isinstance(r, tuple) else (r,))
    with mode:
        xc = torch.empty(2, 40, T, device="cuda")
        fq, fs = torch.ops.tts.quantize_act(xc, 0.1, None)
    assert (fq.shape, fq.stride(), fq.device.type, fs.shape) == ((2, T, 40), (T * 64, 64, 1),
                                                                 "cuda", ())
