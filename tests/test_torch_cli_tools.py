"""The port's remaining CLIs and tools against the JAX package's, on the
same inputs, on the CPU: the checkpoint converter (`cli/convert_checkpoint.py`),
`cli/preprocess_text.py`, `tools/helper.py`, `cli/preprocess_audio.py`,
`cli/audio_check.py`; and every CLI's fp32 setting.

- VITS2 `--from-torch`: a reference-format G_77.pth / D_77.pth pair (the
  JAX exporter's names, from seeded JAX parameters) through both CLIs. The
  port's ckpt_77.pt loads strictly into the port's generator and MPD and
  infers what JAX infers from the run dir JAX's CLI writes (noise scales
  0: durations exactly, the waveform within 1e-4). `--to-torch` from each
  package's run dir: G_77.pth and D_77.pth with the same names and equal
  tensors.
- Tacotron `--from-torch` (a reference checkpoint.pt of the JAX exporter's
  names): the port's ckpt_5.pt equals, name for name, the port's
  conversion of the parameters JAX's CLI imports, and loads strictly;
  `--to-torch` raises in both.
- Text cleaning and the alphabet report: equal output. Trimmed and
  resampled WAVs: equal samples. The audio check's round trip (encode,
  mel_inv, Griffin-Lim from injected phases, as the Griffin-Lim test
  injects them): 16-bit samples within 1e-4 of the peak, that test's
  tolerance, plus the quantization step.
- Each CLI's `main(["--help"])` leaves cuDNN's TF32 off.
"""

import dataclasses
import io
import json
import sys
import wave
from concurrent.futures import ThreadPoolExecutor
from contextlib import redirect_stdout
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_vits2_infer import random_params
from torch_tts_tpu.cli import audio_check as j_audio_check
from torch_tts_tpu.cli import convert_checkpoint as j_convert
from torch_tts_tpu.cli import preprocess_audio as j_preprocess_audio
from torch_tts_tpu.cli import preprocess_text as j_preprocess_text
from torch_tts_tpu.core import config as jcfg
from torch_tts_tpu.models.tacotron import build_tacotron as jax_build_tacotron
from torch_tts_tpu.models.tacotron.convert import export_torch_state_dict as j_taco_export
from torch_tts_tpu.models.vits2 import MultiPeriodDiscriminator as JaxMPD
from torch_tts_tpu.models.vits2 import SynthesizerTrn as JaxSynth
from torch_tts_tpu.models.vits2.convert import export_mpd_torch_state_dict, export_torch_state_dict
from torch_tts_tpu.text import symbols as j_symbols
from torch_tts_tpu.tools import helper as j_helper
from torch_tts_tpu.train import checkpoint as j_ckpt
from torch_tts_tpu_torch.audio.frontend import AudioFrontend
from torch_tts_tpu_torch.cli import audio_check, convert_checkpoint, preprocess_audio
from torch_tts_tpu_torch.cli import preprocess_text
from torch_tts_tpu_torch.core import config as tcfg
from torch_tts_tpu_torch.models.tacotron.convert import state_dict_from_jax_params as taco_sd
from torch_tts_tpu_torch.models.tacotron.model import Tacotron
from torch_tts_tpu_torch.models.vits2.discriminators import MultiPeriodDiscriminator
from torch_tts_tpu_torch.models.vits2.model import SynthesizerTrn
from torch_tts_tpu_torch.text import symbols
from torch_tts_tpu_torch.tools import helper

WAVE_ATOL, GL_ATOL = 1e-4, 1e-4
STEP, MAX_FRAMES = 77, 40
TINY_YAML = """
model:
  inter_channels: 16
  hidden_channels: 16
  filter_channels: 32
  n_heads: 2
  n_layers: 1
  kernel_size: 3
  p_dropout: 0.1
  resblock: "1"
  resblock_kernel_sizes: [3]
  resblock_dilation_sizes: [[1, 3]]
  upsample_rates: [8, 8]
  upsample_initial_channel: 64
  upsample_kernel_sizes: [16, 16]
  use_sdp: true
  use_transformer_flows: true
  transformer_flow_type: "pre_conv"
  segment_size: 256
  posterior_wn_layers: 2
data:
  sampling_rate: 8000
  filter_length: 128
  hop_length: 64
  win_length: 128
  n_mel_channels: 20
"""
TACO_ALPHABET = "#abcdefghijklmnopqrstuvwxyz .,"
TACO_CFG = dict(audio=dict(num_mels=20, win_length=256, hop_length=64, sample_rate=8000,
                           fmax=3800.0),
                text=dict(alphabet=TACO_ALPHABET),
                # the reference's layout, which both packages' loaders read
                model=dict(encoder=dict(dim_emb=32, dim_out=32),
                           decoder=dict(r=2, dim_pre=16, dim_att=16, dim_rnn=[48, 32]),
                           postnet=dict(dim_hidden=32, num_layers=3)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while this module runs: under pytest-xdist a thread
    per core in every worker oversubscribes the cores, which slowed the
    port's tests about twofold and took CPU from the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_cli(main, argv):
    """A JAX package CLI (which reads sys.argv) -> what it printed."""
    out = io.StringIO()
    with mock.patch.object(sys, "argv", ["cli", *argv]), redirect_stdout(out):
        main()
    return out.getvalue()


def _save_pth(path, sd, step):
    torch.save({"model": {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
                "iteration": step, "learning_rate": 2e-4, "optimizer": None}, path)


def _samples(path):
    with wave.open(str(path)) as f:
        return f.getframerate(), np.frombuffer(f.readframes(f.getnframes()), "<i2")


@pytest.fixture(scope="module")
def vits2(tmp_path_factory):
    """A G_77.pth / D_77.pth pair through both converters, and JAX's infer
    on the parameters of JAX's run dir."""
    tmp = tmp_path_factory.mktemp("convert")
    rng = np.random.default_rng(13)
    cfg_path = tmp / "tiny.yaml"
    cfg_path.write_text(TINY_YAML)
    cfg = jcfg.load_vits2_config(str(cfg_path))
    jmodel = JaxSynth(n_vocab=len(j_symbols), spec_channels=cfg.posterior_channels,
                      segment_frames=cfg.segment_frames, cfg=cfg.model)
    rngs = {k: jax.random.PRNGKey(i) for i, k in enumerate(("params", "noise", "dropout"))}
    g_shapes = jax.eval_shape(lambda: jmodel.init(
        rngs, jnp.ones((1, 9), jnp.int32), jnp.full((1,), 9, jnp.int32),
        jnp.zeros((1, 20, cfg.posterior_channels)), jnp.full((1,), 20, jnp.int32))["params"])
    seg = cfg.model.segment_size
    d_shapes = jax.eval_shape(lambda: JaxMPD().init(
        {"params": jax.random.PRNGKey(3)}, jnp.zeros((1, seg, 1)),
        jnp.zeros((1, seg, 1)))["params"])
    params_g, params_d = random_params(g_shapes, rng), random_params(d_shapes, rng)
    g_pth, d_pth = tmp / f"G_{STEP}.pth", tmp / f"D_{STEP}.pth"
    _save_pth(g_pth, export_torch_state_dict(params_g, cfg.model), STEP)
    _save_pth(d_pth, export_mpd_torch_state_dict(params_d), STEP)

    common = ["--model", "vits2", "-c", str(cfg_path)]
    _jax_cli(j_convert.main, [*common, "--from-torch", str(g_pth), "--mpd", str(d_pth),
                              "-o", str(tmp / "jax_run")])
    loaded = j_ckpt.restore_checkpoint(
        str(tmp / "jax_run" / f"ckpt_{STEP}.msgpack"),
        {"step": np.zeros((), np.int32), "params_g": params_g, "params_d": params_d})
    ids = rng.integers(1, len(symbols), (1, 11))
    infer = jax.jit(lambda p, x, xl: jmodel.apply(
        {"params": p}, x, xl, noise_scale=0.0, noise_scale_w=0.0, max_frames=MAX_FRAMES,
        method=JaxSynth.infer, rngs={"noise": jax.random.PRNGKey(0)}))
    jargs = (loaded["params_g"], jnp.asarray(ids, jnp.int32), jnp.asarray([11], jnp.int32))
    with ThreadPoolExecutor(1) as ex:
        compiled = ex.submit(infer.lower(*jargs).compile)
        convert_checkpoint.main([*common, "--from-torch", str(g_pth), "--mpd", str(d_pth),
                                 "-o", str(tmp / "port_run")])
        want = jax.tree.map(np.asarray, compiled.result()(*jargs))
    return dict(tmp=tmp, cfg_path=cfg_path, common=common, ids=ids, want=want,
                port_cfg=tcfg.load_vits2_config(str(cfg_path)))


def test_vits2_from_torch_loads_strictly_and_infers_as_jax(vits2):
    cfg = vits2["port_cfg"]
    tree = torch.load(vits2["tmp"] / "port_run" / f"ckpt_{STEP}.pt", weights_only=True)
    assert tree["step"] == STEP and "opt_g" not in tree
    model = SynthesizerTrn(len(symbols), cfg.posterior_channels, cfg.model, cfg.segment_frames)
    model.load_state_dict(tree["model"], strict=True)
    MultiPeriodDiscriminator().load_state_dict(tree["mpd"], strict=True)
    audio, attn, _, _, y_lengths = model.eval().infer(
        torch.from_numpy(vits2["ids"]), torch.tensor([11]), noise_scale=0.0, noise_scale_w=0.0,
        max_frames=MAX_FRAMES, generator=torch.Generator().manual_seed(0))
    w_audio, w_attn, _, _, w_lengths = vits2["want"]
    np.testing.assert_array_equal(y_lengths.numpy(), w_lengths)
    np.testing.assert_array_equal(attn.numpy(), w_attn)
    np.testing.assert_allclose(audio.numpy(), w_audio, rtol=0, atol=WAVE_ATOL)


def test_vits2_to_torch_writes_jax_tensors(vits2):
    tmp, common = vits2["tmp"], vits2["common"]
    _jax_cli(j_convert.main, [*common, "--to-torch", str(tmp / "jax_run"), "-o",
                              str(tmp / "jax_out")])
    convert_checkpoint.main([*common, "--to-torch", str(tmp / "port_run"), "-o",
                             str(tmp / "port_out")])
    for name in (f"G_{STEP}.pth", f"D_{STEP}.pth"):
        want = torch.load(tmp / "jax_out" / name, weights_only=False)
        got = torch.load(tmp / "port_out" / name, weights_only=True)
        assert got["iteration"] == want["iteration"] == STEP
        assert set(got["model"]) == set(want["model"]), name
        for k, v in want["model"].items():
            torch.testing.assert_close(got["model"][k], v, rtol=0, atol=0, msg=k)


def test_tacotron_from_torch_matches_jax_import(tmp_path):
    cfg_path = tmp_path / "taco.json"
    cfg_path.write_text(json.dumps(TACO_CFG))
    jc, tc = jcfg.load_tacotron_config(str(cfg_path)), tcfg.load_tacotron_config(str(cfg_path))
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc) and tc.model.dim_emb == 32
    jmodel = jax_build_tacotron(jc)
    variables = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2)}, jnp.zeros((1, 8), jnp.int32),
        jnp.full((1,), 8, jnp.int32), jnp.zeros((1, 12, 20)), jnp.full((1,), 12, jnp.int32),
        train=True, deterministic=False))
    rng = np.random.default_rng(5)
    params, stats = random_params(variables["params"], rng), random_params(
        variables["batch_stats"], rng)
    stats = jax.tree.map(np.abs, stats)  # variances
    src = tmp_path / "checkpoint_5.pt"
    torch.save({"model_state": {k: torch.from_numpy(np.ascontiguousarray(v))
                                for k, v in j_taco_export(params, stats, jc).items()}, "step": 5},
               src)
    common = ["--model", "tacotron", "-c", str(cfg_path)]
    _jax_cli(j_convert.main, [*common, "--from-torch", str(src), "-o", str(tmp_path / "jax")])
    convert_checkpoint.main([*common, "--from-torch", str(src), "-o", str(tmp_path / "port")])
    tpl = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), variables)
    loaded = j_ckpt.restore_checkpoint(str(tmp_path / "jax" / "ckpt_5.msgpack"),
                                       {"step": np.zeros((), np.int32), **tpl})
    want = taco_sd(loaded["params"], loaded["batch_stats"], tc)
    got = torch.load(tmp_path / "port" / "ckpt_5.pt", weights_only=True)
    assert got["step"] == 5 and set(got["model"]) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got["model"][k].numpy(), np.asarray(v), err_msg=k)
    Tacotron(tc, 1 + len(TACO_ALPHABET)).load_state_dict(got["model"], strict=True)
    for main in (lambda a: _jax_cli(j_convert.main, a), convert_checkpoint.main):
        with pytest.raises(SystemExit, match="tacotron --to-torch"):
            main([*common, "--to-torch", str(tmp_path / "port"), "-o", str(tmp_path / "x")])


def test_preprocess_text_writes_jax_filelists(tmp_path):
    lines = ["a/1.wav|Hello, World! It's Dr. Smith at 3 o'clock.|x",
             "a/2.wav|  Ünïcödé   text -- with  spaces.  ", "no text column", ""]
    for cleaners in (["basic_cleaners"], ["transliteration_cleaners"], ["english_cleaners2"]):
        outs = []
        for name, run in (("jax", lambda a: _jax_cli(j_preprocess_text.main, a)),
                          ("port", preprocess_text.main)):
            flist = tmp_path / f"{name}.txt"
            flist.write_text("\n".join(lines) + "\n", encoding="utf-8")
            run(["--filelists", str(flist), "--text-cleaners", *cleaners])
            outs.append((tmp_path / f"{name}.txt.cleaned").read_text(encoding="utf-8"))
        assert outs[0] == outs[1], cleaners


def test_alphabet_report_matches_jax(tmp_path):
    lines = ["hello world", "héllo!", "abc abc", "Ω ≈ ç|ß", "tab\there"]
    assert helper.audit_alphabet(lines) == j_helper.audit_alphabet(lines)
    assert helper.audit_alphabet(lines, 0) == j_helper.audit_alphabet(lines, 0)
    path = tmp_path / "t.txt"
    path.write_text("\n".join(f"id{i}|{t}" for i, t in enumerate(lines)) + "\n", encoding="utf-8")
    for argv in ([str(path)], [str(path), "--column", "1"]):
        out = io.StringIO()
        with redirect_stdout(out):
            helper.main(argv)
        assert out.getvalue() == _jax_cli(j_helper.main, argv)


def _write_wav(path, x, sr):
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())


def test_preprocess_audio_writes_jax_wavs(tmp_path):
    rng = np.random.default_rng(8)
    src = tmp_path / "raw"
    (src / "spk").mkdir(parents=True)
    for name, sr, n in (("a.wav", 16000, 12000), ("spk/b.wav", 22050, 15000),
                        ("short.wav", 22050, 3000)):
        t = np.arange(n) / sr
        voiced = (t > 0.1 * n / sr) & (t < 0.8 * n / sr)
        x = 0.5 * np.sin(2 * np.pi * 220 * t) * voiced + 1e-4 * rng.standard_normal(n)
        _write_wav(src / name, x, sr)
    argv = ["--in-dir", str(src), "--sr", "22050", "--min-samples", "4000"]
    printed = _jax_cli(j_preprocess_audio.main, [*argv, "--out-dir", str(tmp_path / "jax")])
    out = io.StringIO()
    with redirect_stdout(out):
        preprocess_audio.main([*argv, "--out-dir", str(tmp_path / "port")])
    assert out.getvalue() == printed and "processed 2, skipped 1" in printed
    for name in ("a.wav", "spk/b.wav"):
        sr_j, want = _samples(tmp_path / "jax" / name)
        sr_t, got = _samples(tmp_path / "port" / name)
        assert sr_t == sr_j == 22050
        np.testing.assert_array_equal(got, want)
    assert not (tmp_path / "port" / "short.wav").exists()


def test_audio_check_round_trip_matches_jax(tmp_path):
    cfg_path = tmp_path / "taco.json"
    cfg_path.write_text(json.dumps(TACO_CFG))
    rng = np.random.default_rng(9)
    sr, n = 8000, 4000
    t = np.arange(n) / sr
    _write_wav(tmp_path / "in.wav", 0.4 * np.sin(2 * np.pi * 300 * t)
               + 0.05 * rng.standard_normal(n), sr)
    frames = 1 + n // TACO_CFG["audio"]["hop_length"]
    phases = (rng.random((frames, TACO_CFG["audio"]["win_length"] // 2 + 1)) * 2 * np.pi
              ).astype(np.float32)
    argv = [str(tmp_path / "in.wav"), str(cfg_path), "--griffin-lim-iters", "4"]
    with mock.patch.object(jax.random, "uniform", lambda *a, **k: jnp.asarray(phases)):
        _jax_cli(j_audio_check.main, [*argv, "-o", str(tmp_path / "jax.wav")])
    decode = AudioFrontend.decode
    with mock.patch.object(AudioFrontend, "decode", lambda self, d, n_iter=32, **kw: decode(
            self, d, n_iter=n_iter, phases=torch.from_numpy(phases))):
        audio_check.main([*argv, "-o", str(tmp_path / "port.wav"), "--device", "cpu"])
    (sr_j, want), (sr_t, got) = _samples(tmp_path / "jax.wav"), _samples(tmp_path / "port.wav")
    assert sr_t == sr_j == sr and got.shape == want.shape
    # both normalise to a peak of 0.9: GL_ATOL of it, plus one 16-bit step
    atol = GL_ATOL * 0.9 * 32767 + 1
    assert int(np.abs(got.astype(np.int32) - want).max()) <= atol


def test_every_cli_turns_cudnn_tf32_off():
    from torch_tts_tpu_torch.cli import (export, tacotron_infer, tacotron_prepare,
                                         tacotron_train, vits2_infer, vits2_train, vits2_vc,
                                         vocoder_train, webui)

    clis = (audio_check, convert_checkpoint, export, preprocess_audio, preprocess_text,
            tacotron_infer, tacotron_prepare, tacotron_train, vits2_infer, vits2_train, vits2_vc,
            vocoder_train, webui, helper)
    before = torch.backends.cudnn.allow_tf32
    try:
        for cli in clis:
            torch.backends.cudnn.allow_tf32 = True
            with pytest.raises(SystemExit) as e, redirect_stdout(io.StringIO()):
                cli.main(["--help"])
            assert e.value.code == 0
            assert torch.backends.cudnn.allow_tf32 is False, cli.__name__
            assert torch.backends.cuda.matmul.allow_tf32 is False, cli.__name__
    finally:
        torch.backends.cudnn.allow_tf32 = before
