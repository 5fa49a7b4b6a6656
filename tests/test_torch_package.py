"""Package rules of the PyTorch port (torch_tts_tpu_torch).

- Importing every module of the package (the voice conversion CLI among
  them) leaves jax out of sys.modules
  (checked in a fresh interpreter), and no module of the package, nor
  chip_smoke.py, imports the JAX package `torch_tts_tpu` (an AST scan).
- Entry points default to the card: `build_synthesizer`, `build_mpd`,
  `build_dur_disc`, `build_models`, `VITS2Trainer`, `build_tacotron`,
  `AudioFrontend`, `TacotronSynthesizer`, `Vocoder`, `load_vocoder`,
  `create_vocoder_state` and the CLIs (the train CLIs' --device too) take
  device="cuda" unless told otherwise.
- Kernel wrappers take their plain version only for CPU tensors: another
  device raises, and a missing nvcc raises instead of falling back;
  `mrf_fused`, which has no backward, raises under autograd instead of
  dropping the gradient.
- The CLI synthesizes a WAV from a reference-format state dict on the CPU.
"""

import ast
import dataclasses
import inspect
import json
import os
import pathlib
import subprocess
import sys
import wave

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while this module runs: under pytest-xdist a thread
    per core in every worker oversubscribes the cores, which slowed the
    port's tests about twofold and took CPU from the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_package_never_imports_jax():
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in (ROOT / "torch_tts_tpu_torch").rglob("*.py") if p.name != "__init__.py")
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in modules)
            + "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax')]\n"
            + "print(len(sys.modules)); assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "torch_tts_tpu_torch.cli.vits2_vc" in modules
    assert len(modules) >= 45


def _imported_modules(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_never_imports_the_jax_package():
    files = sorted((ROOT / "torch_tts_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    bad = [(str(f.relative_to(ROOT)), m) for f in files for m in _imported_modules(f)
           if m.split(".")[0] in ("torch_tts_tpu", "jax", "jaxlib", "flax", "optax")]
    assert not bad, bad
    assert ROOT / "torch_tts_tpu_torch" / "cli" / "vits2_vc.py" in files
    assert len(files) >= 59


def test_entry_points_default_to_the_card():
    from torch_tts_tpu_torch.audio.frontend import AudioFrontend
    from torch_tts_tpu_torch.cli import tacotron_infer, vits2_infer
    from torch_tts_tpu_torch.models.tacotron import build_tacotron
    from torch_tts_tpu_torch.models.vits2 import build_synthesizer
    from torch_tts_tpu_torch.cli import vits2_train, vits2_vc, vocoder_train
    from torch_tts_tpu_torch.infer.taco_serving import TacotronSynthesizer
    from torch_tts_tpu_torch.infer.vocoder import Vocoder, load_vocoder
    from torch_tts_tpu_torch.train.vits2_train import build_dur_disc, build_mpd
    from torch_tts_tpu_torch.train.vits2_trainer import VITS2Trainer, build_models
    from torch_tts_tpu_torch.train.vocoder_train import create_vocoder_state

    for fn in (build_synthesizer, build_mpd, build_dur_disc, build_models, VITS2Trainer,
               build_tacotron, AudioFrontend, TacotronSynthesizer, Vocoder, load_vocoder,
               create_vocoder_state):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    for cli in (vits2_infer, tacotron_infer, vits2_train, vits2_vc, vocoder_train):
        assert "default='cuda'" in inspect.getsource(cli.main) or \
            'default="cuda"' in inspect.getsource(cli.main)
    # the mel frontend and the LLTM cell run where their input lies
    from torch_tts_tpu_torch.kernels import gated_cell, stft

    for fn in (stft.mel_spectrogram_auto, stft.mel_spectrogram_fused, gated_cell.lltm):
        assert "device" not in inspect.signature(fn).parameters


def test_mrf_fused_raises_instead_of_dropping_a_gradient():
    from torch_tts_tpu_torch.kernels.mrf_fused import check_no_grad, dilated_offsets

    w, b = torch.zeros(96, 32), torch.zeros(32)
    blocks = ((((dilated_offsets(3, 1), w, b), (dilated_offsets(3, 1), w, b)),),)
    check_no_grad(torch.zeros(1, 8, 32), blocks)
    with pytest.raises(RuntimeError, match="no backward"):
        check_no_grad(torch.zeros(1, 8, 32, requires_grad=True), blocks)
    w.requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        check_no_grad(torch.zeros(1, 8, 32), blocks)
    with torch.no_grad():
        check_no_grad(torch.zeros(1, 8, 32, requires_grad=True), blocks)


def test_wrappers_raise_on_non_cpu_non_cuda_device():
    from torch_tts_tpu_torch.kernels.mrf_fused import dilated_offsets, mrf_fused
    from torch_tts_tpu_torch.kernels.wn_stack import wn_group

    x = torch.zeros(1, 8, 32, device="meta")
    w, b = torch.zeros(96, 32, device="meta"), torch.zeros(32, device="meta")
    blocks = (((dilated_offsets(3, 1), w, b), (dilated_offsets(3, 1), w, b)),)
    with pytest.raises(ValueError):
        mrf_fused(x, blocks)
    with pytest.raises(ValueError):
        wn_group(x, x[..., :1], None, *(torch.zeros(1, device="meta"),) * 4)
    from torch_tts_tpu_torch.kernels.gated_cell import lltm
    from torch_tts_tpu_torch.kernels.stft import mel_spectrogram_fused

    with pytest.raises(ValueError):
        mel_spectrogram_fused(torch.zeros(8, 65536, device="meta"), 1024, 80, 22050, 256, 1024)
    with pytest.raises(ValueError):
        lltm(*(torch.zeros(2, 2, device="meta"),) * 5)


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    from torch_tts_tpu_torch.kernels import build

    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        build.nvcc_path()


def test_build_dir_is_keyed_by_sources():
    from torch_tts_tpu_torch.kernels import build

    d = build.library_dir()
    assert d.parent == ROOT / "build" / "torch_kernels" and len(d.name) == 16
    assert sorted(p.name for p in build.CSRC.glob("*.cu")) == [
        "gated_cell.cu", "int8_conv.cu", "mas.cu", "mrf_fused.cu", "stft_mel.cu", "taco_step.cu",
        "wn_stack.cu", "wn_stack_bf16.cu"]


def test_cli_writes_wav_on_cpu(tmp_path):
    from torch_tts_tpu_torch.cli import vits2_infer
    from torch_tts_tpu_torch.core.config import VITS2Config, VITS2ModelConfig
    from torch_tts_tpu_torch.models.vits2 import build_synthesizer
    from torch_tts_tpu_torch.text import symbols

    model_cfg = VITS2ModelConfig(
        inter_channels=8, hidden_channels=8, filter_channels=16, n_layers=2,
        resblock_kernel_sizes=(3, 5), resblock_dilation_sizes=((1, 3, 5), (1, 3, 5)),
        upsample_rates=(4, 2), upsample_initial_channel=16, upsample_kernel_sizes=(8, 4),
        posterior_wn_layers=2, fuse_mrf=True)
    cfg = VITS2Config(model=model_cfg)
    model = build_synthesizer(cfg, len(symbols), seed=0, device="cpu")
    ckpt, cfg_path, wav = tmp_path / "G.pth", tmp_path / "c.json", tmp_path / "o.wav"
    torch.save({"model": model.state_dict()}, ckpt)
    cfg_path.write_text(json.dumps({"model": dataclasses.asdict(model_cfg),
                                    "data": {"text_cleaners": ["transliteration_cleaners"],
                                             "sampling_rate": 22050, "hop_length": 8}}))
    audio = vits2_infer.main(["-c", str(cfg_path), "-m", str(ckpt), "--text", "Hello there.",
                              "-o", str(wav), "--max-frames", "200", "--device", "cpu"])
    assert audio.size > 0 and audio.size % 8 == 0 and bool(torch.isfinite(torch.from_numpy(audio)).all())
    with wave.open(str(wav)) as f:
        assert (f.getnchannels(), f.getsampwidth(), f.getframerate()) == (1, 2, 22050)
        assert f.getnframes() == audio.size


def test_ctypes_signatures_match_the_c_entries():
    """Each C entry's parameters, read from its source, have the ctypes
    types build.py declares: void* for pointers, int for ints (ctypes would
    otherwise pass a pointer in 32 bits)."""
    import re

    from torch_tts_tpu_torch.kernels import build

    found = {}
    for src in build.CSRC.glob("*.cu"):
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src.read_text()):
            kinds = ["p" if "*" in p else "i" for p in params.split(",")]
            assert all("*" in p or p.split()[0] == "int" for p in params.split(",")), params
            found[name] = kinds
    assert set(found) == set(build._SIGNATURES)
    for name, argtypes in build._SIGNATURES.items():
        want = ["p" if t is build._P else "i" for t in argtypes]
        assert found[name] == want, name
