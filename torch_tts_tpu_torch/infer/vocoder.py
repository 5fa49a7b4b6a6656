"""Standalone mel -> waveform neural vocoder: the artifact, its loader and
`synth` (port of `torch_tts_tpu/infer/vocoder.py`).

A vocoder is the HiFi-GAN `Generator` of `ops/hifigan.py` trained to invert
the Tacotron frontend's mel (`train/vocoder_train.py`), plus the affine that
maps the Tacotron network domain (m_fwd, [0, 1]) onto the standardised
log-mel the generator takes: ``mel_log = (mel_net - mel_shift) /
mel_scale``, by default the reference's handoff pair (0.911, 0.0869).

The port's artifact is its own file: `torch.save` of

    {"meta": {"format": "ttsrt-vocoder-torch-v1", "sample_rate", "num_mels",
              "mel_shift", "mel_scale", "gen_kwargs": {...}},
     "generator": {torch name: tensor}}

(the JAX package's meta, its format name apart, and the generator's
state dict under the reference's names), read with
`torch.load(..., weights_only=True)`. `load_vocoder` also reads the JAX
package's msgpack artifact ("ttsrt-vocoder-v1", a flax tree), converting
its parameters with the VITS2 converter's decoder rules; it imports
`msgpack` only then.

The generator runs with `fuse_mrf=True`, the card's default: on a CUDA
device each stage's ResBlock1 bank is one `mrf_fused` launch where the
kernel takes its width. `export_vocoder` is the twin of the JAX
`export_vocoder_stablehlo`: the renorm and the generator as a
`torch.export` program (`infer/export.py`), mel_net [1, max_frames, M] ->
wav [1, max_frames * hop].
"""

from __future__ import annotations

import zipfile
from typing import Any, Dict

import numpy as np
import torch

from torch_tts_tpu_torch.ops.hifigan import Generator

# the affine from the m_fwd network domain to the vocoder's standardised
# log-mel input (the reference's tacotron inference handoff)
REF_MEL_SHIFT = 0.911
REF_MEL_SCALE = 0.0869
FORMAT = "ttsrt-vocoder-torch-v1"
JAX_FORMAT = "ttsrt-vocoder-v1"

GEN_FIELDS = ("resblock", "resblock_kernel_sizes", "resblock_dilation_sizes", "upsample_rates",
              "upsample_initial_channel", "upsample_kernel_sizes")


def _tuplify(v):
    if isinstance(v, (list, tuple)):
        return tuple(_tuplify(x) for x in v)
    return v


def build_generator(gen_kwargs: Dict[str, Any], num_mels: int, fuse_mrf: bool = True) -> Generator:
    """The vocoder's Generator ([B, num_mels, T] -> [B, 1, T * hop])."""
    kw = {k: _tuplify(gen_kwargs[k]) for k in GEN_FIELDS if k in gen_kwargs}
    return Generator(num_mels, fuse_mrf=fuse_mrf, **kw)


class Vocoder:
    """A loaded mel -> wav vocoder on `device` (its weights need no
    gradient). `wave` is the renorm and the generator on tensors (what
    the Tacotron serving layer runs in its dispatch); `synth` is the
    reference's `synth_audio_vocoder`: renorm, generator, peak per item."""

    def __init__(self, generator: Generator, gen_kwargs: Dict[str, Any], sample_rate: int,
                 num_mels: int, mel_shift: float = REF_MEL_SHIFT,
                 mel_scale: float = REF_MEL_SCALE, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Vocoder: device cuda asked for, but no CUDA device is available "
                               "(pass device='cpu' to run on the CPU)")
        self.generator = generator.to(self.device).eval().requires_grad_(False)
        self.gen_kwargs = {k: _tuplify(v) for k, v in gen_kwargs.items()}
        self.sample_rate, self.num_mels = int(sample_rate), int(num_mels)
        self.mel_shift, self.mel_scale = float(mel_shift), float(mel_scale)

    @property
    def hop_length(self) -> int:
        return int(np.prod(self.gen_kwargs["upsample_rates"]))

    @torch.no_grad()
    def wave(self, mel_net: torch.Tensor) -> torch.Tensor:
        """mel_net [B, T, M] (network domain, on the device) -> wav [B, T * hop]."""
        mel_log = (mel_net - self.mel_shift) / self.mel_scale
        return self.generator(mel_log.transpose(1, 2))[:, 0]

    def synth(self, mel_net, normalize: bool = True) -> np.ndarray:
        """mel_net [T, M] or [B, T, M] -> wav [B, T * hop] (numpy), each item
        divided by its peak unless normalize is False."""
        mel = torch.as_tensor(np.asarray(mel_net) if not torch.is_tensor(mel_net) else mel_net,
                              dtype=torch.float32).to(self.device)
        if mel.ndim == 2:
            mel = mel[None]
        wav = self.wave(mel).cpu().numpy()
        if normalize:
            wav = wav / np.maximum(np.abs(wav).max(axis=-1, keepdims=True), 1e-8)
        return wav


class _VocoderProgram(torch.nn.Module):
    def __init__(self, voc: Vocoder):
        super().__init__()
        self.generator = voc.generator
        self.mel_shift, self.mel_scale = voc.mel_shift, voc.mel_scale

    def forward(self, mel_net):
        mel_log = (mel_net - self.mel_shift) / self.mel_scale
        return self.generator(mel_log.transpose(1, 2))[:, 0]


def export_vocoder(voc: Vocoder, max_frames: int, path=None, device="cuda"):
    """The vocoder (moved to `device`, as `voc.device` then says) as a
    `torch.export` program of the signature (mel_net [1, max_frames, M]) ->
    wav [1, max_frames * hop], saved to `path` when given (load it with
    `infer.export.load_exported`) -> the ExportedProgram."""
    from torch_tts_tpu_torch.infer.export import export_program

    voc.device = torch.device(device)
    voc.generator.to(voc.device)
    mel = torch.zeros(1, max_frames, voc.num_mels, dtype=torch.float32, device=voc.device)
    return export_program(_VocoderProgram(voc), [mel], path)


def check_compat(voc: Vocoder, *, num_mels: int, hop_length: int, sample_rate: int) -> None:
    """Raise ValueError naming every mismatch between the vocoder and the
    acoustic model's audio config (mel count, hop, sample rate)."""
    problems = []
    if voc.num_mels != num_mels:
        problems.append(f"num_mels {voc.num_mels} != config {num_mels}")
    if voc.hop_length != hop_length:
        problems.append(f"hop (prod of upsample_rates) {voc.hop_length} != config "
                        f"hop_length {hop_length}")
    if voc.sample_rate != sample_rate:
        problems.append(f"sample_rate {voc.sample_rate} != config {sample_rate}")
    if problems:
        raise ValueError("vocoder artifact incompatible with audio config: " + "; ".join(problems))


def save_vocoder(path: str, generator: Generator, *, gen_kwargs: Dict[str, Any], sample_rate: int,
                 num_mels: int, mel_shift: float = REF_MEL_SHIFT,
                 mel_scale: float = REF_MEL_SCALE) -> None:
    """Write the port's artifact (see the module docstring)."""
    meta = {"format": FORMAT, "sample_rate": int(sample_rate), "num_mels": int(num_mels),
            "mel_shift": float(mel_shift), "mel_scale": float(mel_scale),
            "gen_kwargs": {k: _tuplify(gen_kwargs[k]) for k in GEN_FIELDS if k in gen_kwargs}}
    sd = {k: v.detach().to("cpu", copy=True) for k, v in generator.state_dict().items()}
    torch.save({"meta": meta, "generator": sd}, path)


def _read_jax_artifact(path: str):
    """The JAX package's msgpack artifact -> (meta, torch state dict)."""
    import msgpack

    from torch_tts_tpu_torch.models.vits2.convert import generator_state_dict_from_jax_params

    def ext_hook(code, data):
        if code in (1, 3):  # flax's ndarray and numpy-scalar extension types
            shape, dtype, buf = msgpack.unpackb(data, raw=True)
            arr = np.frombuffer(buf, dtype=np.dtype(dtype.decode())).reshape(shape)
            return arr[()] if code == 3 else arr
        return msgpack.ExtType(code, data)

    with open(path, "rb") as f:
        tree = msgpack.unpackb(f.read(), ext_hook=ext_hook, raw=False)
    meta = tree["meta"]
    if meta.get("format") != JAX_FORMAT:
        raise ValueError(f"{path}: not a ttsrt vocoder artifact ({meta})")
    sd = generator_state_dict_from_jax_params(tree["params"],
                                              meta["gen_kwargs"]["resblock_kernel_sizes"])
    return meta, sd


def load_vocoder(path: str, device="cuda") -> Vocoder:
    """A vocoder artifact, the port's (`save_vocoder`) or the JAX package's
    msgpack one, on `device` (the card unless the caller says otherwise),
    its generator loaded strictly with `fuse_mrf=True`."""
    if zipfile.is_zipfile(path):  # torch.save's container
        blob = torch.load(path, map_location="cpu", weights_only=True)
        meta, sd = blob["meta"], blob["generator"]
        if meta.get("format") != FORMAT:
            raise ValueError(f"{path}: not a vocoder artifact of this package ({meta})")
    else:
        meta, sd = _read_jax_artifact(path)
    gen_kwargs = {k: _tuplify(v) for k, v in meta["gen_kwargs"].items()}
    gen = build_generator(gen_kwargs, int(meta["num_mels"]))
    gen.load_state_dict(sd, strict=True)
    return Vocoder(gen, gen_kwargs, meta["sample_rate"], meta["num_mels"], meta["mel_shift"],
                   meta["mel_scale"], device=device)
