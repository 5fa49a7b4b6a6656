"""VITS2 inference CLI: text -> 16-bit WAV (reduced port of
`torch_tts_tpu/cli/vits2_infer.py`).

`-m` takes a reference-format state dict (`.pth`, bare or {"model": ...}),
such as `tts-convert-checkpoint --to-torch` writes from a JAX run dir, or
a run directory of this package's trainer (its latest `ckpt_<step>.pt`).
`--sid` picks the speaker of a multi-speaker model.
Text goes through `torch_tts_tpu_torch.text` (cleaners from the config, blanks
interspersed when `add_blank`).

Usage:
  python -m torch_tts_tpu_torch.cli.vits2_infer -c configs/vits2-ljspeech.yaml \\
      -m G.pth --text "speech synthesis is neat" -o out.wav
  python -m torch_tts_tpu_torch.cli.vits2_infer -c configs/vits2-multispeaker.yaml \\
      -m runs/vctk --sid 3 --text "speech synthesis is neat" -o out.wav
"""

from __future__ import annotations

import argparse
import os
import wave
from typing import List, Optional, Sequence

import numpy as np
import torch

from torch_tts_tpu_torch.text import intersperse, symbols, text_to_sequence
from torch_tts_tpu_torch.core.config import VITS2Config, load_vits2_config
from torch_tts_tpu_torch.models.vits2.model import SynthesizerTrn


def load_model(cfg: VITS2Config, checkpoint: str, device) -> SynthesizerTrn:
    """SynthesizerTrn for `cfg` with the state dict in `checkpoint` (a file,
    or a run directory's latest checkpoint) loaded strictly, on `device`,
    in eval mode."""
    if os.path.isdir(checkpoint):
        from torch_tts_tpu_torch.train.checkpoint import latest_checkpoint

        path = latest_checkpoint(checkpoint)
        if path is None:
            raise SystemExit(f"no checkpoint in {checkpoint}")
        checkpoint = path
    blob = torch.load(checkpoint, map_location="cpu", weights_only=True)
    sd = blob["model"] if "model" in blob and isinstance(blob["model"], dict) else blob
    sd = {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}
    model = SynthesizerTrn(len(symbols), cfg.posterior_channels, cfg.model, cfg.segment_frames)
    model.load_state_dict(sd, strict=True)
    return model.to(device).eval()


def text_ids(text: str, cfg: VITS2Config) -> List[int]:
    ids = text_to_sequence(text, list(cfg.data.text_cleaners))
    return intersperse(ids, 0) if cfg.data.add_blank else ids


def synthesize(model: SynthesizerTrn, ids: Sequence[int], hop_length: int, *,
               noise_scale: float, noise_scale_w: float, length_scale: float,
               max_frames: int, generator: torch.Generator,
               sid: Optional[int] = None) -> np.ndarray:
    """One utterance (of speaker `sid`, or unconditioned) -> float
    waveform, trimmed to its length."""
    device = next(model.parameters()).device
    x = torch.tensor([list(ids)], dtype=torch.int64, device=device)
    x_lengths = torch.tensor([len(ids)], dtype=torch.int64, device=device)
    sids = None if sid is None else torch.tensor([sid], dtype=torch.int64, device=device)
    audio, _, _, _, y_lengths = model.infer(
        x, x_lengths, sid=sids, noise_scale=noise_scale, noise_scale_w=noise_scale_w,
        length_scale=length_scale, max_frames=max_frames, generator=generator)
    n = int(y_lengths[0]) * hop_length
    return audio[0, :n, 0].float().cpu().numpy()


def write_wav(path: str, audio: np.ndarray, sampling_rate: int):
    pcm = (np.clip(audio, -1, 1) * 32767).astype("<i2")
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sampling_rate)
        f.writeframes(pcm.tobytes())


def main(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-c", "--config", required=True, help="YAML or JSON VITS2 config")
    p.add_argument("-m", "--model", required=True,
                   help="reference-format state dict (.pth) or a trainer run directory")
    p.add_argument("--text", required=True)
    p.add_argument("-o", "--output", default="out.wav")
    p.add_argument("--sid", type=int, default=None, help="speaker id (multi-speaker models)")
    p.add_argument("--noise-scale", type=float, default=0.667)
    p.add_argument("--noise-scale-w", type=float, default=0.8)
    p.add_argument("--length-scale", type=float, default=1.0)
    p.add_argument("--max-frames", type=int, default=1000)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    cfg = load_vits2_config(args.config)
    device = torch.device(args.device)
    model = load_model(cfg, args.model, device)
    audio = synthesize(
        model, text_ids(args.text, cfg), cfg.audio.hop_length,
        noise_scale=args.noise_scale, noise_scale_w=args.noise_scale_w,
        length_scale=args.length_scale, max_frames=args.max_frames,
        generator=torch.Generator(device=device).manual_seed(args.seed), sid=args.sid)
    write_wav(args.output, audio, cfg.audio.sampling_rate)
    print(f"wrote {args.output}: {len(audio) / cfg.audio.sampling_rate:.2f}s")
    return audio


if __name__ == "__main__":
    main()
