"""Voice conversion CLI for a multi-speaker VITS2 (port of
`torch_tts_tpu/cli/vits2_vc.py`): re-synthesizes an utterance of a source
speaker in a target speaker's voice through `SynthesizerTrn.voice_conversion`
(the flow round trip).

`-m` is a run directory of this package's trainer (its latest
`ckpt_<step>.pt`) or a reference-format state dict (`.pth`). The wav is
read and featurised with this package's `data/audio_np.py` (the config's
log-mel, or the linear spectrogram without `use_mel_posterior_encoder`).

Usage:
  python -m torch_tts_tpu_torch.cli.vits2_vc -c configs/vits2-multispeaker.yaml \\
      -m runs/vctk --wav input.wav --sid-src 3 --sid-tgt 7 -o converted.wav
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from torch_tts_tpu_torch.cli.vits2_infer import load_model, write_wav
from torch_tts_tpu_torch.core.config import VITS2Config, load_vits2_config
from torch_tts_tpu_torch.core.precision import fp32_cudnn
from torch_tts_tpu_torch.data import audio_np


def wav_features(path: str, cfg: VITS2Config) -> np.ndarray:
    """A wav at the config's rate -> the posterior encoder's input [T, C]."""
    a = cfg.audio
    wav, sr = audio_np.load_wav(path)
    if sr != a.sampling_rate:
        raise SystemExit(f"{path}: {sr} Hz, the config expects {a.sampling_rate} Hz")
    if cfg.model.use_mel_posterior_encoder:
        return audio_np.mel_spectrogram_np(wav, a.filter_length, a.n_mel_channels,
                                           a.sampling_rate, a.hop_length, a.win_length,
                                           a.mel_fmin, a.mel_fmax)
    return audio_np.spectrogram_np(wav, a.filter_length, a.hop_length, a.win_length)


def main(argv: Optional[Sequence[str]] = None):
    fp32_cudnn()
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-c", "--config", required=True, help="YAML or JSON VITS2 config")
    p.add_argument("-m", "--model", required=True,
                   help="trainer run directory, or a reference-format state dict (.pth)")
    p.add_argument("--wav", required=True)
    p.add_argument("--sid-src", type=int, required=True)
    p.add_argument("--sid-tgt", type=int, required=True)
    p.add_argument("-o", "--output", default="converted.wav")
    p.add_argument("--seed", type=int, default=0, help="seed of the posterior's noise")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    cfg = load_vits2_config(args.config)
    if cfg.model.n_speakers <= 1:
        raise SystemExit("voice conversion needs a multi-speaker model (n_speakers > 1)")
    device = torch.device(args.device)
    model = load_model(cfg, args.model, device)
    feats = wav_features(args.wav, cfg)
    y = torch.from_numpy(feats)[None].to(device)
    y_lengths = torch.tensor([feats.shape[0]], device=device)
    sid_src, sid_tgt = (torch.tensor([s], device=device) for s in (args.sid_src, args.sid_tgt))
    o_hat, _, _ = model.voice_conversion(
        y, y_lengths, sid_src, sid_tgt,
        generator=torch.Generator(device=device).manual_seed(args.seed))
    audio = o_hat[0, :, 0].float().cpu().numpy()
    write_wav(args.output, audio, cfg.audio.sampling_rate)
    print(f"wrote {args.output}: {len(audio) / cfg.audio.sampling_rate:.2f}s")
    return audio


if __name__ == "__main__":
    main()
