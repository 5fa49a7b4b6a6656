"""Tacotron inference CLI: text -> 16-bit WAV (reduced port of
`torch_tts_tpu/cli/tacotron_infer.py`).

Encodes the text with the config's alphabet, decodes to --max-steps
(trimmed at the first stop), inverts the postnet mel (m_rev, the
pseudo-inverse of the mel filterbank) and runs Griffin-Lim. `-m` takes a
reference-format state dict (`.pth`, bare or {"model": ...}) such as
`models/tacotron/convert.py` writes; the PreNet's dropout masks and the
Griffin-Lim phases come from --seed.

Usage:
  python -m torch_tts_tpu_torch.cli.tacotron_infer "speech synthesis is neat" \\
      configs/tacotron-ljspeech.yaml -m tacotron.pth -o out.wav
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from torch_tts_tpu_torch.audio.frontend import AudioFrontend, m_rev
from torch_tts_tpu_torch.cli.vits2_infer import write_wav
from torch_tts_tpu_torch.core.config import TacotronConfig, load_tacotron_config
from torch_tts_tpu_torch.models.tacotron.model import Tacotron
from torch_tts_tpu_torch.text.encoder import TextEncoder

_NOT_PORTED = {
    "ref": "the VAE style encoder and AudioFrontend.encode",
    "vocoder": "the HiFi-GAN vocoder artifact path (infer/vocoder.py)",
    "plot": "the attention plot (utils/logging_utils.py)",
}


def load_model(cfg: TacotronConfig, checkpoint: str, device) -> Tacotron:
    """Tacotron for `cfg` with the state dict in `checkpoint` loaded
    strictly, on `device`, in eval mode."""
    blob = torch.load(checkpoint, map_location="cpu", weights_only=True)
    sd = blob["model"] if isinstance(blob.get("model"), dict) else blob
    sd = {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}
    model = Tacotron(cfg, 1 + len(cfg.text.alphabet))
    model.load_state_dict(sd, strict=True)
    return model.to(device).eval()


def text_encoder(cfg: TacotronConfig) -> TextEncoder:
    t = cfg.text
    return TextEncoder(t.alphabet, t.character_map, t.bos_symbols or None, t.eos_symbols or None)


def main(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("text")
    p.add_argument("config", help="YAML or JSON Tacotron config")
    p.add_argument("-m", "--model", required=True, help="reference-format state dict (.pth)")
    p.add_argument("-o", "--output", default="output.wav")
    p.add_argument("--max-steps", type=int, default=400)
    p.add_argument("--griffin-lim-iters", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    for name in _NOT_PORTED:
        p.add_argument(f"--{name}", default=None, help="not ported yet")
    args = p.parse_args(argv)
    for name, what in _NOT_PORTED.items():
        if getattr(args, name) is not None:
            raise SystemExit(f"--{name} is not ported to torch_tts_tpu_torch yet: it needs {what}")

    cfg = load_tacotron_config(args.config)
    device = torch.device(args.device)
    model = load_model(cfg, args.model, device)
    ids = text_encoder(cfg).encode(args.text)
    c = torch.tensor([ids], dtype=torch.int64, device=device)
    c_lengths = torch.tensor([len(ids)], dtype=torch.int64, device=device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    _, y_post, _, aux = model.infer(c, c_lengths, max_steps=args.max_steps, generator=gen)
    n_groups = int(aux["stop_lengths"][0])
    mel = y_post[0, : n_groups * cfg.model.r]  # [T, M], network domain

    fe = AudioFrontend(cfg.audio, device)
    wav = fe.decode(fe.mel_inv(m_rev(mel)), n_iter=args.griffin_lim_iters, generator=gen)
    wav = wav.cpu().numpy()
    wav = wav / max(1e-6, float(np.abs(wav).max())) * 0.9
    write_wav(args.output, wav, cfg.audio.sample_rate)
    print(f"wrote {args.output}: {len(wav) / cfg.audio.sample_rate:.2f}s ({n_groups} decoder steps)")
    return wav, mel


if __name__ == "__main__":
    main()
