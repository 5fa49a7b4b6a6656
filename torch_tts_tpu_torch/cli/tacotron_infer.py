"""Tacotron inference CLI: text -> 16-bit WAV (reduced port of
`torch_tts_tpu/cli/tacotron_infer.py`).

Encodes the text with the config's alphabet, decodes to --max-steps
(trimmed at the first stop), then either hands the postnet mel to a
neural vocoder (--vocoder: an `infer/vocoder.py` artifact, the port's or
the JAX package's, checked against the config's mel count, hop and sample
rate) or inverts it (m_rev, the pseudo-inverse of the mel filterbank) and
runs Griffin-Lim. The weights: `-m`, a reference-format state dict
(`.pth`, bare or {"model": ...}) such as `models/tacotron/convert.py`
writes, or `--run-dir`, the latest checkpoint of a `cli/tacotron_train.py`
run (random weights, with a warning, when it has none); exactly one of the
two. --ref WAV: a reference recording for a VAE model's style (its mel by
the port's `load_wav`, `AudioFrontend.encode` and `m_fwd`; ignored, with a
warning, by a model without a style encoder, as the JAX model ignores
it); --plot PNG: the attention of the decode up to its stop, as
`utils/logging_utils.py` renders it. The PreNet's dropout masks, the VAE's
eps (drawn after the masks) and the Griffin-Lim phases come from --seed.

Usage:
  python -m torch_tts_tpu_torch.cli.tacotron_infer "speech synthesis is neat" \\
      configs/tacotron-ljspeech.yaml -m tacotron.pth -o out.wav
  python -m torch_tts_tpu_torch.cli.tacotron_infer "speech synthesis is neat" \\
      configs/tacotron-ljspeech.yaml --run-dir runs/tacotron -o out.wav
  python -m torch_tts_tpu_torch.cli.tacotron_infer "speech synthesis is neat" \\
      vae.yaml -m vae.pth --ref reference.wav --plot attention.png
"""

from __future__ import annotations

import argparse
import logging
from typing import Optional, Sequence

import numpy as np
import torch

from torch_tts_tpu_torch.audio.frontend import AudioFrontend, m_fwd, m_rev
from torch_tts_tpu_torch.cli.vits2_infer import write_wav
from torch_tts_tpu_torch.core.config import TacotronConfig, load_tacotron_config
from torch_tts_tpu_torch.core.precision import fp32_cudnn
from torch_tts_tpu_torch.models.tacotron.model import Tacotron
from torch_tts_tpu_torch.text.encoder import TextEncoder

def load_model(cfg: TacotronConfig, checkpoint: str, device) -> Tacotron:
    """Tacotron for `cfg` with the state dict in `checkpoint` (a `.pth`, or
    a run directory's latest `ckpt_<step>.pt`) loaded strictly, on `device`,
    in eval mode; a run directory without a checkpoint gives the seeded
    random weights of `build_tacotron`, with a warning."""
    from torch_tts_tpu_torch.infer.serving import load_generator_state
    from torch_tts_tpu_torch.models.tacotron.model import build_tacotron

    sd = load_generator_state(checkpoint)
    if sd is None:
        logging.warning("no checkpoint in %s: random weights", checkpoint)
        return build_tacotron(cfg, device=device)
    model = Tacotron(cfg, 1 + len(cfg.text.alphabet))
    model.load_state_dict(sd, strict=True)
    return model.to(device).eval()


def text_encoder(cfg: TacotronConfig) -> TextEncoder:
    t = cfg.text
    return TextEncoder(t.alphabet, t.character_map, t.bos_symbols or None, t.eos_symbols or None)


def main(argv: Optional[Sequence[str]] = None):
    fp32_cudnn()
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("text")
    p.add_argument("config", help="YAML or JSON Tacotron config")
    weights = p.add_mutually_exclusive_group(required=True)
    weights.add_argument("-m", "--model", help="reference-format state dict (.pth)")
    weights.add_argument("--run-dir", help="a tacotron_train run directory: its latest checkpoint")
    p.add_argument("-o", "--output", default="output.wav")
    p.add_argument("--max-steps", type=int, default=400)
    p.add_argument("--griffin-lim-iters", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--vocoder", default=None, help="vocoder artifact (else Griffin-Lim)")
    p.add_argument("--ref", default=None, help="reference wav for style (VAE models)")
    p.add_argument("--plot", default=None, help="write the attention plot PNG here")
    args = p.parse_args(argv)

    cfg = load_tacotron_config(args.config)
    device = torch.device(args.device)
    model = load_model(cfg, args.model or args.run_dir, device)
    ids = text_encoder(cfg).encode(args.text)
    c = torch.tensor([ids], dtype=torch.int64, device=device)
    c_lengths = torch.tensor([len(ids)], dtype=torch.int64, device=device)
    fe = AudioFrontend(cfg.audio, device)
    xref = xref_lengths = None
    if args.ref:
        if model.refencoder is None:
            logging.warning("--ref given, but the model has no style encoder: ignored")
        else:
            from torch_tts_tpu_torch.data.audio_np import load_wav

            wav, sr = load_wav(args.ref)
            xref = m_fwd(fe.encode(wav, sr)[1])[None]  # [1, T, M]
            xref_lengths = torch.tensor([xref.shape[1]], dtype=torch.int64, device=device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    _, y_post, _, aux = model.infer(c, c_lengths, max_steps=args.max_steps, generator=gen,
                                    xref=xref, xref_lengths=xref_lengths)
    n_groups = int(aux["stop_lengths"][0])
    mel = y_post[0, : n_groups * cfg.model.r]  # [T, M], network domain

    if args.vocoder:
        from torch_tts_tpu_torch.infer.vocoder import check_compat, load_vocoder

        voc = load_vocoder(args.vocoder, device=device)
        try:
            check_compat(voc, num_mels=cfg.audio.num_mels, hop_length=cfg.audio.hop_length,
                         sample_rate=cfg.audio.sample_rate)
        except ValueError as e:
            raise SystemExit(str(e))
        wav = voc.synth(mel[None])[0]
    else:
        wav = fe.decode(fe.mel_inv(m_rev(mel)), n_iter=args.griffin_lim_iters, generator=gen)
        wav = wav.cpu().numpy()
    wav = wav / max(1e-6, float(np.abs(wav).max())) * 0.9
    write_wav(args.output, wav, cfg.audio.sample_rate)
    print(f"wrote {args.output}: {len(wav) / cfg.audio.sample_rate:.2f}s ({n_groups} decoder steps)")
    if args.plot:
        from torch_tts_tpu_torch.utils.logging_utils import plot_alignment_to_numpy, write_png

        write_png(args.plot, plot_alignment_to_numpy(aux["w"][0, :n_groups].cpu().numpy()))
        print(f"wrote {args.plot}")
    return wav, mel


if __name__ == "__main__":
    main()
