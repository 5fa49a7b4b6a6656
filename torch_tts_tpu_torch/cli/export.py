"""Model export CLI (port of `torch_tts_tpu/cli/export.py`).

Exports VITS2 inference with the reference's (text, text_lengths, scales,
sid) signature (`infer/export.py`). Format:
  pt2 — a `torch.export` program, saved by `torch.export.save`; load it with
        `torch_tts_tpu_torch.infer.export.load_exported`.
A program exported on the card runs the package's kernels as `tts::`
operators; `--device cpu` exports the plain versions. (The JAX package's
`savedmodel` format, a TensorFlow artifact, is not ported.)

Usage:
  python -m torch_tts_tpu_torch.cli.export -c config.json -m runs/ljspeech \\
      --format pt2 -o vits2.pt2
"""

from __future__ import annotations

import argparse
import logging
from typing import Optional, Sequence

from torch_tts_tpu_torch.core.precision import fp32_cudnn


def main(argv: Optional[Sequence[str]] = None):
    fp32_cudnn()
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-c", "--config", required=True)
    p.add_argument("-m", "--model-dir", required=True,
                   help="run dir, checkpoint file, or reference G_*.pth")
    p.add_argument("--format", choices=["pt2"], default="pt2")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--max-text-len", type=int, default=512)
    p.add_argument("--max-frames", type=int, default=1000)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from torch_tts_tpu_torch.infer.export import export_vits2_infer
    from torch_tts_tpu_torch.infer.serving import Synthesizer

    synth = Synthesizer.from_run_dir(args.config, args.model_dir, device=args.device)
    multispeaker = synth.cfg.model.n_speakers > 1
    program = export_vits2_infer(synth.model, max_text_len=args.max_text_len,
                                 max_frames=args.max_frames, multispeaker=multispeaker,
                                 path=args.output, device=args.device)
    print(f"exported {args.format} to {args.output}")
    return program


if __name__ == "__main__":
    main()
