"""Audio frontend round-trip check (port of `torch_tts_tpu/cli/audio_check.py`).

wav -> mel -> inverse mel -> Griffin-Lim -> wav, to audition the Tacotron
frontend's configuration, on `--device` (the card by default). The
Griffin-Lim phases start from a generator seeded with 0.

Usage:
  python -m torch_tts_tpu_torch.cli.audio_check input.wav config.json -o roundtrip.wav
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from torch_tts_tpu_torch.core.precision import fp32_cudnn


def main(argv: Optional[Sequence[str]] = None):
    fp32_cudnn()
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("wav")
    p.add_argument("config")
    p.add_argument("-o", "--output", default="roundtrip.wav")
    p.add_argument("--griffin-lim-iters", type=int, default=32)
    p.add_argument("--direct", action="store_true",
                   help="skip the mel bottleneck (STFT round-trip only)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from torch_tts_tpu_torch.audio.frontend import AudioFrontend
    from torch_tts_tpu_torch.cli.vits2_infer import write_wav
    from torch_tts_tpu_torch.core.config import load_tacotron_config
    from torch_tts_tpu_torch.data.audio_np import load_wav

    cfg = load_tacotron_config(args.config)
    fe = AudioFrontend(cfg.audio, device=args.device)
    wav, sr = load_wav(args.wav)
    D_db, M_db = fe.encode(wav, sr)
    print(f"encoded: {D_db.shape[0]} frames, {M_db.shape[1]} mels")
    spec = D_db if args.direct else fe.mel_inv(M_db)
    gen = torch.Generator(device=fe.device).manual_seed(0)
    out = fe.decode(spec, n_iter=args.griffin_lim_iters, generator=gen).cpu().numpy()
    out = out / max(1e-6, np.abs(out).max()) * 0.9
    write_wav(args.output, out, cfg.audio.sample_rate)
    print(f"wrote {args.output}")
    return out


if __name__ == "__main__":
    main()
