"""Build the Tacotron HDF5 feature cache (port of
`torch_tts_tpu/cli/tacotron_prepare.py`): every utterance of a transcribed
dataset (metadata.csv + wavs/) as `<utt>/mel` (m_fwd-normalised log-mel,
computed on --device) and `<utt>/text`. Needs h5py.

Usage:
  python -m torch_tts_tpu_torch.cli.tacotron_prepare /path/to/LJSpeech-1.1 \\
      configs/tacotron-ljspeech.yaml --data cache.h5
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
    p.add_argument("dataset", help="dataset dir (transcript + wavs)")
    p.add_argument("config", help="YAML or JSON Tacotron config")
    p.add_argument("--data", required=True, help="output HDF5 path")
    p.add_argument("--transcript", default="metadata.csv")
    p.add_argument("--device", default="cuda", help="torch device of the mel frontend")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from torch_tts_tpu_torch.core.config import load_tacotron_config
    from torch_tts_tpu_torch.data.tacotron_dataset import build_dataset_hdf5

    cfg = load_tacotron_config(args.config)
    build_dataset_hdf5(args.dataset, cfg, args.data, args.transcript, device=args.device)
    print(f"wrote {args.data}")


if __name__ == "__main__":
    main()
