"""Offline text cleaning for filelists (port of
`torch_tts_tpu/cli/preprocess_text.py`).

Applies the cleaners to each filelist's text column and writes
`<filelist>.<out-extension>` (training can then run with cleaned_text=True
and skip per-item cleaning).

Usage:
  python -m torch_tts_tpu_torch.cli.preprocess_text --filelists a.txt b.txt \\
      --text-cleaners basic_cleaners --text-index 1
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from torch_tts_tpu_torch.core.precision import fp32_cudnn


def main(argv: Optional[Sequence[str]] = None):
    fp32_cudnn()
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out-extension", default="cleaned")
    p.add_argument("--text-index", type=int, default=1)
    p.add_argument("--filelists", nargs="+", required=True)
    p.add_argument("--text-cleaners", nargs="+", default=["english_cleaners2"])
    args = p.parse_args(argv)

    from torch_tts_tpu_torch.text.frontend import _clean_text

    for filelist in args.filelists:
        out_path = f"{filelist}.{args.out_extension}"
        with open(filelist, encoding="utf-8") as f, open(out_path, "w", encoding="utf-8") as out:
            for line in f:
                parts = line.rstrip("\n").split("|")
                if len(parts) > args.text_index:
                    parts[args.text_index] = _clean_text(parts[args.text_index],
                                                         args.text_cleaners)
                out.write("|".join(parts) + "\n")
        print(f"wrote {out_path}")


if __name__ == "__main__":
    main()
