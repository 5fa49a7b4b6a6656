"""Alphabet auditor (port of `torch_tts_tpu/tools/helper.py`): a Unicode
category census and a rare-character report of transcripts, to design an
alphabet / character map for a new dataset.

Usage:
  python -m torch_tts_tpu_torch.tools.helper transcript.txt [--column 1]
"""

from __future__ import annotations

import argparse
import unicodedata
from collections import Counter
from typing import Dict, Iterable, Optional, Sequence

from torch_tts_tpu_torch.core.precision import fp32_cudnn


def audit_alphabet(lines: Iterable[str], rare_threshold: int = 2) -> Dict:
    """Per character its count, per Unicode category its count, the
    characters seen at most `rare_threshold` times, and the sorted alphabet."""
    counts: Counter = Counter()
    categories: Counter = Counter()
    for line in lines:
        for ch in line:
            counts[ch] += 1
            categories[unicodedata.category(ch)] += 1
    rare = {c: n for c, n in counts.items() if n <= rare_threshold}
    return {
        "counts": dict(counts),
        "categories": dict(categories),
        "rare": rare,
        "alphabet": "".join(sorted(counts)),
    }


def main(argv: Optional[Sequence[str]] = None):
    fp32_cudnn()
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("transcript", help="text file (one utterance per line)")
    p.add_argument("--column", type=int, default=None,
                   help="pipe-separated column to audit")
    args = p.parse_args(argv)

    def lines():
        with open(args.transcript, encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if args.column is not None:
                    parts = line.split("|")
                    if len(parts) > args.column:
                        yield parts[args.column]
                else:
                    yield line

    report = audit_alphabet(lines())
    print("alphabet:", repr(report["alphabet"]))
    print("categories:", report["categories"])
    if report["rare"]:
        print("rare characters:")
        for c, n in sorted(report["rare"].items(), key=lambda kv: kv[1]):
            print(f"  {c!r} ({unicodedata.name(c, '?')}): {n}")
    return report


if __name__ == "__main__":
    main()
