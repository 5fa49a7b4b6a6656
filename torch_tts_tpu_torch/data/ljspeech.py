"""LJSpeech metadata parser (copy of `torch_tts_tpu/data/ljspeech.py`)."""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Dict, Iterator


def parse_ljspeech(dataset_path) -> Iterator[Dict[str, str]]:
    """Yield {id, text_surface, text_normalised, audio_path} from metadata.csv."""
    dataset_path = Path(dataset_path)
    meta = dataset_path / "metadata.csv"
    with open(meta, encoding="utf-8", newline="") as f:
        for row in csv.reader(f, delimiter="|", quoting=csv.QUOTE_NONE):
            if len(row) < 3:
                continue
            utt_id, surface, normalised = row[0], row[1], row[2]
            yield {
                "id": utt_id,
                "text_surface": surface,
                "text_normalised": normalised,
                "audio_path": str(dataset_path / "wavs" / f"{utt_id}.wav"),
            }
