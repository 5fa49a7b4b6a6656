"""Text -> id-sequence conversion (equivalent of the kgoba reference's vits2/text/__init__.py)."""

from __future__ import annotations

from typing import Iterable, List, Sequence

from torch_tts_tpu_torch.text import cleaners as _cleaners
from torch_tts_tpu_torch.text.symbols import symbols

_symbol_to_id = {s: i for i, s in enumerate(symbols)}
_id_to_symbol = {i: s for i, s in enumerate(symbols)}


def _clean_text(text: str, cleaner_names: Iterable[str]) -> str:
    for name in cleaner_names:
        fn = _cleaners.CLEANERS.get(name)
        if fn is None:
            raise ValueError(f"Unknown cleaner: {name}")
        text = fn(text)
    return text


def text_to_sequence(text: str, cleaner_names: Sequence[str]) -> List[int]:
    """Clean text then map to symbol ids, silently dropping unknown symbols
    (same skip behavior as the reference's cleaned_text_to_sequence)."""
    clean = _clean_text(text, cleaner_names) if cleaner_names else text
    return cleaned_text_to_sequence(clean)


def cleaned_text_to_sequence(cleaned_text: str) -> List[int]:
    return [_symbol_to_id[s] for s in cleaned_text if s in _symbol_to_id]


def sequence_to_text(sequence: Iterable[int]) -> str:
    return "".join(_id_to_symbol[i] for i in sequence if i in _id_to_symbol)


def intersperse(ids: Sequence[int], item: int = 0) -> List[int]:
    """Insert `item` (blank) between/around every id (vits2/commons.py:24)."""
    out = [item] * (len(ids) * 2 + 1)
    out[1::2] = list(ids)
    return out
