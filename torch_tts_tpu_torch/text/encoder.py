"""Character-level text encoders for the tacotron stack.

Equivalents of TextEncoder / MixedTextEncoder in
the reference's tacotron/data/text.py:25-116: regex character normalization,
optional bos/eos symbols, 1-based id lookup (0 is the pad id), warn-once on
unknown characters, and grapheme/phoneme mixed markup `{graph|phon}` with
random grapheme substitution for robustness training.
"""

from __future__ import annotations

import logging
import random
import re
from typing import Dict, List, Optional, Sequence, Tuple

logger = logging.getLogger(__name__)


def text_has_no_digits(text: str) -> bool:
    return re.search(r"\d", text) is None


def unpack_mixed(transcript: str) -> List[Tuple[str, Optional[str]]]:
    """Split `{grapheme|phoneme}` markup into (grapheme, phoneme-or-None) runs."""
    out: List[Tuple[str, Optional[str]]] = []
    pos = 0
    for m in re.finditer(r"{([^}]*)\|([^}]*)}", transcript):
        if m.start() > pos:
            out.append((transcript[pos : m.start()], None))
        out.append((m.group(1), m.group(2)))
        pos = m.end()
    if pos < len(transcript):
        out.append((transcript[pos:], None))
    return out


class TextEncoder:
    """Alphabet-based 1-indexed character encoder (pad = 0)."""

    def __init__(
        self,
        alphabet: str,
        char_map: Optional[Sequence[Tuple[str, str]]] = None,
        bos: Optional[str] = None,
        eos: Optional[str] = None,
        base_index: int = 1,
    ):
        self.char_map: Dict[str, str] = dict(char_map) if char_map else {}
        self.bos = bos or None
        self.eos = eos or None
        self.alphabet = alphabet
        self.lookup = {c: i + base_index for i, c in enumerate(alphabet)}
        self._warned: set = set()

    @property
    def num_symbols(self) -> int:
        return 1 + len(self.alphabet)

    def prepare(self, text: str) -> str:
        text = text.lower()
        for pattern, repl in self.char_map.items():
            text = re.sub(pattern, repl, text)
        if self.bos:
            text = self.bos + text
        if self.eos:
            text = text + self.eos
        return text

    def encode(self, text: str, encode_unk: Optional[int] = None) -> List[int]:
        text = self.prepare(text)
        if encode_unk is not None:
            return [self.lookup.get(c, encode_unk) for c in text]
        for c in text:
            if c not in self.lookup and c not in self._warned:
                self._warned.add(c)
                logger.warning("Unknown character: [%s]", c)
        return [self.lookup[c] for c in text if c in self.lookup]

    def decode(self, ids: Sequence[int], decode_unk: Optional[str] = None) -> List[str]:
        if decode_unk is not None:
            return [
                self.alphabet[i - 1] if 0 < i <= len(self.alphabet) else decode_unk
                for i in ids
            ]
        return [self.alphabet[i - 1] for i in ids if 0 < i <= len(self.alphabet)]


class MixedTextEncoder:
    """Grapheme/phoneme mixed encoder with stochastic grapheme fallback.

    Phoneme ids start after the grapheme alphabet (base 1+len(graphemes)).
    """

    def __init__(
        self,
        graphemes: str,
        phonemes: str,
        char_map: Optional[Sequence[Tuple[str, str]]] = None,
        bos: Optional[int] = None,
        eos: Optional[int] = None,
        p_graphemes: float = 0.3,
        rng: Optional[random.Random] = None,
    ):
        self.g_encoder = TextEncoder(graphemes, char_map, base_index=1)
        self.p_encoder = TextEncoder(phonemes, char_map, base_index=1 + len(graphemes))
        self.bos = bos
        self.eos = eos
        self.alphabet = graphemes + phonemes
        self.p_graphemes = p_graphemes
        self.rng = rng or random.Random()

    @property
    def num_symbols(self) -> int:
        return 1 + len(self.alphabet)

    def encode(self, text: str, encode_unk: Optional[int] = None) -> List[int]:
        encoded: List[int] = []
        if self.bos is not None:
            encoded.append(self.bos)
        for g, p in unpack_mixed(text):
            if p is None or self.rng.random() < self.p_graphemes:
                encoded.extend(self.g_encoder.encode(g))
            else:
                encoded.extend(self.p_encoder.encode(p))
        if self.eos is not None:
            encoded.append(self.eos)
        return encoded

    def decode(self, ids: Sequence[int], decode_unk: Optional[str] = None) -> List[str]:
        if decode_unk is not None:
            return [
                self.alphabet[i - 1] if 0 < i <= len(self.alphabet) else decode_unk
                for i in ids
            ]
        return [self.alphabet[i - 1] for i in ids if 0 < i <= len(self.alphabet)]
