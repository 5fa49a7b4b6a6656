"""Text cleaners (equivalents of the kgoba reference's vits2/text/cleaners.py).

Pure-Python normalization pipelines selectable by name. Cleaners that depend
on optional packages degrade explicitly:
- when `unidecode` is absent, ASCII transliteration falls back to a
  Unicode-NFKD + combining-mark-strip pass (covers Latin-script diacritics,
  which is what LJSpeech/VCTK need).
- espeak phonemization (`english_cleaners*`) raises a clear error when the
  `phonemizer` package is absent rather than failing deep inside.
"""

from __future__ import annotations

import logging
import re
import unicodedata

_whitespace_re = re.compile(r"\s+")

# Abbreviation expansion pairs used by keithito-style English cleaners.
_abbreviations = [
    (re.compile(r"\b%s\." % abbr, re.IGNORECASE), full)
    for abbr, full in [
        ("mrs", "misess"),
        ("mr", "mister"),
        ("dr", "doctor"),
        ("st", "saint"),
        ("co", "company"),
        ("jr", "junior"),
        ("maj", "major"),
        ("gen", "general"),
        ("drs", "doctors"),
        ("rev", "reverend"),
        ("lt", "lieutenant"),
        ("hon", "honorable"),
        ("sgt", "sergeant"),
        ("capt", "captain"),
        ("esq", "esquire"),
        ("ltd", "limited"),
        ("col", "colonel"),
        ("ft", "fort"),
    ]
]


def expand_abbreviations(text: str) -> str:
    for regex, replacement in _abbreviations:
        text = regex.sub(replacement, text)
    return text


def lowercase(text: str) -> str:
    return text.lower()


def collapse_whitespace(text: str) -> str:
    return _whitespace_re.sub(" ", text)


def convert_to_ascii(text: str) -> str:
    """ASCII transliteration. Uses unidecode when available, else NFKD fold."""
    try:
        from unidecode import unidecode  # pragma: no cover - optional package

        return unidecode(text)
    except ImportError:
        decomposed = unicodedata.normalize("NFKD", text)
        return "".join(c for c in decomposed if ord(c) < 128)


_warned_g2p_fallback = False


def basic_cleaners(text: str) -> str:
    """Lowercase + collapse whitespace, no transliteration."""
    return collapse_whitespace(lowercase(text))


def transliteration_cleaners(text: str) -> str:
    """ASCII transliteration + lowercase + collapse whitespace."""
    return collapse_whitespace(lowercase(convert_to_ascii(text)))


def _phonemize(text: str, **kwargs) -> str:
    """espeak phonemization when available; pure-Python fallback otherwise.

    The reference's default LJSpeech recipe is phoneme text via espeak
    (the kgoba reference's vits2/text/cleaners.py:90-114). When the `phonemizer`
    package is absent, the built-in lexicon+rules G2P (text/g2p.py) is used so
    the recipe still runs end-to-end — it is an approximation, not bit-exact
    espeak. Set TTS_REQUIRE_ESPEAK=1 to error loudly instead (e.g. to
    guarantee filelists are byte-compatible with espeak-phonemized ones).
    """
    try:
        from phonemizer import phonemize  # pragma: no cover - optional package

        return phonemize(text, language="en-us", backend="espeak", **kwargs)
    except ImportError as e:
        import os

        if os.environ.get("TTS_REQUIRE_ESPEAK"):
            raise RuntimeError(
                "english_cleaners require the `phonemizer` package (espeak "
                "backend), which is not installed, and TTS_REQUIRE_ESPEAK is "
                "set. Unset it to use the built-in approximate G2P, or use "
                "`transliteration_cleaners` / pre-cleaned filelists."
            ) from e
        from torch_tts_tpu_torch.text.g2p import phonemize_en

        global _warned_g2p_fallback
        if not _warned_g2p_fallback:
            _warned_g2p_fallback = True
            logging.getLogger(__name__).warning(
                "phonemizer (espeak) is not installed; falling back to the "
                "built-in approximate G2P (text/g2p.py). Phoneme sequences "
                "will NOT be byte-compatible with espeak-phonemized "
                "checkpoints/filelists. Set TTS_REQUIRE_ESPEAK=1 to error "
                "instead."
            )
        return phonemize_en(
            text,
            preserve_punctuation=kwargs.get("preserve_punctuation", False),
            with_stress=kwargs.get("with_stress", False),
        )


def english_cleaners(text: str) -> str:
    text = expand_abbreviations(lowercase(convert_to_ascii(text)))
    return collapse_whitespace(_phonemize(text, strip=True))


def english_cleaners2(text: str) -> str:
    text = expand_abbreviations(lowercase(convert_to_ascii(text)))
    return collapse_whitespace(
        _phonemize(text, strip=True, preserve_punctuation=True, with_stress=True)
    )


CLEANERS = {
    "basic_cleaners": basic_cleaners,
    "transliteration_cleaners": transliteration_cleaners,
    "english_cleaners": english_cleaners,
    "english_cleaners2": english_cleaners2,
}
