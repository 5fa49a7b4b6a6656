"""The port's copy of the text frontend (torch_tts_tpu_torch/text) gives the
JAX package's ids, under the cleaners the shipped configs use
(transliteration_cleaners), the default basic_cleaners, and the G2P path
(english_cleaners2), with and without interspersed blanks."""

import pytest

from torch_tts_tpu import text as jax_text
from torch_tts_tpu_torch import text as port_text

SENTENCES = (
    "The quick brown fox jumps over the lazy dog.",
    "Dr. Smith paid $3.50 for 2 coffees on Jan. 5th, didn't he?",
    "Printing, in the only sense with which we are at present concerned, differs from most arts.",
    "Crème brûlée — naïve café façade!",
)


@pytest.mark.parametrize("cleaner", ["transliteration_cleaners", "basic_cleaners",
                                     "english_cleaners2"])
def test_text_ids_match_the_jax_frontend(cleaner):
    assert port_text.symbols == jax_text.symbols
    for s in SENTENCES:
        ids = port_text.text_to_sequence(s, [cleaner])
        assert ids == jax_text.text_to_sequence(s, [cleaner]) and ids
        assert port_text.intersperse(ids, 0) == jax_text.intersperse(ids, 0)
        assert port_text.sequence_to_text(ids) == jax_text.sequence_to_text(ids)
