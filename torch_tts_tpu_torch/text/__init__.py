"""Text frontend of the port: its own copy of the JAX package's pure-Python
`torch_tts_tpu/text` (cleaners, G2P, symbols, id conversion), so the port
imports nothing of the JAX package. tests/test_torch_text.py holds the two
copies to the same ids."""

from torch_tts_tpu_torch.text.symbols import symbols, SPACE_ID
from torch_tts_tpu_torch.text.frontend import (
    text_to_sequence,
    cleaned_text_to_sequence,
    sequence_to_text,
    intersperse,
)
from torch_tts_tpu_torch.text.encoder import TextEncoder, MixedTextEncoder
