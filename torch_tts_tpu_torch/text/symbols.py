"""Symbol inventory for VITS2-style models.

The exact keithito-style symbol set used by the reference
(the kgoba reference's vits2/text/symbols.py:6-13) — ids must match so that
reference checkpoints and filelists remain interoperable.
"""

_pad = "_"
_punctuation = ';:,.!?¡¿—…"«»“” '
_letters = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
_letters_ipa = (
    "ɑɐɒæɓʙβɔɕçɗɖðʤəɘɚɛɜɝɞɟʄɡɠɢʛɦɧħɥʜɨɪʝɭɬɫɮʟɱɯɰŋɳɲɴøɵɸθœɶʘɹɺɾɻʀʁɽʂʃʈʧʉʊʋⱱʌɣɤʍχʎʏʑʐʒʔʡʕʢǀǁǂǃˈˌːˑʼʴʰʱʲʷˠˤ˞↓↑→↗↘'̩'ᵻ"
)

symbols = [_pad] + list(_punctuation) + list(_letters) + list(_letters_ipa)

SPACE_ID = symbols.index(" ")
