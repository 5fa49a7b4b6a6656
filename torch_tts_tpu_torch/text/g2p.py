"""Pure-Python English grapheme-to-phoneme fallback.

The reference's default LJSpeech recipe phonemizes text with espeak via the
`phonemizer` package (the kgoba reference's vits2/text/cleaners.py:90-114), which is
an optional dependency. This module provides a dependency-free
approximation so `english_cleaners` / `english_cleaners2` run end-to-end:

- number/currency/ordinal expansion (inflect-free re-implementation of the
  keithito normalization the espeak backend otherwise performs internally),
- a lexicon of common English words (function words + frequent irregulars)
  in ARPAbet with stress,
- an NRL-style context-sensitive letter-to-sound rule engine (Elovitz et al.
  1976 pattern language: # vowels, : consonants*, ^ consonant, . voiced,
  + front vowel, % suffix) for out-of-lexicon words,
- ARPAbet -> espeak-flavoured IPA mapping restricted to the model's symbol
  inventory (text/symbols.py), with optional ˈ/ˌ stress marks.

This is an *approximate* G2P: suitable for running the reference recipe and
for training from scratch without espeak, not a bit-exact espeak clone. When
the real `phonemizer` is available it is always preferred (text/cleaners.py).
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# number expansion (keithito-style, inflect-free)
# ---------------------------------------------------------------------------

_ONES = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_TENS = [
    "", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
    "eighty", "ninety",
]
_SCALES = [
    (10**12, "trillion"), (10**9, "billion"), (10**6, "million"),
    (10**3, "thousand"), (100, "hundred"),
]

_ORDINAL_SPECIAL = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def _two_digits(n: int) -> str:
    if n < 20:
        return _ONES[n]
    t, o = divmod(n, 10)
    return _TENS[t] + ("-" + _ONES[o] if o else "")


def number_to_words(n: int) -> str:
    if n < 0:
        return "minus " + number_to_words(-n)
    if n < 100:
        return _two_digits(n)
    parts: List[str] = []
    for scale, name in _SCALES:
        if n >= scale:
            parts.append(number_to_words(n // scale) + " " + name)
            n %= scale
    if n:
        parts.append(_two_digits(n))
    return " ".join(parts)


def ordinal_to_words(n: int) -> str:
    words = number_to_words(n)
    head, _, last = words.rpartition(" ") if " " in words else ("", "", words)
    h2, _, l2 = last.rpartition("-") if "-" in last else ("", "", last)
    if l2 in _ORDINAL_SPECIAL:
        ord_last = _ORDINAL_SPECIAL[l2]
    elif l2.endswith("y"):
        ord_last = l2[:-1] + "ieth"
    else:
        ord_last = l2 + "th"
    last = (h2 + "-" if h2 else "") + ord_last
    return (head + " " if head else "") + last


def _expand_year(n: int) -> str:
    """1806 -> eighteen oh six; 2000 -> two thousand; 2024 -> twenty twenty-four."""
    if 1000 <= n < 3000:
        if n % 1000 == 0:
            return number_to_words(n // 1000) + " thousand"
        if n % 100 == 0:
            return _two_digits(n // 100) + " hundred"
        hi, lo = divmod(n, 100)
        if lo < 10:
            return _two_digits(hi) + " oh " + _ONES[lo]
        return _two_digits(hi) + " " + _two_digits(lo)
    return number_to_words(n)


_comma_number_re = re.compile(r"([0-9][0-9,]+[0-9])")
_decimal_re = re.compile(r"([0-9]+)\.([0-9]+)")
_dollars_re = re.compile(r"\$([0-9.,]*[0-9]+)")
_pounds_re = re.compile(r"£([0-9.,]*[0-9]+)")
_ordinal_re = re.compile(r"([0-9]+)(st|nd|rd|th)")
_number_re = re.compile(r"[0-9]+")


def _expand_dollars(m: re.Match) -> str:
    parts = m.group(1).replace(",", "").split(".")
    dollars = int(parts[0]) if parts[0] else 0
    cents = int(parts[1][:2].ljust(2, "0")) if len(parts) > 1 and parts[1] else 0
    out = []
    if dollars:
        out.append(number_to_words(dollars) + (" dollar" if dollars == 1 else " dollars"))
    if cents:
        out.append(number_to_words(cents) + (" cent" if cents == 1 else " cents"))
    return ", ".join(out) if out else "zero dollars"


def _expand_decimal(m: re.Match) -> str:
    digits = " ".join(_ONES[int(d)] for d in m.group(2))
    return number_to_words(int(m.group(1))) + " point " + digits


def _expand_plain_number(m: re.Match) -> str:
    n = int(m.group(0))
    return _expand_year(n) if 1000 <= n < 3000 else number_to_words(n)


def normalize_numbers(text: str) -> str:
    text = _comma_number_re.sub(lambda m: m.group(1).replace(",", ""), text)
    text = _pounds_re.sub(lambda m: _dollars_re.sub(_expand_dollars, "$" + m.group(1))
                          .replace("dollar", "pound").replace("cent", "penny")
                          .replace("pennys", "pence"), text)
    text = _dollars_re.sub(_expand_dollars, text)
    text = _decimal_re.sub(_expand_decimal, text)
    text = _ordinal_re.sub(lambda m: ordinal_to_words(int(m.group(1))), text)
    text = _number_re.sub(_expand_plain_number, text)
    return text


# ---------------------------------------------------------------------------
# lexicon (ARPAbet with stress digits on vowels)
# ---------------------------------------------------------------------------

LEXICON: Dict[str, str] = {
    "a": "AH0", "an": "AH0 N", "the": "DH AH0", "of": "AH0 V",
    "to": "T UW1", "and": "AH0 N D", "in": "IH0 N", "is": "IH1 Z",
    "it": "IH1 T", "you": "Y UW1", "that": "DH AE1 T", "he": "HH IY1",
    "was": "W AA1 Z", "for": "F AO1 R", "on": "AA1 N", "are": "AA1 R",
    "as": "AE1 Z", "with": "W IH1 DH", "his": "HH IH1 Z", "they": "DH EY1",
    "i": "AY1", "at": "AE1 T", "be": "B IY1", "this": "DH IH1 S",
    "have": "HH AE1 V", "from": "F R AH1 M", "or": "AO1 R",
    "one": "W AH1 N", "had": "HH AE1 D", "by": "B AY1",
    "word": "W ER1 D", "but": "B AH1 T", "not": "N AA1 T",
    "what": "W AH1 T", "all": "AO1 L", "were": "W ER1", "we": "W IY1",
    "when": "W EH1 N", "your": "Y AO1 R", "can": "K AE1 N",
    "said": "S EH1 D", "there": "DH EH1 R", "use": "Y UW1 S",
    "each": "IY1 CH", "which": "W IH1 CH", "she": "SH IY1",
    "do": "D UW1", "how": "HH AW1", "their": "DH EH1 R",
    "if": "IH1 F", "will": "W IH1 L", "up": "AH1 P",
    "other": "AH1 DH ER0", "about": "AH0 B AW1 T", "out": "AW1 T",
    "many": "M EH1 N IY0", "then": "DH EH1 N", "them": "DH EH1 M",
    "these": "DH IY1 Z", "so": "S OW1", "some": "S AH1 M",
    "her": "HH ER1", "would": "W UH1 D", "make": "M EY1 K",
    "like": "L AY1 K", "him": "HH IH1 M", "into": "IH1 N T UW0",
    "time": "T AY1 M", "has": "HH AE1 Z", "look": "L UH1 K",
    "two": "T UW1", "more": "M AO1 R", "write": "R AY1 T",
    "go": "G OW1", "see": "S IY1", "no": "N OW1", "way": "W EY1",
    "could": "K UH1 D", "people": "P IY1 P AH0 L", "my": "M AY1",
    "than": "DH AE1 N", "first": "F ER1 S T", "water": "W AO1 T ER0",
    "been": "B IH1 N", "who": "HH UW1", "its": "IH1 T S",
    "now": "N AW1", "find": "F AY1 N D", "long": "L AO1 NG",
    "down": "D AW1 N", "day": "D EY1", "did": "D IH1 D",
    "get": "G EH1 T", "come": "K AH1 M", "made": "M EY1 D",
    "may": "M EY1", "part": "P AA1 R T", "over": "OW1 V ER0",
    "new": "N UW1", "sound": "S AW1 N D", "take": "T EY1 K",
    "only": "OW1 N L IY0", "little": "L IH1 T AH0 L",
    "work": "W ER1 K", "know": "N OW1", "place": "P L EY1 S",
    "year": "Y IH1 R", "live": "L IH1 V", "me": "M IY1",
    "back": "B AE1 K", "give": "G IH1 V", "most": "M OW1 S T",
    "very": "V EH1 R IY0", "after": "AE1 F T ER0",
    "thing": "TH IH1 NG", "our": "AW1 ER0", "just": "JH AH1 S T",
    "name": "N EY1 M", "good": "G UH1 D", "sentence": "S EH1 N T AH0 N S",
    "man": "M AE1 N", "think": "TH IH1 NG K", "say": "S EY1",
    "great": "G R EY1 T", "where": "W EH1 R", "through": "TH R UW1",
    "much": "M AH1 CH", "before": "B IH0 F AO1 R", "too": "T UW1",
    "mean": "M IY1 N", "same": "S EY1 M", "right": "R AY1 T",
    "any": "EH1 N IY0", "tell": "T EH1 L", "boy": "B OY1",
    "follow": "F AA1 L OW0", "came": "K EY1 M", "want": "W AA1 N T",
    "show": "SH OW1", "also": "AO1 L S OW0", "around": "AH0 R AW1 N D",
    "form": "F AO1 R M", "three": "TH R IY1", "small": "S M AO1 L",
    "set": "S EH1 T", "put": "P UH1 T", "end": "EH1 N D",
    "does": "D AH1 Z", "another": "AH0 N AH1 DH ER0",
    "well": "W EH1 L", "large": "L AA1 R JH", "must": "M AH1 S T",
    "big": "B IH1 G", "even": "IY1 V AH0 N", "such": "S AH1 CH",
    "because": "B IH0 K AO1 Z", "turn": "T ER1 N", "here": "HH IY1 R",
    "why": "W AY1", "ask": "AE1 S K", "went": "W EH1 N T",
    "men": "M EH1 N", "read": "R IY1 D", "need": "N IY1 D",
    "land": "L AE1 N D", "different": "D IH1 F ER0 AH0 N T",
    "home": "HH OW1 M", "us": "AH1 S", "move": "M UW1 V",
    "try": "T R AY1", "kind": "K AY1 N D", "hand": "HH AE1 N D",
    "picture": "P IH1 K CH ER0", "again": "AH0 G EH1 N",
    "change": "CH EY1 N JH", "off": "AO1 F", "play": "P L EY1",
    "spell": "S P EH1 L", "air": "EH1 R", "away": "AH0 W EY1",
    "animal": "AE1 N AH0 M AH0 L", "house": "HH AW1 S",
    "point": "P OY1 N T", "page": "P EY1 JH", "letter": "L EH1 T ER0",
    "mother": "M AH1 DH ER0", "father": "F AA1 DH ER0",
    "answer": "AE1 N S ER0", "found": "F AW1 N D",
    "study": "S T AH1 D IY0", "still": "S T IH1 L",
    "learn": "L ER1 N", "should": "SH UH1 D", "world": "W ER1 L D",
    "high": "HH AY1", "every": "EH1 V ER0 IY0", "near": "N IH1 R",
    "add": "AE1 D", "food": "F UW1 D", "between": "B IH0 T W IY1 N",
    "own": "OW1 N", "below": "B IH0 L OW1", "country": "K AH1 N T R IY0",
    "plant": "P L AE1 N T", "last": "L AE1 S T", "school": "S K UW1 L",
    "keep": "K IY1 P", "tree": "T R IY1", "never": "N EH1 V ER0",
    "start": "S T AA1 R T", "city": "S IH1 T IY0", "earth": "ER1 TH",
    "eye": "AY1", "light": "L AY1 T", "thought": "TH AO1 T",
    "head": "HH EH1 D", "under": "AH1 N D ER0", "story": "S T AO1 R IY0",
    "saw": "S AO1", "left": "L EH1 F T", "don't": "D OW1 N T",
    "few": "F Y UW1", "while": "W AY1 L", "along": "AH0 L AO1 NG",
    "might": "M AY1 T", "close": "K L OW1 S", "something": "S AH1 M TH IH0 NG",
    "seem": "S IY1 M", "next": "N EH1 K S T", "hard": "HH AA1 R D",
    "open": "OW1 P AH0 N", "example": "IH0 G Z AE1 M P AH0 L",
    "begin": "B IH0 G IH1 N", "life": "L AY1 F", "always": "AO1 L W EY0 Z",
    "those": "DH OW1 Z", "both": "B OW1 TH", "paper": "P EY1 P ER0",
    "together": "T AH0 G EH1 DH ER0", "got": "G AA1 T",
    "group": "G R UW1 P", "often": "AO1 F AH0 N", "run": "R AH1 N",
    "important": "IH0 M P AO1 R T AH0 N T", "until": "AH0 N T IH1 L",
    "children": "CH IH1 L D R AH0 N", "side": "S AY1 D",
    "feet": "F IY1 T", "car": "K AA1 R", "mile": "M AY1 L",
    "night": "N AY1 T", "walk": "W AO1 K", "white": "W AY1 T",
    "sea": "S IY1", "began": "B IH0 G AE1 N", "grow": "G R OW1",
    "took": "T UH1 K", "river": "R IH1 V ER0", "four": "F AO1 R",
    "carry": "K AE1 R IY0", "state": "S T EY1 T", "once": "W AH1 N S",
    "book": "B UH1 K", "hear": "HH IY1 R", "stop": "S T AA1 P",
    "without": "W IH0 TH AW1 T", "second": "S EH1 K AH0 N D",
    "later": "L EY1 T ER0", "miss": "M IH1 S", "idea": "AY0 D IY1 AH0",
    "enough": "IH0 N AH1 F", "eat": "IY1 T", "face": "F EY1 S",
    "watch": "W AA1 CH", "far": "F AA1 R", "really": "R IH1 L IY0",
    "almost": "AO1 L M OW0 S T", "let": "L EH1 T", "above": "AH0 B AH1 V",
    "girl": "G ER1 L", "sometimes": "S AH1 M T AY0 M Z",
    "mountain": "M AW1 N T AH0 N", "cut": "K AH1 T",
    "young": "Y AH1 NG", "talk": "T AO1 K", "soon": "S UW1 N",
    "list": "L IH1 S T", "song": "S AO1 NG", "being": "B IY1 IH0 NG",
    "leave": "L IY1 V", "family": "F AE1 M AH0 L IY0",
    "mr": "M IH1 S T ER0", "mrs": "M IH1 S IH0 Z",
    "one's": "W AH1 N Z", "there's": "DH EH1 R Z", "i'm": "AY1 M",
    "it's": "IH1 T S", "he's": "HH IY1 Z", "she's": "SH IY1 Z",
    "that's": "DH AE1 T S", "what's": "W AH1 T S", "let's": "L EH1 T S",
    "who's": "HH UW1 Z", "won't": "W OW1 N T", "can't": "K AE1 N T",
    "didn't": "D IH1 D AH0 N T", "isn't": "IH1 Z AH0 N T",
    "wasn't": "W AA1 Z AH0 N T", "aren't": "AA1 R AH0 N T",
    "weren't": "W ER1 AH0 N T", "couldn't": "K UH1 D AH0 N T",
    "wouldn't": "W UH1 D AH0 N T", "shouldn't": "SH UH1 D AH0 N T",
    "oh": "OW1", "says": "S EH1 Z", "does't": "D AH1 Z AH0 N T",
    "doesn't": "D AH1 Z AH0 N T", "done": "D AH1 N", "gone": "G AO1 N",
    "heart": "HH AA1 R T", "pretty": "P R IH1 T IY0",
    "woman": "W UH1 M AH0 N", "women": "W IH1 M AH0 N",
    "money": "M AH1 N IY0", "island": "AY1 L AH0 N D",
    "iron": "AY1 ER0 N", "hour": "AW1 ER0", "honest": "AA1 N AH0 S T",
    "honor": "AA1 N ER0", "colonel": "K ER1 N AH0 L",
    "choir": "K W AY1 ER0", "answered": "AE1 N S ER0 D",
    "sugar": "SH UH1 G ER0", "sure": "SH UH1 R",
    "ocean": "OW1 SH AH0 N", "special": "S P EH1 SH AH0 L",
    "machine": "M AH0 SH IY1 N", "police": "P AH0 L IY1 S",
    "friend": "F R EH1 N D", "against": "AH0 G EH1 N S T",
    "early": "ER1 L IY0", "heard": "HH ER1 D", "door": "D AO1 R",
    "floor": "F L AO1 R", "poor": "P UH1 R", "your're": "Y UH1 R",
    "blood": "B L AH1 D", "flood": "F L AH1 D", "dove": "D AH1 V",
    "love": "L AH1 V", "some'": "S AH1 M", "come'": "K AH1 M",
    "eight": "EY1 T", "eighty": "EY1 T IY0", "height": "HH AY1 T",
    "weight": "W EY1 T", "either": "IY1 DH ER0", "neither": "N IY1 DH ER0",
    "breakfast": "B R EH1 K F AH0 S T", "break": "B R EY1 K",
    "steak": "S T EY1 K", "heavy": "HH EH1 V IY0",
    "weather": "W EH1 DH ER0", "bread": "B R EH1 D",
    "dead": "D EH1 D", "ready": "R EH1 D IY0", "instead": "IH0 N S T EH1 D",
    "measure": "M EH1 ZH ER0", "pleasure": "P L EH1 ZH ER0",
    "treasure": "T R EH1 ZH ER0", "usual": "Y UW1 ZH AH0 W AH0 L",
    "usually": "Y UW1 ZH AH0 W AH0 L IY0", "vision": "V IH1 ZH AH0 N",
    "decision": "D IH0 S IH1 ZH AH0 N", "asia": "EY1 ZH AH0",
    "mister": "M IH1 S T ER0", "misess": "M IH1 S IH0 Z",
    "doctor": "D AA1 K T ER0", "saint": "S EY1 N T",
    "company": "K AH1 M P AH0 N IY0", "junior": "JH UW1 N Y ER0",
    "major": "M EY1 JH ER0", "general": "JH EH1 N ER0 AH0 L",
    "doctors": "D AA1 K T ER0 Z", "reverend": "R EH1 V ER0 AH0 N D",
    "lieutenant": "L UW0 T EH1 N AH0 N T", "honorable": "AA1 N ER0 AH0 B AH0 L",
    "sergeant": "S AA1 R JH AH0 N T", "captain": "K AE1 P T AH0 N",
    "esquire": "EH1 S K W AY0 R", "limited": "L IH1 M AH0 T IH0 D",
    "fort": "F AO1 R T", "zero": "Z IH1 R OW0", "percent": "P ER0 S EH1 N T",
    "point": "P OY1 N T", "minus": "M AY1 N AH0 S",
    "hundred": "HH AH1 N D R AH0 D", "thousand": "TH AW1 Z AH0 N D",
    "million": "M IH1 L Y AH0 N", "billion": "B IH1 L Y AH0 N",
    "trillion": "T R IH1 L Y AH0 N", "eleven": "IH0 L EH1 V AH0 N",
    "twelve": "T W EH1 L V", "twenty": "T W EH1 N T IY0",
    "thirty": "TH ER1 T IY0", "forty": "F AO1 R T IY0",
    "fifty": "F IH1 F T IY0", "sixty": "S IH1 K S T IY0",
    "seventy": "S EH1 V AH0 N T IY0", "ninety": "N AY1 N T IY0",
    "five": "F AY1 V", "nine": "N AY1 N", "six": "S IH1 K S",
    "seven": "S EH1 V AH0 N", "ten": "T EH1 N",
    "dollars": "D AA1 L ER0 Z", "dollar": "D AA1 L ER0",
    "pounds": "P AW1 N D Z", "pound": "P AW1 N D",
    "brown": "B R AW1 N", "crown": "K R AW1 N", "crowd": "K R AW1 D",
    "beautiful": "B Y UW1 T AH0 F AH0 L", "beauty": "B Y UW1 T IY0",
    "generate": "JH EH1 N ER0 EY2 T", "general": "JH EH1 N ER0 AH0 L",
    "english": "IH1 NG G L IH0 SH", "language": "L AE1 NG G W AH0 JH",
    "voice": "V OY1 S", "speech": "S P IY1 CH",
}

# Frequency-ranked expansion (round 5): the next tier of common English —
# words whose spellings are irregular enough that the rule engine audibly
# misses them, ordered roughly by corpus frequency. ARPAbet follows CMUdict
# conventions (primary variant only).
LEXICON.update({
    "people": "P IY1 P AH0 L", "water": "W AO1 T ER0",
    "little": "L IH1 T AH0 L", "world": "W ER1 L D",
    "school": "S K UW1 L", "still": "S T IH1 L",
    "every": "EH1 V ER0 IY0", "great": "G R EY1 T",
    "should": "SH UH1 D", "country": "K AH1 N T R IY0",
    "something": "S AH1 M TH IH0 NG", "thought": "TH AO1 T",
    "together": "T AH0 G EH1 DH ER0", "children": "CH IH1 L D R AH0 N",
    "example": "IH0 G Z AE1 M P AH0 L", "paper": "P EY1 P ER0",
    "music": "M Y UW1 Z IH0 K", "question": "K W EH1 S CH AH0 N",
    "enough": "IH0 N AH1 F", "almost": "AO1 L M OW2 S T",
    "above": "AH0 B AH1 V", "sometimes": "S AH1 M T AY2 M Z",
    "mountain": "M AW1 N T AH0 N", "young": "Y AH1 NG",
    "family": "F AE1 M AH0 L IY0", "usually": "Y UW1 ZH AH0 W AH0 L IY0",
    "really": "R IH1 L IY0", "morning": "M AO1 R N IH0 NG",
    "island": "AY1 L AH0 N D", "idea": "AY0 D IY1 AH0",
    "body": "B AA1 D IY0", "money": "M AH1 N IY0",
    "business": "B IH1 Z N AH0 S", "important": "IH0 M P AO1 R T AH0 N T",
    "once": "W AH1 N S", "friend": "F R EH1 N D",
    "woman": "W UH1 M AH0 N", "women": "W IH1 M AH0 N",
    "machine": "M AH0 SH IY1 N", "special": "S P EH1 SH AH0 L",
    "heavy": "HH EH1 V IY0", "ocean": "OW1 SH AH0 N",
    "measure": "M EH1 ZH ER0", "pleasure": "P L EH1 ZH ER0",
    "treasure": "T R EH1 ZH ER0", "building": "B IH1 L D IH0 NG",
    "minute": "M IH1 N AH0 T", "minutes": "M IH1 N AH0 T S",
    "color": "K AH1 L ER0", "colour": "K AH1 L ER0",
    "early": "ER1 L IY0", "easy": "IY1 Z IY0",
    "hour": "AW1 ER0", "hours": "AW1 ER0 Z",
    "iron": "AY1 ER0 N", "answer": "AE1 N S ER0",
    "often": "AO1 F AH0 N", "listen": "L IH1 S AH0 N",
    "whole": "HH OW1 L", "heart": "HH AA1 R T",
    "half": "HH AE1 F", "talk": "T AO1 K", "walk": "W AO1 K",
    "watch": "W AA1 CH", "father": "F AA1 DH ER0",
    "mother": "M AH1 DH ER0", "brother": "B R AH1 DH ER0",
    "daughter": "D AO1 T ER0", "cousin": "K AH1 Z AH0 N",
    "earth": "ER1 TH", "learn": "L ER1 N", "heard": "HH ER1 D",
    "height": "HH AY1 T", "weight": "W EY1 T",
    "eight": "EY1 T", "eighty": "EY1 T IY0",
    "busy": "B IH1 Z IY0", "sugar": "SH UH1 G ER0",
    "sure": "SH UH1 R", "truth": "T R UW1 TH",
    "beautifully": "B Y UW1 T AH0 F L IY0", "ready": "R EH1 D IY0",
    "among": "AH0 M AH1 NG", "front": "F R AH1 N T",
    "month": "M AH1 N TH", "months": "M AH1 N TH S",
    "touch": "T AH1 CH", "blood": "B L AH1 D", "flood": "F L AH1 D",
    "door": "D AO1 R", "floor": "F L AO1 R", "poor": "P UH1 R",
    "break": "B R EY1 K", "steak": "S T EY1 K",
    "heavyweight": "HH EH1 V IY0 W EY2 T",
    "eye": "AY1", "eyes": "AY1 Z", "dead": "D EH1 D",
    "death": "D EH1 TH", "bread": "B R EH1 D", "breath": "B R EH1 TH",
    "breathe": "B R IY1 DH", "weather": "W EH1 DH ER0",
    "whether": "W EH1 DH ER0", "neither": "N IY1 DH ER0",
    "either": "IY1 DH ER0", "straight": "S T R EY1 T",
    "built": "B IH1 L T", "guess": "G EH1 S", "guest": "G EH1 S T",
    "guide": "G AY1 D", "guard": "G AA1 R D",
    "quiet": "K W AY1 AH0 T", "quite": "K W AY1 T",
    "science": "S AY1 AH0 N S", "scene": "S IY1 N",
    "scissors": "S IH1 Z ER0 Z", "muscle": "M AH1 S AH0 L",
    "castle": "K AE1 S AH0 L", "whistle": "W IH1 S AH0 L",
    "christmas": "K R IH1 S M AH0 S", "chorus": "K AO1 R AH0 S",
    "chemistry": "K EH1 M AH0 S T R IY0", "character": "K EH1 R IH0 K T ER0",
    "stomach": "S T AH1 M AH0 K", "echo": "EH1 K OW0",
    "orchestra": "AO1 R K AH0 S T R AH0", "ache": "EY1 K",
    "anchor": "AE1 NG K ER0", "tongue": "T AH1 NG", "fatigue": "F AH0 T IY1 G",
    "antique": "AE0 N T IY1 K", "unique": "Y UW0 N IY1 K",
    "giant": "JH AY1 AH0 N T", "ginger": "JH IH1 N JH ER0",
    "danger": "D EY1 N JH ER0", "dangerous": "D EY1 N JH ER0 AH0 S",
    "angel": "EY1 N JH AH0 L", "angle": "AE1 NG G AH0 L",
    "engine": "EH1 N JH AH0 N", "energy": "EH1 N ER0 JH IY0",
    "magic": "M AE1 JH IH0 K", "region": "R IY1 JH AH0 N",
    "religion": "R IH0 L IH1 JH AH0 N", "soldier": "S OW1 L JH ER0",
    "laugh": "L AE1 F", "laughter": "L AE1 F T ER0",
    "cough": "K AO1 F", "rough": "R AH1 F", "tough": "T AH1 F",
    "though": "DH OW1", "although": "AO0 L DH OW1",
    "thorough": "TH ER1 OW0", "brought": "B R AO1 T",
    "bought": "B AO1 T", "caught": "K AO1 T", "taught": "T AO1 T",
    "fought": "F AO1 T", "sought": "S AO1 T", "naughty": "N AO1 T IY0",
    "neighbor": "N EY1 B ER0", "neighbour": "N EY1 B ER0",
    "weigh": "W EY1", "sleigh": "S L EY1",
    "comb": "K OW1 M", "climb": "K L AY1 M", "thumb": "TH AH1 M",
    "crumb": "K R AH1 M", "debt": "D EH1 T", "doubt": "D AW1 T",
    "subtle": "S AH1 T AH0 L", "honest": "AA1 N AH0 S T",
    "honor": "AA1 N ER0", "honour": "AA1 N ER0", "ghost": "G OW1 S T",
    "receipt": "R IH0 S IY1 T", "psalm": "S AA1 M",
    "calm": "K AA1 M", "palm": "P AA1 M",
    "photo": "F OW1 T OW0", "photograph": "F OW1 T AH0 G R AE2 F",
    "telephone": "T EH1 L AH0 F OW2 N", "television": "T EH1 L AH0 V IH2 ZH AH0 N",
    "computer": "K AH0 M P Y UW1 T ER0", "company": "K AH1 M P AH0 N IY0",
    "complete": "K AH0 M P L IY1 T", "common": "K AA1 M AH0 N",
    "problem": "P R AA1 B L AH0 M", "possible": "P AA1 S AH0 B AH0 L",
    "probably": "P R AA1 B AH0 B L IY0", "promise": "P R AA1 M AH0 S",
    "police": "P AH0 L IY1 S", "nature": "N EY1 CH ER0", "natural": "N AE1 CH ER0 AH0 L",
    "picture": "P IH1 K CH ER0", "future": "F Y UW1 CH ER0",
    "culture": "K AH1 L CH ER0", "capture": "K AE1 P CH ER0",
    "century": "S EH1 N CH ER0 IY0", "cycle": "S AY1 K AH0 L", "bicycle": "B AY1 S IH0 K AH0 L",
    "recycle": "R IY0 S AY1 K AH0 L", "oxygen": "AA1 K S AH0 JH AH0 N",
    "dog": "D AO1 G", "dogs": "D AO1 G Z", "cat": "K AE1 T",
    "horse": "HH AO1 R S", "bird": "B ER1 D", "bear": "B EH1 R",
    "wolf": "W UH1 L F", "lion": "L AY1 AH0 N",
    "tiger": "T AY1 G ER0", "mouse": "M AW1 S", "snake": "S N EY1 K",
    "box": "B AA1 K S", "boxes": "B AA1 K S IH0 Z",
    "orange": "AO1 R AH0 N JH", "purple": "P ER1 P AH0 L",
    "circle": "S ER1 K AH0 L", "square": "S K W EH1 R",
    "triangle": "T R AY1 AE2 NG G AH0 L", "middle": "M IH1 D AH0 L",
    "table": "T EY1 B AH0 L",
    "apple": "AE1 P AH0 L", "bottle": "B AA1 T AH0 L",
    "double": "D AH1 B AH0 L", "trouble": "T R AH1 B AH0 L",
    "couple": "K AH1 P AH0 L", "single": "S IH1 NG G AH0 L",
    "simple": "S IH1 M P AH0 L", "certain": "S ER1 T AH0 N", "certainly": "S ER1 T AH0 N L IY0",
    "curtain": "K ER1 T AH0 N", "captain": "K AE1 P T AH0 N",
    "britain": "B R IH1 T AH0 N", "australia": "AO0 S T R EY1 L Y AH0", "america": "AH0 M EH1 R AH0 K AH0",
    "europe": "Y UH1 R AH0 P", "africa": "AE1 F R IH0 K AH0",
    "india": "IH1 N D IY0 AH0", "china": "CH AY1 N AH0",
    "japan": "JH AH0 P AE1 N", "france": "F R AE1 N S",
    "london": "L AH1 N D AH0 N", "january": "JH AE1 N Y UW0 EH2 R IY0",
    "february": "F EH1 B Y AH0 W EH2 R IY0", "march": "M AA1 R CH",
    "april": "EY1 P R AH0 L", "june": "JH UW1 N",
    "july": "JH UW0 L AY1", "august": "AO1 G AH0 S T",
    "september": "S EH0 P T EH1 M B ER0", "october": "AA0 K T OW1 B ER0",
    "november": "N OW0 V EH1 M B ER0", "december": "D IH0 S EH1 M B ER0",
    "monday": "M AH1 N D EY2", "tuesday": "T UW1 Z D EY2",
    "wednesday": "W EH1 N Z D EY2", "thursday": "TH ER1 Z D EY2",
    "friday": "F R AY1 D EY2", "saturday": "S AE1 T ER0 D EY2",
    "sunday": "S AH1 N D EY2", "yesterday": "Y EH1 S T ER0 D EY2",
    "tomorrow": "T AH0 M AA1 R OW2", "tonight": "T AH0 N AY1 T",
    "evening": "IY1 V N IH0 NG", "afternoon": "AE2 F T ER0 N UW1 N",
    "breakfast": "B R EH1 K F AH0 S T", "dinner": "D IH1 N ER0",
    "kitchen": "K IH1 CH AH0 N", "garden": "G AA1 R D AH0 N",
    "window": "W IH1 N D OW0", "yellow": "Y EH1 L OW0",
    "shadow": "SH AE1 D OW0", "follow": "F AA1 L OW0",
    "swallow": "S W AA1 L OW0", "narrow": "N EH1 R OW0",
    "arrow": "EH1 R OW0", "borrow": "B AA1 R OW0",
    "pillow": "P IH1 L OW0", "elbow": "EH1 L B OW2",
    "hollow": "HH AA1 L OW0", "fellow": "F EH1 L OW0",
    "used": "Y UW1 Z D", "using": "Y UW1 Z IH0 NG",
    "useful": "Y UW1 S F AH0 L", "useless": "Y UW1 S L AH0 S",
    "usual": "Y UW1 ZH AH0 W AH0 L", "casual": "K AE1 ZH AH0 W AH0 L",
    "visual": "V IH1 ZH AH0 W AH0 L", "issue": "IH1 SH UW0",
    "tissue": "T IH1 SH UW0", "pressure": "P R EH1 SH ER0",
    "vision": "V IH1 ZH AH0 N", "decision": "D IH0 S IH1 ZH AH0 N",
    "division": "D IH0 V IH1 ZH AH0 N", "occasion": "AH0 K EY1 ZH AH0 N",
    "version": "V ER1 ZH AH0 N", "student": "S T UW1 D AH0 N T", "students": "S T UW1 D AH0 N T S",
    "studio": "S T UW1 D IY0 OW2", "study": "S T AH1 D IY0",
    "super": "S UW1 P ER0", "supper": "S AH1 P ER0",
    "summer": "S AH1 M ER0", "winter": "W IH1 N T ER0",
    "autumn": "AO1 T AH0 M", "spring": "S P R IH1 NG",
    "season": "S IY1 Z AH0 N", "reason": "R IY1 Z AH0 N",
    "person": "P ER1 S AH0 N", "parent": "P EH1 R AH0 N T",
    "parents": "P EH1 R AH0 N T S", "moment": "M OW1 M AH0 N T",
    "movement": "M UW1 V M AH0 N T", "government": "G AH1 V ER0 N M AH0 N T",
    "different": "D IH1 F ER0 AH0 N T", "difference": "D IH1 F ER0 AH0 N S",
    "sentence": "S EH1 N T AH0 N S", "silence": "S AY1 L AH0 N S",
    "distance": "D IH1 S T AH0 N S",
    "instance": "IH1 N S T AH0 N S", "second": "S EH1 K AH0 N D",
    "seconds": "S EH1 K AH0 N D Z", "record": "R EH1 K ER0 D",
    "modern": "M AA1 D ER0 N", "model": "M AA1 D AH0 L",
    "level": "L EH1 V AH0 L", "travel": "T R AE1 V AH0 L",
    "eleven": "IH0 L EH1 V AH0 N",
    "twelve": "T W EH1 L V", "thousand": "TH AW1 Z AH0 N D",
    "million": "M IH1 L Y AH0 N", "billion": "B IH1 L Y AH0 N",
    "onion": "AH1 N Y AH0 N", "union": "Y UW1 N Y AH0 N",
    "opinion": "AH0 P IH1 N Y AH0 N", "companion": "K AH0 M P AE1 N Y AH0 N",
    "behavior": "B IH0 HH EY1 V Y ER0", "familiar": "F AH0 M IH1 L Y ER0",
    "area": "EH1 R IY0 AH0", "camera": "K AE1 M ER0 AH0",
    "extra": "EH1 K S T R AH0", "sofa": "S OW1 F AH0",
    "zebra": "Z IY1 B R AH0", "pizza": "P IY1 T S AH0",
    "banana": "B AH0 N AE1 N AH0", "umbrella": "AH0 M B R EH1 L AH0",
    "across": "AH0 K R AO1 S", "against": "AH0 G EH1 N S T",
    "ahead": "AH0 HH EH1 D", "alone": "AH0 L OW1 N",
    "along": "AH0 L AO1 NG", "already": "AO0 L R EH1 D IY0",
    "always": "AO1 L W EY2 Z",
    "become": "B IH0 K AH1 M", "because": "B IH0 K AO1 Z",
    "before": "B IH0 F AO1 R", "begin": "B IH0 G IH1 N",
    "behind": "B IH0 HH AY1 N D", "believe": "B IH0 L IY1 V",
    "below": "B IH0 L OW1", "beside": "B IH0 S AY1 D",
    "between": "B IH0 T W IY1 N", "beyond": "B IH0 Y AA1 N D",
    "toward": "T AH0 W AO1 R D", "receive": "R IH0 S IY1 V", "ceiling": "S IY1 L IH0 NG",
    "field": "F IY1 L D", "piece": "P IY1 S", "niece": "N IY1 S",
    "chief": "CH IY1 F", "brief": "B R IY1 F", "thief": "TH IY1 F",
    "view": "V Y UW1",
    "juice": "JH UW1 S", "fruit": "F R UW1 T", "suit": "S UW1 T",
    "build": "B IH1 L D", "biscuit": "B IH1 S K AH0 T",
    "circuit": "S ER1 K AH0 T",
    # audited additions (rule engine measurably wrong on these; round 5)
    "prove": "P R UW1 V", "none": "N AH1 N", "search": "S ER1 CH",
    "womb": "W UW1 M", "tomb": "T UW1 M", "calf": "K AE1 F",
    "aisle": "AY1 L", "bury": "B EH1 R IY0", "shoes": "SH UW1 Z",
    "shoe": "SH UW1", "lose": "L UW1 Z", "leather": "L EH1 DH ER0",
    "chemist": "K EH1 M IH0 S T",
    "chaos": "K EY1 AA0 S", "soften": "S AO1 F AH0 N",
    "sword": "S AO1 R D", "leopard": "L EH1 P ER0 D",
    "jeopardy": "JH EH1 P ER0 D IY0",
    "vegetable": "V EH1 JH T AH0 B AH0 L",
    "restaurant": "R EH1 S T ER0 AA2 N T",
    "chocolate": "CH AO1 K L AH0 T",
    "interesting": "IH1 N T R AH0 S T IH0 NG",
    "interest": "IH1 N T R AH0 S T",
    "comfortable": "K AH1 M F ER0 T AH0 B AH0 L",
    "comfort": "K AH1 M F ER0 T", "cushion": "K UH1 SH AH0 N",
    "fashion": "F AE1 SH AH0 N", "delicious": "D IH0 L IH1 SH AH0 S",
    "anxious": "AE1 NG K SH AH0 S", "anxiety": "AE0 NG Z AY1 AH0 T IY0",
    "luxury": "L AH1 G ZH ER0 IY0", "exist": "IH0 G Z IH1 S T",
    "exact": "IH0 G Z AE1 K T", "exactly": "IH0 G Z AE1 K T L IY0",
    "examine": "IH0 G Z AE1 M AH0 N", "exam": "IH0 G Z AE1 M",
    "taxi": "T AE1 K S IY0", "basket": "B AE1 S K AH0 T",
    "foreign": "F AO1 R AH0 N", "campaign": "K AE0 M P EY1 N",
    "champagne": "SH AE0 M P EY1 N", "cologne": "K AH0 L OW1 N",
    "nephew": "N EH1 F Y UW0", "meant": "M EH1 N T",
    "lost": "L AO1 S T", "cost": "K AO1 S T", "drove": "D R OW1 V",
    "stove": "S T OW1 V", "southern": "S AH1 DH ER0 N",
    "guitar": "G IH0 T AA1 R", "magazine": "M AE1 G AH0 Z IY2 N",
    "technique": "T EH0 K N IY1 K", "vehicle": "V IY1 IH0 K AH0 L",
    "recipe": "R EH1 S AH0 P IY0", "cafe": "K AH0 F EY1",
    "ballet": "B AE0 L EY1", "bouquet": "B OW0 K EY1",
    "debris": "D AH0 B R IY1", "corps": "K AO1 R",
    "chassis": "CH AE1 S IY0", "genre": "ZH AA1 N R AH0",
    "entrepreneur": "AA2 N T R AH0 P R AH0 N ER1",
    "amateur": "AE1 M AH0 CH ER2", "reward": "R IH0 W AO1 R D",
    "bureau": "B Y UH1 R OW0", "plateau": "P L AE0 T OW1",
    "ancient": "EY1 N SH AH0 N T",
})

# ---------------------------------------------------------------------------
# NRL-style letter-to-sound rules
# ---------------------------------------------------------------------------
# Each rule: (left_context, letters, right_context, arpabet_string).
# Context pattern language (Elovitz et al. 1976):
#   '#'  one or more vowels          '^' exactly one consonant
#   ':'  zero or more consonants     '.' one voiced consonant (bdvgjlmnrwz)
#   '+'  one front vowel (e i y)     '%' suffix e|es|ed|er|ing|ely
#   ' '  word boundary; letters match themselves.
# First matching rule wins; rules are grouped by the first letter of `letters`.

# NRL treats y as a vowel in context classes ('#'); without it, final-e
# silencing after y-nucleus syllables (st[y]le, c[y]cle) never fires
_VOWELS = "aeiouy"
_FRONT = "eiy"
_VOICED = "bdvgjlmnrwz"
_CONS = "bcdfghjklmnpqrstvwxz"

RULES: Dict[str, List[Tuple[str, str, str, str]]] = {}


def _add(rules_text: str) -> None:
    for line in rules_text.splitlines():
        line = line.rstrip()  # leading spaces are word-boundary anchors!
        if not line or line.lstrip().startswith("//"):
            continue
        # format: L[match]R=phones   (keithito/NRL notation)
        m = re.match(r"^(.*)\[(.+)\](.*)=(.*)$", line)
        assert m, line
        left, mid, right, ph = m.groups()
        RULES.setdefault(mid[0], []).append((left, mid, right, ph.strip()))


_add("""
 [a] =AH0
 [are] =AA1 R
 [ar]o=AH0 R
[ar]#=EH1 R
 ^[as]#=EY1 S
[a]wa=AH0
[aw]=AO1
 :[any]=EH1 N IY0
[a]^+#=EY1
#:[ally]=AH0 L IY0
 [al]#=AH0 L
[again]=AH0 G EH1 N
#:[ag]e=IH0 JH
[a]^+:#=AE1
 :[a]^+ =EY1
[a]^%=EY1
 [arr]=AH0 R
[arr]=AE1 R
 :[ar] =AA1 R
[ar] =ER0
[ar]=AA1 R
[air]=EH1 R
[ai]=EY1
[ay]=EY1
[au]=AO1
#:[al] =AH0 L
#:[als] =AH0 L Z
[ague] =EY1 G
[acle] =AH0 K AH0 L
[alk]=AO1 K
[al]^=AO1 L
 :[able]=EY1 B AH0 L
[able]=AH0 B AH0 L
[ang]+=EY1 N JH
[ation]=EY1 SH AH0 N
[a]=AE1
""")

_add("""
 [be]^#=B IH0
[being]=B IY1 IH0 NG
 [both] =B OW1 TH
 [bus]#=B IH1 Z
[buil]=B IH1 L
[bb]=B
[b]=B
""")

_add("""
 [ch]^=K
^e[ch]=K
[ch]=CH
 s[ci]#=S AY1
[ci]a=SH
[ci]o=SH
[ci]en=SH
[c]+=S
[ck]=K
[com]%=K AH1 M
[cc]+=K S
[cc]=K
[c]=K
""")

_add("""
#:[ded] =D IH0 D
.e[d] =D
#:^e[d] =T
 [de]^#=D IH0
 [do] =D UW1
 [does]=D AH1 Z
 [doing]=D UW1 IH0 NG
 [dow]=D AW1
[du]a=JH UW0
[dge]=JH
[dd]=D
[d]=D
""")

_add("""
#:[e] =
':^[e] =
 :[e] =IY1
#[ed] =D
#:[e]d =
[ev]er=EH1 V
#:^[en] =AH0 N
#:[ent] =AH0 N T
#:^[el] =AH0 L
[e]^%=IY1
[eri]#=IY1 R IY0
[eri]=EH1 R IH0
#:[er]#=ER0
[er]#=EH1 R
[er]=ER0
 [even]=IY1 V EH0 N
#:[e]w=
@[ew]=UW1
[ew]=Y UW1
[e]o=IY1
#:&[es] =IH0 Z
#:[e]s =
#:[ely] =L IY0
#:[ement]=M AH0 N T
[eful]=F UH0 L
[ee]=IY1
[earn]=ER1 N
 [ear]^=ER1
[eau]=OW1
[ead]=EH1 D
#:[ea] =IY0 AH0
[ea]su=EH1
[ea]=IY1
[eigh]=EY1
[ei]=IY1
 [eye]=AY1
[ey]=IY0
@[eu]=UW1
[eu]=Y UW1
[e]=EH1
""")

_add("""
[ful]=F UH0 L
[ff]=F
[f]=F
""")

_add("""
 [gn]=N
[giv]=G IH1 V
 [g]i^=G
[ge]t=G EH1
su[gges]=G JH EH1 S
[gg]=G
 b#[g]=G
[g]+=JH
[great]=G R EY1 T
#[gh]=
[gh]=G
[g]=G
""")

_add("""
 [hav]=HH AE1 V
 [here]=HH IY1 R
 [hour]=AW1 ER0
[how]=HH AW1
[h]#=HH
[h]=
""")

_add("""
 [in]=IH0 N
 [i] =AY1
[ies] =AY1 Z
 :[ind] =AY1 N D
[icle] =IH0 K AH0 L
[ier]=IY0 ER0
#:r[ied] =IY0 D
[ied] =AY1 D
[ien]=IY0 EH0 N
[ie]t=AY1 EH0
 :[i]%=AY1
[i]%=IY0
[ie]=IY1
[i]^+:#=IH0
[ir]#=AY1 R
[iz]%=AY1 Z
[is]%=AY1 Z
[i]d%=AY1
+^[i]^+=IH0
[i]t%=AY1
#:^[i]^+=IH0
[i]^+=AY1
[ir]=ER0
[igh]=AY1
[ild]=AY1 L D
[ign] =AY1 N
[ign]^=AY1 N
[ign]%=AY1 N
[ique]=IY1 K
[i]=IH1
""")

_add("""
[j]=JH
""")

_add("""
 [k]n=
[k]=K
""")

_add("""
[lo]c#=L OW0
l[l]=
#:^[l]%=AH0 L
[lead]=L IY1 D
[l]=L
""")

_add("""
 [mn]=N
[mov]=M UW1 V
[mb] =M
[mm]=M
[m]=M
""")

_add("""
e[ng]+=N JH
[ng]r=NG G
[ng]#=NG G
[ngl]%=NG G AH0 L
[ng]=NG
[nk]=NG K
 [now] =N AW1
[nn]=N
[n]=N
""")

_add("""
[of] =AH0 V
[orough]=ER0 OW0
#:[or] =ER0
#:[ors] =ER0 Z
[or]=AO1 R
 [one]=W AH1 N
[ow]=OW1
 [over]=OW1 V ER0
[ov]=AH1 V
[o]^%=OW1
[o]^en=OW1
[o]^i#=OW1
[ol]d=OW1 L
[ought]=AO1 T
[ough]=AH1 F
 [ou]=AW1
h[ou]s#=AW1
[ous]=AH0 S
[our]=AO1 R
[ould]=UH1 D
^[ou]^l=AH1
[oup]=UW1 P
[ou]=AW1
[oy]=OY1
[oing]=OW1 IH0 NG
[oi]=OY1
[oor]=AO1 R
[ook]=UH1 K
[ood]=UH1 D
[oo]=UW1
[o]e=OW1
[o] =OW1
[oa]=OW1
 [only]=OW1 N L IY0
 [once]=W AH1 N S
[on't]=OW1 N T
c[o]n=AA1
[o]ng=AO1
 ^[o]n=AH0
i[on]=AH0 N
#:[on] =AH0 N
#^[on]=AH0 N
[o]st =OW1
[of]^=AO1 F
[other]=AH1 DH ER0
[oss] =AO1 S
#:^[om]=AH0 M
[o]=AA1
""")

_add("""
 [psych]=S AY2 K
 [ps]=S
 [pn]=N
[ph]=F
[peop]=P IY1 P
[pow]=P AW1
[put] =P UH1 T
[pp]=P
[p]=P
""")

_add("""
[quare]=K W EH1 R
[quar]=K W AO1 R
[qu]=K W
[q]=K
""")

_add("""
 [re]^#=R IH0
[rr]=R
[r]=R
""")

_add("""
[sh]=SH
#[sion]=ZH AH0 N
[some]=S AH1 M
#[sur]#=ZH ER0
[sur]#=SH ER0
#[su]#=ZH UW0
#[ssu]#=SH UW0
#[sed] =Z D
#[s]#=Z
[said]=S EH1 D
^[sion]=SH AH0 N
[s]s=
.[s] =Z
#:.e[s] =Z
#:^#[s] =S
u[s] =S
 :#[s] =Z
 [sch]=S K
[s]c+=
#[sm]=Z M
#[sn]'=Z AH0 N
[s]=S
""")

_add("""
 [the] =DH AH0
[to] =T UW1
[that] =DH AE1 T
 [this] =DH IH1 S
 [they]=DH EY1
 [there]=DH EH1 R
[ther]=DH ER0
[their]=DH EH1 R
 [than] =DH AE1 N
 [them] =DH EH1 M
[these] =DH IY1 Z
 [then]=DH EH1 N
[through]=TH R UW1
[those]=DH OW1 Z
[though] =DH OW1
 [thus]=DH AH1 S
[th]=TH
#:[ted] =T IH0 D
s[ti]#n=CH
[ti]o=SH
[ti]a=SH
[tien]=SH AH0 N
[tur]#=CH ER0
[tu]a=CH UW0
 [two]=T UW1
 [tele]=T EH1 L AH0
[tt]=T
[t]=T
""")

_add("""
 [un]i=Y UW1 N
 [un]=AH0 N
 [upon]=AH0 P AO1 N
@[ur]#=UH1 R
[ur]#=Y UH1 R
[ur]=ER0
[u]^ =AH1
[u]^^=AH1
[uy]=AY1
 g[u]#=
g[u]%=
g[u]#=W
#n[u]=Y UW0
@[u]=UW1
[u]=Y UW1
""")

_add("""
[view]=V Y UW1
[v]=V
""")

_add("""
#:[ward] =W ER0 D
 [were]=W ER1
[wa]s=W AA1
[wa]t=W AA1
[where]=W EH1 R
[what]=W AH1 T
[whol]=HH OW1 L
[who]=HH UW1
[wh]=W
[war]=W AO1 R
[wor]^=W ER1
[wr]=R
[w]=W
""")

_add("""
 [x]=Z
[x]=K S
""")

_add("""
[young]=Y AH1 NG
 [you]=Y UW1
 [yes]=Y EH1 S
 [y]=Y
#:^[y] =IY0
#:^[y]i=IY0
 :[y] =AY1
 :[y]#=AY1
 :[y]^+:#=IH0
 :[y]^#=AY1
[y]=IH0
""")

_add("""
[zz]=Z
[z]=Z
""")


def _match_left(ctx: str, word: str, pos: int) -> bool:
    """Match ctx against word[:pos], anchored at pos, right-to-left."""
    i = pos
    for c in reversed(ctx):
        if c == "#":
            if i <= 0 or word[i - 1] not in _VOWELS:
                return False
            i -= 1
            while i > 0 and word[i - 1] in _VOWELS:
                i -= 1
        elif c == ":":
            while i > 0 and word[i - 1] in _CONS:
                i -= 1
        elif c == "^":
            if i <= 0 or word[i - 1] not in _CONS:
                return False
            i -= 1
        elif c == ".":
            if i <= 0 or word[i - 1] not in _VOICED:
                return False
            i -= 1
        elif c == "+":
            if i <= 0 or word[i - 1] not in _FRONT:
                return False
            i -= 1
        elif c == "@":
            # non-palatalizing consonant before u (d t s n l th ch sh z j)
            if i <= 0 or word[i - 1] not in "dtsrnlzj":
                return False
            i -= 1
        elif c == " ":
            if i != 0:
                return False
        elif c == "&":
            if i <= 0 or word[i - 1] not in "cgjsxz":
                return False
            i -= 1
        elif c == "'":
            if i <= 0 or word[i - 1] != "'":
                return False
            i -= 1
        else:
            if i <= 0 or word[i - 1] != c:
                return False
            i -= 1
    return True


def _match_right(ctx: str, word: str, pos: int) -> bool:
    """Match ctx against word[pos:], anchored at pos, left-to-right."""
    i, n = pos, len(word)
    for k, c in enumerate(ctx):
        if c == "#":
            if i >= n or word[i] not in _VOWELS:
                return False
            i += 1
            while i < n and word[i] in _VOWELS:
                i += 1
        elif c == ":":
            while i < n and word[i] in _CONS:
                i += 1
        elif c == "^":
            if i >= n or word[i] not in _CONS:
                return False
            i += 1
        elif c == ".":
            if i >= n or word[i] not in _VOICED:
                return False
            i += 1
        elif c == "+":
            if i >= n or word[i] not in _FRONT:
                return False
            i += 1
        elif c == "%":
            rest = word[i:]
            # suffix must reach the END of the word (a bare re.match let
            # "e" fire mid-word, e.g. pi[e]ce / t[e]lephone -> wrong vowels)
            if not re.fullmatch(r"ing|ings|ely|e[rd]?|ers|es|est", rest):
                return False
            return True  # '%' is always terminal in our rules
        elif c == " ":
            if i != n:
                return False
        elif c == "'":
            if i >= n or word[i] != "'":
                return False
            i += 1
        else:
            if i >= n or word[i] != c:
                return False
            i += 1
    return True


def letters_to_arpabet(word: str) -> List[str]:
    """Rule-based ARPAbet for one lowercase word."""
    out: List[str] = []
    pos = 0
    n = len(word)
    while pos < n:
        ch = word[pos]
        matched = False
        for left, mid, right, ph in RULES.get(ch, ()):  # first match wins
            if word.startswith(mid, pos) and _match_left(left, word, pos) \
                    and _match_right(right, word, pos + len(mid)):
                if ph:
                    out.extend(ph.split())
                pos += len(mid)
                matched = True
                break
        if not matched:
            pos += 1  # silent character (apostrophes, stray symbols)
    return out


def _one_primary_stress(phones: List[str]) -> List[str]:
    """Normalize rule-engine stress to English-like word stress.

    The NRL rules mark every heavy vowel with primary stress; real words
    carry exactly one primary. Keep the FIRST primary (English strongly
    prefers early stress), demote later primaries to unstressed in common
    unstressed codas (-ing, -ow, -er, -ic style endings) or secondary
    elsewhere, and promote the first vowel when the rules produced no
    primary at all (e.g. monosyllables whose vowel rule was unstressed)."""
    out = list(phones)
    vid = [i for i, p in enumerate(out) if p and p[-1].isdigit()]
    if not vid:
        return out
    prim = [i for i in vid if out[i].endswith("1")]
    if not prim:
        i = vid[0]
        out[i] = out[i][:-1] + "1"
        return out
    unstressed_codas = {"NG", "Z", "S", "D", "K"}
    for i in prim[1:]:
        is_last_vowel = i == vid[-1]
        coda = [p.rstrip("012") for p in out[i + 1:]]
        if is_last_vowel and all(c in unstressed_codas for c in coda):
            out[i] = out[i][:-1] + "0"
        elif len(vid) <= 2:
            # disyllables almost never carry secondary stress in English —
            # the non-primary syllable is simply unstressed (basket, master)
            out[i] = out[i][:-1] + "0"
        else:
            out[i] = out[i][:-1] + "2"
    return out


def _rule_phones(word: str) -> List[str]:
    return _one_primary_stress(letters_to_arpabet(word))


def _stem_phones(stem: str, allow_rules: bool) -> Optional[List[str]]:
    """Phones for a morphological stem: lexicon first; optionally the rule
    engine when the stem is word-shaped (>=3 letters with a vowel nucleus)."""
    if stem in LEXICON:
        return LEXICON[stem].split()
    if allow_rules and len(stem) >= 3 and any(c in "aeiouy" for c in stem):
        return _rule_phones(stem)
    return None


def word_to_arpabet(word: str) -> List[str]:
    if word in LEXICON:
        return LEXICON[word].split()
    # morphology: inflectional suffixes layered on a resolvable stem —
    # running->run+ing (de-doubling), makes->make+s (e-restore),
    # carried->carry+ed (i->y), boxes->box+es. A rule-derived stem is far
    # more reliable than running the rules over the inflected surface
    # (suffix vowels otherwise grab stress and break silent-e contexts).
    res = _morph_phones(word)
    if res is not None:
        return res
    return _rule_phones(word)


def _morph_phones(word: str) -> Optional[List[str]]:
    for suffix, tail_fn, allow_rules, guard in _MORPH:
        if not word.endswith(suffix) or len(word) - len(suffix) < 2:
            continue
        if guard is not None and not guard(word):
            continue
        base = word[: -len(suffix)]
        if suffix in ("ies", "ied"):
            cands = [base + "y"]              # cities -> city, carried -> carry
            for allow in (False, True) if allow_rules else (False,):
                ph = _stem_phones(cands[0], allow)
                if ph:
                    return ph + tail_fn(ph)
            continue
        cands = [base]
        if len(base) >= 3 and base[-1] == base[-2] and base[-1] in _CONS:
            cands.append(base[:-1])           # running -> run
        if not base.endswith("e") and any(c in "aeiouy" for c in base[:-1]):
            # silent-e restore (used -> use, makes -> make) — only when the
            # base already has a vowel nucleus; otherwise this invents fake
            # stems for vowel-less bases (bring -/-> br+e='bre')
            cands.append(base + "e")
        if base.endswith("i"):
            cands.append(base[:-1] + "y")     # carried -> carry
        # lexicon stems first (any candidate), then rule-derived stems
        for allow in (False, True) if allow_rules else (False,):
            for stem in cands:
                ph = _stem_phones(stem, allow)
                if ph:
                    return ph + tail_fn(ph)
    return None


def _plural_tail(stem: List[str]) -> List[str]:
    last = stem[-1]
    base = last.rstrip("012")
    if base in ("S", "Z", "SH", "ZH", "CH", "JH"):
        return ["IH0", "Z"]
    if base in ("P", "T", "K", "F", "TH"):
        return ["S"]
    return ["Z"]


def _past_tail(stem: List[str]) -> List[str]:
    last = stem[-1].rstrip("012")
    if last in ("T", "D"):
        return ["IH0", "D"]
    if last in ("P", "K", "F", "S", "SH", "CH", "TH"):
        return ["T"]
    return ["D"]


def _sibilant_es(word: str) -> bool:
    return bool(re.search(r"(s|z|x|ch|sh)es$", word))


def _plain_s(word: str) -> bool:
    # not a plural/3sg marker after these endings (glass, bus, this);
    # 'es' words reach here too (machines, goes) — the sibilant -es cases
    # (boxes, glasses) were already taken by the _sibilant_es entry above
    return not word.endswith(("ss", "us", "is"))


# (suffix, tail from stem phones, allow rule-derived stems, guard(word))
_MORPH: List[Tuple[str, object, bool, object]] = [
    ("ings", lambda stem: ["IH0", "NG", "Z"], True, None),
    ("ing", lambda stem: ["IH0", "NG"], True, None),
    ("ies", lambda stem: ["Z"], True, None),
    ("ied", lambda stem: ["D"], True, None),
    ("ed", _past_tail, True, None),
    ("es", lambda stem: ["IH0", "Z"], True, _sibilant_es),
    ("ly", lambda stem: ["L", "IY0"], False, None),
    ("ness", lambda stem: ["N", "AH0", "S"], False, None),
    ("ment", lambda stem: ["M", "AH0", "N", "T"], False, None),
    ("ful", lambda stem: ["F", "AH0", "L"], False, None),
    ("less", lambda stem: ["L", "AH0", "S"], False, None),
    ("s", _plural_tail, True, _plain_s),
]

# ---------------------------------------------------------------------------
# ARPAbet -> espeak-flavoured IPA (restricted to text/symbols.py inventory)
# ---------------------------------------------------------------------------

ARPA_TO_IPA = {
    "AA": "ɑː", "AE": "æ", "AH": "ʌ", "AO": "ɔː", "AW": "aʊ", "AY": "aɪ",
    "EH": "ɛ", "ER": "ɜː", "EY": "eɪ", "IH": "ɪ", "IY": "iː", "OW": "oʊ",
    "OY": "ɔɪ", "UH": "ʊ", "UW": "uː",
    "B": "b", "CH": "tʃ", "D": "d", "DH": "ð", "F": "f", "G": "ɡ",
    "HH": "h", "JH": "dʒ", "K": "k", "L": "l", "M": "m", "N": "n",
    "NG": "ŋ", "P": "p", "R": "ɹ", "S": "s", "SH": "ʃ", "T": "t",
    "TH": "θ", "V": "v", "W": "w", "Y": "j", "Z": "z", "ZH": "ʒ",
}
# unstressed variants (schwa-family reductions espeak also makes)
_UNSTRESSED_IPA = {"AH": "ə", "ER": "ɚ", "IY": "i", "IH": "ɪ", "UW": "u"}
# "u" is not in the model inventory; espeak uses ʊ-adjacent "uː" anyway
_UNSTRESSED_IPA["UW"] = "uː"


def arpabet_to_ipa(phones: List[str], with_stress: bool = True) -> str:
    out: List[str] = []
    seen_primary = False
    for p in phones:
        stress = ""
        base = p
        if p and p[-1].isdigit():
            base, d = p[:-1], p[-1]
            if d == "1":
                stress = "ˈ"
            elif d == "2":
                stress = "ˌ"
            if d == "0" and base in _UNSTRESSED_IPA:
                out.append(_UNSTRESSED_IPA[base])
                continue
        ipa = ARPA_TO_IPA.get(base)
        if ipa is None:
            continue
        if stress and with_stress:
            # one primary stress per word (the rules mark every heavy vowel;
            # espeak marks exactly one primary)
            if stress == "ˈ" and seen_primary:
                stress = ""
            elif stress == "ˈ":
                seen_primary = True
            if stress:
                out.append(stress)
        out.append(ipa)
    return "".join(out)


# ---------------------------------------------------------------------------
# public entry
# ---------------------------------------------------------------------------

_word_re = re.compile(r"[a-z']+|[^a-z'\s]")


def phonemize_en(
    text: str, preserve_punctuation: bool = True, with_stress: bool = True
) -> str:
    """English text -> IPA phoneme string (one space between words).

    Input should already be lowercase ASCII (the cleaner pipeline applies
    convert_to_ascii + lowercase + expand_abbreviations first, mirroring
    the kgoba reference's vits2/text/cleaners.py:100-114).
    """
    text = normalize_numbers(text)
    pieces: List[str] = []
    for token in text.split():
        word_out: List[str] = []
        for m in _word_re.finditer(token):
            t = m.group(0)
            if t[0].isalpha() or t[0] == "'":
                phones = word_to_arpabet(t.strip("'") or t)
                word_out.append(arpabet_to_ipa(phones, with_stress=with_stress))
            elif preserve_punctuation and t in ";:,.!?¡¿—…\"«»“”'-":
                word_out.append(t if t != "-" else " ")
        piece = "".join(word_out)
        if piece:
            pieces.append(piece)
    return " ".join(pieces)
