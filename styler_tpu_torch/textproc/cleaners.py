"""Text cleaners (reference text/cleaners.py semantics).

``english_cleaners`` pipeline: ASCII transliteration, lowercase, number
expansion, abbreviation expansion, whitespace collapse. The reference
uses the ``unidecode`` package for transliteration; here a compact
Latin-coverage fold is built in (NFKD + combining-mark strip + a small
special-case table), which covers the Latin-script inputs this pipeline
ever sees.
"""

from __future__ import annotations

import re
import unicodedata

from styler_tpu_torch.textproc.numbers import normalize_numbers

_whitespace_re = re.compile(r"\s+")

_abbreviations = [
    (re.compile(rf"\b{abbr}\.", re.IGNORECASE), full)
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

_ascii_special = {
    "æ": "ae", "Æ": "AE", "œ": "oe", "Œ": "OE", "ß": "ss",
    "ø": "o", "Ø": "O", "đ": "d", "Đ": "D", "þ": "th", "Þ": "Th",
    "ð": "dh", "Ð": "Dh", "ł": "l", "Ł": "L",
    "«": '"', "»": '"', "“": '"', "”": '"', "‘": "'", "’": "'",
    "–": "-", "—": "-", "…": "...",
}


def to_ascii(text: str) -> str:
    out = []
    for ch in text:
        if ord(ch) < 128:
            out.append(ch)
            continue
        if ch in _ascii_special:
            out.append(_ascii_special[ch])
            continue
        decomp = unicodedata.normalize("NFKD", ch)
        stripped = "".join(c for c in decomp if not unicodedata.combining(c))
        out.append(stripped if all(ord(c) < 128 for c in stripped) else "")
    return "".join(out)


def lowercase(text: str) -> str:
    return text.lower()


def expand_numbers(text: str) -> str:
    return normalize_numbers(text)


def expand_abbreviations(text: str) -> str:
    for pattern, replacement in _abbreviations:
        text = pattern.sub(replacement, text)
    return text


def collapse_whitespace(text: str) -> str:
    return _whitespace_re.sub(" ", text)


def basic_cleaners(text: str) -> str:
    return collapse_whitespace(lowercase(text))


def transliteration_cleaners(text: str) -> str:
    return collapse_whitespace(lowercase(to_ascii(text)))


def english_cleaners(text: str) -> str:
    """Full English pipeline (reference cleaners.py:82-89)."""
    text = to_ascii(text)
    text = lowercase(text)
    text = expand_numbers(text)
    text = expand_abbreviations(text)
    text = collapse_whitespace(text)
    return text


CLEANERS = {
    "basic_cleaners": basic_cleaners,
    "transliteration_cleaners": transliteration_cleaners,
    "english_cleaners": english_cleaners,
}
