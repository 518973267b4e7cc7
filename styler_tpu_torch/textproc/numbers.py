"""Number-to-words expansion for English text normalization.

Self-contained replacement for the reference's inflect-based expansion
(reference text/numbers.py). Covers the same cases: comma removal,
currency ($ amounts), decimals, ordinals, cardinals, and years.
"""

from __future__ import annotations

import re

_ONES = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_TENS = [
    "", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
    "eighty", "ninety",
]
_SCALES = ["", " thousand", " million", " billion", " trillion", " quadrillion"]

_ORDINAL_SPECIAL = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def _two_digits(n: int) -> str:
    if n < 20:
        return _ONES[n]
    tens, ones = divmod(n, 10)
    return _TENS[tens] + ("-" + _ONES[ones] if ones else "")


def _three_digits(n: int) -> str:
    hundreds, rest = divmod(n, 100)
    parts = []
    if hundreds:
        parts.append(_ONES[hundreds] + " hundred")
    if rest:
        parts.append(_two_digits(rest))
    return " ".join(parts)


def number_to_words(n: int) -> str:
    """Cardinal form of a non-negative integer ('and'-free inflect style)."""
    if n == 0:
        return "zero"
    groups = []
    i = 0
    while n > 0:
        n, g = divmod(n, 1000)
        if g:
            groups.append(_three_digits(g) + _SCALES[i])
        i += 1
    return ", ".join(reversed(groups)) if len(groups) > 2 else " ".join(reversed(groups))


def ordinal_to_words(n: int) -> str:
    words = number_to_words(n)
    head, _, last = words.rpartition(" ")
    if "-" in last:
        pre, _, tail = last.rpartition("-")
        last_ord = pre + "-" + _ordinal_word(tail)
    else:
        last_ord = _ordinal_word(last)
    return (head + " " + last_ord).strip()


def _ordinal_word(word: str) -> str:
    if word in _ORDINAL_SPECIAL:
        return _ORDINAL_SPECIAL[word]
    if word.endswith("y"):
        return word[:-1] + "ieth"
    if word.endswith("hundred") or word.endswith("thousand") or word.endswith(
        "llion"
    ):
        return word + "th"
    return word + "th"


def _year_to_words(n: int) -> str:
    """Year-style reading (reference numbers.py uses inflect group=2)."""
    if n < 1000 or n >= 3000:
        return number_to_words(n)
    if n % 100 == 0:
        if n % 1000 == 0:
            return number_to_words(n // 1000) + " thousand"
        return number_to_words(n // 100) + " hundred"
    hi, lo = divmod(n, 100)
    if lo < 10:
        return number_to_words(hi) + " oh " + number_to_words(lo)
    return number_to_words(hi) + " " + _two_digits(lo)


_comma_re = re.compile(r"([0-9][0-9,]+[0-9])")
_pounds_re = re.compile(r"£([0-9,]*[0-9]+)")
_dollars_re = re.compile(r"\$([0-9.,]*[0-9]+)")
_decimal_re = re.compile(r"([0-9]+\.[0-9]+)")
_ordinal_re = re.compile(r"([0-9]+)(st|nd|rd|th)")
_number_re = re.compile(r"[0-9]+")


def _expand_dollars(m: re.Match) -> str:
    value = m.group(1).replace(",", "")
    parts = value.split(".")
    if len(parts) > 2:
        return value + " dollars"
    dollars = int(parts[0]) if parts[0] else 0
    cents = int(parts[1][:2].ljust(2, "0")) if len(parts) > 1 and parts[1] else 0
    if dollars and cents:
        d_unit = "dollar" if dollars == 1 else "dollars"
        c_unit = "cent" if cents == 1 else "cents"
        return (
            f"{number_to_words(dollars)} {d_unit}, {number_to_words(cents)} {c_unit}"
        )
    if dollars:
        return f"{number_to_words(dollars)} {'dollar' if dollars == 1 else 'dollars'}"
    if cents:
        return f"{number_to_words(cents)} {'cent' if cents == 1 else 'cents'}"
    return "zero dollars"


def _expand_decimal(m: re.Match) -> str:
    whole, frac = m.group(1).split(".")
    digits = " ".join(_ONES[int(d)] for d in frac)
    return f"{number_to_words(int(whole))} point {digits}"


def _expand_number(m: re.Match) -> str:
    return _year_to_words(int(m.group(0)))


def normalize_numbers(text: str) -> str:
    text = _comma_re.sub(lambda m: m.group(1).replace(",", ""), text)
    text = _pounds_re.sub(r"\1 pounds", text)
    text = _dollars_re.sub(_expand_dollars, text)
    text = _decimal_re.sub(_expand_decimal, text)
    text = _ordinal_re.sub(lambda m: ordinal_to_words(int(m.group(1))), text)
    text = _number_re.sub(_expand_number, text)
    return text
