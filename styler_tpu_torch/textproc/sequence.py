"""Text → symbol-ID sequence conversion (reference text/__init__.py:15-42).

Supports ARPAbet segments in curly braces: ``"Turn {L EH1 F T} here"``.
"""

from __future__ import annotations

import re
from typing import Iterable, List

from styler_tpu_torch.textproc.cleaners import CLEANERS
from styler_tpu_torch.textproc.symbols import id_to_symbol, symbol_to_id

_curly_re = re.compile(r"(.*?)\{(.+?)\}(.*)")


def _clean(text: str, cleaner_names: Iterable[str]) -> str:
    for name in cleaner_names:
        if name not in CLEANERS:
            raise ValueError(f"Unknown cleaner: {name}")
        text = CLEANERS[name](text)
    return text


def _keep(symbol: str) -> bool:
    return symbol in symbol_to_id and symbol not in ("_", "~")


def _symbols_to_ids(syms: Iterable[str]) -> List[int]:
    return [symbol_to_id[s] for s in syms if _keep(s)]


def _arpabet_to_ids(text: str) -> List[int]:
    return _symbols_to_ids("@" + p for p in text.split())


def text_to_sequence(text: str, cleaner_names: Iterable[str] = ()) -> List[int]:
    """Convert text (optionally with {ARPAbet} spans) to symbol IDs."""
    sequence: List[int] = []
    while text:
        m = _curly_re.match(text)
        if not m:
            sequence += _symbols_to_ids(_clean(text, cleaner_names))
            break
        sequence += _symbols_to_ids(_clean(m.group(1), cleaner_names))
        sequence += _arpabet_to_ids(m.group(2))
        text = m.group(3)
    return sequence


def sequence_to_text(sequence: Iterable[int]) -> str:
    out = ""
    for sid in sequence:
        if sid in id_to_symbol:
            s = id_to_symbol[sid]
            if len(s) > 1 and s[0] == "@":
                s = "{%s}" % s[1:]
            out += s
    return out.replace("}{", " ")
