"""Minimal Praat TextGrid parser + phone-alignment extraction (a copy of
``styler_tpu/data/textgrid.py``).

Replaces the reference's ``tgt`` dependency. ``get_alignment`` reproduces
reference utils.py:40-70: leading/trailing silences trimmed, frame
durations = round(end*sr/hop) - round(start*sr/hop). ``format_textgrid``
writes the long format that ``read_textgrid`` reads, as MFA does.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List, Tuple


@dataclass
class Interval:
    start_time: float
    end_time: float
    text: str


@dataclass
class Tier:
    name: str
    intervals: List[Interval]


SIL_PHONES = ("sil", "sp", "spn")


def read_textgrid(path: str) -> dict:
    """Parse a (long-format) TextGrid into {tier_name: Tier}."""
    with open(path, encoding="utf-8", errors="replace") as f:
        content = f.read()

    tiers = {}
    # split on item [n] blocks
    items = re.split(r"item\s*\[\d+\]\s*:", content)[1:]
    for item in items:
        name_m = re.search(r'name\s*=\s*"([^"]*)"', item)
        if not name_m:
            continue
        name = name_m.group(1)
        intervals = []
        for m in re.finditer(
            r"intervals\s*\[\d+\]\s*:?\s*"
            r"xmin\s*=\s*([\d.eE+-]+)\s*"
            r"xmax\s*=\s*([\d.eE+-]+)\s*"
            r'text\s*=\s*"([^"]*)"',
            item,
        ):
            intervals.append(Interval(float(m.group(1)), float(m.group(2)), m.group(3)))
        tiers[name] = Tier(name, intervals)
    return tiers


def format_textgrid(intervals, tiers=("phones",), xmax=None) -> str:
    """A long-format TextGrid with one interval tier per name in ``tiers``,
    each holding ``intervals`` = [(start, end, text), ...]; ``xmax``
    defaults to the last interval's end."""
    xmax = intervals[-1][1] if xmax is None else xmax
    out = ['File type = "ooTextFile"', 'Object class = "TextGrid"', "",
           "xmin = 0", f"xmax = {xmax}", "tiers? <exists>", f"size = {len(tiers)}", "item []:"]
    for i, name in enumerate(tiers, start=1):
        out += [f"    item [{i}]:", '        class = "IntervalTier"', f'        name = "{name}"',
                "        xmin = 0", f"        xmax = {xmax}",
                f"        intervals: size = {len(intervals)}"]
        for j, (s, e, text) in enumerate(intervals, start=1):
            out += [f"        intervals [{j}]:", f"            xmin = {s}",
                    f"            xmax = {e}", f'            text = "{text}"']
    return "\n".join(out) + "\n"


def get_alignment(
    tier: Tier, sampling_rate: int, hop_length: int
) -> Tuple[List[str], List[int], float, float]:
    """Phones + frame durations with silence trimming (utils.py:40-70)."""
    import numpy as np

    phones: List[str] = []
    durations: List[int] = []
    start_time = 0.0
    end_time = 0.0
    end_idx = 0
    for t in tier.intervals:
        s, e, p = t.start_time, t.end_time, t.text

        if not phones:
            if p in SIL_PHONES:
                continue
            start_time = s
        if p not in SIL_PHONES:
            phones.append(p)
            end_time = e
            end_idx = len(phones)
        else:
            phones.append(p)
        durations.append(
            int(
                np.round(e * sampling_rate / hop_length)
                - np.round(s * sampling_rate / hop_length)
            )
        )

    phones = phones[:end_idx]
    durations = durations[:end_idx]
    return phones, durations, start_time, end_time


def alignment_from_file(
    tg_path: str, sampling_rate: int, hop_length: int, tier_name: str = "phones"
):
    tiers = read_textgrid(tg_path)
    if tier_name not in tiers:
        raise ValueError(f"tier '{tier_name}' not in {tg_path} ({list(tiers)})")
    return get_alignment(tiers[tier_name], sampling_rate, hop_length)
