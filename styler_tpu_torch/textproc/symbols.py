"""Phoneme/character symbol inventory.

The symbol *ordering* is a compatibility contract with the reference
(text/symbols.py:9-20, keithito/tacotron lineage): the text encoder's
embedding table is indexed by these IDs, so a ported checkpoint only works
if the ordering matches exactly:

    [pad] + special + punctuation + letters + @ARPAbet + silences
"""

from __future__ import annotations

# ARPAbet phone inventory (CMUdict; reference text/cmudict.py:6-14).
ARPABET = [
    "AA", "AA0", "AA1", "AA2", "AE", "AE0", "AE1", "AE2",
    "AH", "AH0", "AH1", "AH2", "AO", "AO0", "AO1", "AO2",
    "AW", "AW0", "AW1", "AW2", "AY", "AY0", "AY1", "AY2",
    "B", "CH", "D", "DH",
    "EH", "EH0", "EH1", "EH2", "ER", "ER0", "ER1", "ER2",
    "EY", "EY0", "EY1", "EY2",
    "F", "G", "HH",
    "IH", "IH0", "IH1", "IH2", "IY", "IY0", "IY1", "IY2",
    "JH", "K", "L", "M", "N", "NG",
    "OW", "OW0", "OW1", "OW2", "OY", "OY0", "OY1", "OY2",
    "P", "R", "S", "SH", "T", "TH",
    "UH", "UH0", "UH1", "UH2", "UW", "UW0", "UW1", "UW2",
    "V", "W", "Y", "Z", "ZH",
]

PAD = "_"
SPECIAL = "-"
PUNCTUATION = "!'(),.:;? "
LETTERS = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
SILENCES = ["@sp", "@spn", "@sil"]

# '@' prefix disambiguates ARPAbet phones from uppercase letters.
symbols = (
    [PAD]
    + list(SPECIAL)
    + list(PUNCTUATION)
    + list(LETTERS)
    + ["@" + p for p in ARPABET]
    + SILENCES
)

symbol_to_id = {s: i for i, s in enumerate(symbols)}
id_to_symbol = {i: s for i, s in enumerate(symbols)}

PAD_ID = 0  # also transformer.Constants.PAD in the reference
VOCAB_SIZE = len(symbols) + 1  # reference Encoder: n_src_vocab=len(symbols)+1
