"""Grapheme-to-phoneme conversion.

The reference shells into the ``g2p_en`` neural package at synthesis time
(reference synthesize.py:9,44-58). That package (and its weights) is not
available offline, so this module provides a layered G2P with the same
output contract — a list of ARPAbet tokens and punctuation marks:

1. a real pronouncing dictionary, auto-discovered when present
   (``STYLER_TPU_LEXICON`` env var, the MFA librispeech lexicon the
   preprocessing path assumes at data/vctk.py:66-83, or a local
   cmudict file) and loadable explicitly via ``load_cmudict``,
2. the built-in ~1000-word curated lexicon (textproc/lexicon.py):
   function words + core vocabulary where spelling defeats rules,
3. morphological decomposition: inflected/derived forms resolve their
   stem through the lexicon and append the suffix phones with the
   correct allomorph (cats K S / dogs Z / boxes IH0 Z; walked T /
   played D / wanted IH0 D),
4. a deterministic letter-to-sound rule engine for true OOV words
   (longest-match grapheme chunks, magic-e long vowels, soft c/g,
   positional s-voicing).

A heteronym layer (neighbor-word context cues for the top noun/verb
stress pairs and vowel-quality cases) sits ABOVE the dictionaries —
dictionary entries are context-free, which is exactly what it corrects —
except for explicitly-loaded entries (``load_cmudict`` calls /
``STYLER_TPU_LEXICON``), which always win: a deliberately-supplied
domain lexicon ("bass" in a fishing corpus) beats the context guess.

``to_phoneme_string`` reproduces the exact formatting of the reference's
``preprocess_text`` (synthesize.py:44-58): ``{AH0 M ...}`` spans with
``{sp}`` standing in for punctuation.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Tuple

from styler_tpu_torch.textproc.lexicon import LEXICON as _LEXICON


def _apply_rhythm(phones: List[str]) -> List[str]:
    """English rhythm rule: a word whose PRIMARY stress falls on its
    last vowel, with at least two vowels before it, carries an initial
    SECONDARY stress (silhouette S IH2 L UW0 EH1 T, guarantee
    G EH2 R AH0 N T IY1, violin V AY2 AH0 L IH1 N). Applied to
    rule-derived pronunciations only — lexicon entries carry gold
    stress."""
    vowel_idx = [i for i, p in enumerate(phones) if p[-1:].isdigit()]
    if len(vowel_idx) >= 3 and phones[vowel_idx[-1]].endswith("1"):
        first = phones[vowel_idx[0]]
        if first.endswith("0") and first != "AH0":
            phones = list(phones)
            phones[vowel_idx[0]] = first[:-1] + "2"
    return phones


def _renormalize_after_corrections(orig, corrected):
    """Stress repair after the LTS correction pass. If a correction
    replaced the span that carried the word's primary stress with an
    unstressed vowel (reduction rules are trained on demoted copies of
    the same letters — collect vs colleague), restore the primary to
    THAT segment before the usual one-primary normalization; otherwise
    the promote-first-vowel fallback would stress the wrong syllable."""
    if any(p.endswith("1") for _, _, ph in corrected for p in ph):
        return _normalize_stress_segs(corrected)
    prim_seg = None
    for k, (_, _, ph) in enumerate(orig):
        if any(p.endswith("1") for p in ph):
            prim_seg = k
            break
    if prim_seg is not None:
        # a reduction on the primary syllable means the stress belongs
        # LATER in the word (collect-class teachers: K AH0 L EH1 K T) —
        # promote the first vowel after the reduced segment, falling
        # back to the segment itself, then to the normalizer's default
        for k in list(range(prim_seg + 1, len(corrected))) + [prim_seg]:
            i0, i1, ph = corrected[k]
            for j, p in enumerate(ph):
                if p[-1:].isdigit():
                    ph = tuple(
                        pp[:-1] + "1" if jj == j else pp
                        for jj, pp in enumerate(ph)
                    )
                    corrected = list(corrected)
                    corrected[k] = (i0, i1, ph)
                    return _normalize_stress_segs(corrected)
    return _normalize_stress_segs(corrected)


def _normalize_stress_segs(segs):
    """One primary stress per word, applied across a (span → phones)
    trace: demote every primary after the first; if none survives,
    promote the first vowel (fern F ER1 N, not F ER0 N)."""
    out = []
    seen_primary = False
    any_vowel_at = None
    flat_idx = 0
    for (i0, i1, ph) in segs:
        np_ = []
        for p in ph:
            if p.endswith("1"):
                if seen_primary:
                    p = p[:-1] + "0"
                seen_primary = True
            if p[-1:].isdigit() and any_vowel_at is None:
                any_vowel_at = flat_idx
            np_.append(p)
            flat_idx += 1
        out.append((i0, i1, tuple(np_)))
    if not seen_primary and any_vowel_at is not None:
        k = 0
        for s, (i0, i1, ph) in enumerate(out):
            if k + len(ph) > any_vowel_at:
                j = any_vowel_at - k
                ph = tuple(
                    p[:-1] + "1" if idx == j else p for idx, p in enumerate(ph)
                )
                out[s] = (i0, i1, ph)
                break
            k += len(ph)
    return out

# Lexicon files probed (in order) by G2p() when no explicit path is
# given; the first existing paths are all loaded (later files do not
# override earlier entries).
DEFAULT_LEXICON_PATHS = (
    os.path.join(
        "montreal-forced-aligner", "pretrained_models", "librispeech-lexicon.txt"
    ),
    os.path.join("lexicon", "librispeech-lexicon.txt"),
    "cmudict.dict",
    "cmudict-0.7b",
)

_VOWELS = "aeiouy"
_VOICELESS = {"P", "T", "K", "F", "TH", "S", "SH", "CH", "HH"}
_SIBILANTS = {"S", "Z", "SH", "CH", "JH", "ZH"}

# Long ("name of the letter") vowel qualities for magic-e contexts.
_LONG = {"a": "EY1", "e": "IY1", "i": "AY1", "o": "OW1", "u": "UW1", "y": "AY1"}

# Longest-match grapheme → phoneme chunk rules (scanned in order).
# Position-specific behavior (word-final 'e' silent, magic-e, soft c/g,
# final s voicing) is handled in code.
_CHUNKS = [
    ("tion", "SH AH0 N"), ("sion", "SH AH0 N"), ("cially", "SH AH0 L IY0"),
    ("cial", "SH AH0 L"), ("tial", "SH AH0 L"), ("cious", "SH AH0 S"),
    ("tious", "SH AH0 S"), ("geous", "JH AH0 S"), ("gious", "JH AH0 S"),
    ("ought", "AO1 T"), ("aught", "AO1 T"), ("ould", "UH1 D"),
    ("old", "OW1 L D"), ("olt", "OW1 L T"), ("ild", "AY1 L D"),
    ("sthm", "Z M"),  # th silent, s voiced: asthma, asthmatic
                      # (isthmus keeps S — lexicon exception)
    ("eigh", "EY1"), ("tch", "CH"), ("dge", "JH"), ("dg", "JH"),
    ("tg", "G"),     # t silent in the tg cluster: mortgage
    ("pb", "B"),     # p silent in the pb cluster: cupboard, clapboard
    ("igh", "AY1"),
    ("ei", "EY1"),   # context-dependent: see the 'ei' case in _rules
    ("lh", "L"),     # h silent after l: silhouette, Delhi
    ("sure", "ZH ER0"), ("ture", "CH ER0"), ("ophe", "AH0 F IY0"),
    ("augh", "AO1"), ("ough", "AH1 F"),
    ("ook", "UH1 K"), ("air", "EH1 R"), ("ear", "IY1 R"), ("eer", "IY1 R"),
    ("oor", "AO1 R"), ("our", "AO1 R"), ("ph", "F"), ("gh", "G"),
    ("ch", "CH"), ("sh", "SH"), ("th", "TH"), ("wh", "W"), ("ck", "K"),
    ("ng", "NG"), ("nk", "NG K"), ("qu", "K W"), ("wr", "R"),
    ("kn", "N"), ("gn", "N"),
    ("mb", "M"), ("ps", "S"), ("sc", "S"),
    ("ieu", "UW1"),  # French: lieu, adieu, lieutenant
    ("eau", "OW1"),  # French: bureau, plateau, beau
    ("cz", "Z"),     # Slavic onset: czar, czech
    ("oup", "UW1 P"),  # soup, group, coupon (not the AW of 'out')
    ("oo", "UW1"), ("ee", "IY1"), ("ea", "IY1"), ("ai", "EY1"),
    ("ay", "EY1"), ("oa", "OW1"), ("ow", "OW1"), ("ou", "AW1"),
    ("oi", "OY1"), ("oy", "OY1"), ("au", "AO1"), ("aw", "AO1"),
    ("ew", "UW1"), ("ue", "UW1"), ("ui", "UW1"), ("ie", "IY1"),
    ("ey", "IY0"),
    ("ar", "AA1 R"), ("er", "ER0"), ("ir", "ER1"), ("or", "AO1 R"),
    ("ur", "ER1"), ("yr", "ER1"),
    ("a", "AE1"), ("b", "B"), ("c", "K"), ("d", "D"), ("e", "EH1"),
    ("f", "F"), ("g", "G"), ("h", "HH"), ("i", "IH1"), ("j", "JH"),
    ("k", "K"), ("l", "L"), ("m", "M"), ("n", "N"), ("o", "AA1"),
    ("p", "P"), ("r", "R"), ("s", "S"), ("t", "T"), ("u", "AH1"),
    ("v", "V"), ("w", "W"), ("x", "K S"), ("y", "IY0"), ("z", "Z"),
]

_word_re = re.compile(r"[a-zA-Z']+|[^a-zA-Z\s]")


def _s_allomorph(phones: List[str]) -> List[str]:
    """Plural/possessive/3sg 's' after the given stem phones."""
    if not phones:
        return ["Z"]
    last = phones[-1].rstrip("012")
    if last in _SIBILANTS:
        return ["IH0", "Z"]
    if last in _VOICELESS:
        return ["S"]
    return ["Z"]


def _ed_allomorph(phones: List[str]) -> List[str]:
    """Past-tense 'ed' after the given stem phones."""
    if not phones:
        return ["D"]
    last = phones[-1].rstrip("012")
    if last in ("T", "D"):
        return ["IH0", "D"]
    if last in _VOICELESS:
        return ["T"]
    return ["D"]


# ---------------------------------------------------------------------
# Heteronyms. The reference's g2p_en disambiguates with a perceptron POS
# tagger (reference synthesize.py:9,44-58); offline, the top cases are
# covered with deterministic neighbor-word cues: a noun/verb
# stress-pair table keyed on determiner vs. infinitive/modal context,
# plus per-word vowel-quality rules (read/wind/live/...). Unknown
# context falls back to the more frequent reading.
# ---------------------------------------------------------------------

_DETERMINERS = {
    "the", "a", "an", "this", "that", "these", "those", "my", "your",
    "his", "her", "its", "our", "their", "some", "any", "no", "each",
    "every", "of", "one", "another", "whose",
}
_VERB_CUES = {
    "to", "will", "would", "can", "could", "may", "might", "shall",
    "should", "must", "do", "does", "did", "don't", "doesn't", "didn't",
    "won't", "cannot", "can't", "i", "we", "you", "they", "please",
    "and", "not", "never", "always", "usually", "often",
}
_PERFECT_CUES = {
    "have", "has", "had", "having", "been", "was", "were", "be", "being",
    "is", "are", "already", "just", "once", "i've", "we've", "you've",
    "they've", "he's", "she's",
}

# noun-vs-verb stress pairs: word -> (noun phones, verb phones).
# Noun reading after a determiner/possessive; verb reading after an
# infinitive/modal/pronoun cue; default noun (the more frequent reading
# for this family in running text).
_STRESS_PAIRS = {
    "record": ("R EH1 K ER0 D", "R IH0 K AO1 R D"),
    "records": ("R EH1 K ER0 D Z", "R IH0 K AO1 R D Z"),
    "present": ("P R EH1 Z AH0 N T", "P R IH0 Z EH1 N T"),
    "presents": ("P R EH1 Z AH0 N T S", "P R IH0 Z EH1 N T S"),
    "object": ("AA1 B JH EH0 K T", "AH0 B JH EH1 K T"),
    "objects": ("AA1 B JH EH0 K T S", "AH0 B JH EH1 K T S"),
    "project": ("P R AA1 JH EH0 K T", "P R AH0 JH EH1 K T"),
    "projects": ("P R AA1 JH EH0 K T S", "P R AH0 JH EH1 K T S"),
    "subject": ("S AH1 B JH IH0 K T", "S AH0 B JH EH1 K T"),
    "subjects": ("S AH1 B JH IH0 K T S", "S AH0 B JH EH1 K T S"),
    "permit": ("P ER1 M IH0 T", "P ER0 M IH1 T"),
    "permits": ("P ER1 M IH0 T S", "P ER0 M IH1 T S"),
    "produce": ("P R OW1 D UW0 S", "P R AH0 D UW1 S"),
    "contract": ("K AA1 N T R AE2 K T", "K AH0 N T R AE1 K T"),
    "contracts": ("K AA1 N T R AE2 K T S", "K AH0 N T R AE1 K T S"),
    "conduct": ("K AA1 N D AH0 K T", "K AH0 N D AH1 K T"),
    "contest": ("K AA1 N T EH0 S T", "K AH0 N T EH1 S T"),
    "refuse": ("R EH1 F Y UW2 S", "R IH0 F Y UW1 Z"),
    "desert": ("D EH1 Z ER0 T", "D IH0 Z ER1 T"),
    "content": ("K AA1 N T EH0 N T", "K AH0 N T EH1 N T"),
    "rebel": ("R EH1 B AH0 L", "R IH0 B EH1 L"),
    "insult": ("IH1 N S AH0 L T", "IH0 N S AH1 L T"),
    "increase": ("IH1 N K R IY2 S", "IH0 N K R IY1 S"),
    "decrease": ("D IH1 K R IY2 S", "D IH0 K R IY1 S"),
    "address": ("AE1 D R EH2 S", "AH0 D R EH1 S"),
    "protest": ("P R OW1 T EH2 S T", "P R AH0 T EH1 S T"),
    "suspect": ("S AH1 S P EH2 K T", "S AH0 S P EH1 K T"),
    "conflict": ("K AA1 N F L IH0 K T", "K AH0 N F L IH1 K T"),
    "convert": ("K AA1 N V ER0 T", "K AH0 N V ER1 T"),
    "export": ("EH1 K S P AO0 R T", "IH0 K S P AO1 R T"),
    "import": ("IH1 M P AO2 R T", "IH0 M P AO1 R T"),
}


# derivational suffixes resolved via lexicon stems: suffix -> phones
_SUFFIX_PHONES = {
    "ing": ["IH0", "NG"],
    "ly": ["L", "IY0"],
    "er": ["ER0"],
    "est": ["AH0", "S", "T"],
    "ness": ["N", "AH0", "S"],
    "ment": ["M", "AH0", "N", "T"],
    "ful": ["F", "AH0", "L"],
    "less": ["L", "AH0", "S"],
    "ish": ["IH0", "SH"],
    "some": ["S", "AH0", "M"],  # handsome, awesome, tiresome
    "en": ["AH0", "N"],
    "y": ["IY0"],
}


class G2p:
    """Callable G2P matching the g2p_en interface: g2p(text) -> token list."""

    def __init__(self, cmudict_path: Optional[str] = None, auto: bool = True):
        self.lexicon: Dict[str, str] = dict(_LEXICON)
        # words whose pronunciation the USER chose (explicit path / env
        # var): these beat the heteronym context rules; auto-discovered
        # generic dictionaries do not (their entries are context-free,
        # which is exactly what the heteronym layer corrects).
        self._explicit: set = set()
        # induced letter-to-sound correction pass (textproc/lts.py);
        # None when the generated table is absent or STYLER_TPU_NO_LTS=1
        from styler_tpu_torch.textproc.lts import load_default as _load_lts

        self.lts = _load_lts()
        env_path = os.environ.get("STYLER_TPU_LEXICON", "")
        if cmudict_path:
            self.load_cmudict(cmudict_path)
        elif auto:
            for p in [env_path] + list(DEFAULT_LEXICON_PATHS):
                if p and os.path.isfile(p):
                    self.load_cmudict(p, explicit=(p == env_path))

    def load_cmudict(self, path: str, explicit: bool = True) -> None:
        """Load a CMUdict-format lexicon ('WORD  PH PH PH' lines).
        Loaded entries override the built-in lexicon (a real dictionary
        beats the curated fallback); alternates '(n)' are skipped.
        ``explicit`` entries (the default for direct calls) also beat
        the heteronym context rules — a deliberately-supplied
        domain lexicon wins everywhere."""
        alt = re.compile(r"\([0-9]+\)$")
        loaded: Dict[str, str] = {}
        with open(path, encoding="latin-1") as f:
            for line in f:
                if not line or line[0] in ";#":
                    continue
                parts = line.strip().split(None, 1)
                if len(parts) != 2:
                    continue
                if alt.search(parts[0]):
                    continue  # keep the primary pronunciation only
                word = parts[0].lower()
                loaded.setdefault(word, parts[1].strip())
        self.lexicon.update(loaded)
        if explicit:
            self._explicit.update(loaded)

    # -- morphology ----------------------------------------------------

    def _stem_phones(self, stem: str) -> Optional[List[str]]:
        """Lexicon phones for a candidate stem, trying the usual
        spelling changes: doubled consonant (stopp-), dropped silent e
        (mak-), y->i (cri-)."""
        cands = [stem]
        if len(stem) > 2 and stem[-1] == stem[-2] and stem[-1] not in _VOWELS:
            cands.append(stem[:-1])  # stopped -> stop
        cands.append(stem + "e")  # making -> make
        if stem.endswith("i"):
            cands.append(stem[:-1] + "y")  # cried -> cry
        for c in cands:
            if c in self.lexicon:
                return self.lexicon[c].split()
        return None

    def _pronounce(self, word: str) -> List[str]:
        if word in self.lexicon:
            return self.lexicon[word].split()

        # possessive / clitic 's
        if word.endswith("'s") and len(word) > 3:
            base = self._pronounce(word[:-2])
            return base + _s_allomorph(base)
        word = word.replace("'", "")
        if word in self.lexicon:
            return self.lexicon[word].split()

        # inflectional suffixes: resolve the stem via the lexicon, or by
        # rules with the usual spelling changes undone (undoubling,
        # silent-e restoration)
        if len(word) > 3 and word.endswith("s") and not word.endswith("ss"):
            # s-final words that are not plurals: the -orps family's
            # ending rule must win over plural decomposition (corps)
            whole = self._endings(word)
            if whole is not None:
                return whole
            base = self._stem_phones(word[:-1])  # slides -> slide, makes -> make
            if base is None and word.endswith("es"):
                base = self._stem_phones(word[:-2])  # boxes -> box
            if base is None:
                # plain -s leaves the stem spelling intact; the e of
                # -es belongs to the stem (stoves, slides) unless it was
                # inserted after a sibilant letter (boxes, churches).
                # Stems keep their ending-rule readings (gauges,
                # fatigues, colleagues).
                if word.endswith("es") and word[-3] in "hsxz":
                    base = self._endings(word[:-2]) or self._rules(word[:-2])
                else:
                    base = self._endings(word[:-1]) or self._rules(word[:-1])
            return base + _s_allomorph(base)
        if len(word) > 4 and word.endswith("ed"):
            base = (
                self._stem_phones(word[:-2])
                or self._endings(word[:-2])
                # e-final stems spell -ed with one letter (gauged)
                or self._endings(word[:-1])
                or self._stem_rules(word[:-2])
            )
            return base + _ed_allomorph(base)
        for suf, phones in _SUFFIX_PHONES.items():
            if len(word) > len(suf) + 2 and word.endswith(suf):
                stem = word[: -len(suf)]
                if suf == "y" and stem[-1] in "aeiou":
                    continue  # tray/play: the y is part of a diphthong
                if suf == "er" and word.endswith("cester"):
                    break  # place-name -cester is not agentive -er;
                    # fall through to the ending rule below
                base = self._stem_phones(stem) or self._endings(stem)
                if base is None and suf in ("ing", "er", "est", "en", "y"):
                    base = self._stem_rules(stem)
                if base is not None:
                    if suf == "some" and base[-2:] == ["N", "D"]:
                        # d-deletion in the nd+s cluster (handsome)
                        base = base[:-1]
                    return base + phones

        ending = self._endings(word)
        if ending is not None:
            return ending

        return self._rules(word)

    def _endings(self, word: str) -> Optional[List[str]]:
        """Ending rules: grapheme clusters whose reading is fixed by the
        word-final context and cannot be composed from letter chunks.
        Returns None when no rule applies (caller falls back to the
        chunk rules). Split from _pronounce so the inflectional-suffix
        paths can consult the same rules for stems (gauges, fatigues,
        indictment).

        Closed-class cluster endings — like the place-name -cester rule,
        each covers a small closed family (the reference's neural g2p_en
        memorizes these from CMUdict):
          -auge   EY1 JH  (gauge, gauged, gauges — no AO counters)
          -flage  F L AA2 ZH  (camouflage, persiflage; French -age
                  after fl keeps the full AA ZH reading)
          -orps   AO1 R   (corps, corps-man: French silent ps)
          -ndict  N D AY1 T  (indict and derivatives; contrast
                  verdict/predict where -dict is D IH0 K T)
          -tenant T EH1 N AH0 N T  (compound tenancy family:
                  lieutenant, subtenant, cotenant — stem destressed,
                  head noun keeps primary stress)
        """
        if len(word) > 4 and word.endswith("auge"):
            return self._rules(word[:-4]) + ["EY1", "JH"]
        if len(word) > 6 and word.endswith("flage"):
            return _apply_rhythm(self._rules(word[:-5]) + ["F", "L", "AA2", "ZH"])
        if len(word) > 4 and word.endswith("orps"):
            return self._rules(word[:-4]) + ["AO1", "R"]
        if len(word) > 5 and word.endswith("ndict"):
            return _apply_rhythm(
                self._destress(self._rules(word[:-5]))
                + ["N", "D", "AY1", "T"]
            )
        if len(word) > 7 and word.endswith("tenant"):
            return _apply_rhythm(
                self._destress(self._pronounce(word[:-6]))
                + ["T", "EH1", "N", "AH0", "N", "T"]
            )
        # French-origin endings regular enough to be rules: -ique is a
        # stressed IY1 K (boutique, critique, oblique), -igue a stressed
        # IY1 G (fatigue, intrigue); any other final -gue is a bare G
        # (colleague, plague, dialogue); -ette is a stressed EH1 T
        # (cassette, brunette, silhouette)
        if len(word) > 5 and word.endswith("ique"):
            return _apply_rhythm(
                self._destress(self._rules(word[:-4])) + ["IY1", "K"]
            )
        if len(word) > 5 and word.endswith("igue"):
            return _apply_rhythm(
                self._destress(self._rules(word[:-4])) + ["IY1", "G"]
            )
        if len(word) > 4 and word.endswith("gue"):
            return self._rules(word[:-3]) + ["G"]
        if len(word) > 5 and word.endswith("ette"):
            stem = word[:-4]
            if stem.endswith("ou"):
                # French hiatus ou = UW before -ette (silhouette,
                # pirouette), not the native AW of 'out'
                return _apply_rhythm(
                    self._destress(self._rules(stem[:-2]))
                    + ["UW0", "EH1", "T"]
                )
            return _apply_rhythm(
                self._destress(self._rules(stem)) + ["EH1", "T"]
            )
        # English place-name -cester is a single ST ER0 syllable
        # (Leicester, Gloucester, Worcester); as an ending rule because
        # the soft-c rule would otherwise split it to S EH S T ER0
        if len(word) > 6 and word.endswith("cester"):
            return self._rules(word[:-6]) + ["S", "T", "ER0"]
        # unstressed final -age is a reduced AH0 JH when the word has
        # another syllable (village, message, mortgage, manage) — the
        # magic-e path would wrongly give a hard g + long a. One-syllable
        # -age words (stage, cage) keep the magic-e reading.
        if (
            len(word) > 4
            and word.endswith("age")
            and any(c in _VOWELS for c in word[:-3])
        ):
            return self._rules(word[:-3]) + ["AH0", "JH"]

        return None

    @staticmethod
    def _destress(phones: List[str]) -> List[str]:
        """Demote every stress mark — used before appending a
        primary-stressed French ending. A demoted short-a reduces to
        schwa, the general English pre-tonic reduction (cassette
        K AH0 S EH1 T, fatigue F AH0 T IY1 G)."""
        out = [p[:-1] + "0" if p[-1:] in "12" else p for p in phones]
        return ["AH0" if p == "AE0" else p for p in out]

    def _stem_rules(self, stem: str) -> List[str]:
        """Rule-engine pronunciation of a suffix-stripped stem, undoing
        the spelling change the suffix caused: stopp- -> stop,
        smil- -> smile (restores the magic-e long vowel)."""
        if len(stem) > 2 and stem[-1] == stem[-2] and stem[-1] not in _VOWELS:
            return self._rules(stem[:-1])
        if (
            len(stem) > 2
            and stem[-1] not in _VOWELS
            and stem[-1] != "r"
            and stem[-2] in "aeiou"
            and stem[-3] not in "aeiou"
        ):
            return self._rules(stem + "e")
        return self._rules(stem)

    # -- letter-to-sound -----------------------------------------------

    def _rules(self, word: str) -> List[str]:
        """Letter-to-sound via the chunk scanner, then (when the induced
        table is present) the data-driven correction pass
        (textproc/lts.py), then stress normalization."""
        w2, segs = self._rules_segs(word)
        segs = _normalize_stress_segs(segs)
        if self.lts is not None:
            corrected = self.lts.correct(w2, segs)
            if corrected != segs:
                segs = _renormalize_after_corrections(segs, corrected)
        return _apply_rhythm([p for _, _, ph in segs for p in ph])

    def _rules_segs(self, word: str):
        """The chunk scan with its (letter-span → phones) trace kept:
        returns (transformed_word, [(i0, i1, phones), ...]) BEFORE
        stress normalization. The trace is both the correction hook and
        the LTS induction substrate (tools/induce_lts.py)."""
        word = word.replace("'", "")
        n0 = len(word)
        # magic-e: vowel + single consonant + final silent e -> the
        # vowel says its name (make, ride, hope, cube)
        long_pos = -1
        if (
            n0 > 3
            and word.endswith("e")
            and word[-2] not in _VOWELS
            and word[-2] != "r"
            and word[-3] in _VOWELS
        ):
            long_pos = n0 - 3
        # final silent 'e' (short words like 'be' come from the lexicon)
        stripped = False
        if n0 > 3 and word.endswith("e") and word[-2] not in "aeiou":
            word = word[:-1]
            stripped = True
        segs: List[Tuple[int, int, Tuple[str, ...]]] = []
        i = 0
        n = len(word)
        while i < n:
            ch = word[i]
            nxt = word[i + 1] if i + 1 < n else ""
            # soft c / soft g before e, i, y
            if ch == "c" and nxt and nxt in "eiy":
                segs.append((i, i + 1, ("S",)))
                i += 1
                continue
            if ch == "g" and nxt and nxt in "ey":
                segs.append((i, i + 1, ("JH",)))
                i += 1
                continue
            # magic-e long vowel (u keeps its yod after labials/velars:
            # cube K Y UW1 B, but rude/flute/june are plain UW1)
            if i == long_pos and ch in _LONG:
                if ch == "u" and i > 0 and word[i - 1] in "bcfghkmpv":
                    segs.append((i, i + 1, ("Y", "UW1")))
                else:
                    segs.append((i, i + 1, (_LONG[ch],)))
                i += 1
                continue
            # collapse doubled consonants
            if ch == nxt and ch not in _VOWELS:
                segs.append((i, i + 1, ()))
                i += 1
                continue
            # word-final 'a' in a polysyllable is a schwa (sofa, asthma,
            # banana) — not the AE of a closed syllable
            if ch == "a" and i == n - 1 and any(c in _VOWELS for c in word[:i]):
                segs.append((i, i + 1, ("AH0",)))
                i += 1
                continue
            matched = False
            for graph, ph in _CHUNKS:
                if word.startswith(graph, i):
                    # word-final 's' after a voiced CONSONANT -> Z
                    # (plurals after vowels go through the morphology
                    # path; monomorphemic -s after a vowel is usually S:
                    # gas, bus, chaos)
                    last = segs[-1][2][-1] if segs and segs[-1][2] else ""
                    if (
                        graph == "s"
                        and i == n - 1
                        and last
                        and last.rstrip("012") not in _VOICELESS
                        and not last[-1].isdigit()
                    ):
                        segs.append((i, i + 1, ("Z",)))
                    # word-initial y is the glide
                    elif graph == "y" and i == 0:
                        segs.append((i, i + 1, ("Y",)))
                    # 'ei' is EY only in the vein/reign/beige family
                    # (after v/r, or before g); the common reading
                    # elsewhere is IY: receive, ceiling, seize, protein
                    elif graph == "ei":
                        if (i > 0 and word[i - 1] in "vr") or (
                            i + 2 < n and word[i + 2] == "g"
                        ):
                            segs.append((i, i + 2, ("EY1",)))
                        else:
                            segs.append((i, i + 2, ("IY1",)))
                    else:
                        segs.append((i, i + len(graph), tuple(ph.split())))
                    i += len(graph)
                    matched = True
                    break
            if not matched:
                segs.append((i, i + 1, ()))
                i += 1  # drop unknown character
        # a stripped silent e stays visible to the correction contexts
        # ('them' and 'theme' must not share a context string) — the
        # sentinel sits beyond the scanned span, so segs are unaffected
        return word + ("~" if stripped else ""), segs

    # -- heteronyms ------------------------------------------------------

    def _heteronym(
        self, word: str, prev: Optional[str], nxt: Optional[str]
    ) -> Optional[str]:
        """Context-disambiguated phones for the top heteronym cases, or
        None when ``word`` is not a handled heteronym. ``prev``/``nxt``
        are the neighboring words (lowercased, punctuation skipped)."""
        if word in _STRESS_PAIRS:
            noun, verb = _STRESS_PAIRS[word]
            if prev in _VERB_CUES:
                return verb
            return noun  # determiner context and the default
        if word == "read":
            return "R EH1 D" if prev in _PERFECT_CUES else "R IY1 D"
        if word == "lead":
            if nxt in ("pipe", "pipes", "paint", "poisoning", "pencil"):
                return "L EH1 D"
            return "L IY1 D"
        if word == "live":
            if nxt in (
                "music", "show", "shows", "broadcast", "stream", "audience",
                "performance", "concert", "wire", "coverage",
            ) or prev in ("a", "went", "goes", "going", "watch", "watched"):
                return "L AY1 V"
            return "L IH1 V"
        if word == "lives":
            # noun plural of life after determiners/possessives
            return "L AY1 V Z" if prev in _DETERMINERS else "L IH1 V Z"
        if word == "wind":
            return "W AY1 N D" if nxt in ("up", "down") else "W IH1 N D"
        if word == "wound":
            return "W AW1 N D" if prev in _PERFECT_CUES else "W UW1 N D"
        if word == "tear":
            if prev in _DETERMINERS and nxt not in ("in", "apart", "down"):
                return "T IH1 R"
            return "T EH1 R"
        if word == "tears":
            return "T EH1 R Z" if prev in _VERB_CUES else "T IH1 R Z"
        if word == "bow":
            if prev in _VERB_CUES or nxt == "down":
                return "B AW1"
            return "B OW1"
        if word == "bass":
            if nxt in ("fishing", "fish", "lake") or prev in ("largemouth", "striped", "sea"):
                return "B AE1 S"
            return "B EY1 S"
        if word == "close":
            if nxt in ("to", "by", "enough", "friend", "friends", "call", "range") or prev in ("so", "too", "very", "how", "really"):
                return "K L OW1 S"
            return "K L OW1 Z"
        if word == "use":
            return "Y UW1 S" if prev in _DETERMINERS else "Y UW1 Z"
        if word == "used":
            return "Y UW1 S T" if nxt == "to" else "Y UW1 Z D"
        if word == "excuse":
            return "IH0 K S K Y UW1 S" if prev in _DETERMINERS else "IH0 K S K Y UW1 Z"
        if word == "separate":
            # verb with full -ate after an infinitive/modal cue
            return "S EH1 P ER0 EY2 T" if prev in _VERB_CUES else "S EH1 P R AH0 T"
        return None

    def __call__(self, text: str) -> List[str]:
        matches = [m.group(0) for m in _word_re.finditer(text)]
        is_word = [t[0].isalpha() or t[0] == "'" for t in matches]
        words = [t.lower() if w else None for t, w in zip(matches, is_word)]

        def neighbor(idx: int, step: int) -> Optional[str]:
            j = idx + step
            while 0 <= j < len(words):
                if words[j] is not None:
                    return words[j]
                if matches[j] in ".!?;":
                    return None  # heteronym cues don't cross sentences
                j += step
            return None

        tokens: List[str] = []
        for idx, tok in enumerate(matches):
            if idx:
                tokens.append(" ")
            if not is_word[idx]:
                tokens.append(tok)
                continue
            word = words[idx]
            het = (
                None
                if word in self._explicit
                else self._heteronym(word, neighbor(idx, -1), neighbor(idx, +1))
            )
            if het is not None:
                tokens.extend(het.split())
            else:
                tokens.extend(self._pronounce(word))
        return tokens


def to_phoneme_string(text: str, g2p: Optional[G2p] = None) -> str:
    """Reference preprocess_text formatting (synthesize.py:44-58):
    '{PH} {PH} ... {sp} ...' with punctuation mapped to {sp}."""
    import string

    text = text.rstrip(string.punctuation)
    g2p = g2p or G2p()
    phones = [p for p in g2p(text) if p != " "]
    s = "{" + "}{".join(phones) + "}"
    s = re.sub(r"\{[^\w\s]?\}", "{sp}", s)
    return s.replace("}{", " ")
