"""Data-driven letter-to-sound corrections induced from the lexicon.

The reference resolves OOV words with the trained neural ``g2p_en``
package (reference synthesize.py:9,44-58), unavailable offline. Our
replacement is layered (textproc/g2p.py): lexicon → morphology → a
hand-written chunk-rule engine. The hand engine is strong on regular
spellings (≥95% exact on the pinned regular holdout) but systematically
off elsewhere — full vowels where English reduces to schwa, wrong
voicing in clusters, missed French/Latinate patterns.

This module closes part of that gap with error-driven
transformation-based learning (Brill-style), adapted to G2P:

1. TRACE the hand engine over every eligible lexicon entry, keeping the
   (letter-span → emitted-phones) segmentation the chunk scanner
   already produces (g2p.py:_rules).
2. ALIGN the emitted phone string to the lexicon's gold phones
   (edit-distance backtrace), giving each letter span its gold target.
3. INDUCE corrections: for every span where emitted ≠ gold, emit
   candidate rules (grapheme, left letter context ≤3, right letter
   context ≤3) → gold phones, and COUNT — for each candidate context —
   how often the hand engine is wrong (and corrected consistently) vs
   already right. A rule is adopted only when the evidence says the
   hand engine errs in that context (support ≥ MIN_SUPPORT, the gold
   outputs agree, and wrong cases outnumber right ones 2:1).
4. APPLY at inference inside the chunk scanner: for each span, the most
   specific adopted rule (longest context match, boundary-aware) wins;
   otherwise the hand output stands. Stress renormalization runs after,
   as before.

Because corrections require positive evidence of hand-engine ERROR in a
specific context, the regular-word behavior the hand engine already
gets right is preserved by construction — unlike wholesale LTS
induction, which would have to re-learn everything the chunks encode.

Rules are induced offline (tools/induce_lts.py) from the curated
lexicon and committed as a generated table (lts_rules.py); loading is
O(1) at G2p construction.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

# letter-context window (each side); '^'/'$' mark word boundaries
MAX_CTX = 3
# minimum number of observed hand-engine errors a context must show
MIN_SUPPORT = 2
# adopted rules must fix at least this fraction of the contexts they
# match (wrong / (wrong + right))
MIN_ERROR_RATE = 2.0 / 3.0
# the corrected output must be the gold target in at least this
# fraction of the wrong cases
MIN_CONSISTENCY = 0.75

Seg = Tuple[int, int, Tuple[str, ...]]  # (i0, i1, phones) over the word
# (grapheme, left ctx, right ctx, from-phones): true transformation
# rules — the from-phones LHS stops corrections learned on reduced
# (unstressed) spans from firing on stressed ones and vice versa
RuleKey = Tuple[str, str, str, Tuple[str, ...]]


def align_gold_spans(
    pred: Sequence[str], gold: Sequence[str]
) -> List[Tuple[int, int]]:
    """For each pred index, the half-open span of gold indices it maps
    to under a minimal edit-distance alignment. Insertions (gold phones
    with no pred partner) attach to the preceding pred position's span
    (to the first position at the word start)."""
    n, m = len(pred), len(gold)
    d = [[0] * (m + 1) for _ in range(n + 1)]
    for i in range(n + 1):
        d[i][0] = i
    for j in range(m + 1):
        d[0][j] = j
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            d[i][j] = min(
                d[i - 1][j] + 1,
                d[i][j - 1] + 1,
                d[i - 1][j - 1] + (pred[i - 1] != gold[j - 1]),
            )
    # backtrace → per-pred gold span
    spans = [[0, 0] for _ in range(n)]
    i, j = n, m
    ops: List[Tuple[str, int, int]] = []  # (op, pred_idx, gold_idx)
    while i > 0 or j > 0:
        if i > 0 and j > 0 and d[i][j] == d[i - 1][j - 1] + (
            pred[i - 1] != gold[j - 1]
        ):
            ops.append(("sub", i - 1, j - 1))
            i, j = i - 1, j - 1
        elif i > 0 and d[i][j] == d[i - 1][j] + 1:
            ops.append(("del", i - 1, j))  # pred phone unmatched
            i -= 1
        else:
            ops.append(("ins", i, j - 1))  # gold phone unmatched
            j -= 1
    ops.reverse()
    for p in range(n):
        spans[p] = [m, m]  # empty until touched
    for op, p, g in ops:
        if op == "sub":
            if spans[p][0] == m and spans[p][1] == m:
                spans[p] = [g, g + 1]
            else:
                spans[p][1] = g + 1
        elif op == "del":
            # pred phone consumed no gold: empty span at current g
            if spans[p][0] == m and spans[p][1] == m:
                spans[p] = [g, g]
        else:  # ins: gold[g] attaches to preceding pred position
            tgt = p - 1 if p > 0 else 0
            if n == 0:
                continue
            if spans[tgt][0] == m and spans[tgt][1] == m:
                spans[tgt] = [g, g + 1]
            else:
                spans[tgt][1] = g + 1
    # make spans monotone & contiguous (fill gaps left→right)
    prev_end = 0
    out: List[Tuple[int, int]] = []
    for p in range(n):
        s, e = spans[p]
        if s == m and e == m:  # untouched (shouldn't happen) → empty
            s = e = prev_end
        s = max(s, prev_end)
        e = max(e, s)
        out.append((s, e))
        prev_end = e
    if out:
        out[-1] = (out[-1][0], m)  # last span absorbs any gold tail
    return out


def seg_gold_targets(
    segs: Sequence[Seg], gold: Sequence[str]
) -> List[Tuple[str, ...]]:
    """Gold phone target for each letter segment: concatenate the gold
    spans of the segment's emitted phones. Zero-phone segments (silent
    letters) get an empty target positioned between neighbors."""
    flat: List[str] = []
    owners: List[int] = []  # flat index -> seg index
    for k, (_, _, ph) in enumerate(segs):
        for p in ph:
            flat.append(p)
            owners.append(k)
    spans = align_gold_spans(flat, gold)
    targets: List[Tuple[int, int]] = [(-1, -1)] * len(segs)
    for idx, (s, e) in enumerate(spans):
        k = owners[idx]
        s0, e0 = targets[k]
        if s0 < 0:
            targets[k] = (s, e)
        else:
            targets[k] = (s0, max(e0, e))
    # empty segments: position at the boundary between neighbors
    prev_end = 0
    res: List[Tuple[str, ...]] = []
    for k in range(len(segs)):
        s, e = targets[k]
        if s < 0:
            s = e = prev_end
        res.append(tuple(gold[s:e]))
        prev_end = max(prev_end, e)
    return res


def contexts(word: str, i0: int, i1: int) -> List[Tuple[str, str]]:
    """All (lctx, rctx) template pairs for span [i0, i1) of ``word``,
    from most to least specific. Boundary markers '^'/'$' are
    OBLIGATORY when the span touches the word edge: word-initial
    evidence must never back off to a context-free template (initial
    'a' reduces in apology/appear; medial 'a' in wrap/strap does not —
    the two classes may not share a rule)."""
    lfull = "^" + word[:i0]
    rfull = word[i1:] + "$"
    lmin = 1 if i0 == 0 else 0
    rmin = 1 if not word[i1:] else 0
    lefts = [lfull[len(lfull) - k:]
             for k in range(min(MAX_CTX, len(lfull)), lmin - 1, -1)]
    rights = [rfull[:k]
              for k in range(min(MAX_CTX, len(rfull)), rmin - 1, -1)]
    out = []
    for lc in lefts:
        for rc in rights:
            out.append((lc, rc))
    # most specific first: sort by total context length desc
    out.sort(key=lambda t: -(len(t[0]) + len(t[1])))
    return out


class LtsCorrector:
    """Applies the induced decision list to a chunk-scanner trace.

    Rule values are either a replacement phone tuple or ``None`` — a
    "keep" shield: positive evidence that the hand engine is RIGHT in
    that (more specific) context, blocking a more general correction
    from misfiring (e.g. the polysyllabic vowel-reduction corrections
    must not reduce stressed monosyllables)."""

    def __init__(self, rules: Dict[RuleKey, Optional[Tuple[str, ...]]]):
        # (grapheme, lctx, rctx) -> replacement phones | None (keep)
        self.rules = rules
        self._by_graph: Dict[str, List[RuleKey]] = {}
        for key in rules:
            self._by_graph.setdefault(key[0], []).append(key)
        for keys in self._by_graph.values():
            # first matching key decides → most specific context first,
            # lexicographic tie-break for determinism
            keys.sort(key=lambda k: (-(len(k[1]) + len(k[2])), k))

    @staticmethod
    def _ctx_match(word: str, i0: int, i1: int, lctx: str, rctx: str) -> bool:
        lfull = "^" + word[:i0]
        rfull = word[i1:] + "$"
        return lfull.endswith(lctx) and rfull.startswith(rctx)

    def correct(self, word: str, segs: Sequence[Seg]) -> List[Seg]:
        out: List[Seg] = []
        for (i0, i1, ph) in segs:
            g = word[i0:i1]
            for key in self._by_graph.get(g, ()):
                if key[3] == tuple(ph) and self._ctx_match(
                    word, i0, i1, key[1], key[2]
                ):
                    repl = self.rules[key]
                    out.append((i0, i1, ph if repl is None else repl))
                    break
            else:
                out.append((i0, i1, ph))
        return out


def induce(
    traces: Sequence[Tuple[str, Sequence[Seg], Sequence[str]]],
    min_support: int = MIN_SUPPORT,
    min_error_rate: float = MIN_ERROR_RATE,
    min_consistency: float = MIN_CONSISTENCY,
    min_ctx: int = 1,
) -> Dict[RuleKey, Tuple[str, ...]]:
    """Induce correction rules from (word, hand-engine segs, gold) triples.

    Counts, per candidate (grapheme, lctx, rctx): occurrences where the
    hand engine's span output was wrong (keyed by the gold replacement)
    and where it was right; adopts the majority replacement when the
    thresholds hold."""
    wrong: Dict[RuleKey, Dict[Tuple[str, ...], int]] = {}
    right: Dict[RuleKey, int] = {}
    for word, segs, gold in traces:
        targets = seg_gold_targets(segs, gold)
        for (i0, i1, ph), tgt in zip(segs, targets):
            g = word[i0:i1]
            if not g:
                continue
            for lc, rc in contexts(word, i0, i1):
                key = (g, lc, rc, tuple(ph))
                if tuple(ph) == tgt:
                    right[key] = right.get(key, 0) + 1
                else:
                    wrong.setdefault(key, {})[tgt] = (
                        wrong.get(key, {}).get(tgt, 0) + 1
                    )
    adopted: Dict[RuleKey, Optional[Tuple[str, ...]]] = {}
    for key, repls in wrong.items():
        if len(key[1]) + len(key[2]) < min_ctx:
            continue  # context-free grapheme rewrites are too blunt
        n_wrong = sum(repls.values())
        if n_wrong < min_support:
            continue
        n_right = right.get(key, 0)
        if n_wrong / (n_wrong + n_right) < min_error_rate:
            continue
        best, n_best = max(repls.items(), key=lambda kv: kv[1])
        if n_best / n_wrong < min_consistency:
            continue
        adopted[key] = best

    # keep-shields: for every adopted correction, any strictly more
    # specific observed context where the hand engine is MAJORITY-right
    # becomes an explicit "keep" rule that out-ranks the correction at
    # apply time (first-match-decides, most specific first). Majority
    # (not min_error_rate) is the right bar here: a shield only
    # suppresses a correction, so 50/50 evidence should favor the hand
    # engine's unmodified output.
    corrections = list(adopted.items())
    for key, n_right in right.items():
        if n_right < min_support or key in adopted:
            continue
        n_wrong = sum(wrong.get(key, {}).values())
        if n_right <= n_wrong:
            continue
        g, lc, rc, frm = key
        for (g2, lc2, rc2, frm2), repl in corrections:
            if repl is None or g2 != g or frm2 != frm:
                continue
            if (
                len(lc) + len(rc) > len(lc2) + len(rc2)
                and lc.endswith(lc2)
                and rc.startswith(rc2)
            ):
                adopted[key] = None
                break
    return _prune(adopted)


def _prune(rules: Dict[RuleKey, Tuple[str, ...]]) -> Dict[RuleKey, Tuple[str, ...]]:
    """Drop rules shadowed by a less specific rule with the same output
    (the general rule already produces the same correction)."""
    pruned: Dict[RuleKey, Optional[Tuple[str, ...]]] = {}
    for (g, lc, rc, frm), out in sorted(
        rules.items(), key=lambda kv: (len(kv[0][1]) + len(kv[0][2]))
    ):
        shadowed = False
        for k2 in range(len(lc) + 1):
            for j2 in range(len(rc) + 1):
                lsub = lc[k2:]
                rsub = rc[:j2] if j2 < len(rc) else rc
                if (lsub, rsub) == (lc, rc):
                    continue
                if (g, lsub, rsub, frm) in pruned and pruned[
                    (g, lsub, rsub, frm)
                ] == out:
                    shadowed = True
                    break
            if shadowed:
                break
        if not shadowed:
            pruned[(g, lc, rc, frm)] = out
    return pruned


def load_default() -> Optional[LtsCorrector]:
    """The committed induced table (generated by tools/induce_lts.py),
    or None when absent/disabled (STYLER_TPU_NO_LTS=1)."""
    import os

    if os.environ.get("STYLER_TPU_NO_LTS", "0") == "1":
        return None
    try:
        from styler_tpu_torch.textproc.lts_rules import RULES
    except ImportError:
        return None
    return LtsCorrector(
        {
            (k[0], k[1], k[2], tuple(k[3])): (
                None if v is None else tuple(v)
            )
            for k, v in RULES
        }
    )
