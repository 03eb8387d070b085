"""Offline caption scorers: BLEU-1..4, METEOR, ROUGE-L, CIDEr-D (copy of
``madtp_tpu/eval/caption_metrics.py:1-357``).

The reference shells out to pycocoevalcap (Java + downloads,
reference ``data/utils.py:94-123``), whose COCO suite reports
Bleu_1..4 / METEOR / ROUGE_L / CIDEr / SPICE.  These pure-python
implementations of the published formulas enable local regression scoring
in a zero-egress environment:

* BLEU (Papineni et al. 2002) and CIDEr-D (Vedantam et al. 2015) — exact
  formula parity with the pycocoevalcap scorers.
* ROUGE-L (Lin 2004) — pycocoevalcap's variant: per-candidate max LCS
  precision/recall over references, F-beta with beta=1.2.
* METEOR — pycocoevalcap wraps the meteor-1.5 **jar**; this is a clean-room
  implementation of the published algorithm (Banerjee & Lavie 2005) with the
  exact- and Porter-stem-match modules.  The WordNet synonym and paraphrase
  modules need data files that cannot ship here, so absolute values sit
  slightly below the jar's; deltas between checkpoints track it closely
  (the matchers it lacks are model-independent).
* SPICE needs a Java scene-graph parser and is intentionally out of scope;
  the reference's model-selection gate uses CIDEr+SPICE — with this scorer
  the gate is CIDEr alone (logged by cli/compress_caption.py) or plug
  pycocoevalcap when available.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Dict, List, Sequence

from madtp_tpu_torch.eval.spice import spice


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))


def bleu(candidates: List[str], references: Dict[str, List[str]],
         ids: List[str], max_n: int = 4) -> List[float]:
    """Corpus BLEU-1..max_n with standard brevity penalty (Papineni et al.
    2002), closest-reference length.  Returns ``[Bleu_1, ..., Bleu_max_n]``."""
    clipped = [0] * max_n
    totals = [0] * max_n
    c_len = 0
    r_len = 0
    for cand, key in zip(candidates, ids):
        ct = cand.split()
        refs = [r.split() for r in references[key]]
        c_len += len(ct)
        r_len += min((abs(len(r) - len(ct)), len(r)) for r in refs)[1]
        for n in range(1, max_n + 1):
            cg = _ngrams(ct, n)
            best = Counter()
            for r in refs:
                rg = _ngrams(r, n)
                for g, cnt in rg.items():
                    best[g] = max(best[g], cnt)
            totals[n - 1] += max(sum(cg.values()), 0)
            clipped[n - 1] += sum(min(c, best[g]) for g, c in cg.items())
    bp = 1.0 if c_len > r_len else math.exp(1.0 - r_len / max(c_len, 1))
    out = []
    logp = 0.0
    for n in range(1, max_n + 1):
        if totals[n - 1] == 0 or clipped[n - 1] == 0:
            out.append(0.0)
            logp = -math.inf
            continue
        logp += math.log(clipped[n - 1] / totals[n - 1])
        out.append(bp * math.exp(logp / n))
    return out


def bleu4(candidates: List[str], references: Dict[str, List[str]],
          ids: List[str]) -> float:
    """Corpus BLEU-4 (see :func:`bleu`)."""
    return bleu(candidates, references, ids, max_n=4)[3]


def rouge_l(candidates: List[str], references: Dict[str, List[str]],
            ids: List[str], *, beta: float = 1.2) -> float:
    """ROUGE-L (Lin 2004), pycocoevalcap variant: per candidate take the max
    LCS precision and max LCS recall over the references, combine with
    F-beta (beta=1.2), average over the corpus."""

    def lcs_len(a: Sequence[str], b: Sequence[str]) -> int:
        if not a or not b:
            return 0
        prev = [0] * (len(b) + 1)
        for x in a:
            cur = [0]
            for j, y in enumerate(b, 1):
                cur.append(prev[j - 1] + 1 if x == y
                           else max(cur[j - 1], prev[j]))
            prev = cur
        return prev[-1]

    total = 0.0
    for cand, key in zip(candidates, ids):
        ct = cand.split()
        prec, rec = [], []
        for r in references[key]:
            rt = r.split()
            l = lcs_len(ct, rt)
            prec.append(l / max(len(ct), 1))
            rec.append(l / max(len(rt), 1))
        p, r_ = max(prec, default=0.0), max(rec, default=0.0)
        if p > 0 and r_ > 0:
            total += ((1 + beta ** 2) * p * r_) / (r_ + beta ** 2 * p)
    return total / max(len(candidates), 1)


_VOWELS = "aeiou"


def _is_cons(word: str, i: int) -> bool:
    c = word[i]
    if c in _VOWELS:
        return False
    if c == "y":
        return i == 0 or not _is_cons(word, i - 1)
    return True


def _measure(stem: str) -> int:
    """Porter's m: number of VC sequences in the c/v form of ``stem``."""
    form = "".join("c" if _is_cons(stem, i) else "v" for i in range(len(stem)))
    m = 0
    prev = None
    for ch in form:
        if prev == "v" and ch == "c":
            m += 1
        prev = ch
    return m


def _has_vowel(stem: str) -> bool:
    return any(not _is_cons(stem, i) for i in range(len(stem)))


def _ends_cvc(stem: str) -> bool:
    if len(stem) < 3:
        return False
    if not (_is_cons(stem, len(stem) - 3)
            and not _is_cons(stem, len(stem) - 2)
            and _is_cons(stem, len(stem) - 1)):
        return False
    return stem[-1] not in "wxy"


def porter_stem(word: str) -> str:
    """Porter (1980) stemmer, clean-room from the published algorithm."""
    w = word.lower()
    if len(w) <= 2:
        return w
    # step 1a
    if w.endswith("sses"):
        w = w[:-2]
    elif w.endswith("ies"):
        w = w[:-2]
    elif w.endswith("ss"):
        pass
    elif w.endswith("s"):
        w = w[:-1]
    # step 1b
    flag_1b = False
    if w.endswith("eed"):
        if _measure(w[:-3]) > 0:
            w = w[:-1]
    elif w.endswith("ed") and _has_vowel(w[:-2]):
        w = w[:-2]
        flag_1b = True
    elif w.endswith("ing") and _has_vowel(w[:-3]):
        w = w[:-3]
        flag_1b = True
    if flag_1b:
        if w.endswith(("at", "bl", "iz")):
            w += "e"
        elif len(w) >= 2 and w[-1] == w[-2] and _is_cons(w, len(w) - 1) \
                and w[-1] not in "lsz":
            w = w[:-1]
        elif _measure(w) == 1 and _ends_cvc(w):
            w += "e"
    # step 1c
    if w.endswith("y") and _has_vowel(w[:-1]):
        w = w[:-1] + "i"
    # step 2
    for suf, rep in (("ational", "ate"), ("tional", "tion"), ("enci", "ence"),
                     ("anci", "ance"), ("izer", "ize"), ("abli", "able"),
                     ("alli", "al"), ("entli", "ent"), ("eli", "e"),
                     ("ousli", "ous"), ("ization", "ize"), ("ation", "ate"),
                     ("ator", "ate"), ("alism", "al"), ("iveness", "ive"),
                     ("fulness", "ful"), ("ousness", "ous"), ("aliti", "al"),
                     ("iviti", "ive"), ("biliti", "ble")):
        if w.endswith(suf):
            if _measure(w[: -len(suf)]) > 0:
                w = w[: -len(suf)] + rep
            break
    # step 3
    for suf, rep in (("icate", "ic"), ("ative", ""), ("alize", "al"),
                     ("iciti", "ic"), ("ical", "ic"), ("ful", ""),
                     ("ness", "")):
        if w.endswith(suf):
            if _measure(w[: -len(suf)]) > 0:
                w = w[: -len(suf)] + rep
            break
    # step 4
    for suf in ("al", "ance", "ence", "er", "ic", "able", "ible", "ant",
                "ement", "ment", "ent", "ion", "ou", "ism", "ate", "iti",
                "ous", "ive", "ize"):
        if w.endswith(suf):
            stem = w[: -len(suf)]
            if suf == "ion" and not stem.endswith(("s", "t")):
                break
            if _measure(stem) > 1:
                w = stem
            break
    # step 5a
    if w.endswith("e"):
        stem = w[:-1]
        m = _measure(stem)
        if m > 1 or (m == 1 and not _ends_cvc(stem)):
            w = stem
    # step 5b
    if len(w) >= 2 and w[-1] == "l" and w[-2] == "l" and _measure(w) > 1:
        w = w[:-1]
    return w


def _meteor_align(cand: List[str], ref: List[str]):
    """Greedy two-stage (exact, then Porter-stem) unigram alignment.
    Returns (num_matches, num_chunks)."""
    n_c, n_r = len(cand), len(ref)
    match_of = [-1] * n_c  # cand idx -> ref idx
    used = [False] * n_r
    for stage in (0, 1):
        key_c = cand if stage == 0 else [porter_stem(t) for t in cand]
        key_r = ref if stage == 0 else [porter_stem(t) for t in ref]
        for i in range(n_c):
            if match_of[i] >= 0:
                continue
            for j in range(n_r):
                if not used[j] and key_c[i] == key_r[j]:
                    match_of[i] = j
                    used[j] = True
                    break
    pairs = [(i, j) for i, j in enumerate(match_of) if j >= 0]
    m = len(pairs)
    chunks = 0
    prev = None
    for i, j in pairs:  # pairs already sorted by candidate position
        if prev is None or j != prev[1] + 1 or i != prev[0] + 1:
            chunks += 1
        prev = (i, j)
    return m, chunks


def meteor(candidates: List[str], references: Dict[str, List[str]],
           ids: List[str], *, alpha: float = 0.9, beta: float = 3.0,
           gamma: float = 0.5) -> float:
    """METEOR (Banerjee & Lavie 2005) with exact + Porter-stem matchers:
    per candidate, best score over references of
    ``F_mean * (1 - gamma * (chunks/m)^beta)`` where
    ``F_mean = P*R / (alpha*P + (1-alpha)*R)``.  WordNet synonym/paraphrase
    modules are omitted (offline); see module docstring."""
    total = 0.0
    for cand, key in zip(candidates, ids):
        ct = cand.split()
        best = 0.0
        for r in references[key]:
            rt = r.split()
            m, chunks = _meteor_align(ct, rt)
            if m == 0:
                continue
            p = m / max(len(ct), 1)
            rc = m / max(len(rt), 1)
            f = p * rc / (alpha * p + (1 - alpha) * rc)
            pen = gamma * (chunks / m) ** beta if m > 0 else 0.0
            best = max(best, f * (1.0 - pen))
        total += best
    return total / max(len(candidates), 1)


def cider_d(candidates: List[str], references: Dict[str, List[str]],
            ids: List[str], *, sigma: float = 6.0) -> float:
    """CIDEr-D (Vedantam et al. 2015): tf-idf weighted n-gram cosine with
    count clipping and a gaussian length penalty, averaged over n=1..4,
    scaled by 10."""
    # document frequencies over the reference corpus
    df: Dict[int, Counter] = {n: Counter() for n in range(1, 5)}
    for key in references:
        for n in range(1, 5):
            seen = set()
            for r in references[key]:
                seen |= set(_ngrams(r.split(), n).keys())
            for g in seen:
                df[n][g] += 1
    n_docs = max(len(references), 1)

    def tfidf(counts: Counter, n: int):
        vec = {}
        norm = 0.0
        length = sum(counts.values())
        for g, c in counts.items():
            idf = math.log(max(n_docs, 1)) - math.log(max(df[n][g], 1))
            w = (c / max(length, 1)) * idf
            vec[g] = w
            norm += w * w
        return vec, math.sqrt(norm), length

    total = 0.0
    for cand, key in zip(candidates, ids):
        ct = cand.split()
        score_n = [0.0] * 4
        for n in range(1, 5):
            cvec, cnorm, clen = tfidf(_ngrams(ct, n), n)
            for r in references[key]:
                rt = r.split()
                rvec, rnorm, rlen = tfidf(_ngrams(rt, n), n)
                num = 0.0
                for g, w in cvec.items():
                    # CIDEr-D clips candidate weight at reference weight
                    num += min(w, rvec.get(g, 0.0)) * rvec.get(g, 0.0)
                denom = cnorm * rnorm
                sim = num / denom if denom > 0 else 0.0
                delta = len(ct) - len(rt)
                sim *= math.exp(-(delta ** 2) / (2 * sigma ** 2))
                score_n[n - 1] += sim
            score_n[n - 1] /= max(len(references[key]), 1)
        total += 10.0 * sum(score_n) / 4.0
    return total / max(len(candidates), 1)


def coco_caption_scores(results: List[dict], gt: Dict[str, List[str]]):
    """``results``: [{'image_id', 'caption'}]; ``gt``: image_id -> refs."""
    ids = [str(r["image_id"]) for r in results if str(r["image_id"]) in gt]
    cands = [r["caption"] for r in results if str(r["image_id"]) in gt]
    refs = {k: gt[k] for k in ids}
    b = bleu(cands, refs, ids, max_n=4)
    return {
        "Bleu_1": b[0],
        "Bleu_2": b[1],
        "Bleu_3": b[2],
        "Bleu_4": b[3],
        # distinguishing key: this is the offline clean-room METEOR (exact +
        # Porter-stem matchers, no WordNet/paraphrase stage — see module
        # docstring), NOT the meteor-1.5 jar pycocoevalcap reports as
        # 'METEOR'; absolute values are not comparable to published COCO
        # numbers, so the key says so
        "METEOR_offline": meteor(cands, refs, ids),
        "ROUGE_L": rouge_l(cands, refs, ids),
        "CIDEr": cider_d(cands, refs, ids),
        # clean-room scene-graph metric (rule-based parser + built-in
        # synonym table standing in for Stanford parser + WordNet) — see
        # eval/spice.py docstring; key says _offline for the same reason
        # METEOR's does
        "SPICE_offline": spice(cands, refs, ids),
    }
