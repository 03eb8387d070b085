"""SPICE_offline: clean-room scene-graph caption metric (copy of
``madtp_tpu/eval/spice.py:1-429``).

The reference reports SPICE through pycocoevalcap's Java pipeline
(reference ``data/utils.py:94-123`` -> ``COCOEvalCap``): captions are
parsed into scene graphs by the Stanford Scene Graph Parser, reduced to
semantic tuples — objects ``(o,)``, attributes ``(o, a)``, relations
``(s, r, o)`` — and scored as the mean per-image F1 between the candidate
tuple set and the union of the reference tuple sets, with WordNet-synset
tuple matching (Anderson et al. 2016, "SPICE: Semantic Propositional
Image Caption Evaluation").

Neither the Java parser nor WordNet can ship in this zero-egress
environment, so this module implements the PUBLISHED metric formula over
a deterministic rule-based scene-graph parser tuned to caption English
(the short, present-tense, noun-phrase-heavy register that
``pre_caption``-normalized COCO/NoCaps captions live in), with a small
built-in synonym table standing in for WordNet synsets.

Honest labeling: the score is reported as ``SPICE_offline`` because its
absolute values are NOT comparable to the jar's (different parser,
different synonym coverage).  What it preserves is what the checkpoint
gate consumes: candidate and reference captions go through the SAME
parser, so semantic-content overlap moves the score the same way SPICE's
does, and deltas between checkpoints track it.  The gate-deviation
analysis in ``tools/measure_gate_deviation.py`` (a CIDEr-tied secondary
content metric flips 0.52% of gate pairs) bounds the effect of the
stand-in.

Parser sketch (all closed-class sets below):

1. tokenize the ``pre_caption``-normalized text; merge multiword
   prepositions ("next to", "in front of", ...);
2. drop existential "there is/are";
3. chunk greedily into noun phrases ``[DET]* [mod]* head`` separated by
   prepositions, copulas, verbs (a lexicon of common caption verbs plus
   -ing/-ed morphology with a noun-ing exception list) and conjunctions;
4. emit tuples: every NP head is an object; premodifiers are attributes;
   ``NP (verb)? (prep)? NP`` links become relations (verb and preposition
   joined when both present); copula + adjective/participle becomes an
   attribute; a trailing participle with no object becomes an attribute
   ("a dog sitting" -> (dog, sit));
   "and"-coordination distributes the relation over the conjunct heads;
5. canonicalize every word: noun de-pluralization and verb de-inflection
   (irregular tables + deterministic suffix rules), then the synonym
   table maps to a cluster representative — tuple matching is plain set
   intersection on canonical forms.
"""

from __future__ import annotations

import re
from typing import Dict, FrozenSet, List, Sequence, Tuple

Tup = Tuple[str, ...]

# ---------------------------------------------------------------------------
# closed-class word sets

_DET = {
    "a", "an", "the", "this", "that", "these", "those", "some", "any", "no",
    "each", "every", "all", "both", "another", "other", "its", "his", "her",
    "their", "my", "your", "our",
}
_PRON = {
    "it", "he", "she", "they", "them", "him", "who", "which", "what",
    "someone", "something", "anyone", "anything", "everyone",
}
_NUM = {
    "one", "two", "three", "four", "five", "six", "seven", "eight", "nine",
    "ten", "eleven", "twelve", "several", "many", "few", "couple", "lots",
    "numerous", "multiple",
}
_PREP = {
    "in", "on", "at", "by", "with", "of", "near", "under", "over", "above",
    "below", "behind", "beside", "besides", "between", "against", "along",
    "across", "around", "atop", "inside", "outside", "onto", "into",
    "through", "from", "to", "off", "down", "up", "upon", "during",
    "without", "underneath", "among", "amongst", "beneath", "toward",
    "towards", "past", "for",
}
# merged left-to-right before tagging, longest first
_MULTI_PREP = [
    ("in", "front", "of"), ("on", "top", "of"), ("in", "back", "of"),
    ("out", "of"), ("next", "to"), ("close", "to"), ("on", "side", "of"),
]
# noun compounds whose parts would misclassify (e.g. "up" is a preposition)
_COMPOUNDS = {("close", "up"): "closeup"}
_COP = {"is", "are", "was", "were", "be", "being", "been", "am"}
_CONJ = {"and", "or"}
_SKIP = {"there", "very", "as", "while", "also", "just", "then", "so",
         "not", "too", "only"}

# common caption verbs (base + 3rd-person + participles resolved by the
# lemmatizer below); -ing/-ed morphology catches the long tail
_VERBS = {
    "sit", "sits", "sat", "stand", "stands", "stood", "hold", "holds",
    "held", "ride", "rides", "rode", "wear", "wears", "wore", "eat",
    "eats", "ate", "play", "plays", "walk", "walks", "run", "runs", "ran",
    "fly", "flies", "flew", "lie", "lies", "lay", "take", "takes", "took",
    "make", "makes", "made", "look", "looks", "drive", "drives", "drove",
    "jump", "jumps", "surf", "surfs", "ski", "skis", "skate", "skates",
    "swim", "swims", "swam", "throw", "throws", "threw", "catch",
    "catches", "caught", "hits", "cuts", "gets",
    "got", "give", "gives", "gave", "smiles", "poses",
    "lean", "leans", "hangs", "hung", "carry", "carries",
    "carried", "pulls", "pushes", "watches",
    "use", "uses", "has", "have", "had", "contains",
    "shows", "shown", "features", "includes",
    "graze", "grazes", "fills", "covers",
    "sleep", "sleeps", "wait", "waits", "talk", "talks",
    "read", "reads", "reaches", "serves", "drank", "cooks",
}
# -ing words that are (almost always) NOUNS in captions, not verbs
_NOUN_ING = {
    "building", "buildings", "painting", "paintings", "ceiling",
    "ceilings", "clothing", "railing", "railings", "awning", "awnings",
    "icing", "evening", "morning", "lightning", "frosting", "topping",
    "toppings", "living", "dining", "wedding", "weddings", "clearing",
    "crossing", "king", "ring", "rings", "wing", "wings", "thing",
    "things", "spring", "string", "strings", "swing", "swings",
}
# -ed words that are NOUNS/adjectives by lexicon (bed, red handled by len)
_NOUN_ED = {"bed", "beds", "shed", "sled", "red", "speed", "seed", "seeds",
            "bred", "feed", "weed", "weeds", "reed", "shred"}

# irregular noun plural -> singular
_IRR_NOUN = {
    "men": "man", "women": "woman", "children": "child", "people":
    "person", "feet": "foot", "teeth": "tooth", "mice": "mouse", "geese":
    "goose", "sheep": "sheep", "leaves": "leaf", "knives": "knife",
    "wolves": "wolf", "shelves": "shelf", "loaves": "loaf", "lives":
    "life", "skies": "sky", "glasses": "glasses", "scissors": "scissors",
    "pants": "pants", "shorts": "shorts", "jeans": "jeans", "buses":
    "bus", "dishes": "dish", "benches": "bench", "beaches": "beach",
    "sandwiches": "sandwich", "watches": "watch", "couches": "couch",
    "giraffes": "giraffe", "zebras": "zebra",
}
# irregular verb form -> base
_IRR_VERB = {
    "sat": "sit", "sitting": "sit", "stood": "stand", "held": "hold",
    "rode": "ride", "riding": "ride", "wore": "wear", "ate": "eat",
    "ran": "run", "running": "run", "flew": "fly", "flying": "fly",
    "flies": "fly", "lay": "lie", "lying": "lie", "lies": "lie", "took":
    "take", "taking": "take", "made": "make", "making": "make", "drove":
    "drive", "driving": "drive", "swam": "swim", "swimming": "swim",
    "threw": "throw", "caught": "catch", "hitting": "hit", "cutting":
    "cut", "got": "get", "getting": "get", "gave": "give", "giving":
    "give", "hung": "hang", "carried": "carry", "carries": "carry",
    "has": "have", "had": "have", "drank": "drink", "shown": "show",
    "using": "use", "used": "use", "uses": "use", "posing": "pose",
    "smiling": "smile", "skating": "skate", "leaning": "lean", "grazing":
    "graze", "serving": "serve", "waving": "wave", "petting": "pet",
    "topped": "top", "stopped": "stop", "dotted": "dot", "wrapped":
    "wrap",
}

# synonym clusters (WordNet stand-in; first element is the representative)
_SYN_CLUSTERS = [
    ["picture", "photo", "photograph", "image", "pic"],
    ["man", "guy", "gentleman", "male"],
    ["woman", "lady", "female"],
    ["child", "kid", "toddler"],
    ["bicycle", "bike"],
    ["motorcycle", "motorbike"],
    ["television", "tv"],
    ["couch", "sofa"],
    ["phone", "cellphone", "smartphone", "telephone"],
    ["car", "automobile", "vehicle"],
    ["ocean", "sea"],
    ["street", "road"],
    ["shop", "store"],
    ["rock", "stone"],
    ["big", "large", "huge", "giant"],
    ["small", "little", "tiny"],
    ["near", "beside", "by", "next to", "close to"],
    ["on", "atop", "upon", "on top of"],
    ["sidewalk", "pavement"],
    ["airplane", "plane", "aircraft", "jet"],
    ["boat", "ship"],
    ["cap", "hat"],
    ["purse", "handbag", "bag"],
    ["doughnut", "donut"],
    ["fridge", "refrigerator"],
    ["train", "locomotive"],
    ["grass", "lawn"],
    ["look", "watch", "stare"],
    ["speak", "talk"],
]
_SYN = {w: c[0] for c in _SYN_CLUSTERS for w in c}


def _lemma_noun(w: str) -> str:
    if w in _IRR_NOUN:
        return _IRR_NOUN[w]
    if len(w) > 3 and w.endswith("ies"):
        return w[:-3] + "y"
    if len(w) > 3 and w.endswith(("ches", "shes", "sses", "xes", "zes")):
        return w[:-2]
    if len(w) > 3 and w.endswith("s") and not w.endswith(("ss", "us", "is")):
        return w[:-1]
    return w


def _dedouble(stem: str) -> str:
    if (len(stem) > 2 and stem[-1] == stem[-2]
            and stem[-1] not in "lsez"):
        return stem[:-1]
    return stem


def _lemma_verb(w: str) -> str:
    if w in _IRR_VERB:
        return _IRR_VERB[w]
    if len(w) > 4 and w.endswith("ing"):
        return _dedouble(w[:-3])
    if len(w) > 3 and w.endswith("ed"):
        return _dedouble(w[:-2])
    if len(w) > 3 and w.endswith("ies"):
        return w[:-3] + "y"
    if len(w) > 3 and w.endswith(("ches", "shes", "sses", "xes")):
        return w[:-2]
    if len(w) > 2 and w.endswith("s") and not w.endswith("ss"):
        return w[:-1]
    return w


def _canon(w: str, *, verb: bool = False) -> str:
    lem = _lemma_verb(w) if verb else _lemma_noun(w)
    return _SYN.get(lem, lem)


def _is_verbish(w: str) -> bool:
    if w in _VERBS or w in _IRR_VERB:
        return True
    if w.endswith("ing") and len(w) > 4 and w not in _NOUN_ING:
        return True
    if w.endswith("ed") and len(w) > 4 and w not in _NOUN_ED:
        return True
    return False


def _tokenize(caption: str) -> List[str]:
    toks = re.findall(r"[a-z0-9']+", caption.lower())
    toks = [t[:-2] if t.endswith("'s") else t for t in toks]
    toks = [t.strip("'") for t in toks]
    toks = [t for t in toks if t and t != "s"]
    # merge multiword prepositions into one space-joined token
    out: List[str] = []
    i = 0
    while i < len(toks):
        pair = tuple(toks[i:i + 2])
        if pair in _COMPOUNDS:
            out.append(_COMPOUNDS[pair])
            i += 2
            continue
        for mp in _MULTI_PREP:
            if tuple(toks[i:i + len(mp)]) == mp:
                out.append(" ".join(mp))
                i += len(mp)
                break
        else:
            out.append(toks[i])
            i += 1
    return out


class _NP:
    __slots__ = ("head", "mods")

    def __init__(self, head: str, mods: List[str]):
        self.head, self.mods = head, mods


def parse_scene_graph(caption: str) -> FrozenSet[Tup]:
    """Caption -> frozenset of canonicalized semantic tuples.

    Objects ``(o,)``, attributes ``(o, a)``, relations ``(s, r, o)`` — the
    tuple schema SPICE scores (Anderson et al. 2016 §3.1)."""
    toks = _tokenize(caption)
    tuples: set = set()

    # ---- chunk pass: NPs and the links between them --------------------
    i, n = 0, len(toks)
    groups: List[List[_NP]] = []   # conjunction groups of NPs, in order
    links: List[Tuple[str, str, bool]] = []  # (verb, prep, cop) before
    # groups[k+1]
    pend_verb, pend_prep, pend_cop = "", "", False
    conj, after_np = False, False   # state between tokens
    trailing: List[Tuple[_NP, str]] = []  # (np, participle) attributes

    while i < n:
        w = toks[i]
        if w in _SKIP or w in _PRON:
            after_np = False
            i += 1
            continue
        if w in _COP:
            pend_cop, conj, after_np = True, False, False
            i += 1
            continue
        if " " in w or w in _PREP:
            pend_prep, conj, after_np = w, False, False
            i += 1
            continue
        if w in _CONJ:
            conj, after_np = True, False
            i += 1
            continue
        if w in _DET:
            i += 1
            continue
        if _is_verbish(w) and w not in _NUM and after_np:
            # "a man riding ..." — verb after a completed NP links groups
            pend_verb, conj, after_np = w, False, False
            i += 1
            continue
        # ---- collect one NP: content words until a boundary -------------
        # (a verbish word at NP start — "running man", "parked car" — is a
        # participle premodifier and rides inside the NP; after the first
        # word any verbish token ends the NP)
        words: List[str] = []
        while i < n:
            w = toks[i]
            if (w in _PREP or " " in w or w in _COP or w in _CONJ
                    or w in _DET or w in _SKIP or w in _PRON):
                break
            if words and _is_verbish(w) and w not in _NUM:
                break
            words.append(w)
            i += 1
        if not words:
            i += 1
            continue
        if len(words) == 1 and _is_verbish(words[0]) and words[0] not in _NUM:
            # a lone participle with nothing following it in the NP slot:
            # "a dog sitting (on ...)" was handled by after_np above; this
            # is "sitting" at caption start or after a det — treat as verb
            pend_verb, conj, after_np = words[0], False, False
            continue
        np_ = _NP(words[-1], words[:-1])
        if conj and groups and not (pend_verb or pend_prep or pend_cop):
            groups[-1].append(np_)       # "a man and a woman ..."
        else:
            if groups and (pend_verb or pend_prep or pend_cop):
                links.append((pend_verb, pend_prep, pend_cop))
            elif groups:
                links.append(("", "", False))  # no link: emits nothing
            groups.append([np_])
            pend_verb, pend_prep, pend_cop = "", "", False
        conj, after_np = False, True

    # trailing verb with no object: "a dog sitting" -> attribute
    if pend_verb and groups:
        for np_ in groups[-1]:
            trailing.append((np_, pend_verb))

    # ---- emit tuples ---------------------------------------------------
    attr_groups = set()  # rhs groups consumed as copular attributes
    for k, (verb, prep, cop) in enumerate(links):
        if not (verb or prep or cop):
            continue  # adjacent NPs with no syntactic link — no relation
        # finite lexicon verbs ("rides", "stood") attach to the clause
        # subject — "a man wearing a hat rides a bike" relates man, not
        # hat; participles/preps/copulas attach to the nearest NP group
        lhs = (groups[0] if verb and not verb.endswith(("ing", "ed"))
               else groups[k])
        rhs = groups[k + 1]
        if (cop and not prep and not verb
                and all(not r.mods and r.head not in _NUM for r in rhs)):
            # copular adjective(s): "the cat is black (and white)" —
            # attribute reading (SPICE's parser emits attributes here);
            # the adjective group is NOT an object of its own
            for l_ in lhs:
                for r_ in rhs:
                    tuples.add((_canon(l_.head), _canon(r_.head)))
            attr_groups.add(k + 1)
            continue
        rel_parts = []
        if verb:
            rel_parts.append(_canon(verb, verb=True))
        if prep:
            rel_parts.append(_SYN.get(prep, prep))
        rel = " ".join(rel_parts) if rel_parts else "be"
        for l_ in lhs:
            for r_ in rhs:
                tuples.add((_canon(l_.head), rel, _canon(r_.head)))
    for g, grp in enumerate(groups):
        if g in attr_groups:
            continue
        for np_ in grp:
            head = _canon(np_.head)
            tuples.add((head,))
            for m in np_.mods:
                if m in _NUM:
                    tuples.add((head, m))
                elif _is_verbish(m):
                    tuples.add((head, _canon(m, verb=True)))
                else:
                    tuples.add((head, _canon(m)))
    for np_, verb in trailing:
        tuples.add((_canon(np_.head), _canon(verb, verb=True)))
    return frozenset(tuples)


def spice_f1(cand_tuples: FrozenSet[Tup],
             ref_tuples: FrozenSet[Tup]) -> float:
    """Per-image SPICE F1 (Anderson et al. 2016 eq. 1-3): binary tuple
    matching over duplicate-free sets."""
    if not cand_tuples or not ref_tuples:
        return 0.0
    matched = len(cand_tuples & ref_tuples)
    p = matched / len(cand_tuples)
    r = matched / len(ref_tuples)
    return 2 * p * r / (p + r) if p + r else 0.0


def spice(candidates: List[str], references: Dict[str, List[str]],
          ids: List[str]) -> float:
    """Corpus SPICE_offline = mean per-image F1, reference-parity
    aggregation (pycocoevalcap SPICE averages per-image scores)."""
    if not candidates:
        return 0.0
    total = 0.0
    for cand, key in zip(candidates, ids):
        ref_tuples = frozenset().union(
            *(parse_scene_graph(r) for r in references[key])) \
            if references[key] else frozenset()
        total += spice_f1(parse_scene_graph(cand), ref_tuples)
    return total / len(candidates)
