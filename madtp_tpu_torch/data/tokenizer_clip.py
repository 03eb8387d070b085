"""CLIP byte-level BPE tokenizer (counterpart of
``madtp_tpu/data/tokenizer_clip.py:22-146``), without the ``regex`` package.

Vocab layout (OpenAI CLIP): 256 byte-units + 256 byte-units+'</w>' +
48894 merged symbols + 2 specials = 49408.  The merge table is the public
``bpe_simple_vocab_16e6.txt.gz``, read by path from the repo's vendored copy
(:data:`DEFAULT_BPE`) or from ``vocab_path``.

The JAX tokenizer splits text with the ``regex`` pattern
``<\\|startoftext\\|>|<\\|endoftext\\|>|'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+``
under ``IGNORECASE``.  :func:`pre_tokenize` is that pattern as a scanner
over ``unicodedata.category``: letters are the ``L*`` categories, numbers
the ``N*`` ones (stdlib ``re``'s ``[^\\W\\d_]`` is not ``\\p{L}``: it also
takes ``No``/``Nl`` characters such as ``²`` and ``Ⅻ``).  Two things of the
pattern's ``IGNORECASE`` carry over: ``ſ`` matches ``s`` in the specials and
the contractions, and U+0345 (a combining mark that case-folds to the
letter ι) matches no alternative, so it is dropped.
"""

from __future__ import annotations

import gzip
import html
import os
import unicodedata
from functools import lru_cache
from typing import List, Sequence

import numpy as np

DEFAULT_BPE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "madtp_tpu", "data", "assets", "bpe_simple_vocab_16e6.txt.gz")
SOT, EOT = "<|startoftext|>", "<|endoftext|>"
_SPECIALS = (SOT, EOT)
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
_LONG_S = "\u017f"  # the one non-ASCII letter IGNORECASE matches to a literal's letters
_NOT_WHITE_SPACE = frozenset("\x1c\x1d\x1e\x1f")  # str.isspace, but not Unicode's \s
_UNMATCHED = frozenset("\u0345")  # neither \p{L} nor [^\s\p{L}\p{N}] under IGNORECASE


@lru_cache()
def bytes_to_unicode():
    """Reversible byte <-> printable-unicode map (GPT-2 convention)."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _kind(c: str) -> str:
    """``"L"``, ``"N"``, ``" "`` (whitespace), ``""`` (matched by nothing)
    or ``"P"`` (the rest)."""
    if c.isspace() and c not in _NOT_WHITE_SPACE:
        return " "
    if c in _UNMATCHED:
        return ""
    cat = unicodedata.category(c)[0]
    return cat if cat in "LN" else "P"


def _literal_at(text: str, i: int, lit: str) -> bool:
    """Whether ``lit`` matches at ``text[i:]`` case-insensitively."""
    if len(text) - i < len(lit):
        return False
    return all(("s" if c == _LONG_S else c.lower()) == w
               for c, w in zip(text[i:i + len(lit)], lit))


def pre_tokenize(text: str) -> List[str]:
    """``pat.findall(text)`` of the JAX tokenizer's pattern: at each position
    the first alternative that matches (the specials, the contractions, a
    run of letters, one number, a run of anything but whitespace, letters
    and numbers); a character no alternative matches is skipped."""
    out, i, n = [], 0, len(text)
    while i < n:
        lit = next((s for s in _SPECIALS + _CONTRACTIONS if _literal_at(text, i, s)), None)
        if lit is not None:
            out.append(text[i:i + len(lit)])
            i += len(lit)
            continue
        kind = _kind(text[i])
        if kind in ("L", "P"):
            j = i + 1
            while j < n and _kind(text[j]) == kind:
                j += 1
            out.append(text[i:j])
            i = j
        elif kind == "N":
            out.append(text[i])
            i += 1
        else:
            i += 1
    return out


def _pairs(word):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


class ClipBPETokenizer:
    def __init__(self, vocab_path: str = DEFAULT_BPE):
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        with gzip.open(vocab_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = [tuple(m.split()) for m in merges[1:49152 - 256 - 2 + 1]]
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab.extend("".join(m) for m in merges)
        vocab.extend([SOT, EOT])
        self.encoder = {t: i for i, t in enumerate(vocab)}
        self.decoder = {i: t for t, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {SOT: SOT, EOT: EOT}
        self.sot_token = self.encoder[SOT]
        self.eot_token = self.encoder[EOT]

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        """HTML-unescaped twice, whitespace collapsed, lowercased, split by
        :func:`pre_tokenize`, each piece's UTF-8 bytes through the BPE."""
        text = html.unescape(html.unescape(text))
        text = " ".join(text.split()).strip().lower()
        ids: List[int] = []
        for token in pre_tokenize(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(token).split(" "))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(self.decoder.get(int(i), "") for i in ids)
        data = bytearray(self.byte_decoder.get(c, 32) for c in text)
        return data.decode("utf-8", errors="replace").replace("</w>", " ").strip()


def clip_tokenize(tokenizer: ClipBPETokenizer, texts: Sequence[str], context_length: int = 77,
                  truncate: bool = True) -> np.ndarray:
    """[B, context_length] int32: SOT + tokens + EOT, zero-padded; a text
    too long is cut to ``context_length`` with EOT kept last (reference
    ``clip/clip.py:202-242``), or raises without ``truncate``."""
    result = np.zeros((len(texts), context_length), np.int32)
    for i, text in enumerate(texts):
        ids = [tokenizer.sot_token] + tokenizer.encode(text) + [tokenizer.eot_token]
        if len(ids) > context_length:
            if not truncate:
                raise RuntimeError(f"text too long: {text!r}")
            ids = ids[:context_length]
            ids[-1] = tokenizer.eot_token
        result[i, :len(ids)] = ids
    return result
