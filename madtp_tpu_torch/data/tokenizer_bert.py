"""Pure-python BERT WordPiece tokenizer (copy of
``madtp_tpu/data/tokenizer_bert.py:1-183``).

Replaces the reference's HF ``BertTokenizer.from_pretrained`` +
``add_special_tokens({'bos_token': '[DEC]', 'additional_special_tokens':
['[ENC]']})`` (reference ``models/blip.py:219-225``) without any network or HF
hub dependency: vocab comes from a local ``vocab.txt`` (bert-base-uncased
layout, 30522 entries; [DEC]/[ENC] appended -> 30524, matching
``configs/med_config.json`` vocab_size).

Implements standard BERT basic+wordpiece tokenization: lowercase, accent
stripping (NFD), CJK spacing, punctuation splitting, greedy longest-match
subwords with ``##`` continuation and 100-char [UNK] cutoff.
"""

from __future__ import annotations

import unicodedata
from typing import Dict, List, Optional, Sequence

import numpy as np

PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"
DEC, ENC = "[DEC]", "[ENC]"


def _is_punct(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F
    )


class BertWordPieceTokenizer:
    def __init__(self, vocab_path: Optional[str] = None,
                 vocab: Optional[Dict[str, int]] = None,
                 lowercase: bool = True):
        if vocab is None:
            vocab = {}
            with open(vocab_path, encoding="utf-8") as f:
                for i, line in enumerate(f):
                    vocab[line.rstrip("\n")] = i
        self.vocab = dict(vocab)
        # reference appends [DEC] then [ENC] as added special tokens
        for tok in (DEC, ENC):
            if tok not in self.vocab:
                self.vocab[tok] = len(self.vocab)
        self.ids_to_tokens = {i: t for t, i in self.vocab.items()}
        self.lowercase = lowercase
        self.pad_token_id = self.vocab[PAD]
        self.unk_token_id = self.vocab[UNK]
        self.cls_token_id = self.vocab[CLS]
        self.sep_token_id = self.vocab[SEP]
        self.bos_token_id = self.vocab[DEC]  # reference bos = [DEC]
        self.enc_token_id = self.vocab[ENC]
        self.special_ids = {
            self.pad_token_id, self.cls_token_id, self.sep_token_id,
            self.bos_token_id, self.enc_token_id, self.vocab.get(MASK, -1),
        }

    # -- basic tokenization ------------------------------------------------
    def _basic(self, text: str) -> List[str]:
        out = []
        buf = []
        text = unicodedata.normalize("NFC", text)
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or unicodedata.category(ch) in ("Cc", "Cf"):
                if ch not in ("\t", "\n", "\r"):
                    continue
            if ch.isspace():
                if buf:
                    out.append("".join(buf))
                    buf = []
                continue
            if _is_cjk(cp) or _is_punct(ch):
                if buf:
                    out.append("".join(buf))
                    buf = []
                out.append(ch)
                continue
            buf.append(ch)
        if buf:
            out.append("".join(buf))
        if self.lowercase:
            norm = []
            for t in out:
                t = t.lower()
                t = unicodedata.normalize("NFD", t)
                t = "".join(c for c in t if unicodedata.category(c) != "Mn")
                if t:
                    norm.append(t)
            out = norm
        return out

    def _wordpiece(self, word: str) -> List[str]:
        if len(word) > 100:
            return [UNK]
        pieces, start = [], 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [UNK]
            pieces.append(cur)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        out = []
        for word in self._basic(text):
            out.extend(self._wordpiece(word))
        return out

    def encode(self, text: str, max_length: Optional[int] = None) -> List[int]:
        """[CLS] tokens [SEP], truncated to max_length like HF
        (truncation keeps [SEP] at the end)."""
        ids = [self.vocab.get(t, self.unk_token_id) for t in self.tokenize(text)]
        if max_length is not None and len(ids) > max_length - 2:
            ids = ids[: max_length - 2]
        return [self.cls_token_id] + ids + [self.sep_token_id]

    def __call__(
        self,
        texts: Sequence[str],
        *,
        padding: str = "longest",  # 'longest' | 'max_length'
        max_length: Optional[int] = None,
        pad_to_multiple_of: Optional[int] = None,
    ):
        """Batch encode -> dict(input_ids [B,N] int32, attention_mask [B,N]).
        Mirrors the reference's tokenizer(...) call sites
        (padding='longest'/'max_length', truncation, max_length)."""
        encoded = [self.encode(t, max_length) for t in texts]
        if padding == "max_length":
            if max_length is None:
                raise ValueError('padding="max_length" needs max_length')
            N = max_length
        else:
            N = max(len(e) for e in encoded)
        if pad_to_multiple_of:
            N = ((N + pad_to_multiple_of - 1) // pad_to_multiple_of) * pad_to_multiple_of
        B = len(encoded)
        ids = np.full((B, N), self.pad_token_id, np.int32)
        mask = np.zeros((B, N), np.int32)
        for i, e in enumerate(encoded):
            e = e[:N]
            ids[i, : len(e)] = e
            mask[i, : len(e)] = 1
        return {"input_ids": ids, "attention_mask": mask}

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        toks = []
        for i in ids:
            i = int(i)
            if skip_special_tokens and i in self.special_ids:
                continue
            toks.append(self.ids_to_tokens.get(i, UNK))
        text = " ".join(toks).replace(" ##", "")
        return text.strip()

    @staticmethod
    def toy(words: Sequence[str]) -> "BertWordPieceTokenizer":
        """Small synthetic vocab for tests."""
        vocab = {t: i for i, t in enumerate(
            [PAD, UNK, CLS, SEP, MASK] + list(words)
        )}
        return BertWordPieceTokenizer(vocab=vocab)
