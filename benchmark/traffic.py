"""Traffic from a mix's parameters and the seed.  The sizes a mix draws
(sentence lengths, caption lengths) come from the mix's own ``sizes_seed``,
the same for every run; the run's seed draws the content (pixels, token
ids, labels) and the order of the batches, so every seed does the same
work in another order.

* :func:`nlvr_text_lengths` is a frozen copy of ``chip_smoke.py:1734-1739``
  (NLVR2's sentence lengths in wordpieces, after Suhr et al. 2019);
* :func:`clip_captions` follows ``clip_corpus`` (``chip_smoke.py:2616-2633``,
  after ``tools/bench_clip.py:45-49``): random ids, the end-of-text id ending
  a length drawn in a range, zeros after.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

CLS_ID, SEP_ID = 101, 102  # BERT's [CLS] and [SEP]


def nlvr_text_lengths(rng, n, mean=19.0, std=6.5, lo=6, hi=64):
    """Sentence lengths in wordpieces with [CLS] and [SEP]: about 19 (NLVR2's
    sentences average 14.8 words at about 1.15 wordpieces a word), spread
    6.5, in [6, 64]."""
    return np.clip(np.rint(rng.normal(mean, std, size=n)), lo, hi).astype(np.int64)


def host_images(n: int, size: int, gen: torch.Generator, device, chunk: int = 32) -> np.ndarray:
    """``n`` normalized fp32 images [n, 3, size, size] in host memory, drawn
    N(0, 1) on ``device`` in chunks and copied back."""
    out = np.empty((n, 3, size, size), dtype=np.float32)
    for i in range(0, n, chunk):
        m = min(chunk, n - i)
        out[i:i + m] = torch.randn((m, 3, size, size), generator=gen, device=device).cpu().numpy()
    return out


class NLVRBatch(NamedTuple):
    image0: np.ndarray  # [B, 3, H, W] fp32
    image1: np.ndarray
    ids: np.ndarray  # [B, N] int64, [CLS] ... [SEP] then 0, N the batch's longest
    mask: np.ndarray  # [B, N] int64
    targets: np.ndarray  # [B]


def nlvr_batches(mix: dict, model_cfg: dict, seed: int, device) -> List[NLVRBatch]:
    """``mix["pool_batches"]`` batches of ``mix["pairs_per_batch"]`` pairs,
    each padded to its longest sentence (``padding="longest"``)."""
    B, nb = mix["pairs_per_batch"], mix["pool_batches"]
    lens = mix["text_lengths"]
    sizes = np.random.default_rng(mix["sizes_seed"])
    lengths = [nlvr_text_lengths(sizes, B, lens["mean"], lens["std"], lens["min"], lens["max"])
               for _ in range(nb)]
    rng = np.random.default_rng(seed)
    order = rng.permutation(nb)
    gen = torch.Generator(device=device).manual_seed(seed)
    size = model_cfg["vit"]["image_size"]
    vocab = model_cfg["med"]["vocab_size"]
    word_lo = mix["word_ids"][0]
    word_hi = min(mix["word_ids"][1], vocab)
    out = []
    for j in order:
        length = rng.permutation(lengths[j])
        N = int(length.max())
        pos = np.arange(N)[None, :]
        ids = np.where(pos < length[:, None], rng.integers(word_lo, word_hi, size=(B, N)), 0)
        ids[:, 0] = CLS_ID
        ids[np.arange(B), length - 1] = SEP_ID
        mask = (pos < length[:, None]).astype(np.int64)
        images = host_images(2 * B, size, gen, device)
        out.append(NLVRBatch(images[:B], images[B:], ids.astype(np.int64), mask,
                             rng.integers(0, 2, size=B)))
    return out


def clip_captions(mix: dict, model_cfg: dict, seed: int) -> np.ndarray:
    """``images * texts_per_image`` captions [n, context_length]: lengths
    from the mix's ``sizes_seed`` in ``caption_lengths`` (half-open), their
    order and ids from the run's seed."""
    n = mix["images"] * mix["texts_per_image"]
    C = model_cfg["context_length"]
    lo, hi = mix["caption_lengths"]
    lengths = np.random.default_rng(mix["sizes_seed"]).integers(lo, hi, size=n)
    rng = np.random.default_rng(seed)
    lengths = rng.permutation(lengths)
    ids = rng.integers(mix["token_ids"][0], mix["token_ids"][1], size=(n, C))
    text = np.where(np.arange(C)[None, :] < lengths[:, None], ids, 0)
    text[np.arange(n), lengths - 1] = model_cfg["vocab_size"] - 1  # end-of-text, the highest id
    return text.astype(np.int64)
