"""Retrieval metrics (copy of ``madtp_tpu/eval/metrics.py:11-62``, the
behaviour of the reference ``compress_retrieval_dtp.py:209-254`` itm_eval)."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from madtp_tpu_torch.utils import profiling


def _rank_of_columns(scores: np.ndarray) -> np.ndarray:
    """rank[q, c] = zero-based position of candidate ``c`` in row ``q``'s
    descending-score ordering (one stable argsort per matrix)."""
    n_q, n_c = scores.shape
    order = np.argsort(-scores, axis=1, kind="stable")
    rank = np.empty((n_q, n_c), dtype=np.int64)
    np.put_along_axis(rank, order, np.broadcast_to(np.arange(n_c), (n_q, n_c)), axis=1)
    return rank


def _recall_triplet(best_rank: np.ndarray) -> tuple:
    return tuple(float(100.0 * np.mean(best_rank < k)) for k in (1, 5, 10))


def itm_eval(scores_i2t: np.ndarray, scores_t2i: np.ndarray, txt2img: Sequence[int],
             img2txt: Sequence[Sequence[int]]) -> Dict[str, float]:
    """Recall@{1,5,10} in both directions and their means: the rank of the
    best-ranked ground truth per query.  ``scores_i2t`` [n_images, n_texts],
    ``scores_t2i`` [n_texts, n_images]; ``txt2img[t]`` is text t's image,
    ``img2txt[i]`` image i's texts.  The span ``rank``."""
    with profiling.span("rank"):
        i2t_rank = _rank_of_columns(np.asarray(scores_i2t, dtype=np.float64))
        n_images = i2t_rank.shape[0]
        q_idx = np.concatenate(
            [np.full(len(img2txt[i]), i, dtype=np.int64) for i in range(n_images)])
        t_idx = np.concatenate(
            [np.asarray(list(img2txt[i]), dtype=np.int64) for i in range(n_images)])
        best_txt_rank = np.full(n_images, np.iinfo(np.int64).max, dtype=np.int64)
        np.minimum.at(best_txt_rank, q_idx, i2t_rank[q_idx, t_idx])

        t2i_rank = _rank_of_columns(np.asarray(scores_t2i, dtype=np.float64))
        n_texts = t2i_rank.shape[0]
        gt_img = np.asarray([txt2img[t] for t in range(n_texts)], dtype=np.int64)
        img_rank = t2i_rank[np.arange(n_texts), gt_img]

        tr1, tr5, tr10 = _recall_triplet(best_txt_rank)
        ir1, ir5, ir10 = _recall_triplet(img_rank)
        tr_mean = (tr1 + tr5 + tr10) / 3
        ir_mean = (ir1 + ir5 + ir10) / 3
        return {
            "txt_r1": tr1, "txt_r5": tr5, "txt_r10": tr10,
            "img_r1": ir1, "img_r5": ir5, "img_r10": ir10,
            "txt_r_mean": tr_mean, "img_r_mean": ir_mean,
            "r_mean": (tr_mean + ir_mean) / 2,
        }
