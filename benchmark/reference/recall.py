"""Retrieval recall from a similarity matrix: for each image, the best rank
of its captions among all captions; for each caption, the rank of its image
among all images (ties to the lower index); Recall@1/5/10 in percent, each
direction's mean and their mean (the metric of BLIP's ``itm_eval``)."""

from __future__ import annotations

import numpy as np


def _ranks(scores):
    order = np.argsort(-scores, axis=1, kind="stable")
    rank = np.empty_like(order)
    np.put_along_axis(rank, order, np.arange(scores.shape[1])[None, :].repeat(len(scores), 0),
                      axis=1)
    return rank


def recalls(sims: np.ndarray, txt2img, img2txt) -> dict:
    """``sims`` [n_images, n_texts]."""
    i2t = _ranks(sims)
    best = np.array([i2t[i, list(ts)].min() for i, ts in enumerate(img2txt)])
    t2i = _ranks(sims.T)
    gt = t2i[np.arange(sims.shape[1]), np.asarray(txt2img)]
    out = {}
    for side, r in (("txt", best), ("img", gt)):
        vals = [100.0 * float(np.mean(r < k)) for k in (1, 5, 10)]
        out.update({f"{side}_r{k}": v for k, v in zip((1, 5, 10), vals)})
        out[f"{side}_r_mean"] = sum(vals) / 3
    out["r_mean"] = (out["txt_r_mean"] + out["img_r_mean"]) / 2
    return out
