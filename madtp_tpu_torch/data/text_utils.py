"""Text preprocessing and the result file (counterpart of
``madtp_tpu/data/text_utils.py:12-60``): per-rank files merged by rank 0."""

from __future__ import annotations

import json
import os
import re
from typing import List

from madtp_tpu_torch.parallel import dist


def pre_caption(caption: str, max_words: int = 50) -> str:
    caption = re.sub(r"([.!\"()*#:;~])", " ", caption.lower())
    caption = re.sub(r"\s{2,}", " ", caption)
    caption = caption.rstrip("\n").strip(" ")
    words = caption.split(" ")
    if len(words) > max_words:
        caption = " ".join(words[:max_words])
    return caption


def pre_question(question: str, max_ques_words: int = 50) -> str:
    question = re.sub(r"([.!\"()*#:;~])", "", question.lower())
    question = question.rstrip(" ")
    words = question.split(" ")
    if len(words) > max_ques_words:
        question = " ".join(words[:max_ques_words])
    return question


def save_result(result: List[dict], result_dir: str, filename: str,
                remove_duplicate: str = "") -> str:
    """Write this rank's ``<filename>_rank<r>.json``; after a barrier, rank 0
    merges every rank's file in rank order into ``<filename>.json``, keeping
    the first entry of each ``remove_duplicate`` key (the loaders pad the
    last shards with repeated samples), as the JAX package does.  Returns
    the final file's path (written by rank 0 only)."""
    rank, world = dist.process_index(), dist.process_count()
    os.makedirs(result_dir, exist_ok=True)
    with open(os.path.join(result_dir, f"{filename}_rank{rank}.json"), "w") as f:
        json.dump(result, f)
    dist.barrier("save_result")
    final = os.path.join(result_dir, f"{filename}.json")
    if rank != 0:
        return final
    merged = []
    for r in range(world):
        with open(os.path.join(result_dir, f"{filename}_rank{r}.json")) as f:
            merged += json.load(f)
    if remove_duplicate:
        seen, out = set(), []
        for res in merged:
            if res[remove_duplicate] not in seen:
                seen.add(res[remove_duplicate])
                out.append(res)
        merged = out
    with open(final, "w") as f:
        json.dump(merged, f)
    return final
