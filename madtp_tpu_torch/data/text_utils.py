"""Text preprocessing and the result file (counterpart of
``madtp_tpu/data/text_utils.py:12-55``), single process."""

from __future__ import annotations

import json
import os
import re
from typing import List


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
    """Write ``<filename>_rank0.json`` and the final ``<filename>.json``,
    keeping the first entry of each ``remove_duplicate`` key, as the JAX
    package does for one process.  Returns the final file's path."""
    os.makedirs(result_dir, exist_ok=True)
    with open(os.path.join(result_dir, f"{filename}_rank0.json"), "w") as f:
        json.dump(result, f)
    merged = list(result)
    if remove_duplicate:
        seen, merged = set(), []
        for res in result:
            if res[remove_duplicate] not in seen:
                seen.add(res[remove_duplicate])
                merged.append(res)
    final = os.path.join(result_dir, f"{filename}.json")
    with open(final, "w") as f:
        json.dump(merged, f)
    return final
