"""Host time of a pass's ranking in the CLIP retrieval eval: the program's
span ``rank`` (``eval/metrics.py`` ``itm_eval`` over the similarities in
both directions), averaged over the traced passes."""

import statistics

from madtp_tpu_torch.utils import profiling

LAYER, UNIT, SOURCE, MOVES = "eval loops", "ms", "program_span", "retrieval_images_per_s"


def read(run):
    ms = profiling.span_ms("rank") if hasattr(profiling, "span_ms") else []
    return statistics.fmean(ms) if ms else None
