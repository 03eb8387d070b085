"""Host time of a batch's upload in the NLVR eval, averaged over the traced
stretch: the program's span ``feed`` (``tasks/nlvr.py`` ``_device_batch``:
the sentences' ids, the two images' concatenation and the copies to the
card)."""

import statistics

from madtp_tpu_torch.utils import profiling

LAYER, UNIT, SOURCE, MOVES = "eval loops", "ms", "program_span", "eval_samples_per_s"


def read(run):
    ms = profiling.span_ms("feed") if hasattr(profiling, "span_ms") else []
    return statistics.fmean(ms) if ms else None
