"""Host time of a captured step's call in the NLVR eval, until it returns,
averaged over the traced stretch: the program's span ``dispatch``
(``utils/graph.py`` ``CapturedStep``: the inputs' copies into the graph's
buffers, the replay and the outputs' clones)."""

import statistics

from madtp_tpu_torch.utils import profiling

LAYER, UNIT, SOURCE, MOVES = "captured steps", "ms", "program_span", "eval_batch_p90_ms"


def read(run):
    ms = profiling.span_ms("dispatch") if hasattr(profiling, "span_ms") else []
    return statistics.fmean(ms) if ms else None
