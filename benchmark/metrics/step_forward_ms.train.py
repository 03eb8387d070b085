"""Host time of the train step's forward phase, averaged over the traced
steps: the self time of the program's span ``forward`` inside the step's
``dispatch`` (``train/loops.py`` ``_optimize``: the loss function, the
towers, the head and both losses)."""

import statistics

from madtp_tpu_torch.utils import profiling

LAYER, UNIT, SOURCE, MOVES = "train loop", "ms", "program_span", "train_samples_per_s"


def read(run):
    ms = profiling.span_ms("forward", self_time=True) if hasattr(profiling, "span_ms") else []
    return statistics.fmean(ms) if ms else None
