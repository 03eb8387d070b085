"""Host time of the train step's optimizer phase, averaged over the traced
steps: the self time of the program's span ``optimizer`` inside the step's
``dispatch`` (``train/loops.py`` ``_optimize``: ``optimizer.step()``, the
AdamW update)."""

import statistics

from madtp_tpu_torch.utils import profiling

LAYER, UNIT, SOURCE, MOVES = "train loop", "ms", "program_span", "train_samples_per_s"


def read(run):
    ms = profiling.span_ms("optimizer", self_time=True) if hasattr(profiling, "span_ms") else []
    return statistics.fmean(ms) if ms else None
