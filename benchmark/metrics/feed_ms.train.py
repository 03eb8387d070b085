"""Host time of a train step's upload, averaged over the traced steps: the
program's outermost span ``feed`` (``tasks/nlvr.py`` ``train_epoch``: the
batch's ``_device_batch`` and its targets' copy)."""

import statistics

from madtp_tpu_torch.utils import profiling

LAYER, UNIT, SOURCE, MOVES = "train loop", "ms", "program_span", "train_samples_per_s"


def read(run):
    ms = profiling.span_ms("feed") if hasattr(profiling, "span_ms") else []
    return statistics.fmean(ms) if ms else None
