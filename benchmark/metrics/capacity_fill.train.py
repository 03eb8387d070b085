"""The share of the gather buffers' slots that hold a token in the traced
train steps: ``capacity_fill.eval``'s arithmetic (the CLS and kept tokens
over the ViT's layers, over the slots of their capacities) on each step's
own kept counts, the program's counter ``kept.vision``."""

import statistics

from benchmark.readings import vit_slots
from madtp_tpu_torch.utils import profiling

LAYER, UNIT, SOURCE, MOVES = "DTP", "%", "program_counter", "train_samples_per_s"


def read(run):
    held = profiling.records() if hasattr(profiling, "records") else []
    kept = [r["value"] for r in held if r["kind"] == "count" and r["name"] == "kept.vision"]
    if not kept:
        return None
    slots = sum(vit_slots(run.cell.config, run.readings["capacities"]["vision"]))
    return 100.0 * statistics.fmean(sum(k + 1 for k in v) for v in kept) / slots
