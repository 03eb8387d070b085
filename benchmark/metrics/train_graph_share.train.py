"""The share of the traced train steps that replayed a CUDA graph: the
program's counter ``graph.replay`` of the step ``nlvr_train``
(``utils/graph.py`` ``CapturedStep``) over the mix's ``trace_steps``.  A
step that captured its graph counts ``graph.capture`` instead; a program
that counts neither reads None."""

from madtp_tpu_torch.utils import profiling

LAYER, UNIT, SOURCE, MOVES = "train loop", "%", "program_counter", "train_samples_per_s"
STEP = "nlvr_train"


def read(run):
    held = profiling.records() if hasattr(profiling, "records") else []
    graphs = [r["name"] for r in held if r["kind"] == "count" and r["value"] == STEP
              and r["name"] in ("graph.replay", "graph.capture")]
    if not graphs:
        return None
    return 100.0 * graphs.count("graph.replay") / run.cell.mix["trace_steps"]
