"""CUDA graphs captured inside the window (``CapturedStep.captures``): a
capture there is a shape the set-up did not warm."""

LAYER, UNIT, SOURCE, MOVES = "captured steps", "count", "program_counter", "eval_batch_p90_ms"


def read(run):
    return run.readings.get("graph_captures")
