"""Host seconds of the set-up's CUDA-graph warm-ups and captures
(``CapturedStep.capture_seconds``)."""

LAYER, UNIT, SOURCE, MOVES = "captured steps", "s", "program_counter", "setup_s"


def read(run):
    return run.readings.get("graph_capture_s")
