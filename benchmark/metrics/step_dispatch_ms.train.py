"""Host time of one train step's call, until it returns, averaged over the
window's steps: the harness's own span around the step it hands to
``train_epoch``."""

LAYER, UNIT, SOURCE, MOVES = "train loop", "ms", "program_span", "train_samples_per_s"


def read(run):
    return run.readings.get("dispatch_ms")
