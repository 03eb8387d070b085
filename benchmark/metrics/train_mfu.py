"""The train step's share of the card's fp32 peak: three times the forward's
operations (the frozen FLOP count on the probe's kept counts at the same
temperature, as the step returns none) for each traced step, over the
stretch's wall time and the fp32 step peak (3xTF32)."""

from benchmark.readings import step_mfu

LAYER, UNIT, SOURCE, MOVES = "model step", "%", "program_counter", "train_samples_per_s"


def read(run):
    return step_mfu(run, passes=3)
