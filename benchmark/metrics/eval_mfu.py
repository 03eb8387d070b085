"""The NLVR eval step's share of the card's fp32 peak: the operations of the
traced stretch's batches (the frozen FLOP count on the kept counts the timed
path returned) over the stretch's wall time and the fp32 step peak
(3xTF32, :data:`benchmark.roofline.STEP_PEAK_FP32`)."""

from benchmark.readings import step_mfu

LAYER, UNIT, SOURCE, MOVES = "model step", "%", "program_counter", "eval_samples_per_s"


def read(run):
    return step_mfu(run)
