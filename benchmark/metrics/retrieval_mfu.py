"""The retrieval pass's share of the card's fp32 peak: the operations of the
traced pass's image and caption batches (the frozen FLOP count on the kept
counts the towers returned, each tower once) over the pass's wall time and
the fp32 step peak (3xTF32)."""

from benchmark.readings import step_mfu

LAYER, UNIT, SOURCE, MOVES = "model step", "%", "program_counter", "retrieval_images_per_s"


def read(run):
    return step_mfu(run)
