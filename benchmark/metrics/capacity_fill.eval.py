"""The share of the gather buffers' slots that hold a token in the NLVR
eval: the CLS, kept and merged tokens summed over the ViT's layers and the
window's images, over the layers' capacities (the padding gather mode
carries)."""

from benchmark.readings import capacity_fill

LAYER, UNIT, SOURCE, MOVES = "DTP", "%", "program_counter", "eval_samples_per_s"


def read(run):
    return capacity_fill(run)
