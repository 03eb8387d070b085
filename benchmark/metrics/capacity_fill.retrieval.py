"""The share of the vision tower's gather buffer slots that hold a token in
the retrieval passes: the CLS, kept and merged tokens summed over the
layers and the window's images, over the layers' capacities."""

from benchmark.readings import capacity_fill

LAYER, UNIT, SOURCE, MOVES = "DTP", "%", "program_counter", "retrieval_images_per_s"


def read(run):
    return capacity_fill(run)
