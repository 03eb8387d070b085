"""The share of the traced stretch in which no kernel, copy or set ran on
the card."""

from benchmark.readings import idle_pct

LAYER, UNIT, SOURCE, MOVES = "device", "%", "device_trace", "retrieval_images_per_s"


def read(run):
    return idle_pct(run)
