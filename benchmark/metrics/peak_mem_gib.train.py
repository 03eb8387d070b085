"""The allocator's peak over the window (``max_memory_allocated`` after a
reset at its start), GiB."""

LAYER, UNIT, SOURCE, MOVES = "device", "GiB", "program_counter", "train_samples_per_s"


def read(run):
    return run.readings.get("peak_mem_gib")
