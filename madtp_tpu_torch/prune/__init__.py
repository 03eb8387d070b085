"""DTP: the MAG query, the pruning and merging, calibration, FLOPs.
``sparsemax`` is exported here, as the JAX package exports it."""

from madtp_tpu_torch.prune.sparsemax import sparsemax  # noqa: F401
