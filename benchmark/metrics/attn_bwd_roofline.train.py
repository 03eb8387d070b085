"""Kernel K2's share of its roofline in the train step: the least time its
launches in the traced steps could take (the frozen ``k2_work`` at the
probe's kept counts, on the 3xTF32 rate at which K2 multiplies fp32) over
the device time of the kernels named here."""

from benchmark.readings import attention_roofline
from benchmark.roofline import TF32X3, k2_work

LAYER, UNIT, SOURCE, MOVES = "kernels", "%", "device_trace", "train_samples_per_s"
# K2's kernels (madtp_tpu_torch/csrc/attention_scores_bwd.cu)
KERNELS = ("::k2_heads", "::k2_prep", "::k2_dq", "::k2_dkv", "::k2_dbias")


def read(run):
    return attention_roofline(run, k2_work, TF32X3, KERNELS)
