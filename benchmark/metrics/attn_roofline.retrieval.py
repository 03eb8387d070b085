"""Kernel K1's share of its roofline in the retrieval pass: the least time of
the vision tower's launches in the traced pass (the frozen ``k1_work`` at
the kept counts each layer had, on the CUDA cores' fp32 peak) over the
device time of the kernels named here."""

from benchmark.readings import attention_roofline
from benchmark.roofline import PEAK_FP32_CUDA_CORES, k1_work

LAYER, UNIT, SOURCE, MOVES = "kernels", "%", "device_trace", "retrieval_images_per_s"
# K1's kernels (madtp_tpu_torch/csrc/attention_scores.cu), K3's range included
KERNELS = ("::k1_fwd", "::k1_scores", "::k1_colsum", "::k1_fwd_simt", "::k1_scores_simt")


def read(run):
    return attention_roofline(run, k1_work, PEAK_FP32_CUDA_CORES, KERNELS)
