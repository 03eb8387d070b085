"""Peaks of the card and the least time a kernel could take: a frozen copy
of ``chip_smoke.py:345-347`` (``MEM_RATE``, ``PEAK``, ``TF32X3``),
``:428-452`` (``k1_work``, ``k2_work``) and ``:727-731`` (``bound``), the
two work functions taking shapes instead of the kernels' tensors.

Peaks are NVIDIA's data sheet for the H100 SXM at its 700 W limit (dense,
no sparsity).  The fp32 peak of a step is taken as 3xTF32 on the tensor
cores (495 / 3 TFLOP/s), the fastest way an fp32-faithful product runs on
the card (kernel K2 multiplies that way), so that no fp32 step can read
above 100%; the CUDA cores' 67 TFLOP/s, which the port's plain fp32 GEMMs
and its other kernels use, is kept beside it."""

from __future__ import annotations

MEM_RATE = 3.35e12  # HBM3, bytes/s
PEAK_BF16 = 989e12
PEAK_FP32_CUDA_CORES = 67e12
TF32X3 = 495e12 / 3  # fp32 as three TF32 products on the tensor cores
STEP_PEAK_FP32 = TF32X3


def k1_work(B: int, N: int, H: int, Dh: int, alive_keys: int, el: int = 4):
    """(flops, bytes) of the scoring attention over a [B, N] buffer whose
    rows hold ``alive_keys`` alive slots in all: 4 Dh flops per (head, query,
    alive key) for q k^T and P v; q, k, v, alive, bias read once, out,
    col_mass, cls_attn written once."""
    flops = 4.0 * H * Dh * N * alive_keys
    nbytes = (3 * B * N * H * Dh * el + B * N + B * N * 4
              + B * N * H * Dh * el + 2 * B * N * 4)
    return flops, nbytes


def k2_work(B: int, N: int, H: int, Dh: int, alive_keys: int, el: int = 4):
    """(flops, bytes) of its backward: one q k^T recompute and four gradient
    products, 10 Dh flops per (head, query, alive key); q, k, v, alive,
    bias, dout, dcls, dcol read once, dq, dk, dv, dbias written once."""
    flops = 10.0 * H * Dh * N * alive_keys
    nbytes = (4 * B * N * H * Dh * el + B * N + B * N * 4 + 2 * B * (N - 1) * 4
              + 3 * B * N * H * Dh * el + B * N * 4)
    return flops, nbytes


def bound_s(flops: float, nbytes: float, peak: float) -> float:
    """The least time the card could take, seconds: the larger of the
    operations over ``peak`` and the bytes over the memory rate."""
    return max(flops / peak, nbytes / MEM_RATE)
