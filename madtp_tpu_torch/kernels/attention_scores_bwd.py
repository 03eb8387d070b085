"""K2: the backward of K1, as a CUDA kernel for Hopper.

Replaces ``madtp_tpu/ops/pallas/fused_attention.py``
``fused_attention_scores_bwd``.  The source, its design and its bound are in
``csrc/attention_scores_bwd.cu``.  The plain PyTorch version of the same
function is :func:`madtp_tpu_torch.ops.attention.attention_scores_bwd_plain`;
:class:`madtp_tpu_torch.ops.attention.ScoringAttention` pairs this kernel with
K1 for autograd.
"""

from __future__ import annotations

import ctypes

import torch

from madtp_tpu_torch.kernels.attention_scores import _DTYPES, _check

SOURCE = "attention_scores_bwd.cu"
MAX_HEADS = 16  # the head-max tie mask is 16 bits per (query, key)

# (rtol, atol) of K2 against the plain version on the same inputs, per output.
# float32: the JAX package's own backward tolerance (tests/test_pallas.py:90-96);
# both compute in fp32 and differ in summation order and in K2's dq, formed as
# scale * (sum_j P dp k - D sum_j P k).  Where the two largest head
# probabilities of a (query, key) agree to the last bits, the head max's
# gradient may go to another head than the plain version's: the comparison
# leaves those rows out (chip_smoke.py `compare_k2`).
# bfloat16: the plain version rounds P to bf16 before P.v and rounds
# dP = dout.v^T and dv to bf16 in its bf16 matmuls (2^-9 relative each, |dP|
# ~ 8 at unit cotangents); K2 keeps them in fp32 and rounds once at the store.
# Gradients of order 0.1-1 take an absolute floor of 2e-2; dbias sums H heads
# of dlog, each with that dP rounding, and takes 1e-1 (the plain bf16 dbias is
# 0.05 from its fp32 self at the text shape, B=4 N=40, on the CPU).
_F32 = (1e-3, 2e-4)
TOLERANCES = {
    torch.float32: {"dq": _F32, "dk": _F32, "dv": _F32, "dbias": _F32},
    torch.bfloat16: {"dq": (5e-2, 2e-2), "dk": (5e-2, 2e-2), "dv": (5e-2, 2e-2),
                     "dbias": (5e-2, 1e-1)},
}


def _load():
    from madtp_tpu_torch.kernels.build import build

    fn = build(SOURCE).lib.k2_attention_scores_bwd
    if fn.argtypes is None:
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [i32, p, p, p, i64, i64] + [p] * 19 + [i32, i32, i32, i32,
                                                            ctypes.c_float, p]
        fn.restype = i32
    return fn


def _check_bwd(q, out, stats, d_out, d_cls, d_col):
    B, N, H, Dh = q.shape
    if H > MAX_HEADS:
        raise ValueError(f"attention_scores_bwd_cuda takes at most {MAX_HEADS} heads, got {H}")
    for name, t in (("out", out), ("d_out", d_out)):
        if t.shape != (B, N, H * Dh) or t.dtype != q.dtype or not t.is_contiguous() \
                or t.device != q.device:
            raise ValueError(f"{name} must be a contiguous [B, N, H*Dh] tensor in q's "
                             f"dtype on q's device")
    if stats.shape != (3, B, H, N) or stats.dtype != torch.float32 \
            or not stats.is_contiguous() or stats.device != q.device:
        raise ValueError("stats must be K1's contiguous float32 [3, B, H, N] row statistics")
    for name, t in (("d_cls", d_cls), ("d_col", d_col)):
        if t.shape != (B, N - 1) or t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != q.device:
            raise ValueError(f"{name} must be a contiguous float32 [B, N-1] tensor on "
                             f"q's device")


def attention_scores_bwd_cuda(q, k, v, key_alive, key_bias, scale: float, out, stats,
                              d_out, d_cls, d_col):
    """Launch K2 on K1's inputs, its ``out`` and its row statistics
    (``attention_scores_cuda(..., return_stats=True)``) and the cotangents
    ``d_out`` [B, N, H*Dh] (q's dtype), ``d_cls`` and ``d_col`` fp32
    [B, N-1].

    Returns ``(dq, dk, dv, dbias)``: ``dq, dk, dv`` contiguous
    [B, N, H, 64] in q's dtype (accumulated in fp32), ``dbias`` fp32
    [B, N].  Raises on any input the kernel does not take; it never falls
    back."""
    _check(q, k, v, key_alive, key_bias, who="attention_scores_bwd_cuda")
    _check_bwd(q, out, stats, d_out, d_cls, d_col)
    fn = _load()
    B, N, H, Dh = q.shape
    dev = q.device
    f32 = dict(dtype=torch.float32, device=dev)
    ismax = torch.empty((B, N, N), dtype=torch.int16, device=dev)  # head-max bits
    clsrow, drow, dbias_h = (torch.empty((B, H, N), **f32) for _ in range(3))
    ssum, csum, dbias = (torch.empty((B, N), **f32) for _ in range(3))
    dq, dk, dv = (torch.empty((B, N, H, Dh), dtype=q.dtype, device=dev) for _ in range(3))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 q.stride(0), q.stride(1), key_alive.data_ptr(), key_bias.data_ptr(),
                 stats[0].data_ptr(), stats[1].data_ptr(), stats[2].data_ptr(),
                 out.data_ptr(), d_out.data_ptr(), d_cls.data_ptr(), d_col.data_ptr(),
                 ismax.data_ptr(), clsrow.data_ptr(), ssum.data_ptr(), csum.data_ptr(),
                 drow.data_ptr(), dbias_h.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), dbias.data_ptr(), B, N, H, Dh, float(scale), stream)
    if err != 0:
        raise RuntimeError(f"K2 launch failed with cudaError_t {err}")
    attention_scores_bwd_cuda.launches += 1
    return dq, dk, dv, dbias


attention_scores_bwd_cuda.launches = 0
