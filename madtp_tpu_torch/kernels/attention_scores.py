"""K1: attention with the DTP scoring outputs, as a CUDA kernel for Hopper.

Replaces ``madtp_tpu/ops/pallas/fused_attention.py`` ``fused_attention_scores``.
The source, its design and its bound are in ``csrc/attention_scores.cu``.  The
plain PyTorch version of the same function is
:func:`madtp_tpu_torch.ops.attention.attention_scores_plain`;
:func:`madtp_tpu_torch.ops.attention.attention_scores` picks between the two
by the device of its inputs.
"""

from __future__ import annotations

import ctypes

import torch

SOURCE = "attention_scores.cu"
HEAD_DIM = 64  # the one head width the kernel is built for
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# (rtol, atol) of K1 against the plain version on the same inputs.
# float32: both compute logits, probabilities and sums in fp32 and differ only
# in summation order.  bfloat16: the logits are still fp32 sums of exact
# products of the same bf16 values, so col_mass stays close; out differs by
# rounding (the plain version rounds P to bf16 before P.v, K1 keeps P in fp32,
# both round out to bf16: up to ~2^-8 of |v| per row); cls_attn differs
# because K1 takes r_h = ||out_h|| in fp32, as the TPU kernel does, while the
# plain version takes it from out rounded to bf16 (2^-9 relative per value).
TOLERANCES = {
    torch.float32: {"out": (1e-5, 1e-5), "col_mass": (1e-5, 1e-5),
                    "cls_attn": (1e-5, 1e-5)},
    torch.bfloat16: {"out": (2e-2, 2e-2), "col_mass": (1e-4, 1e-4),
                     "cls_attn": (1e-2, 1e-5)},
}


def _load():
    from madtp_tpu_torch.kernels.build import build

    lib = build(SOURCE).lib
    fn = lib.k1_attention_scores
    if fn.argtypes is None:
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [i32, p, p, p, i64, i64, p, p, p, p, p, p, p, p,
                       i32, i32, i32, i32, ctypes.c_float, p]
        fn.restype = i32
    return fn


def _check(q, k, v, key_alive, key_bias, who="attention_scores_cuda"):
    if not q.is_cuda:
        raise ValueError(f"{who} needs CUDA tensors, got {q.device}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"{who} takes float32 or bfloat16, got {q.dtype}")
    if q.dim() != 4:
        raise ValueError(f"q must be [B, N, H, Dh], got shape {tuple(q.shape)}")
    B, N, H, Dh = q.shape
    if Dh != HEAD_DIM or N < 2:
        raise ValueError(f"{who} needs Dh == {HEAD_DIM} and N >= 2, "
                         f"got shape {tuple(q.shape)}")
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q in shape, dtype and device")
        if t.stride() != q.stride():
            raise ValueError("q, k and v must share their strides")
    if q.stride(3) != 1 or q.stride(2) != Dh:
        raise ValueError("q, k, v need contiguous [H, Dh] rows (a view of a "
                         "[B, N, H*Dh] or packed qkv tensor)")
    if key_alive.dtype != torch.bool or key_alive.shape != (B, N) \
            or not key_alive.is_contiguous() or key_alive.device != q.device:
        raise ValueError("key_alive must be a contiguous bool [B, N] tensor on q's device")
    if key_bias.dtype != torch.float32 or key_bias.shape != (B, N) \
            or not key_bias.is_contiguous() or key_bias.device != q.device:
        raise ValueError("key_bias must be a contiguous float32 [B, N] tensor on q's device")


def attention_scores_cuda(q, k, v, key_alive, key_bias, scale: float, *,
                          return_stats: bool = False):
    """Launch K1.  ``q, k, v``: [B, N, H, 64] float32 or bfloat16 views with
    contiguous heads; ``key_alive`` bool [B, N]; ``key_bias`` float32 [B, N].

    Returns ``(out [B, N, H*Dh] in q's dtype, cls_attn [B, N-1],
    col_mass [B, N-1])`` (fp32 scores over slots 1..N-1), like
    ``attention_scores_plain``; with ``return_stats`` also the row
    statistics K2 reads, fp32 [3, B, H, N]: the max of the scaled, biased
    logits over alive keys (0 for a row with none), the sum of exp, and the
    fp32 norm of the row of out.  Raises on any input the kernel does not
    take, and on an input that needs a gradient while grad mode is on: the
    outputs carry none (``ops.attention.ScoringAttention`` is the
    differentiable path).  It never falls back."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, key_bias)):
        raise RuntimeError(
            "attention_scores_cuda returns no gradient: call it under torch.no_grad() "
            "or through madtp_tpu_torch.ops.attention.attention_scores")
    _check(q, k, v, key_alive, key_bias)
    fn = _load()
    B, N, H, Dh = q.shape
    dev = q.device
    out = torch.empty((B, N, H, Dh), dtype=q.dtype, device=dev)
    col = torch.empty((B, N), dtype=torch.float32, device=dev)
    cls = torch.empty((B, N), dtype=torch.float32, device=dev)
    stats = torch.empty((3, B, H, N), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 q.stride(0), q.stride(1), key_alive.data_ptr(),
                 key_bias.data_ptr(), out.data_ptr(), col.data_ptr(),
                 cls.data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(),
                 stats[2].data_ptr(), B, N, H, Dh, float(scale), stream)
    if err != 0:
        raise RuntimeError(f"K1 launch failed with cudaError_t {err}")
    attention_scores_cuda.launches += 1
    res = (out.view(B, N, H * Dh), cls[:, 1:], col[:, 1:])
    return res + (stats,) if return_stats else res


attention_scores_cuda.launches = 0
