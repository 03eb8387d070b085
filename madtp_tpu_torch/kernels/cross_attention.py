"""K4: masked-softmax cross-attention, as a CUDA kernel for Hopper.

Replaces ``madtp_tpu/ops/pallas/cross_attention.py`` ``fused_cross_attention``.
The source, its design and its bound are in ``csrc/cross_attention.cu``.  The
plain PyTorch version of the same function is
:func:`madtp_tpu_torch.ops.attention.cross_attention_plain`;
:func:`madtp_tpu_torch.ops.attention.cross_attention` picks between the two by
the device of its inputs.
"""

from __future__ import annotations

import ctypes

import torch

SOURCE = "cross_attention.cu"
HEAD_DIM = 64  # the one head width the kernel is built for
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# (rtol, atol) of K4's out against the plain version on the same inputs.
# float32: both take fp32 logits, softmax and sums and differ only in
# summation order.  bfloat16: the logits are fp32 sums of exact products of
# the same bf16 values; the plain version rounds P to bf16 before P.v, K4
# keeps P in fp32, and both round out to bf16 once (up to ~2^-8 of |v|).
TOLERANCES = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2e-2, 2e-2)}


def _load():
    from madtp_tpu_torch.kernels.build import build

    fn = build(SOURCE).lib.k4_cross_attention
    if fn.argtypes is None:
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [i32, p, p, p, i64, i64, i64, i64, p, p, p,
                       i32, i32, i32, i32, i32, ctypes.c_float, p]
        fn.restype = i32
    return fn


def _check(q, k, v, key_alive, key_bias):
    if not q.is_cuda:
        raise ValueError(f"cross_attention_cuda needs CUDA tensors, got {q.device}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"cross_attention_cuda takes float32 or bfloat16, got {q.dtype}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q must be [B, Nq, H, Dh] and k, v [B, S, H, Dh], got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    B, Nq, H, Dh = q.shape
    S = k.shape[1]
    if Dh != HEAD_DIM or Nq < 1 or S < 1:
        raise ValueError(f"cross_attention_cuda needs Dh == {HEAD_DIM}, Nq >= 1 and S >= 1, "
                         f"got q {tuple(q.shape)}, k {tuple(k.shape)}")
    for name, t in (("k", k), ("v", v)):
        if t.shape != (B, S, H, Dh) or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must be [B, S, H, Dh] = {(B, S, H, Dh)} in q's dtype "
                             f"and device, got {tuple(t.shape)} {t.dtype} {t.device}")
    if v.stride() != k.stride():
        raise ValueError("k and v must share their strides")
    for name, t in (("q", q), ("k", k)):
        if t.stride(3) != 1 or t.stride(2) != Dh:
            raise ValueError(f"{name} needs contiguous [H, Dh] rows (a view of a "
                             "[B, N, H*Dh] tensor)")
    if key_alive.dtype != torch.bool or key_alive.shape != (B, S) \
            or not key_alive.is_contiguous() or key_alive.device != q.device:
        raise ValueError("key_alive must be a contiguous bool [B, S] tensor on q's device")
    if key_bias is not None and (key_bias.dtype != torch.float32 or key_bias.shape != (B, S)
                                 or not key_bias.is_contiguous()
                                 or key_bias.device != q.device):
        raise ValueError("key_bias must be None or a contiguous float32 [B, S] tensor "
                         "on q's device")


def cross_attention_cuda(q, k, v, key_alive, key_bias, scale: float):
    """Launch K4.  ``q``: [B, Nq, H, 64], ``k, v``: [B, S, H, 64], float32 or
    bfloat16 views with contiguous heads (``k`` and ``v`` sharing strides);
    ``key_alive`` bool [B, S]; ``key_bias`` float32 [B, S] or None.

    Returns ``out`` [B, Nq, H*Dh] in q's dtype, like
    ``cross_attention_plain``.  Raises on any input the kernel does not take,
    and on an input that needs a gradient while grad mode is on: the output
    carries none (``ops.attention.CrossAttention`` is the differentiable
    path).  It never falls back."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (q, k, v, key_bias)):
        raise RuntimeError(
            "cross_attention_cuda returns no gradient: call it under torch.no_grad() "
            "or through madtp_tpu_torch.ops.attention.cross_attention")
    _check(q, k, v, key_alive, key_bias)
    fn = _load()
    B, Nq, H, Dh = q.shape
    S = k.shape[1]
    dev = q.device
    out = torch.empty((B, Nq, H, Dh), dtype=q.dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 q.stride(0), q.stride(1), k.stride(0), k.stride(1), key_alive.data_ptr(),
                 None if key_bias is None else key_bias.data_ptr(), out.data_ptr(),
                 B, Nq, S, H, Dh, float(scale), stream)
    if err != 0:
        raise RuntimeError(f"K4 launch failed with cudaError_t {err}")
    cross_attention_cuda.launches += 1
    return out.view(B, Nq, H * Dh)


cross_attention_cuda.launches = 0
