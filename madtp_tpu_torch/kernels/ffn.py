"""K5: the transformer FFN ``act(x W1^T + b1) W2^T + b2``, as a CUDA kernel
for Hopper on tensor cores.

Replaces ``madtp_tpu/ops/pallas/fused_ffn.py`` ``fused_mlp_2d``.  The source,
its design and its bound are in ``csrc/ffn.cu``.  The plain PyTorch version
of the same function is :func:`madtp_tpu_torch.ops.layers.mlp_plain`;
:func:`madtp_tpu_torch.ops.layers.mlp` picks between the two by the device
and dtype of its input.
"""

from __future__ import annotations

import ctypes

import torch

SOURCE = "ffn.cu"
TILE = 128  # D and F must be multiples of the kernel's 128-wide output tile
ACTS = {"gelu": 1, "quick_gelu": 2}

# (rtol, atol) of K5's y against the plain version on the same bf16 inputs.
# Both take exact products of the same bf16 values, sum them in fp32 (in
# another order) and round h, g and y to bf16 at the same places, so a sum
# that lands next to a rounding edge may round one bf16 step apart (2^-8
# relative) in h, g or y; cuBLAS may also reduce split-K partial sums in
# reduced precision for the plain version.
TOLERANCES = {torch.bfloat16: (2e-2, 2e-2)}


def _load():
    from madtp_tpu_torch.kernels.build import build

    fn = build(SOURCE).lib.k5_ffn
    if fn.argtypes is None:
        p, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, i32, i32, i32, i32, p]
        fn.restype = i32
    return fn


def _check(x, w1, b1, w2, b2, act):
    if act not in ACTS:
        raise ValueError(f"ffn_cuda takes act in {sorted(ACTS)}, got {act!r}")
    if b1 is None or b2 is None:
        raise ValueError("ffn_cuda needs both biases")
    if not x.is_cuda:
        raise ValueError(f"ffn_cuda needs CUDA tensors, got {x.device}")
    if x.dim() != 2:
        raise ValueError(f"x must be [M, D], got shape {tuple(x.shape)}")
    M, D = x.shape
    F = w1.shape[0]
    if M < 1 or D % TILE or F % TILE or D < TILE or F < TILE:
        raise ValueError(f"ffn_cuda needs M >= 1 and D, F multiples of {TILE}, "
                         f"got M={M}, D={D}, F={F}")
    for name, t, shape in (("x", x, (M, D)), ("w1", w1, (F, D)), ("b1", b1, (F,)),
                           ("w2", w2, (D, F)), ("b2", b2, (D,))):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"ffn_cuda takes bfloat16 only (fp32 FFNs stay on two "
                             f"linears), got {name} in {t.dtype}")
        if tuple(t.shape) != shape or t.device != x.device:
            raise ValueError(f"{name} must be {shape} on {x.device}, got "
                             f"{tuple(t.shape)} on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous with a 16-byte aligned base")


def ffn_cuda(x, w1, b1, w2, b2, act: str = "gelu"):
    """Launch K5.  ``x`` [M, D], ``w1`` [F, D], ``b1`` [F], ``w2`` [D, F],
    ``b2`` [D]: contiguous bfloat16 CUDA tensors, D and F multiples of 128,
    any M >= 1; ``act`` ``"gelu"`` (exact erf) or ``"quick_gelu"``.

    Returns ``y`` [M, D] bf16, like ``mlp_plain``; the hidden [M, F] goes
    through a scratch tensor.  Raises on any input the kernel does not take,
    and on an input that needs a gradient while grad mode is on: the output
    carries none (``ops.layers.FusedMLP`` is the differentiable path).  It
    never falls back."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w1, b1, w2, b2)):
        raise RuntimeError(
            "ffn_cuda returns no gradient: call it under torch.no_grad() or through "
            "madtp_tpu_torch.ops.layers.mlp")
    _check(x, w1, b1, w2, b2, act)
    fn = _load()
    M, D = x.shape
    F = w1.shape[0]
    hidden = torch.empty((M, F), dtype=x.dtype, device=x.device)
    y = torch.empty((M, D), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                 hidden.data_ptr(), y.data_ptr(), M, D, F, ACTS[act], stream)
    if err != 0:
        raise RuntimeError(f"K5 launch failed with cudaError_t {err}")
    ffn_cuda.launches += 1
    return y


ffn_cuda.launches = 0
