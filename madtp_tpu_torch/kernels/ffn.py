"""K5: the transformer FFN ``act(x W1^T + b1) W2^T + b2``, as a CUDA kernel
for Hopper: bf16 on the tensor cores (wgmma fed by TMA), fp32 on the CUDA
cores (no TF32), each GEMM on a plan chosen from its shape (``fp32_plan``).

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
TILE = 128  # D and F must be multiples of 128
ACTS = {"gelu": 1, "quick_gelu": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SMS = 132  # the H100 SXM's streaming multiprocessors
MAX_SPLIT = 8  # the fp32 kernel's split of K: one thread-block cluster, at most 8 blocks
MIN_SLICE = 64  # the least depth of a slice of K
FEW_BLOCKS = 80  # 128-row tiles split K until there are this many blocks (one an SM)


def fp32_plan(M: int, N: int, K: int):
    """``(tm, split)`` of one fp32 GEMM ``C[M, N] = A[M, K] B[N, K]^T``, a
    function of the shape alone, so a relaunch runs alike.  Blocks are ``16
    tm`` rows by 128 columns: 128 rows (tm 8, one block an SM, the most
    efficient tile) above M = 64, else the smallest tile that holds M (tm
    4, 2 or 1, two blocks an SM).  K is then cut into ``split`` slices (2, 4
    or 8, each at least ``MIN_SLICE`` deep) until the 128-row tiles make
    ``FEW_BLOCKS`` blocks and the smaller ones a block for every SM, and a
    128-row plan that would end in a partly filled second wave splits once
    more.  The slices of a tile are one cluster, which adds their partials
    in slice order (``csrc/ffn.cu``).  The thresholds are the H100's
    measured best at the paths' M = 480-1,000 (PERF.md)."""
    if M > 64:
        tm, target = 8, FEW_BLOCKS
    else:
        tm, target = 4, SMS
        while tm > 1 and 8 * tm >= M:
            tm //= 2
    blocks = -(-M // (16 * tm)) * (N // TILE)

    def can_split(split):
        return split < MAX_SPLIT and K // (2 * split) >= MIN_SLICE

    split = 1
    while blocks * split < target and can_split(split):
        split *= 2
    if tm == 8 and SMS < blocks * split < 2 * SMS and can_split(split):
        split *= 2
    return tm, split


# (rtol, atol) of K5's y against the plain version on the same inputs.
# bfloat16: both take exact products of the same bf16 values, sum them in
# fp32 (in another order) and round h, g and y to bf16 at the same places,
# so a sum that lands next to a rounding edge may round one bf16 step
# apart (2^-8 relative) in h, g or y; so may the activation, which K5
# evaluates with fast intrinsics and, for GELU, the TPU kernel's erf
# polynomial (errors ~1e-7); cuBLAS may also reduce split-K partial sums in
# reduced precision for the plain version.  float32: both sum fp32
# products in fp32 (no TF32 on either side) and differ only in summation
# order and in the last bit of erf / exp, ~1e-7 relative over sums of up
# to 4,096 terms; 1e-5 is the limit the fp32 parity checks hold features
# to, and the JAX package's own fp32 K5 test.
TOLERANCES = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2e-2, 2e-2)}


def _load():
    from madtp_tpu_torch.kernels.build import build

    fn = build(SOURCE).lib.k5_ffn
    if fn.argtypes is None:
        p, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i32, p, p, p, p, p, p, p, i32, i32, i32, i32, i32, i32, i32, i32, p]
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
    if x.dtype not in _DTYPES:
        raise ValueError(f"ffn_cuda takes float32 or bfloat16, got x in {x.dtype}")
    for name, t, shape in (("x", x, (M, D)), ("w1", w1, (F, D)), ("b1", b1, (F,)),
                           ("w2", w2, (D, F)), ("b2", b2, (D,))):
        if t.dtype != x.dtype:
            raise ValueError(f"ffn_cuda needs weights and biases in x's dtype {x.dtype}, "
                             f"got {name} in {t.dtype}")
        if tuple(t.shape) != shape or t.device != x.device:
            raise ValueError(f"{name} must be {shape} on {x.device}, got "
                             f"{tuple(t.shape)} on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous with a 16-byte aligned base")


def ffn_cuda(x, w1, b1, w2, b2, act: str = "gelu"):
    """Launch K5.  ``x`` [M, D], ``w1`` [F, D], ``b1`` [F], ``w2`` [D, F],
    ``b2`` [D]: contiguous CUDA tensors, all bfloat16 or all float32, D and F
    multiples of 128, any M >= 1; ``act`` ``"gelu"`` (erf GELU) or
    ``"quick_gelu"``.

    Returns ``y`` [M, D] in x's dtype, like ``mlp_plain``; the hidden [M, F] goes
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
    plans = (*fp32_plan(M, F, D), *fp32_plan(M, D, F)) if x.dtype == torch.float32 else (0,) * 4
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(_DTYPES[x.dtype], x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                 b2.data_ptr(), hidden.data_ptr(), y.data_ptr(), M, D, F, ACTS[act], *plans,
                 stream)
    if err != 0:
        raise RuntimeError(f"K5 launch failed with cudaError_t {err}")
    ffn_cuda.launches += 1
    if x.dtype == torch.float32:
        ffn_cuda.fp32_launches += 1
    return y


ffn_cuda.launches = 0
ffn_cuda.fp32_launches = 0  # the fp32 ones among ``launches``
