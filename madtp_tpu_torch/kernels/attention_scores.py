"""K1: attention with the DTP scoring outputs, as a CUDA kernel for Hopper.

Replaces ``madtp_tpu/ops/pallas/fused_attention.py`` ``fused_attention_scores``
and, above ``LARGE_N`` slots, ``fused_attention_scores_tiled`` (K3): the TPU
kernel was split in two only because its [N, N] head-max plane outgrows VMEM
past 1,536 slots (``_needs_tiling``), and K1 keeps no such plane (it tiles
queries and keys and takes any N >= 2), so one kernel serves both ranges.
``attention_scores_cuda.large_n_launches`` counts the launches in K3's range.
The source, its design and its bound are in ``csrc/attention_scores.cu``.  The
plain PyTorch version of the same function is
:func:`madtp_tpu_torch.ops.attention.attention_scores_plain`;
:func:`madtp_tpu_torch.ops.attention.attention_scores` picks between the two
by the device of its inputs.

:func:`attention_planes_cuda` launches K1's planes variant, the scoring
attention of a tensor-parallel MED on a rank's heads: pass A, then the rank's
head-max plane and the CLS row's two partial sums, which the model group
combines (:func:`madtp_tpu_torch.ops.attention.attention_scores`); its plain
version is :func:`madtp_tpu_torch.ops.attention.attention_planes_plain`, and
it counts its launches in ``attention_planes_cuda.launches``.
"""

from __future__ import annotations

import ctypes

import torch

SOURCE = "attention_scores.cu"
HEAD_DIM = 64  # the one head width the kernel is built for
# the TPU sends a padded N above this to the tiled kernel K3
# (madtp_tpu/ops/attention.py:56-76: N rounded up to 128 > 1536, i.e. N > 1536)
LARGE_N = 1536
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KEY_TILE = 64  # keys per block of pass B (bf16: K of all heads, 128 KB at H = 16)
QUERY_TILE = 128  # query rows of one pass-B stage: 8 warps of 16
SMS = 132  # the H100 SXM's streaming multiprocessors
WAVES = 4  # pass B's blocks: enough that the last wave's tail stays short
MAX_N = 16384  # pass A keeps every key's bias in shared memory
MAX_HEADS = 16  # pass B keeps the K tiles of all heads in shared memory


def query_split(blocks: int, N: int) -> int:
    """The number of ranges a pass over key tiles (one block an SM, for its
    shared memory) splits its 128-row query tiles into: 1 where its
    ``blocks`` make four waves of the card, else as many as make four
    waves, at most one per query tile.  The ranges' column partials are then
    added in order."""
    if blocks >= WAVES * SMS:
        return 1
    return min(-(-N // QUERY_TILE), -(-WAVES * SMS // blocks))


def pass_b_chunks(B: int, N: int) -> int:
    """K1's pass-B split, fp32 and bf16 alike (``query_split`` of its
    ceil(N / 64) B blocks, added by ``k1_colsum``; CLIP's B = 32, N = 320:
    160 blocks, 3 chunks)."""
    return query_split(-(-N // KEY_TILE) * B, N)


# (rtol, atol) of K1 against the plain version on the same inputs.
# float32: both compute logits, probabilities and sums in fp32 (K1 on the
# CUDA cores) and differ only in summation order and in K1's P taken as
# exp(x - m) times 1/l (one rounding more than a division).  bfloat16: the logits are
# fp32 sums of exact products of the same bf16 values, so col_mass stays
# close; out differs by rounding (both round P to bf16 for P.v, K1 before
# dividing by the row sum and the plain version after; both round out to
# bf16: up to ~2^-8 of |v| per row); cls_attn differs because K1 takes
# r_h = ||out_h|| in fp32, as the TPU kernel does, while the plain version
# takes it from out rounded to bf16 (2^-9 relative per value).
TOLERANCES = {
    torch.float32: {"out": (1e-5, 1e-5), "col_mass": (1e-5, 1e-5),
                    "cls_attn": (1e-5, 1e-5)},
    torch.bfloat16: {"out": (2e-2, 2e-2), "col_mass": (1e-4, 1e-4),
                     "cls_attn": (1e-2, 1e-5)},
}


# (rtol, atol) of the planes variant against its plain version: the plane
# and the CLS row's sums take the probabilities K1's pass A describes (its m
# and l, the same as for col_mass and cls_attn), so they keep K1's
# tolerances; num and den sum over a rank's heads only.
PLANES_TOLERANCES = {
    torch.float32: {"out": (1e-5, 1e-5), "plane": (1e-5, 1e-5), "num": (1e-5, 1e-5),
                    "den": (1e-5, 1e-5)},
    torch.bfloat16: {"out": (2e-2, 2e-2), "plane": (1e-4, 1e-4), "num": (1e-2, 1e-5),
                     "den": (1e-2, 1e-5)},
}


def _load(symbol="k1_attention_scores"):
    from madtp_tpu_torch.kernels.build import build

    lib = build(SOURCE).lib
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        if symbol == "k1_attention_scores":
            fn.argtypes = [i32, p, p, p, i64, i64, p, p, p, p, p, p, p, p, p,
                           i32, i32, i32, i32, i32, ctypes.c_float, p]
        else:
            fn.argtypes = [i32, p, p, p, i64, i64, p, p, p, p, p, p, p, p, p,
                           i32, i32, i32, i32, ctypes.c_float, p]
        fn.restype = i32
    return fn


def _check(q, k, v, key_alive, key_bias, who="attention_scores_cuda", max_n=MAX_N):
    if not q.is_cuda:
        raise ValueError(f"{who} needs CUDA tensors, got {q.device}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"{who} takes float32 or bfloat16, got {q.dtype}")
    if q.dim() != 4:
        raise ValueError(f"q must be [B, N, H, Dh], got shape {tuple(q.shape)}")
    B, N, H, Dh = q.shape
    if Dh != HEAD_DIM or not 2 <= N <= max_n:
        raise ValueError(f"{who} needs Dh == {HEAD_DIM} and 2 <= N <= {max_n}, "
                         f"got shape {tuple(q.shape)}")
    if H > MAX_HEADS:
        raise ValueError(f"{who} takes at most {MAX_HEADS} heads, got {H}")
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q in shape, dtype and device")
        if t.stride() != q.stride():
            raise ValueError("q, k and v must share their strides")
    if q.stride(3) != 1 or q.stride(2) != Dh:
        raise ValueError("q, k, v need contiguous [H, Dh] rows (a view of a "
                         "[B, N, H*Dh] or packed qkv tensor)")
    el = 16 // q.element_size()  # 16-byte copies of the rows
    if any(t.data_ptr() % 16 for t in (q, k, v)) or q.stride(0) % el or q.stride(1) % el:
        raise ValueError("q, k, v need 16-byte aligned rows (base and strides)")
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
    chunks = pass_b_chunks(B, N)
    part = torch.empty((chunks, B, N), dtype=torch.float32, device=dev) if chunks > 1 else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 q.stride(0), q.stride(1), key_alive.data_ptr(),
                 key_bias.data_ptr(), out.data_ptr(), col.data_ptr(),
                 cls.data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(),
                 stats[2].data_ptr(), None if part is None else part.data_ptr(),
                 B, N, H, Dh, chunks, float(scale), stream)
    if err != 0:
        raise RuntimeError(f"K1 launch failed with cudaError_t {err}")
    attention_scores_cuda.launches += 1
    if N > LARGE_N:
        attention_scores_cuda.large_n_launches += 1
    res = (out.view(B, N, H * Dh), cls[:, 1:], col[:, 1:])
    return res + (stats,) if return_stats else res


attention_scores_cuda.launches = 0
attention_scores_cuda.large_n_launches = 0  # K3's range, N > LARGE_N


def attention_planes_cuda(q, k, v, key_alive, key_bias, scale: float):
    """Launch K1's planes variant on a rank's heads (inputs as for
    :func:`attention_scores_cuda`, no gradient).  Returns ``(out [B, N,
    H*Dh] in q's dtype, plane [B, N-1, N-1], num [B, N-1], den [B, N-1])``,
    fp32 but ``out``: ``plane[b, i-1, n-1]`` the max over the heads of
    ``P_h[i, n]`` at alive queries ``i`` (0 at dead ones), ``num`` the sum
    over the heads of ``P_h[0, n] r_h[n]`` and ``den`` that of ``r_h[n]``,
    ``r_h[n]`` the fp32 norm of the row of out.  A model group combines them
    with a MAX and a SUM into ``col_mass`` and ``cls_attn``.  Raises on any
    input the kernel does not take; it never falls back."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, key_bias)):
        raise RuntimeError("attention_planes_cuda returns no gradient: tensor "
                           "parallelism here is inference only")
    _check(q, k, v, key_alive, key_bias, who="attention_planes_cuda")
    fn = _load("k1_attention_planes")
    B, N, H, Dh = q.shape
    dev = q.device
    out = torch.empty((B, N, H, Dh), dtype=q.dtype, device=dev)
    plane = torch.empty((B, N - 1, N - 1), dtype=torch.float32, device=dev)
    num = torch.empty((B, N - 1), dtype=torch.float32, device=dev)
    den = torch.empty((B, N - 1), dtype=torch.float32, device=dev)
    stats = torch.empty((3, B, H, N), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 q.stride(0), q.stride(1), key_alive.data_ptr(), key_bias.data_ptr(),
                 out.data_ptr(), plane.data_ptr(), num.data_ptr(), den.data_ptr(),
                 stats[0].data_ptr(), stats[1].data_ptr(), stats[2].data_ptr(),
                 B, N, H, Dh, float(scale), stream)
    if err != 0:
        raise RuntimeError(f"K1 planes launch failed with cudaError_t {err}")
    attention_planes_cuda.launches += 1
    return out.view(B, N, H * Dh), plane, num, den


attention_planes_cuda.launches = 0
