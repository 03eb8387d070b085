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
# the same bf16 values; both round P to bf16 before P.v, the plain version
# after normalising, K4 before (it divides by the row sum at the end), so
# a weight may round one bf16 step apart; both round out to bf16 once (up
# to ~2^-8 of |v|).
TOLERANCES = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2e-2, 2e-2)}

# The split of the keys (``split_chunks``): a block holds up to 64 query
# rows of one (b, h) in bf16, 40 in fp32.  Where that gives fewer than
# MIN_BLOCKS blocks, the keys are cut into chunks of whole 64-key tiles until
# there are about TARGET_BLOCKS blocks, at most one chunk for every
# MIN_CHUNK_KEYS keys; one rule for each dtype.  bf16 (2 and 8 blocks on each
# of the H100's 132 SMs, 256 keys): splitting where B H already fills the
# card, or into chunks of 128 keys, costs more in partials and merging than
# it gains.  fp32 lists each chunk's alive keys first, so a chunk costs a
# block more; measured on the H100, one chunk beats any split wherever B H
# gives a block an SM (the NLVR train step's 192, the decode's 288 and up),
# and a chunk holds at most FP32_MAX_CHUNK_KEYS keys, the list's room.
KEY_TILE = 64
QUERY_TILE = {torch.bfloat16: 64, torch.float32: 40}
MIN_BLOCKS = {torch.bfloat16: 2 * 132, torch.float32: 132}
TARGET_BLOCKS = {torch.bfloat16: 8 * 132, torch.float32: 2 * 132}
MIN_CHUNK_KEYS = {torch.bfloat16: 256, torch.float32: 256}
FP32_MAX_CHUNK_KEYS = 1024


def split_chunks(B: int, H: int, Nq: int, S: int, dtype=torch.bfloat16):
    """(chunks, chunk_keys) of the kernel in ``dtype``: chunk c covers keys
    ``[c chunk_keys, min(S, (c + 1) chunk_keys))``, a function of the shape
    and dtype alone, so a relaunch splits alike.  With blocks = B H ceil(Nq
    / QUERY_TILE): one chunk if blocks >= MIN_BLOCKS, else chunks =
    min(ceil(TARGET_BLOCKS / blocks), ceil(S / MIN_CHUNK_KEYS)); in fp32 at
    least ceil(S / FP32_MAX_CHUNK_KEYS); then rounded so that every chunk is
    a whole number of 64-key tiles and none is empty."""
    blocks = B * H * -(-Nq // QUERY_TILE[dtype])
    chunks = 1
    if blocks < MIN_BLOCKS[dtype]:
        chunks = max(1, min(-(-TARGET_BLOCKS[dtype] // blocks), -(-S // MIN_CHUNK_KEYS[dtype])))
    if dtype == torch.float32:
        chunks = max(chunks, -(-S // FP32_MAX_CHUNK_KEYS))
    tiles = -(-S // KEY_TILE)
    chunk_keys = -(-tiles // chunks) * KEY_TILE
    return -(-S // chunk_keys), chunk_keys


def cross_attention_split_plain(q, k, v, key_alive, key_bias, scale: float, chunks: int,
                                chunk_keys: int):
    """The kernel's split in plain PyTorch, in fp32: for each chunk of
    ``chunk_keys`` keys the running max, the sum and the unnormalised out of
    its alive keys, then the merge of ``k4_combine`` in chunk order 0, 1, ...
    Equals :func:`madtp_tpu_torch.ops.attention.cross_attention_plain` up to
    fp32 rounding; shapes as there."""
    B, Nq, H, Dh = q.shape
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))  # [B, H, N, Dh]
    s = scale * qf @ kf.transpose(-1, -2)
    if key_bias is not None:
        s = s + key_bias.float()[:, None, None, :]
    s = s.masked_fill(~key_alive[:, None, None, :], float("-inf"))
    parts = []
    for c in range(chunks):
        sc = s[..., c * chunk_keys:(c + 1) * chunk_keys]
        m = sc.amax(dim=-1, keepdim=True)
        p = torch.where(sc == float("-inf"), torch.zeros_like(sc), torch.exp(sc - m))
        parts.append((m, p.sum(dim=-1, keepdim=True),
                      p @ vf[..., c * chunk_keys:(c + 1) * chunk_keys, :]))
    m_all = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    total_l, total_o = torch.zeros_like(m_all), torch.zeros_like(parts[0][2])
    for m, l, o in parts:
        w = torch.where(m == float("-inf"), torch.zeros_like(m), torch.exp(m - m_all))
        total_l, total_o = total_l + w * l, total_o + w * o
    out = total_o / total_l.clamp_min(1e-30)
    return out.transpose(1, 2).reshape(B, Nq, H * Dh).to(q.dtype)


def _load():
    from madtp_tpu_torch.kernels.build import build

    fn = build(SOURCE).lib.k4_cross_attention
    if fn.argtypes is None:
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [i32, p, p, p, i64, i64, i64, i64, p, p, p, p,
                       i32, i32, i32, i32, i32, i32, i32, ctypes.c_float, p]
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
    el = k.element_size()  # 16-byte copies of k and v rows
    if any(t.data_ptr() % 16 for t in (k, v)) or k.stride(0) * el % 16 \
            or k.stride(1) * el % 16:
        raise ValueError("k and v need 16-byte aligned rows (base and strides)")
    if q.dtype == torch.bfloat16 and (q.data_ptr() % 4 or q.stride(0) % 2 or q.stride(1) % 2):
        raise ValueError("bf16 q needs 4-byte aligned rows (base and strides)")  # 4-byte reads
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
    chunks, chunk_keys = split_chunks(B, H, Nq, S, q.dtype)
    part = None  # fp32 partials of the chunks: out unnormalised, then (max, sum)
    if chunks > 1:
        part = torch.empty(chunks * B * H * Nq * (Dh + 2), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 q.stride(0), q.stride(1), k.stride(0), k.stride(1), key_alive.data_ptr(),
                 None if key_bias is None else key_bias.data_ptr(), out.data_ptr(),
                 None if part is None else part.data_ptr(),
                 B, Nq, S, H, Dh, chunks, chunk_keys, float(scale), stream)
    if err != 0:
        raise RuntimeError(f"K4 launch failed with cudaError_t {err}")
    cross_attention_cuda.launches += 1
    return out.view(B, Nq, H * Dh)


cross_attention_cuda.launches = 0
