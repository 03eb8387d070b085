"""K1 (and its tensor-parallel planes variant), K2, fp32 K4 and fp32 K5, the
CUDA sources themselves, run on the CPU through the emulator of
``tests/cuda_emu.h`` (g++; skipped without it) against their plain versions
and the JAX package's ``attention_core``,
``fused_cross_attention`` and ``fused_mlp_2d``, fp32 (K1, K4 and K5 on the
CUDA cores, K2 as 3xTF32 on the emulated tensor cores) and bf16, at small
shapes that cross the tiles' edges and take pass B's and pass M's query
splits, K4's key chunks and decode plan and K5's split-K clusters, a row
with no alive key and PAD_BIAS keys among them.  The emulator follows the PTX fragment layouts and lands
``cp.async`` copies only at their waits, with shared memory starting as NaN
bytes, so a layout, masking or ordering slip shows here before the card."""

import ctypes
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cuda_emu
from chip_smoke import compare_k2
from madtp_tpu.ops import attention as JA
from madtp_tpu.ops.pallas.cross_attention import fused_cross_attention
from madtp_tpu.ops.pallas.fused_ffn import fused_mlp_2d
from madtp_tpu_torch.kernels.attention_scores import _DTYPES, TOLERANCES, pass_b_chunks
from madtp_tpu_torch.kernels.attention_scores_bwd import TOLERANCES as K2_TOL, pass_m_chunks
from madtp_tpu_torch.kernels.cross_attention import FP32_MAX_CHUNK_KEYS, KEY_TILE, split_chunks
from madtp_tpu_torch.kernels.cross_attention import TOLERANCES as K4_TOL
from madtp_tpu_torch.kernels.ffn import ACTS, MAX_SPLIT, MIN_SLICE, fp32_plan
from madtp_tpu_torch.kernels.ffn import TOLERANCES as K5_TOL
from madtp_tpu_torch.ops.attention import (attention_scores_bwd_plain, attention_scores_plain,
                                           cross_attention_plain)
from madtp_tpu_torch.ops.layers import mlp_plain

CSRC = Path(__file__).resolve().parent.parent / "madtp_tpu_torch" / "csrc"
P, I64, I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


@pytest.fixture(scope="module")
def kernels():
    if not cuda_emu.available():
        pytest.skip("needs g++ for the CPU emulator")
    k1 = cuda_emu.build(CSRC / "attention_scores.cu").k1_attention_scores
    k1.argtypes = [I32, P, P, P, I64, I64] + [P] * 9 + [I32] * 5 + [ctypes.c_float, P]
    k1.restype = I32
    k2 = cuda_emu.build(CSRC / "attention_scores_bwd.cu").k2_attention_scores_bwd
    k2.argtypes = [I32, P, P, P, I64, I64] + [P] * 21 + [I32] * 5 + [ctypes.c_float, P]
    k2.restype = I32
    return k1, k2


def _case(B, N, H, dtype, with_bias, dead_row, seed=0):
    rng = np.random.RandomState(seed)
    packed = torch.from_numpy(rng.randn(B, N, 3 * H * 64).astype(np.float32)).to(dtype)
    q, k, v = (packed[..., i * H * 64:(i + 1) * H * 64].unflatten(-1, (H, 64))
               for i in range(3))
    alive = rng.rand(B, N) > 0.25
    alive[:, 0] = True
    alive[:, N - max(1, N // 50):] = False
    if dead_row:
        alive[B - 1] = False
    bias = (rng.rand(B, N) < 0.2).astype(np.float32) * -10000.0 if with_bias else None
    return (q, k, v, torch.from_numpy(alive),
            None if bias is None else torch.from_numpy(bias), 64 ** -0.5)


def _k1(fn, q, k, v, alive, bias, scale):
    B, N, H, _ = q.shape
    bias_in = torch.zeros(B, N) if bias is None else bias
    out = torch.empty(B, N, H, 64, dtype=q.dtype)
    col, cls = torch.empty(B, N), torch.empty(B, N)
    stats = torch.empty(3, B, H, N)
    chunks = pass_b_chunks(B, N)
    part = torch.empty(chunks, B, N)
    err = fn(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), q.stride(0),
             q.stride(1), alive.data_ptr(), bias_in.data_ptr(), out.data_ptr(), col.data_ptr(),
             cls.data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(), stats[2].data_ptr(),
             part.data_ptr(), B, N, H, 64, chunks, scale, None)
    assert err == 0
    return (out.view(B, N, H * 64), cls[:, 1:], col[:, 1:]), stats


# (B, N, H, bias, a row with no alive key): a ragged 70, a single warp's 17,
# 130 past the 128-row stage (pass B splits its two query tiles at B = 2),
# the text side's 40
SHAPES = [(2, 70, 2, True, False), (1, 17, 3, False, False), (2, 130, 2, False, False),
          (2, 40, 2, True, True)]


# fp32 K1's own tile edges: N on both sides of 64 (pass A's query and key
# tiles, pass B's key blocks) and 128 (pass B's query stages), and 300 at B
# = 1, where pass B splits its three query tiles into three chunks
FP32_EDGES = [(1, 63, 2, True, False), (1, 64, 2, False, False), (2, 65, 2, True, True),
              (1, 127, 3, False, False), (1, 128, 2, True, False), (1, 129, 2, False, True),
              (1, 300, 2, True, False)]


@pytest.mark.parametrize("B,N,H,with_bias,dead_row", FP32_EDGES)
def test_k1_fp32_tile_edges(kernels, B, N, H, with_bias, dead_row):
    test_k1_source_matches_plain_and_jax(kernels, B, N, H, with_bias, dead_row, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,H,with_bias,dead_row", SHAPES)
def test_k1_source_matches_plain_and_jax(kernels, B, N, H, with_bias, dead_row, dtype):
    q, k, v, alive, bias, scale = _case(B, N, H, dtype, with_bias, dead_row)
    got, _ = _k1(kernels[0], q, k, v, alive, bias, scale)
    want = attention_scores_plain(q, k, v, alive, bias, scale)
    j_out, j_aux = JA.attention_core(
        *(jnp.asarray(t.float().transpose(1, 2).numpy()) for t in (q, k, v)), scale=scale,
        key_bias=None if bias is None else jnp.asarray(bias.numpy()),
        key_alive=jnp.asarray(alive.numpy()), query_alive=jnp.asarray(alive.numpy()),
        need_scores=True)
    jax_res = (np.asarray(j_out), np.asarray(j_aux.cls_attn), np.asarray(j_aux.col_mass))
    for name, g, w, j in zip(("out", "cls_attn", "col_mass"), got, want, jax_res):
        rtol, atol = TOLERANCES[dtype][name]
        assert torch.isfinite(g.float()).all()
        torch.testing.assert_close(g.float(), w.float(), rtol=rtol, atol=atol)
        if dtype == torch.float32:
            np.testing.assert_allclose(g.numpy(), j, rtol=rtol, atol=atol)
    if dead_row:
        assert not got[0][-1].float().any() and not got[2][-1].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,H,with_bias,dead_row", [(2, 40, 2, True, True),
                                                     (1, 70, 3, False, False)])
def test_k1_planes_source_matches_plain(B, N, H, with_bias, dead_row, dtype):
    """K1's planes variant (``k1_attention_planes``: pass A and
    ``k1_planes``) on the emulator against its plain version, the text
    side's 40 slots and 70 (past one 32-slot tile of the planes)."""
    from madtp_tpu_torch.kernels.attention_scores import PLANES_TOLERANCES
    from madtp_tpu_torch.ops.attention import attention_planes_plain

    if not cuda_emu.available():
        pytest.skip("needs g++ for the CPU emulator")
    fn = cuda_emu.build(CSRC / "attention_scores.cu").k1_attention_planes
    fn.argtypes = [I32, P, P, P, I64, I64] + [P] * 9 + [I32] * 4 + [ctypes.c_float, P]
    fn.restype = I32
    q, k, v, alive, bias, scale = _case(B, N, H, dtype, with_bias, dead_row)
    bias_in = torch.zeros(B, N) if bias is None else bias
    out = torch.empty(B, N, H, 64, dtype=dtype)
    plane, num, den = torch.empty(B, N - 1, N - 1), torch.empty(B, N - 1), torch.empty(B, N - 1)
    stats = torch.empty(3, B, H, N)
    assert fn(_DTYPES[dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), q.stride(0), q.stride(1),
              alive.data_ptr(), bias_in.data_ptr(), out.data_ptr(), plane.data_ptr(),
              num.data_ptr(), den.data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(),
              stats[2].data_ptr(), B, N, H, 64, scale, None) == 0
    want = attention_planes_plain(q, k, v, alive, bias, scale)
    for name, g, w in zip(("out", "plane", "num", "den"), (out.view(B, N, -1), plane, num, den),
                          want):
        rtol, atol = PLANES_TOLERANCES[dtype][name]
        torch.testing.assert_close(g.float(), w.float(), rtol=rtol, atol=atol,
                                   msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,H,with_bias,dead_row", SHAPES)
def test_k2_source_matches_plain(kernels, B, N, H, with_bias, dead_row, dtype):
    q, k, v, alive, bias, scale = _case(B, N, H, dtype, with_bias, dead_row, seed=1)
    (out, _, _), stats = _k1(kernels[0], q, k, v, alive, bias, scale)
    rng = np.random.RandomState(2)
    d_out = torch.from_numpy(rng.randn(B, N, H * 64).astype(np.float32)).to(dtype)
    d_cls, d_col = (torch.from_numpy(rng.randn(B, N - 1).astype(np.float32)) for _ in range(2))
    bias_in = torch.zeros(B, N) if bias is None else bias
    f32 = dict(dtype=torch.float32)
    ismax = torch.empty((B, -(-N // 64), N, 64), dtype=torch.int16)
    clsrow, drow, dbias_h, rowlg = (torch.empty((B, H, N), **f32) for _ in range(4))
    ssum, csum, dbias = (torch.empty((B, N), **f32) for _ in range(3))
    deff, dq, dk, dv = (torch.empty((B, N, H, 64), dtype=dtype) for _ in range(4))
    err = kernels[1](
        _DTYPES[dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), q.stride(0), q.stride(1),
        alive.data_ptr(), bias_in.data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(),
        stats[2].data_ptr(), out.data_ptr(), d_out.data_ptr(), d_cls.data_ptr(),
        d_col.data_ptr(), ismax.data_ptr(), clsrow.data_ptr(), ssum.data_ptr(), csum.data_ptr(),
        drow.data_ptr(), dbias_h.data_ptr(), deff.data_ptr(), rowlg.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), dbias.data_ptr(), B, N, H, 64,
        pass_m_chunks(B, N, dtype), scale, None)
    assert err == 0
    got = (dq.view(B, N, H, 64), dk.view(B, N, H, 64), dv.view(B, N, H, 64), dbias)
    want = attention_scores_bwd_plain(q, k, v, alive, bias, scale, d_out, d_cls, d_col)
    for g in got:
        assert torch.isfinite(g.float()).all()
    compare_k2(dict(q=q, k=k, alive=alive, bias_in=bias_in, scale=scale), got, want,
               K2_TOL[dtype], "emulated")
    if dead_row:
        assert all(not g[-1].float().any() for g in got)


@pytest.fixture(scope="module")
def k5():
    if not cuda_emu.available():
        pytest.skip("needs g++ for the CPU emulator")
    fn = cuda_emu.build(CSRC / "ffn.cu").k5_ffn  # its fp32 half (CUDA_EMULATOR)
    fn.argtypes = [I32] + [P] * 7 + [I32] * 8 + [P]
    fn.restype = I32
    return fn


def _k5_case(M, D, F, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(M, D).astype(np.float32),
            (rng.randn(F, D) * D ** -0.5).astype(np.float32),
            (rng.randn(F) * 0.1).astype(np.float32),
            (rng.randn(D, F) * F ** -0.5).astype(np.float32),
            (rng.randn(D) * 0.1).astype(np.float32))


def _k5(fn, args, act, plans=None):
    x, w1, b1, w2, b2 = (torch.from_numpy(a) for a in args)
    M, D = x.shape
    F = w1.shape[0]
    plans = plans or (*fp32_plan(M, F, D), *fp32_plan(M, D, F))
    hidden, y = torch.empty(M, F), torch.empty(M, D)
    assert fn(0, x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
              hidden.data_ptr(), y.data_ptr(), M, D, F, ACTS[act], *plans, None) == 0
    return y, mlp_plain(x, w1, b1, w2, b2, act)


@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
@pytest.mark.parametrize("M,D,F", [(M, D, F) for M in (1, 17, 130, 300)
                                   for D, F in ((128, 256), (256, 512))])
def test_k5_fp32_source_matches_plain_and_jax(k5, M, D, F, act):
    """fp32 K5 on ``fp32_plan``'s plans (row tiles of 16, 32 and 128 rows,
    K split 2 to 8 ways into clusters) against ``mlp_plain`` and the TPU
    kernel in interpret mode, at 1e-5."""
    args = _k5_case(M, D, F, seed=M + D)
    got, want = _k5(k5, args, act)
    rtol, atol = K5_TOL[torch.float32]
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
    x, w1, b1, w2, b2 = args
    jax_y = np.asarray(fused_mlp_2d(jnp.asarray(x), jnp.asarray(w1.T), jnp.asarray(b1),
                                    jnp.asarray(w2.T), jnp.asarray(b2), act=act,
                                    interpret=True))
    np.testing.assert_allclose(got.numpy(), jax_y, rtol=rtol, atol=atol)


@pytest.mark.parametrize("tm,split", [(1, 1), (2, 1), (4, 1), (8, 1), (1, MAX_SPLIT),
                                      (4, 2), (8, 4)])
def test_k5_fp32_every_tile_and_split(k5, tm, split):
    """Every row tile, unsplit and split, on both GEMMs of a ragged M = 70
    (past the 16-, 32- and 64-row tiles' edges)."""
    args = _k5_case(70, 128, 256, seed=tm * 10 + split)
    got, want = _k5(k5, args, "gelu", plans=(tm, split, tm, split))
    torch.testing.assert_close(got, want, rtol=K5_TOL[torch.float32][0],
                               atol=K5_TOL[torch.float32][1])


@pytest.mark.parametrize("M,N,K,plan", [
    (1, 3072, 768, (1, 8)), (16, 768, 3072, (1, 8)), (17, 768, 3072, (2, 8)),
    (32, 768, 3072, (2, 8)), (33, 768, 3072, (4, 8)), (64, 3072, 768, (4, 8)),
    (65, 768, 3072, (8, 8)), (480, 3072, 768, (8, 1)), (608, 768, 3072, (8, 4)),
    (800, 3072, 768, (8, 2)), (800, 768, 3072, (8, 2)), (18944, 768, 3072, (8, 1)),
    (1, 128, 128, (1, 2)), (1, 128, 256, (1, 4))])
def test_k5_fp32_plan_edges(M, N, K, plan):
    """``fp32_plan`` at its edges: the row tile steps at M = 16, 32, 64;
    split until 80 blocks of 128 rows (a block an SM) or 132 of the smaller
    tiles, once more where 128-row blocks would end in a partial second
    wave (M = 800 at F = 3072), never past 8 ways or below 64-deep slices
    (K = 128: 2 ways at most)."""
    assert fp32_plan(M, N, K) == plan
    tm, split = plan
    assert split == 1 or (K // split >= MIN_SLICE and split <= MAX_SPLIT)


@pytest.fixture(scope="module")
def k4():
    if not cuda_emu.available():
        pytest.skip("needs g++ for the CPU emulator")
    fn = cuda_emu.build(CSRC / "cross_attention.cu").k4_cross_attention
    fn.argtypes = [I32, P, P, P, I64, I64, I64, I64, P, P, P, P] + [I32] * 7 \
        + [ctypes.c_float, P]
    fn.restype = I32
    return fn


def _k4_case(B, Nq, S, H, with_bias, seed):
    """fp32 K4 inputs: q a strided view of a packed [B, Nq, 3 H 64] tensor, k
    and v views of one [B, S, 2 H 64] tensor (the key and value linears
    packed), a quarter of the keys dead, the last batch row with none alive,
    PAD_BIAS on about a fifth with ``with_bias``."""
    rng = np.random.RandomState(seed)
    q = torch.from_numpy(rng.randn(B, Nq, 3 * H * 64).astype(np.float32))[..., :H * 64]
    kv = torch.from_numpy(rng.randn(B, S, 2 * H * 64).astype(np.float32))
    q, k, v = (t.unflatten(-1, (H, 64)) for t in (q, kv[..., :H * 64], kv[..., H * 64:]))
    alive = rng.rand(B, S) > 0.25
    alive[:, 0] = True
    alive[-1] = False
    bias = (rng.rand(B, S) < 0.2).astype(np.float32) * -10000.0 if with_bias else None
    return (q, k, v, torch.from_numpy(alive),
            None if bias is None else torch.from_numpy(bias), 64 ** -0.5)


def _k4(fn, q, k, v, alive, bias, scale, chunks, chunk_keys, want_err=0):
    B, Nq, H, Dh = q.shape
    S = k.shape[1]
    out = torch.empty(B, Nq, H, Dh)
    part = torch.empty(chunks * B * H * Nq * (Dh + 2)) if chunks > 1 else None
    err = fn(0, q.data_ptr(), k.data_ptr(), v.data_ptr(), q.stride(0), q.stride(1),
             k.stride(0), k.stride(1), alive.data_ptr(),
             None if bias is None else bias.data_ptr(), out.data_ptr(),
             None if part is None else part.data_ptr(), B, Nq, S, H, Dh, chunks, chunk_keys,
             scale, None)
    assert err == want_err
    return out.view(B, Nq, H * Dh)


@pytest.mark.parametrize("Nq", [1, 7, 40, 70])
@pytest.mark.parametrize("S", [1, 65, 300, 1100])
def test_k4_fp32_source_matches_plain(k4, Nq, S):
    """fp32 K4 (the decode plan at Nq = 1, the row plan at 7, 40 and 70, past
    one 40-row query block) in the fewest chunks it takes (one, or two past
    its 1,024 keys), in 64-key chunks and as ``split_chunks``' fp32 rule
    splits, against ``cross_attention_plain`` within K4's fp32 tolerance;
    the batch row with no alive key gives zeros.  A longer chunk is
    refused."""
    B, H = 2, 2
    q, k, v, alive, bias, scale = _k4_case(B, Nq, S, H, with_bias=(Nq + S) % 2 == 1,
                                           seed=Nq * 1000 + S)
    want = cross_attention_plain(q, k, v, alive, bias, scale)
    tiles = -(-S // KEY_TILE)
    fewest = -(-tiles // -(-S // FP32_MAX_CHUNK_KEYS)) * KEY_TILE
    splits = {(-(-S // fewest), fewest), (tiles, KEY_TILE),
              split_chunks(B, H, Nq, S, torch.float32)}
    if S > FP32_MAX_CHUNK_KEYS:  # cudaErrorInvalidValue
        _k4(k4, q, k, v, alive, bias, scale, 1, tiles * KEY_TILE, want_err=1)
    for chunks, chunk_keys in sorted(splits):
        got = _k4(k4, q, k, v, alive, bias, scale, chunks, chunk_keys)
        torch.testing.assert_close(got, want, rtol=K4_TOL[torch.float32][0],
                                   atol=K4_TOL[torch.float32][1],
                                   msg=lambda m: f"{chunks} chunks of {chunk_keys}: {m}")
        assert not got[-1].any()


@pytest.mark.parametrize("Nq", [2, 4, 40])
def test_k4_fp32_source_matches_jax(k4, Nq):
    """Where every row has an alive key, fp32 K4 (the decode plan at 2 and 4
    queries, the row plan at 40) equals the TPU kernel in interpret mode
    within K4's fp32 tolerance, split by the fp32 rule."""
    B, H, S = 2, 2, 130
    q, k, v, alive, bias, scale = _k4_case(B, Nq, S, H, with_bias=True, seed=Nq)
    alive[-1] = torch.from_numpy(np.random.RandomState(7).rand(S) > 0.25)
    alive[-1, 0] = True
    got = _k4(k4, q, k, v, alive, bias, scale, *split_chunks(B, H, Nq, S, torch.float32))
    j = fused_cross_attention(*(jnp.asarray(t.permute(0, 2, 3, 1).numpy()) for t in (q, k, v)),
                              jnp.asarray(alive.numpy()), jnp.asarray(bias.numpy()),
                              scale=scale, interpret=True)
    j = np.asarray(j).transpose(0, 3, 1, 2).reshape(B, Nq, H * 64)
    np.testing.assert_allclose(got.numpy(), j, rtol=K4_TOL[torch.float32][0],
                               atol=K4_TOL[torch.float32][1])
