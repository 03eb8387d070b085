"""K4's key split (``kernels.cross_attention.split_chunks``, a rule for each
dtype), on the CPU: the chunks cover every key once, fp32's hold at most
``FP32_MAX_CHUNK_KEYS`` keys, the rule is a function of the shape alone, and
merging the plain per-chunk partials (running max, sum, unnormalised out) in
chunk order, as the kernels' ``k4_combine`` does, equals
``cross_attention_plain`` within 1e-6 (fp32).  The kernels themselves are
held on the card (``tests/test_torch_cuda.py``) and, fp32, on the CPU
emulator (``tests/test_torch_kernel_emu.py``)."""

import numpy as np
import pytest
import torch

from madtp_tpu_torch.kernels.cross_attention import (FP32_MAX_CHUNK_KEYS, KEY_TILE,
                                                     cross_attention_split_plain,
                                                     split_chunks)
from madtp_tpu_torch.ops.attention import cross_attention_plain


def _cases(bf16, fp32):
    """pytest params: the bf16 cases under their plain ids, the fp32 ones
    under ids that start with ``fp32``."""
    return ([pytest.param(*c, torch.bfloat16, id="-".join(map(str, c))) for c in bf16]
            + [pytest.param(*c, torch.float32, id="fp32-" + "-".join(map(str, c)))
               for c in fp32])


# (B, H, Nq, S): the main paths' shapes (retrieval ITM, VQA gather / dense /
# 640 mask, the BOS step, NLVR's twin cross) and ragged ones; in fp32 the
# training paths' (NLVR's twin cross, the retrieval ITM's 96 rows, the caption
# controller's decode, the VQA-640 mask memory past one 1,024-key chunk)
SHAPES = [(256, 12, 35, 256), (256, 12, 35, 592), (16, 12, 22, 448), (16, 12, 22, 901),
          (16, 12, 40, 1616), (16, 12, 1, 448), (32, 12, 32, 320), (8, 12, 7, 130),
          (8, 12, 1, 100), (4, 12, 70, 200), (1, 1, 1, 1), (1, 1, 1, 65), (2, 12, 35, 900)]
FP32_SHAPES = [(16, 12, 40, 592), (96, 12, 35, 592), (96, 12, 1, 577), (24, 12, 1, 320),
               (16, 12, 40, 1616), (4, 12, 40, 600), (1, 1, 1, 1), (1, 1, 70, 5000),
               (2, 12, 35, 900)]


@pytest.mark.parametrize("B,H,Nq,S,dtype", _cases(SHAPES, FP32_SHAPES))
def test_split_covers_every_key_once(B, H, Nq, S, dtype):
    chunks, chunk_keys = split_chunks(B, H, Nq, S, dtype)
    assert chunks >= 1 and chunk_keys % KEY_TILE == 0
    assert (chunks, chunk_keys) == split_chunks(B, H, Nq, S, dtype)  # the shape's alone
    covered = np.concatenate([np.arange(c * chunk_keys, min(S, (c + 1) * chunk_keys))
                              for c in range(chunks)])
    np.testing.assert_array_equal(covered, np.arange(S))  # in order, each once, none empty
    assert (chunks - 1) * chunk_keys < S <= chunks * chunk_keys
    if dtype == torch.float32:
        assert chunk_keys <= FP32_MAX_CHUNK_KEYS


def test_split_rule_splits_where_the_card_is_short_of_blocks():
    """One chunk where B H gives at least two blocks an SM (the ITM rerank,
    NLVR's twin cross), several on the VQA memories (192 blocks), at most
    one for every 256 keys."""
    assert split_chunks(256, 12, 35, 256) == (1, 256)
    assert split_chunks(32, 12, 32, 320) == (1, 320)
    assert split_chunks(16, 12, 40, 1616) == (6, 320)
    assert split_chunks(16, 12, 22, 901) == (4, 256)
    assert split_chunks(16, 12, 22, 448) == (2, 256)
    assert split_chunks(8, 12, 1, 100) == (1, 128)


@pytest.mark.parametrize("shape,want", [
    ((16, 12, 40, 592), (1, 640)), ((96, 12, 1, 577), (1, 640)), ((24, 12, 1, 320), (1, 320)),
    ((16, 12, 40, 1616), (2, 832)), ((10, 12, 41, 100), (1, 128)), ((4, 12, 40, 600), (3, 256)),
    ((2, 12, 1, 3000), (10, 320)), ((1, 1, 70, 5000), (20, 256))])
def test_fp32_split_rule(shape, want):
    """fp32: one chunk wherever B H (times the 40-row query blocks) gives a
    block an SM, the NLVR train step's and the decode's included; under
    that up to 264 blocks, at most one chunk for every 256 keys; never more
    than 1,024 keys a chunk (the VQA-640 mask memory's 1,616 in two)."""
    assert split_chunks(*shape, torch.float32) == want


@pytest.mark.parametrize("B,Nq,S,with_bias,dtype", _cases(
    [(4, 40, 600, True), (3, 22, 901, False), (2, 7, 530, True), (2, 70, 300, False)],
    [(4, 40, 600, True), (2, 1, 1300, False), (2, 3, 530, True), (3, 41, 900, False)]))
def test_merged_chunks_equal_the_plain_version(B, Nq, S, with_bias, dtype):
    H, Dh = 12, 64
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, n, H, Dh), dtype=np.float32))
               for n in (Nq, S, S))
    alive = torch.from_numpy(rng.random((B, S)) > 0.25)
    alive[0] = False  # a row with no alive key: zeros
    alive[1, :200] = False  # whole chunks with no alive key
    bias = (torch.from_numpy((rng.random((B, S)) < 0.2).astype(np.float32)) * -10000.0
            if with_bias else None)
    scale = Dh ** -0.5
    chunks, chunk_keys = split_chunks(B, H, Nq, S, dtype)
    assert chunks > 1
    got = cross_attention_split_plain(q, k, v, alive, bias, scale, chunks, chunk_keys)
    want = cross_attention_plain(q, k, v, alive, bias, scale)
    assert not got[0].any()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
