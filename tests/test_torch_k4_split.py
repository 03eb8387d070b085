"""K4's key split (``kernels.cross_attention.split_chunks``), on the CPU: the
chunks cover every key once, and merging the plain per-chunk partials
(running max, sum, unnormalised out) in chunk order, as the bf16 kernel's
``k4_combine`` does, equals ``cross_attention_plain`` within 1e-6 (fp32).
The kernel itself is held on the card (``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from madtp_tpu_torch.kernels.cross_attention import (KEY_TILE, cross_attention_split_plain,
                                                     split_chunks)
from madtp_tpu_torch.ops.attention import cross_attention_plain

# (B, H, Nq, S): the main paths' shapes (retrieval ITM, VQA gather / dense /
# 640 mask, the BOS step, NLVR's twin cross) and ragged ones
SHAPES = [(256, 12, 35, 256), (256, 12, 35, 592), (16, 12, 22, 448), (16, 12, 22, 901),
          (16, 12, 40, 1616), (16, 12, 1, 448), (32, 12, 32, 320), (8, 12, 7, 130),
          (8, 12, 1, 100), (4, 12, 70, 200), (1, 1, 1, 1), (1, 1, 1, 65), (2, 12, 35, 900)]


@pytest.mark.parametrize("B,H,Nq,S", SHAPES)
def test_split_covers_every_key_once(B, H, Nq, S):
    chunks, chunk_keys = split_chunks(B, H, Nq, S)
    assert chunks >= 1 and chunk_keys % KEY_TILE == 0
    covered = np.concatenate([np.arange(c * chunk_keys, min(S, (c + 1) * chunk_keys))
                              for c in range(chunks)])
    np.testing.assert_array_equal(covered, np.arange(S))  # in order, each once, none empty
    assert (chunks - 1) * chunk_keys < S <= chunks * chunk_keys


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


@pytest.mark.parametrize("B,Nq,S,with_bias", [(4, 40, 600, True), (3, 22, 901, False),
                                              (2, 7, 530, True), (2, 70, 300, False)])
def test_merged_chunks_equal_the_plain_version(B, Nq, S, with_bias):
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
    chunks, chunk_keys = split_chunks(B, H, Nq, S)
    assert chunks > 1
    got = cross_attention_split_plain(q, k, v, alive, bias, scale, chunks, chunk_keys)
    want = cross_attention_plain(q, k, v, alive, bias, scale)
    assert not got[0].any()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
