"""Kernel K1 against its plain PyTorch version on the card (the checks of
``chip_smoke.py`` phase 2).  Needs an NVIDIA GPU with nvcc; skipped elsewhere.

Run on the card: ``python -m pytest tests/test_torch_cuda.py -q -m cuda``.
"""

import pytest
import torch

from chip_smoke import k1_case
from madtp_tpu_torch.kernels.attention_scores import TOLERANCES, attention_scores_cuda
from madtp_tpu_torch.ops.attention import attention_scores, attention_scores_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _compare(q, k, v, alive, bias):
    bias_in = torch.zeros(alive.shape, device=q.device) if bias is None else bias
    got = attention_scores_cuda(q, k, v, alive, bias_in, q.shape[-1] ** -0.5)
    want = attention_scores_plain(q, k, v, alive, bias, q.shape[-1] ** -0.5)
    torch.cuda.synchronize()
    for name, g, w in zip(("out", "cls_attn", "col_mass"), got, want):
        rtol, atol = TOLERANCES[q.dtype][name]
        torch.testing.assert_close(g.float(), w.float(), rtol=rtol, atol=atol,
                                   msg=lambda m: f"{name}: {m}")
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,with_bias", [
    (64, 584, False), (64, 592, False), (64, 320, False), (32, 35, True),
    (3, 2, True), (3, 65, False)])
def test_k1_matches_plain(cuda, B, N, with_bias, dtype):
    _compare(*k1_case(B, N, with_bias=with_bias, dtype=dtype, device=cuda))


def test_k1_dead_rows_and_determinism(cuda):
    """A batch row with no alive key gives zeros (not NaN); col_mass is the
    same bit for bit on a second launch."""
    q, k, v, alive, bias = k1_case(4, 130, with_bias=True, dtype=torch.float32,
                                   device=cuda)
    alive[1] = False
    out, cls, col = _compare(q, k, v, alive, bias)
    assert not out[1].any() and not col[1].any() and not cls[1].any()
    assert torch.equal(attention_scores_cuda(
        q, k, v, alive, bias, q.shape[-1] ** -0.5)[2], col)


def test_k1_dispatch_and_refusals(cuda):
    """CUDA tensors go through the kernel (the count grows); inputs the
    kernel does not take raise instead of falling back."""
    q, k, v, alive, _ = k1_case(2, 40, with_bias=False, dtype=torch.float32, device=cuda)
    before = attention_scores_cuda.launches
    attention_scores(q, k, v, alive)
    assert attention_scores_cuda.launches == before + 1
    with pytest.raises(ValueError):
        attention_scores(q.half(), k.half(), v.half(), alive)
    with pytest.raises(ValueError):
        q32, k32, v32 = (t[..., :32] for t in (q, k, v))
        attention_scores(q32, k32, v32, alive)
