"""Kernels K1, K2, K4 and K5 against their plain PyTorch versions on the card
(the checks of ``chip_smoke.py``), K1 also in K3's range (N > 1536, where
the TPU runs its query-tiled kernel), K1 and K2 on both sides of every tile
edge of their tensor-core designs, at H = 16 and where pass B / pass M split
the query tiles (each relaunch bit-identical), the autograd pairings (K1
with K2, K4 and K5 with the plain version's backward), the FFN routing
rule, and the refusals; K4 at the decode's one query per row, an fp32 decode
step on the card against the CPU, and beam search with no hidden wait on the
card.  Needs an NVIDIA GPU with nvcc; skipped elsewhere.

Run on the card: ``python -m pytest --noconftest tests/test_torch_cuda.py -q``.
"""

import copy

import pytest
import torch

from chip_smoke import compare_k2, k1_case, k2_case, k4_case, k5_case
from madtp_tpu_torch.kernels import attention_scores_bwd as k2
from madtp_tpu_torch.kernels import cross_attention as k4
from madtp_tpu_torch.kernels import ffn as k5
from madtp_tpu_torch.ops import layers
from madtp_tpu_torch.kernels.attention_scores import (LARGE_N, TOLERANCES,
                                                      attention_scores_cuda, pass_b_chunks)
from madtp_tpu_torch.kernels.attention_scores_bwd import attention_scores_bwd_cuda
from madtp_tpu_torch.kernels.cross_attention import cross_attention_cuda
from madtp_tpu_torch.core.config import MedConfig
from madtp_tpu_torch.models.med import MedDecoder, init_decode_cache
from madtp_tpu_torch.prune.dtp import TokenState
from madtp_tpu_torch.tasks.caption import beam_generate
from madtp_tpu_torch.ops.attention import (attention_scores, attention_scores_bwd_plain,
                                           attention_scores_plain, cross_attention,
                                           cross_attention_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _compare(q, k, v, alive, bias):
    bias_in = torch.zeros(alive.shape, device=q.device) if bias is None else bias
    with torch.no_grad():
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N", [(8, 584), (4, 608), (2, 130)])
def test_k1_at_sixteen_heads(cuda, B, N, dtype):
    """K1 at the CLIP ViT-L vision tower's head count, H = 16 (gather 584
    and mask-mode 608 slots), which no BLIP path reaches."""
    _compare(*k1_case(B, N, with_bias=False, dtype=dtype, device=cuda, H=16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,with_bias", [
    (2, 1537, True), (2, 1608, False), (1, 2305, True), (1, 4096, False)])
def test_k1_in_k3_range(cuda, B, N, with_bias, dtype):
    """K1 where the TPU runs K3 (``fused_attention_scores_tiled``): one slot
    past 1,536, the VQA-640 gather path's first layer (1,608), a ragged
    2,305 and K3's ceiling 4,096; random dead keys and a dead tail cross the
    64-wide tiles.  Each launch counts as one of K3's, and a second launch
    gives the same bits."""
    q, k, v, alive, bias = k1_case(B, N, with_bias=with_bias, dtype=dtype, device=cuda)
    before = attention_scores_cuda.large_n_launches
    got = _compare(q, k, v, alive, bias)
    bias_in = torch.zeros(alive.shape, device=cuda) if bias is None else bias
    again = attention_scores_cuda(q, k, v, alive, bias_in, q.shape[-1] ** -0.5)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert attention_scores_cuda.large_n_launches == before + 2


# N on both sides of every tile edge: 16-row warps, 32-key (fp32) and
# 64-key (bf16) pass-B blocks, 64-key pass-A and pass-Q/K tiles, 128-row
# pass-B stages
EDGE_NS = [15, 16, 17, 31, 32, 33, 63, 64, 65, 127, 128, 129]


def _relaunch_k1(q, k, v, alive, bias, got):
    bias_in = torch.zeros(alive.shape, device=q.device) if bias is None else bias
    with torch.no_grad():
        again = attention_scores_cuda(q, k, v, alive, bias_in, q.shape[-1] ** -0.5)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N", EDGE_NS)
def test_k1_tile_edges(cuda, N, dtype):
    """K1 at N on both sides of each tile edge of its tensor-core design,
    with PAD_BIAS keys, and a second launch bit-identical."""
    case = k1_case(3, N, with_bias=True, dtype=dtype, device=cuda)
    _relaunch_k1(*case, _compare(*case))


@pytest.mark.parametrize("B,N,H", [(2, 300, 12), (1, 700, 16)])
def test_k1_query_split(cuda, B, N, H):
    """Shapes short of blocks, where bf16 pass B splits the query tiles
    across blocks and ``k1_colsum`` adds their column partials: within
    tolerance and bit-identical on a second launch."""
    dtype = torch.bfloat16
    assert pass_b_chunks(B, N, dtype) > 1
    case = k1_case(B, N, with_bias=False, dtype=dtype, device=cuda, H=H)
    _relaunch_k1(*case, _compare(*case))


def test_k1_large_n_count(cuda):
    """The count of K3's range follows the TPU's rule: N = 1536 is the full
    kernel's, N = 1537 the tiled one's."""
    assert LARGE_N == 1536
    for N, step in ((LARGE_N, 0), (LARGE_N + 1, 1)):
        q, k, v, alive, _ = k1_case(1, N, with_bias=False, dtype=torch.bfloat16, device=cuda,
                                    H=2)
        launches, large = attention_scores_cuda.launches, attention_scores_cuda.large_n_launches
        with torch.inference_mode():
            attention_scores(q, k, v, alive)
        assert attention_scores_cuda.launches == launches + 1
        assert attention_scores_cuda.large_n_launches == large + step


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
    q17, k17, v17, alive17, _ = k1_case(1, 8, with_bias=False, dtype=torch.float32,
                                        device=cuda, H=17)
    with pytest.raises(ValueError, match="heads"):
        attention_scores(q17, k17, v17, alive17)


def test_k1_refuses_inputs_that_need_a_gradient(cuda):
    """K1's outputs carry no gradient, so a direct call that would drop one
    raises; under no_grad it runs."""
    q, k, v, alive, _ = k1_case(2, 40, with_bias=False, dtype=torch.float32, device=cuda)
    bias = torch.zeros(alive.shape, device=cuda)
    qg = q.detach().requires_grad_()
    with pytest.raises(RuntimeError, match="no gradient"):
        attention_scores_cuda(qg, k, v, alive, bias, 0.125)
    with torch.no_grad():
        attention_scores_cuda(qg, k, v, alive, bias, 0.125)


def _k2_compare(c):
    got = attention_scores_bwd_cuda(c["q"], c["k"], c["v"], c["alive"], c["bias_in"],
                                    c["scale"], c["out"], c["stats"], c["d_out"],
                                    c["d_cls"], c["d_col"])
    want = attention_scores_bwd_plain(c["q"], c["k"], c["v"], c["alive"], c["bias"],
                                      c["scale"], c["d_out"], c["d_cls"], c["d_col"])
    torch.cuda.synchronize()
    compare_k2(c, got, want, k2.TOLERANCES[c["q"].dtype], "")
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,with_bias", [
    (32, 592, False), (32, 584, False), (16, 40, True), (16, 26, True),
    (3, 2, True), (3, 65, False), (16, 901, False)])
def test_k2_matches_plain(cuda, B, N, with_bias, dtype):
    _k2_compare(k2_case(B, N, with_bias=with_bias, dtype=dtype, device=cuda))


def _relaunch_k2(c, got):
    again = attention_scores_bwd_cuda(*(c[n] for n in ("q", "k", "v", "alive", "bias_in",
                                                       "scale", "out", "stats", "d_out",
                                                       "d_cls", "d_col")))
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N", EDGE_NS)
def test_k2_tile_edges(cuda, N, dtype):
    """K2 at the same N as ``test_k1_tile_edges``, with PAD_BIAS keys, and a
    second launch bit-identical."""
    c = k2_case(3, N, with_bias=True, dtype=dtype, device=cuda)
    _relaunch_k2(c, _k2_compare(c))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,H", [(4, 130, 16), (2, 300, 16)])
def test_k2_at_sixteen_heads(cuda, B, N, H, dtype):
    """K2 at H = 16, the head-max mask's full width (16 bits), also where
    pass M splits the query tiles across blocks; a second launch
    bit-identical."""
    assert B == 4 or k2.pass_m_chunks(B, N, dtype) > 1
    c = k2_case(B, N, with_bias=True, dtype=dtype, device=cuda, H=H)
    _relaunch_k2(c, _k2_compare(c))


def test_k2_dead_rows_and_determinism(cuda):
    """A batch row with no alive key gets zero gradients, not NaN; K2 uses
    no float atomics, so a second launch gives the same bits."""
    c = k2_case(4, 130, with_bias=True, dtype=torch.float32, device=cuda)
    c["alive"][1] = False
    with torch.no_grad():
        c["out"], _, _, c["stats"] = attention_scores_cuda(
            c["q"], c["k"], c["v"], c["alive"], c["bias_in"], c["scale"], return_stats=True)
    first = _k2_compare(c)
    for g in first:
        assert torch.isfinite(g).all() and not g[1].any()
    again = attention_scores_bwd_cuda(c["q"], c["k"], c["v"], c["alive"], c["bias_in"],
                                      c["scale"], c["out"], c["stats"], c["d_out"],
                                      c["d_cls"], c["d_col"])
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scoring_attention_gradients(cuda, packed, dtype):
    """attention_scores with inputs that need a gradient goes through
    ScoringAttention (one K1 and one K2 launch) and returns the gradients
    autograd finds through the plain version, for views of one packed qkv
    (the ViT) and for three separate tensors (the MED text side)."""
    q, k, v, alive, bias = k1_case(4, 70, with_bias=True, dtype=dtype, device=cuda)
    if not packed:
        q, k, v = (t.contiguous() for t in (q, k, v))
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    bias_g = bias.clone().requires_grad_()
    gen = torch.Generator(device=cuda).manual_seed(0)
    k1_before, k2_before = attention_scores_cuda.launches, attention_scores_bwd_cuda.launches
    outs = attention_scores(*leaves, alive, bias_g)
    weights = [torch.randn(o.shape, generator=gen, device=cuda) for o in outs]
    loss = sum((o.float() * w).sum() for o, w in zip(outs, weights))
    got = torch.autograd.grad(loss, (*leaves, bias_g))
    assert attention_scores_cuda.launches == k1_before + 1
    assert attention_scores_bwd_cuda.launches == k2_before + 1
    assert outs[0].grad_fn is not None and "ScoringAttention" in type(outs[0].grad_fn).__name__
    scale = q.shape[-1] ** -0.5
    want = attention_scores_bwd_plain(q, k, v, alive, bias, scale, weights[0].to(dtype),
                                      weights[1], weights[2])
    compare_k2(dict(q=q, k=k, alive=alive, bias_in=bias, scale=scale), got, want,
               k2.TOLERANCES[dtype], "ScoringAttention")


def test_scoring_attention_eval_launches_k1_alone(cuda):
    """Under inference_mode (the eval step) the Function is not used."""
    q, k, v, alive, _ = k1_case(2, 40, with_bias=False, dtype=torch.float32, device=cuda)
    before = attention_scores_cuda.launches
    with torch.inference_mode():
        out, _, _ = attention_scores(q, k, v, alive)
    assert out.grad_fn is None and attention_scores_cuda.launches == before + 1


def test_remat_relaunches_k1_and_keeps_the_gradients(cuda):
    """With the last ViT block recomputed in the backward pass, K1 runs once
    more for it, K2 once per forward launch, and the loss is that without
    remat bit for bit (K1 is deterministic, so the recompute takes the same
    DTP decisions); the gradients agree to fp32 rounding (PyTorch's own
    backward kernels may sum with atomics)."""
    import dataclasses

    from madtp_tpu_torch.core.config import BlipConfig, MedConfig, ViTConfig
    from madtp_tpu_torch.models.blip import init_nlvr_model

    vit = ViTConfig(image_size=64, embed_dim=128, depth=2, num_heads=2, sd_dim=128)
    med = MedConfig(hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
                    intermediate_size=256, vocab_size=100, max_position_embeddings=32,
                    twin_cross=True, encoder_width=128, sd_dim=128, merge_start_layer=1)
    cfg = BlipConfig(vit, med, sd_num=16, sd_dim=128)
    gen = torch.Generator().manual_seed(0)
    images = torch.randn(4, 3, 64, 64, generator=gen).to(cuda)
    ids = torch.randint(1, 100, (2, 10), generator=gen).to(cuda)
    mask = torch.ones(2, 10, dtype=torch.int64, device=cuda)
    targets = torch.tensor([0, 1], device=cuda)
    runs = []
    for remat in (False, True):
        c = cfg._replace(vit=dataclasses.replace(vit, grad_checkpoint=remat, ckpt_layers=1))
        model = init_nlvr_model(c, seed=0, device=cuda)
        k1, k2 = attention_scores_cuda.launches, attention_scores_bwd_cuda.launches
        lo, lf, _ = model(images, ids, mask, temperature=20.0, prune_active=True,
                          targets=targets)
        (lo + 0.1 * lf).backward()
        runs.append((float(lo.detach()), [p.grad for p in model.parameters()],
                     attention_scores_cuda.launches - k1, attention_scores_bwd_cuda.launches - k2))
    (lo, grads, k1, k2), (lo_r, grads_r, k1_r, k2_r) = runs
    assert (k1, k2) == (4, 4) and (k1_r, k2_r) == (5, 4)
    assert lo_r == lo
    for a, b in zip(grads, grads_r):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-7)


def test_k2_refusals(cuda):
    """K2 raises on what it does not take: another head width, dtype,
    layout, or more than 16 heads."""
    c = k2_case(2, 40, with_bias=False, dtype=torch.float32, device=cuda)
    args = [c[n] for n in ("q", "k", "v", "alive", "bias_in", "scale", "out", "stats",
                           "d_out", "d_cls", "d_col")]

    def call(**repl):
        a = list(args)
        names = ("q", "k", "v", "alive", "bias_in", "scale", "out", "stats", "d_out",
                 "d_cls", "d_col")
        for n, val in repl.items():
            a[names.index(n)] = val
        return attention_scores_bwd_cuda(*a)

    q, k, v = args[:3]
    with pytest.raises(ValueError):
        call(q=q[..., :32], k=k[..., :32], v=v[..., :32])
    with pytest.raises(ValueError):
        call(q=q.half(), k=k.half(), v=v.half())
    with pytest.raises(ValueError):
        call(k=k.contiguous())  # strides differ from q's
    with pytest.raises(ValueError):
        call(d_out=c["d_out"].double())
    with pytest.raises(ValueError):
        call(d_col=c["d_col"][:, :-1])
    # K1 takes at most 16 heads too, so the 17-head case's out and stats are
    # stand-ins of the right shapes: K2 refuses before it reads them
    q17, k17, v17, alive17, _ = k1_case(1, 8, with_bias=False, dtype=torch.float32,
                                        device=cuda, H=17)
    zeros = torch.zeros(1, 8, device=cuda)
    with pytest.raises(ValueError, match="heads"):
        attention_scores_bwd_cuda(q17, k17, v17, alive17, zeros, 0.125,
                                  torch.zeros(1, 8, 17 * 64, device=cuda),
                                  torch.zeros(3, 1, 17, 8, device=cuda),
                                  torch.zeros(1, 8, 17 * 64, device=cuda),
                                  torch.zeros(1, 7, device=cuda), torch.zeros(1, 7, device=cuda))


def _k4_compare(q, k, v, alive, bias):
    scale = q.shape[-1] ** -0.5
    with torch.no_grad():
        got = cross_attention_cuda(q, k, v, alive, bias, scale)
    want = cross_attention_plain(q, k, v, alive, bias, scale)
    torch.cuda.synchronize()
    rtol, atol = k4.TOLERANCES[q.dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("B,Nq,S,packed_q", [
    (256, 35, 592, False), (256, 35, 320, False), (32, 32, 320, False), (4, 1, 100, False),
    (4, 7, 130, True), (3, 65, 64, False), (2, 130, 1, True), (16, 1, 40, False),
    (16, 40, 1616, False), (16, 22, 901, True)])
def test_k4_matches_plain(cuda, B, Nq, S, packed_q, with_bias, dtype):
    """The ITM and twin-cross shapes; ragged Nq (1, 7, and past one 64-row
    query tile), S not a multiple of the 64-key tile, a strided q view; the
    VQA decoder's BOS step (one query over a ~40-slot question state, whose
    padding rides as the key bias); the VQA-640 mask memory (1,616 slots)
    and the VQA dense one (901), where bf16 splits the keys into chunks."""
    _k4_compare(*k4_case(B, Nq, S, with_bias=with_bias, dtype=dtype, device=cuda,
                         packed_q=packed_q))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,with_bias", [(96, 192, False), (96, 577, False), (48, 40, True)])
def test_k4_at_one_query(cuda, B, S, with_bias, dtype):
    """K4 at the beam decode's shape, one query per row: 32 images x 3 beams
    over a pruned and a dense caption memory (192 and 577 image slots), and
    VQA generate's 16 questions x 3 beams over a question state whose
    padding rides as the key bias."""
    _k4_compare(*k4_case(B, 1, S, with_bias=with_bias, dtype=dtype, device=cuda))


@pytest.mark.parametrize("dtype,S", [(torch.float32, 150), (torch.bfloat16, 150),
                                     (torch.bfloat16, 600)])
def test_k4_dead_rows_determinism_and_count(cuda, dtype, S):
    """A batch row with no alive key gives zeros (the plain version's rule);
    a second launch gives the same bits, also where bf16 splits the keys and
    merges the chunks (S = 600: 3 chunks); each launch adds one to the
    count."""
    if dtype == torch.bfloat16:
        assert k4.split_chunks(4, 12, 40, S)[0] == (1 if S == 150 else 3)
    q, k, v, alive, bias = k4_case(4, 40, S, with_bias=True, dtype=dtype, device=cuda)
    alive[1] = False
    before = cross_attention_cuda.launches
    out = _k4_compare(q, k, v, alive, bias)
    assert not out[1].any() and torch.isfinite(out).all()
    again = cross_attention_cuda(q, k, v, alive, bias, q.shape[-1] ** -0.5)
    assert torch.equal(out, again)
    assert cross_attention_cuda.launches == before + 2


def test_k4_refusals(cuda):
    """K4 raises on what it does not take: CPU tensors, another dtype or
    head width, mismatched shapes or strides, and inputs that need a
    gradient while grad mode is on."""
    q, k, v, alive, bias = k4_case(2, 9, 70, with_bias=True, dtype=torch.float32, device=cuda)
    scale = 0.125

    def call(**repl):
        a = dict(q=q, k=k, v=v, alive=alive, bias=bias)
        a.update(repl)
        return cross_attention_cuda(a["q"], a["k"], a["v"], a["alive"], a["bias"], scale)

    for bad in (dict(q=q.cpu(), k=k.cpu(), v=v.cpu(), alive=alive.cpu(), bias=bias.cpu()),
                dict(q=q.half(), k=k.half(), v=v.half()),
                dict(q=q[..., :32], k=k[..., :32], v=v[..., :32]),
                dict(v=v[:, :-1]),
                dict(k=k.transpose(1, 2).contiguous().transpose(1, 2)),
                dict(alive=alive[:, :-1]),
                dict(bias=bias.double())):
        with pytest.raises(ValueError):
            call(**bad)
    with pytest.raises(RuntimeError, match="no gradient"):
        call(q=q.detach().requires_grad_())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cross_attention_dispatch_and_gradients(cuda, dtype):
    """cross_attention on CUDA tensors: under inference_mode straight to K4;
    with inputs that need a gradient through CrossAttention (one K4 launch),
    whose gradients are the plain version's autograd gradients."""
    q, k, v, alive, bias = k4_case(3, 26, 200, with_bias=True, dtype=dtype, device=cuda,
                                   packed_q=True)
    before = cross_attention_cuda.launches
    with torch.inference_mode():
        out = cross_attention(q, k, v, alive, bias)
    assert out.grad_fn is None and cross_attention_cuda.launches == before + 1

    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    bias_g = bias.clone().requires_grad_()
    w = torch.randn(out.shape, generator=torch.Generator(device=cuda).manual_seed(0),
                    device=cuda)
    got_out = cross_attention(*leaves, alive, bias_g)
    assert "CrossAttention" in type(got_out.grad_fn).__name__
    assert cross_attention_cuda.launches == before + 2
    got = torch.autograd.grad((got_out.float() * w).sum(), (*leaves, bias_g))
    ref = [t.detach().requires_grad_() for t in (q, k, v)]
    ref_b = bias.clone().requires_grad_()
    want_out = cross_attention_plain(*ref, alive, ref_b, q.shape[-1] ** -0.5)
    want = torch.autograd.grad((want_out.float() * w).sum(), (*ref, ref_b))
    rtol, atol = k4.TOLERANCES[dtype]
    torch.testing.assert_close(got_out.float(), want_out.float(), rtol=rtol, atol=atol)
    for g, wnt in zip(got, want):  # both backward passes are the plain version's
        torch.testing.assert_close(g, wnt, rtol=1e-5, atol=1e-6)


def _k5_compare(x, w1, b1, w2, b2, act):
    with torch.no_grad():
        got = k5.ffn_cuda(x, w1, b1, w2, b2, act)
    want = layers.mlp_plain(x, w1, b1, w2, b2, act)
    torch.cuda.synchronize()
    rtol, atol = k5.TOLERANCES[x.dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
@pytest.mark.parametrize("M,D,F", [
    (32 * 584, 1024, 4096), (32 * 96, 768, 3072), (8 * 584, 768, 3072), (1000, 768, 3072),
    (1, 128, 128), (130, 256, 384)])
def test_k5_matches_plain(cuda, M, D, F, act, dtype):
    """The CLIP vision and text towers' widths, BLIP's, and ragged M (one
    row, and past one 128-row tile); widths that are multiples of 128 but
    not of the bf16 kernel's 256-wide tile; fp32 and bf16."""
    _k5_compare(*k5_case(M, D, F, cuda, dtype=dtype), act)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k5_determinism_and_count(cuda, dtype):
    """A second launch gives the same bits; each call adds one to the count,
    and an fp32 call to the fp32 count too."""
    args = k5_case(300, 256, 512, cuda, dtype=dtype)
    before, before32 = k5.ffn_cuda.launches, k5.ffn_cuda.fp32_launches
    out = _k5_compare(*args, "quick_gelu")
    assert torch.equal(out, k5.ffn_cuda(*args, "quick_gelu"))
    assert k5.ffn_cuda.launches == before + 2
    assert k5.ffn_cuda.fp32_launches == before32 + (2 if dtype == torch.float32 else 0)


def test_k5_refusals(cuda):
    """K5 raises on what it does not take: CPU tensors, fp16, mismatched
    dtypes, a missing bias, widths off its 128 tile, a strided input, an
    unknown activation, and inputs that need a gradient while grad mode is
    on."""
    x, w1, b1, w2, b2 = k5_case(40, 256, 512, cuda)
    off_d = k5_case(40, 192, 512, cuda)
    off_f = k5_case(40, 256, 320, cuda)
    bad = [dict(x=x.cpu(), w1=w1.cpu(), b1=b1.cpu(), w2=w2.cpu(), b2=b2.cpu()),
           dict(x=x.half(), w1=w1.half(), b1=b1.half(), w2=w2.half(), b2=b2.half()),
           dict(w1=w1.float()), dict(b2=None), dict(b1=b1[:-1]),
           dict(zip(("x", "w1", "b1", "w2", "b2"), off_d)),
           dict(zip(("x", "w1", "b1", "w2", "b2"), off_f)),
           dict(x=torch.cat([x, x], dim=1)[:, ::2]), dict(act="relu")]
    base = dict(x=x, w1=w1, b1=b1, w2=w2, b2=b2, act="gelu")
    for repl in bad:
        a = dict(base, **repl)
        with pytest.raises(ValueError):
            k5.ffn_cuda(a["x"], a["w1"], a["b1"], a["w2"], a["b2"], a["act"])
    with pytest.raises(RuntimeError, match="no gradient"):
        k5.ffn_cuda(x.detach().requires_grad_(), w1, b1, w2, b2)


def _linears(w1, b1, w2, b2):
    fc1, fc2 = torch.nn.Linear(1, 1), torch.nn.Linear(1, 1)
    fc1.weight, fc1.bias = torch.nn.Parameter(w1), torch.nn.Parameter(b1)
    fc2.weight, fc2.bias = torch.nn.Parameter(w2), torch.nn.Parameter(b2)
    return fc1, fc2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
def test_fused_mlp_gradients(cuda, act, dtype):
    """mlp on inputs that need a gradient goes through FusedMLP (one K5
    launch); its gradients are those autograd finds through the plain
    version, whose recompute its backward is."""
    x, w1, b1, w2, b2 = k5_case(3 * 70, 256, 512, cuda, seed=1, dtype=dtype)
    x = x.view(3, 70, 256)
    fc1, fc2 = _linears(w1, b1, w2, b2)
    xg = x.clone().requires_grad_()
    gen = torch.Generator(device=cuda).manual_seed(0)
    w = torch.randn(x.shape, generator=gen, device=cuda)
    before = k5.ffn_cuda.launches
    y = layers.mlp(xg, fc1, fc2, act=act)
    fused = y.grad_fn.next_functions[0][0]  # y is a view of FusedMLP's 2-D output
    assert "FusedMLP" in type(fused).__name__ and k5.ffn_cuda.launches == before + 1
    params = [xg, fc1.weight, fc1.bias, fc2.weight, fc2.bias]
    got = torch.autograd.grad((y.float() * w).sum(), params)
    ref = [t.detach().clone().requires_grad_() for t in params]
    want_y = layers.mlp_plain(*ref, act)
    want = torch.autograd.grad((want_y.float() * w).sum(), ref)
    rtol, atol = k5.TOLERANCES[dtype]
    torch.testing.assert_close(y.float(), want_y.float(), rtol=rtol, atol=atol)
    for g, wnt in zip(got, want):  # both backward passes are the plain version's
        torch.testing.assert_close(g, wnt)


def test_mlp_routing_rule(cuda):
    """On the card every bf16 and fp32 FFN goes to K5 (straight to the
    kernel under inference_mode), the fp32 one counted as fp32 too; an fp16
    one is refused."""
    x, w1, b1, w2, b2 = k5_case(64, 256, 512, cuda)
    fc1, fc2 = _linears(w1, b1, w2, b2)
    before, before32 = k5.ffn_cuda.launches, k5.ffn_cuda.fp32_launches
    with torch.inference_mode():
        y = layers.mlp(x.view(4, 16, 256), fc1, fc2)
    assert k5.ffn_cuda.launches == before + 1 and y.shape == (4, 16, 256)
    assert y.grad_fn is None and k5.ffn_cuda.fp32_launches == before32
    fc1_32, fc2_32 = _linears(w1.float(), b1.float(), w2.float(), b2.float())
    with torch.inference_mode():
        y32 = layers.mlp(x.float(), fc1_32, fc2_32, act="quick_gelu")
    assert k5.ffn_cuda.launches == before + 2 and y32.dtype == torch.float32
    assert k5.ffn_cuda.fp32_launches == before32 + 1
    torch.testing.assert_close(y32, layers.mlp_plain(x.float(), *(t.float() for t in (
        w1, b1, w2, b2)), "quick_gelu"), rtol=k5.TOLERANCES[torch.float32][0],
        atol=k5.TOLERANCES[torch.float32][1])
    fc1_16, fc2_16 = _linears(w1.half(), b1.half(), w2.half(), b2.half())
    with torch.inference_mode(), pytest.raises(ValueError):
        layers.mlp(x.half(), fc1_16, fc2_16)


def _decoder_and_memory():
    """A 2-layer decoder (width 128, 2 heads of 64, torch's default init)
    and a memory of 2 rows x 50 slots with dead slots and a padding bias,
    on the CPU in fp32."""
    torch.manual_seed(0)
    cfg = MedConfig(vocab_size=64, hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
                    intermediate_size=256, max_position_embeddings=16, encoder_width=128)
    decoder = MedDecoder(cfg).eval()
    g = torch.Generator().manual_seed(1)
    alive = torch.ones(2, 50, dtype=torch.bool)
    alive[0, 40:] = False
    bias = torch.zeros(2, 50)
    bias[1, 45:] = -10000.0
    return decoder, TokenState(torch.randn(2, 50, 128, generator=g), alive, bias)


def _to(state, device):
    return TokenState(*(t.to(device) for t in state))


def test_decode_step_on_the_card_matches_the_cpu(cuda):
    """``MedDecoder.step`` in fp32 over 6 positions on the card (K4 and K5
    in each layer) against the CPU run: hidden states and caches within
    1e-5; each step launches K4 and K5 once a layer."""
    cpu, mem = _decoder_and_memory()
    card = copy.deepcopy(cpu).to(cuda)
    ids = torch.randint(0, 64, (2, 6), generator=torch.Generator().manual_seed(2))
    caches = {d: init_decode_cache(cpu.cfg, 2, 8, device=d) for d in ("cpu", cuda)}
    positions = torch.arange(8, device=cuda)
    before = cross_attention_cuda.launches, k5.ffn_cuda.launches
    with torch.inference_mode():
        for t in range(6):
            want, caches["cpu"] = cpu.step(ids[:, t:t + 1], torch.tensor(t), caches["cpu"], mem)
            got, caches[cuda] = card.step(ids[:, t:t + 1].to(cuda), positions[t], caches[cuda],
                                          _to(mem, cuda))
            torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-5)
    for a, b in zip(caches[cuda], caches["cpu"]):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-5)
    assert (cross_attention_cuda.launches - before[0], k5.ffn_cuda.launches - before[1]) == (12, 12)


@pytest.mark.parametrize("repetition_penalty", [1.0, 1.2])
def test_beam_generate_on_the_card_waits_for_nothing(cuda, repetition_penalty):
    """The whole beam search on the card under ``set_sync_debug_mode("error")``
    (any read-back to the host raises) gives the CPU's sequences, fp32."""
    cpu, mem = _decoder_and_memory()
    card = copy.deepcopy(cpu).to(cuda)
    prompt = torch.tensor([[60, 5, 6, 7], [60, 5, 6, 7]])
    kw = dict(num_beams=3, max_length=12, min_length=3, eos_token_id=3,
              repetition_penalty=repetition_penalty)
    want = beam_generate(cpu, mem, prompt, **kw)
    prompt_d, mem_d = prompt.to(cuda), _to(mem, cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = beam_generate(card, mem_d, prompt_d, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(got.cpu(), want)


# ---------------------------------------------------------------- captured steps


def _tiny_nlvr(cuda, dtype):
    """A two-layer NLVR model the kernels take (heads of 64, widths of 128)
    and one batch of 2 pairs."""
    from madtp_tpu_torch.core.config import BlipConfig, ViTConfig
    from madtp_tpu_torch.models.blip import init_nlvr_model

    vit = ViTConfig(image_size=64, patch_size=16, embed_dim=128, depth=2, num_heads=2,
                    sd_dim=128)
    med = MedConfig(hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
                    intermediate_size=256, twin_cross=True, encoder_width=128, vocab_size=64,
                    max_position_embeddings=16, merge_start_layer=1, sd_dim=128)
    model = init_nlvr_model(BlipConfig(vit, med, sd_num=16, sd_dim=128), seed=0, device=cuda,
                            dtype=dtype)
    g = torch.Generator().manual_seed(1)
    images = torch.randn(4, 3, 64, 64, generator=g).to(cuda, dtype)
    ids = torch.randint(1, 64, (2, 10), generator=g).to(cuda)
    mask = torch.ones(2, 10, dtype=torch.long, device=cuda)
    mask[1, 7:] = 0
    return model, (images, ids, mask)


def _equal(a, b):
    return all((x is None and y is None) or torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["dense", "mask", "gather"])
def test_captured_step_replays_bit_equal_to_eager(cuda, mode, dtype):
    """The NLVR step as a CUDA graph against the same step run eagerly
    (``graph=False``): bit-equal at the captured temperature and, replayed
    with no new capture, at a second one; each replay launches the kernels
    its capture recorded and counts them."""
    from madtp_tpu_torch.tasks.nlvr import make_eval_step
    from madtp_tpu_torch.utils.graph import model_cache

    model, batch = _tiny_nlvr(cuda, dtype)
    caps = {"dense": (False, None, None), "mask": (True, None, None),
            "gather": (True, (12, 8), (6, 6))}[mode]
    step, eager = make_eval_step(model, *caps), make_eval_step(model, *caps, graph=False)
    temps = (0.0,) if mode == "dense" else (4.0, 0.5)
    step(*batch, temps[0])
    per_replay = (attention_scores_cuda.launches, k5.ffn_cuda.launches)
    step(*batch, temps[0])
    per_replay = tuple(b - a for a, b in zip(per_replay, (attention_scores_cuda.launches,
                                                          k5.ffn_cuda.launches)))
    assert per_replay == ((0 if mode == "dense" else 4), 4)
    for t in temps:
        got, want = step(*batch, t), eager(*batch, t)
        torch.cuda.synchronize()
        assert _equal(got, want), t
    assert len(model_cache(model)) == 1


def test_text_lengths_share_one_entry_and_its_pool(cuda):
    """Batches padded to other lengths get a graph each inside one entry,
    whose graphs share a memory pool: the first call of a length (its
    warm-up's outputs) and later replays in any order, two before either is
    read, are bit-equal to the eager step."""
    from madtp_tpu_torch.tasks.nlvr import make_eval_step
    from madtp_tpu_torch.utils.graph import CapturedStep, graph_count, model_cache

    model, (images, ids, mask) = _tiny_nlvr(cuda, torch.bfloat16)
    caps = (True, (12, 8), (6, 6))
    step, eager = make_eval_step(model, *caps), make_eval_step(model, *caps, graph=False)
    g = torch.Generator().manual_seed(5)
    batches = []
    for width in (10, 7, 13):
        b_ids = torch.randint(1, 64, (2, width), generator=g).to(cuda)
        b_mask = torch.ones(2, width, dtype=torch.long, device=cuda)
        b_mask[0, width - 2:] = 0
        batches.append((images, b_ids, b_mask))
    captures = CapturedStep.captures
    for b in batches:
        got, want = step(*b, 2.0), eager(*b, 2.0)
        torch.cuda.synchronize()
        assert _equal(got, want)
    assert CapturedStep.captures - captures == 3
    for order in ((2, 0, 1), (1, 2, 0)):
        got = [step(*batches[i], 2.0) for i in order]
        for i, out in zip(order, got):
            assert _equal(out, eager(*batches[i], 2.0)), i
    cache = model_cache(model)
    assert len(cache) == 1 and graph_count(cache) == 3
    assert CapturedStep.captures - captures == 3


def test_captured_caption_decode_is_bit_equal_to_eager(cuda):
    """The encode and the whole beam search as one graph give the eager
    run's sequences and kept counts, at two temperatures through one
    capture (bf16, gather mode)."""
    from madtp_tpu_torch.core.config import BlipConfig, ViTConfig
    from madtp_tpu_torch.data.tokenizer_bert import BertWordPieceTokenizer
    from madtp_tpu_torch.models.blip import init_caption_model
    from madtp_tpu_torch.tasks.caption import generate_captions
    from madtp_tpu_torch.utils.graph import model_cache

    tok = BertWordPieceTokenizer.toy("a picture of dog cat man on the table".split())
    vit = ViTConfig(image_size=64, patch_size=16, embed_dim=128, depth=2, num_heads=2,
                    sd_dim=128)
    med = MedConfig(vocab_size=len(tok.vocab), hidden_size=128, num_hidden_layers=2,
                    num_attention_heads=2, intermediate_size=256, encoder_width=128,
                    max_position_embeddings=32, sd_dim=128)
    model = init_caption_model(BlipConfig(vit, med, sd_num=16, sd_dim=128), seed=0,
                               device=cuda, dtype=torch.bfloat16)
    images = torch.randint(0, 256, (4, 64, 64, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(3)).numpy()
    kw = dict(max_length=12, min_length=3, capacities=(12, 8))
    for t in (4.0, 0.5):
        got = generate_captions(model, tok, images, t, **kw)
        want = generate_captions(model, tok, images, t, graph=False, **kw)
        torch.cuda.synchronize()
        assert _equal(got, want), t
    assert len(model_cache(model)) == 1


def test_capture_refuses_a_read_back(cuda):
    """A step that reads a value back to the host (``.item()``) raises at
    capture with its name, is not cached and does not run eagerly instead:
    the next call raises again."""
    from madtp_tpu_torch.utils.graph import CapturedStep, model_cache

    owner = torch.nn.Linear(4, 4).to(cuda)
    calls = []

    def step(x, t):
        calls.append(1)
        return owner(x) * t * owner(x).sum().item()

    captured = CapturedStep(step, "reads_back", owner)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="reads_back"):
            captured(torch.ones(2, 4, device=cuda), 1.0)
    assert len(model_cache(owner)) == 0
    assert len(calls) == 4  # per call: the warm-up and the capture, nothing eager after


# ---------------------------------------------------------------- retrieval training


@pytest.mark.parametrize("mode", ["mask", "gather"])
def test_retrieval_train_step_keeps_its_state_on_the_card(cuda, mode):
    """Two BLIP retrieval train steps (the kernels' widths: heads of 64) under
    ``set_sync_debug_mode("error")``: nothing reads back to the host, the
    queue's pointer stays a 0-d device tensor and moves on by the batch, the
    momentum towers and the queue stay fp32 on the card."""
    from madtp_tpu_torch.core.config import BlipConfig, ViTConfig
    from madtp_tpu_torch.models.blip import init_retrieval_model
    from madtp_tpu_torch.train.loops import init_retrieval_train_state, make_retrieval_train_step
    from madtp_tpu_torch.train.optim import make_adamw

    vit = ViTConfig(image_size=64, patch_size=16, embed_dim=128, depth=2, num_heads=2,
                    sd_dim=128)
    med = MedConfig(hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
                    intermediate_size=256, encoder_width=128, vocab_size=64,
                    max_position_embeddings=16, sd_dim=128)
    model = init_retrieval_model(BlipConfig(vit, med, sd_num=16, sd_dim=128), device=cuda)
    state = init_retrieval_train_state(model, queue_size=8)
    caps = {"mask": (None, None), "gather": ((24, 16), (12, 12))}[mode]
    step = make_retrieval_train_step(state, make_adamw(model.parameters(), 1e-5, 0.05),
                                     enc_token_id=63, capacities_v=caps[0],
                                     capacities_t=caps[1])
    g = torch.Generator().manual_seed(1)
    images = torch.randn(4, 3, 64, 64, generator=g).to(cuda)
    ids = torch.randint(1, 60, (4, 10), generator=g).to(cuda)
    mask = torch.ones(4, 10, dtype=torch.long, device=cuda)
    idx = torch.tensor([0, 1, 1, 2], device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            m = step(images, ids, mask, idx, 2.0, 0.2, generator=gen)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    q = state.queue
    assert q.ptr.device.type == "cuda" and q.ptr.dim() == 0 and int(q.ptr) == 0  # 2 x 4 of 8
    assert torch.equal(q.idx.cpu(), torch.tensor([0, 1, 1, 2] * 2))
    assert q.image.dtype == q.text.dtype == torch.float32
    assert all(t.device.type == "cuda" and t.dtype == torch.float32
               for t in state.params_m.values())
    assert all(torch.isfinite(v) for v in m.values())
