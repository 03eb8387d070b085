"""Kernels K1, K2, K4 and K5 against their plain PyTorch versions on the card
(the checks of ``chip_smoke.py``), the autograd pairings (K1 with K2, K4 and
K5 with the plain version's backward), the FFN routing rule, and the
refusals.  Needs an NVIDIA GPU with nvcc; skipped elsewhere.

Run on the card: ``python -m pytest --noconftest tests/test_torch_cuda.py -q``.
"""

import pytest
import torch

from chip_smoke import compare_k2, k1_case, k2_case, k4_case, k5_case
from madtp_tpu_torch.kernels import attention_scores_bwd as k2
from madtp_tpu_torch.kernels import cross_attention as k4
from madtp_tpu_torch.kernels import ffn as k5
from madtp_tpu_torch.ops import layers
from madtp_tpu_torch.kernels.attention_scores import TOLERANCES, attention_scores_cuda
from madtp_tpu_torch.kernels.attention_scores_bwd import attention_scores_bwd_cuda
from madtp_tpu_torch.kernels.cross_attention import cross_attention_cuda
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
    (3, 2, True), (3, 65, False)])
def test_k2_matches_plain(cuda, B, N, with_bias, dtype):
    _k2_compare(k2_case(B, N, with_bias=with_bias, dtype=dtype, device=cuda))


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
    wide = k2_case(1, 8, with_bias=False, dtype=torch.float32, device=cuda, H=17)
    with pytest.raises(ValueError, match="heads"):
        attention_scores_bwd_cuda(*(wide[n] for n in ("q", "k", "v", "alive", "bias_in",
                                                      "scale", "out", "stats", "d_out",
                                                      "d_cls", "d_col")))


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
    (4, 7, 130, True), (3, 65, 64, False), (2, 130, 1, True)])
def test_k4_matches_plain(cuda, B, Nq, S, packed_q, with_bias, dtype):
    """The ITM and twin-cross shapes; ragged Nq (1, 7, and past one 64-row
    query tile), S not a multiple of the 64-key tile, a strided q view."""
    _k4_compare(*k4_case(B, Nq, S, with_bias=with_bias, dtype=dtype, device=cuda,
                         packed_q=packed_q))


def test_k4_dead_rows_determinism_and_count(cuda):
    """A batch row with no alive key gives zeros (the plain version's rule);
    a second launch gives the same bits; each launch adds one to the count."""
    q, k, v, alive, bias = k4_case(4, 40, 150, with_bias=True, dtype=torch.float32,
                                   device=cuda)
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
    rtol, atol = k5.TOLERANCES[torch.bfloat16]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)
    return got


@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
@pytest.mark.parametrize("M,D,F", [
    (32 * 584, 1024, 4096), (32 * 96, 768, 3072), (8 * 584, 768, 3072), (1000, 768, 3072),
    (1, 128, 128), (130, 256, 384)])
def test_k5_matches_plain(cuda, M, D, F, act):
    """The CLIP vision and text towers' widths, BLIP's, and ragged M (one
    row, and past one 128-row tile)."""
    _k5_compare(*k5_case(M, D, F, cuda), act)


def test_k5_determinism_and_count(cuda):
    """A second launch gives the same bits; each call adds one to the count."""
    args = k5_case(300, 256, 512, cuda)
    before = k5.ffn_cuda.launches
    out = _k5_compare(*args, "quick_gelu")
    assert torch.equal(out, k5.ffn_cuda(*args, "quick_gelu"))
    assert k5.ffn_cuda.launches == before + 2


def test_k5_refusals(cuda):
    """K5 raises on what it does not take: CPU tensors, fp32, mismatched
    dtypes, a missing bias, widths off its 128 tile, a strided input, an
    unknown activation, and inputs that need a gradient while grad mode is
    on."""
    x, w1, b1, w2, b2 = k5_case(40, 256, 512, cuda)
    off_d = k5_case(40, 192, 512, cuda)
    off_f = k5_case(40, 256, 320, cuda)
    bad = [dict(x=x.cpu(), w1=w1.cpu(), b1=b1.cpu(), w2=w2.cpu(), b2=b2.cpu()),
           dict(x=x.float(), w1=w1.float(), b1=b1.float(), w2=w2.float(), b2=b2.float()),
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


@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
def test_fused_mlp_gradients(cuda, act):
    """mlp on bf16 inputs that need a gradient goes through FusedMLP (one K5
    launch); its gradients are those autograd finds through the plain
    version, whose recompute its backward is."""
    x, w1, b1, w2, b2 = k5_case(3 * 70, 256, 512, cuda, seed=1)
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
    rtol, atol = k5.TOLERANCES[torch.bfloat16]
    torch.testing.assert_close(y.float(), want_y.float(), rtol=rtol, atol=atol)
    for g, wnt in zip(got, want):  # both backward passes are the plain version's
        torch.testing.assert_close(g, wnt)


def test_mlp_routing_rule(cuda):
    """On the card a bf16 FFN goes to K5 (straight to the kernel under
    inference_mode) and an fp32 one stays on two linears."""
    x, w1, b1, w2, b2 = k5_case(64, 256, 512, cuda)
    fc1, fc2 = _linears(w1, b1, w2, b2)
    before = k5.ffn_cuda.launches
    with torch.inference_mode():
        y = layers.mlp(x.view(4, 16, 256), fc1, fc2)
    assert k5.ffn_cuda.launches == before + 1 and y.shape == (4, 16, 256)
    assert y.grad_fn is None
    fc1_32, fc2_32 = _linears(w1.float(), b1.float(), w2.float(), b2.float())
    with torch.inference_mode():
        y32 = layers.mlp(x.float(), fc1_32, fc2_32, act="quick_gelu")
    assert k5.ffn_cuda.launches == before + 1 and y32.dtype == torch.float32
