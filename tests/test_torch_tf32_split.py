"""3xTF32, the fp32 arithmetic of K2 on the card, emulated on the CPU.

K2 multiplies fp32 operands on the tensor cores as three TF32 products:
a = hi + lo with hi = tf32(a) and lo = tf32(a - hi), each rounded to the
nearest 10-bit mantissa with ties away from zero (``cvt.rna.tf32.f32``), and
a b = hi_a lo_b + lo_a hi_b + hi_a hi_b accumulated in fp32.  Here the split
is made with integer operations on the fp32 bits and every product of K1's
and K2's plain versions goes through it (K2 recomputes K1's forward): the
results stay within the fp32 ``TOLERANCES`` of the plain fp32 results and of
the JAX package's ``attention_core``, and a two-layer ViT keeps the same
tokens.  K1's own fp32 half stays on the CUDA cores: with 3xTF32 the
full-width card-against-CPU checks drifted past their limits (PERF.md), which
these small CPU cases cannot show.
"""

import dataclasses
from contextlib import contextmanager
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _nlvr_setup
from chip_smoke import compare_k2
from madtp_tpu.models.vit import vit_forward
from madtp_tpu.ops import attention as JA
from madtp_tpu_torch.ckpt.convert import nlvr_from_jax_params
from madtp_tpu_torch.core.config import BlipConfig, MedConfig, ViTConfig
from madtp_tpu_torch.kernels.attention_scores import TOLERANCES as K1_TOL
from madtp_tpu_torch.kernels.attention_scores_bwd import TOLERANCES as K2_TOL
from madtp_tpu_torch.ops import attention as TA

PAD_BIAS = -10000.0
_matmul = torch.matmul


def tf32_rna(x):
    """fp32 -> the nearest value with a 10-bit mantissa, ties away from zero,
    as ``cvt.rna.tf32.f32`` rounds (its low 13 bits cleared)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def matmul3(a, b):
    """a @ b as the kernels form it: hi lo + lo hi + hi hi, in fp32."""
    a_hi, a_lo = split(a.float())
    b_hi, b_lo = split(b.float())
    return _matmul(a_hi, b_lo) + _matmul(a_lo, b_hi) + _matmul(a_hi, b_hi)


class Matmul3(torch.autograd.Function):
    """``matmul3`` whose gradients are 3xTF32 products too, as K2's are."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return matmul3(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        return matmul3(g, b.transpose(-1, -2)), matmul3(a.transpose(-1, -2), g)


@contextmanager
def products_in_3xtf32():
    """While active, the port's plain attention multiplies as the kernels do."""
    core = TA.attention_core

    def split_core(*args, **kw):
        with mock.patch.object(torch, "matmul", Matmul3.apply):
            return core(*args, **kw)

    with mock.patch.object(TA, "attention_core", split_core):
        yield


def _case(B, N, H, seed, with_bias):
    rng = np.random.RandomState(seed)
    q, k, v = (torch.from_numpy(rng.randn(B, N, H, 64).astype(np.float32)) for _ in range(3))
    alive = rng.rand(B, N) > 0.25
    alive[:, 0] = True
    alive[:, N - 2:] = False
    bias = (rng.rand(B, N) < 0.2).astype(np.float32) * PAD_BIAS if with_bias else None
    return q, k, v, torch.from_numpy(alive), None if bias is None else torch.from_numpy(bias)


@pytest.mark.parametrize("x", [1.0, -1.0, 3.0e-5, -7.25e3, 1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                               1.0 + 3 * 2.0 ** -12, 65504.0 - 2.0 ** -3])
def test_rna_rounding(x):
    """The nearest 10-bit mantissa, ties away from zero; hi + lo within 2^-21
    of the value."""
    t = torch.tensor([x], dtype=torch.float32)
    hi, lo = split(t)
    e = np.floor(np.log2(abs(x)))
    step = 2.0 ** (e - 10)
    q = abs(x) / step
    want = np.sign(x) * (np.floor(q + 0.5)) * step  # half away from zero on |x|
    assert float(hi) == want
    assert int(hi.view(torch.int32)) & 0x1FFF == 0 and int(lo.view(torch.int32)) & 0x1FFF == 0
    assert abs(float(hi) + float(lo) - x) <= 2.0 ** -21 * abs(x)


@pytest.mark.parametrize("B,N,H,with_bias", [(2, 40, 4, True), (2, 70, 12, False),
                                             (1, 130, 16, True)])
def test_k1_in_3xtf32_within_fp32_tolerance(B, N, H, with_bias):
    """K1's plain version with every product in 3xTF32 against the plain
    fp32 version and the JAX package's attention, within K1's fp32
    tolerances."""
    q, k, v, alive, bias = _case(B, N, H, 0, with_bias)
    scale = 64 ** -0.5
    want = TA.attention_scores_plain(q, k, v, alive, bias, scale)
    with products_in_3xtf32():
        got = TA.attention_scores_plain(q, k, v, alive, bias, scale)
    j_out, j_aux = JA.attention_core(
        *(jnp.asarray(t.transpose(1, 2).numpy()) for t in (q, k, v)), scale=scale,
        key_bias=None if bias is None else jnp.asarray(bias.numpy()),
        key_alive=jnp.asarray(alive.numpy()), query_alive=jnp.asarray(alive.numpy()),
        need_scores=True)
    jax_res = (np.asarray(j_out), np.asarray(j_aux.cls_attn), np.asarray(j_aux.col_mass))
    for name, g, w, j in zip(("out", "cls_attn", "col_mass"), got, want, jax_res):
        rtol, atol = K1_TOL[torch.float32][name]
        torch.testing.assert_close(g, w, rtol=rtol, atol=atol)
        np.testing.assert_allclose(g.numpy(), j, rtol=rtol, atol=atol)


@pytest.mark.parametrize("B,N,H,with_bias", [(2, 40, 4, True), (2, 70, 12, False),
                                             (1, 130, 16, True)])
def test_k2_in_3xtf32_within_fp32_tolerance(B, N, H, with_bias):
    """K2's plain version (autograd) with every product, forward and
    backward, in 3xTF32 against the plain fp32 gradients within K2's fp32
    tolerances, head-max near ties left out as on the card."""
    q, k, v, alive, bias = _case(B, N, H, 1, with_bias)
    scale = 64 ** -0.5
    rng = np.random.RandomState(2)
    d_out = torch.from_numpy(rng.randn(B, N, H * 64).astype(np.float32))
    d_cls, d_col = (torch.from_numpy(rng.randn(B, N - 1).astype(np.float32)) for _ in range(2))
    want = TA.attention_scores_bwd_plain(q, k, v, alive, bias, scale, d_out, d_cls, d_col)
    with products_in_3xtf32():
        got = TA.attention_scores_bwd_plain(q, k, v, alive, bias, scale, d_out, d_cls, d_col)
    bias_in = torch.zeros(B, N) if bias is None else bias
    compare_k2(dict(q=q, k=k, alive=alive, bias_in=bias_in, scale=scale), got, want,
               K2_TOL[torch.float32], "3xTF32")


@pytest.fixture(scope="module")
def vit_setup():
    jcfg, params, _, _, _, _ = _nlvr_setup(
        image_size=64, B=2, text_len=8,
        vit_kw=dict(embed_dim=128, depth=2, num_heads=2),
        med_kw=dict(hidden_size=64, num_hidden_layers=1, num_attention_heads=4,
                    intermediate_size=128, merge_start_layer=1, vocab_size=100,
                    max_position_embeddings=16))
    tcfg = BlipConfig(ViTConfig(**dataclasses.asdict(jcfg.vit)),
                      MedConfig(**dataclasses.asdict(jcfg.med)), jcfg.sd_num, jcfg.sd_dim)
    model = nlvr_from_jax_params(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    images = np.random.RandomState(4).randn(4, 3, 64, 64).astype(np.float32)
    return dict(jcfg=jcfg, params=params, vit=model.visual_encoder,
                space_dict=model.space_dict, images=images)


@pytest.mark.parametrize("temperature", [20.0, 40.0])
def test_vit_kept_counts_unchanged_in_3xtf32(vit_setup, temperature):
    """A two-layer ViT in mask mode keeps the same tokens with its scoring
    attention's products in 3xTF32 as in fp32 and as ``vit_forward``."""
    s = vit_setup
    images = torch.from_numpy(s["images"])
    kw = dict(space_dict=s["space_dict"], temperature=temperature, prune_active=True)
    with torch.no_grad():
        ref = s["vit"](images, **kw)
        with products_in_3xtf32():
            got = s["vit"](images, **kw)
    _, _, j_kept = jax.jit(
        lambda p, im: vit_forward(p["visual_encoder"], im, cfg=s["jcfg"].vit,
                                  space_dict=p["space_dict"], temperature=temperature,
                                  prune_active=True))(s["params"], s["images"])
    assert torch.equal(got.kept_counts, ref.kept_counts)
    np.testing.assert_array_equal(got.kept_counts.numpy(), np.asarray(j_kept))
    assert torch.equal(got.state.alive, ref.state.alive)
    assert int(got.kept_counts[-1]) < 16  # the temperature prunes
