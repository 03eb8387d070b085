"""The port's layers, attention and MAG query against the JAX package (CPU,
fp32).  Attention tolerances are those of tests/test_pallas.py: out 2e-6,
cls_attn/col_mass 1e-6."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from madtp_tpu.ops import attention as JA
from madtp_tpu.ops import layers as JL
from madtp_tpu.ops.pallas.fused_attention import fused_attention_scores
from madtp_tpu.prune.query import query_model as j_query_model
from madtp_tpu_torch.ops import attention as TA
from madtp_tpu_torch.ops import layers as TL
from madtp_tpu_torch.prune.query import query_model as t_query_model

PAD_BIAS = -10000.0


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _qkv_alive_bias(B, H, N, Dh, seed, with_bias):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, H, N, Dh).astype(np.float32) for _ in range(3))
    alive = rng.rand(B, N) > 0.3
    alive[:, 0] = True
    alive[1, N // 2:] = False
    bias = ((rng.rand(B, N) < 0.25).astype(np.float32) * PAD_BIAS
            if with_bias else None)
    return q, k, v, alive, bias


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("need_scores", [False, True])
def test_attention_core_matches_jax(with_bias, need_scores):
    q, k, v, alive, bias = _qkv_alive_bias(2, 4, 40, 16, 0, with_bias)
    alive[0, :] = False  # a fully masked batch row: zeros, not NaN
    kw = dict(key_alive=alive, query_alive=alive, need_scores=need_scores)
    j_out, j_aux = JA.attention_core(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        key_bias=None if bias is None else jnp.asarray(bias),
        **{n: jnp.asarray(a) if isinstance(a, np.ndarray) else a for n, a in kw.items()})
    t_out, t_aux = TA.attention_core(
        _t(q), _t(k), _t(v), key_bias=None if bias is None else _t(bias),
        **{n: _t(a) if isinstance(a, np.ndarray) else a for n, a in kw.items()})
    assert torch.isfinite(t_out).all()
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=2e-6)
    if need_scores:
        np.testing.assert_allclose(t_aux.col_mass.numpy(), np.asarray(j_aux.col_mass), atol=1e-6)
        np.testing.assert_allclose(t_aux.cls_attn.numpy(), np.asarray(j_aux.cls_attn), atol=1e-6)
    else:
        assert t_aux.col_mass is None and t_aux.cls_attn is None


@pytest.mark.parametrize("with_bias", [False, True])
def test_attention_scores_matches_fused_kernel_interpret(with_bias):
    """The CPU path of attention_scores (K1's plain version) against the TPU
    kernel run in interpret mode, in the port's [B, N, H, Dh] layout."""
    B, H, N, Dh = 2, 4, 128, 16
    q, k, v, alive, bias = _qkv_alive_bias(B, H, N, Dh, 1, with_bias)
    j_out, j_col, j_cls = fused_attention_scores(
        *(jnp.asarray(x.transpose(0, 1, 3, 2)) for x in (q, k, v)),
        jnp.asarray(alive), None if bias is None else jnp.asarray(bias),
        num_heads=H, scale=Dh ** -0.5, interpret=True)
    j_out = np.asarray(j_out).transpose(0, 3, 1, 2).reshape(B, N, H * Dh)
    out, cls, col = TA.attention_scores(
        *(_t(x.transpose(0, 2, 1, 3)) for x in (q, k, v)), _t(alive),
        None if bias is None else _t(bias))
    np.testing.assert_allclose(out.numpy(), j_out, atol=2e-6)
    np.testing.assert_allclose(col.numpy(), np.asarray(j_col)[:, 1:], atol=1e-6)
    np.testing.assert_allclose(cls.numpy(), np.asarray(j_cls)[:, 1:], atol=1e-6)


def test_attention_scores_rejects_other_devices():
    q = torch.zeros(1, 4, 2, 64, device="meta")
    with pytest.raises(ValueError):
        TA.attention_scores(q, q, q, torch.ones(1, 4, dtype=torch.bool, device="meta"))


def test_layers_match_jax():
    rng = np.random.RandomState(2)
    x = rng.randn(2, 5, 24).astype(np.float32)
    w = (rng.randn(24, 40) * 0.1).astype(np.float32)  # JAX kernel [in, out]
    b = rng.randn(40).astype(np.float32)
    p = {"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}
    np.testing.assert_allclose(TL.linear(_t(x), _t(w.T), _t(b)).numpy(),
                               np.asarray(JL.linear(p, jnp.asarray(x))), atol=1e-6)
    s, c = rng.randn(24).astype(np.float32), rng.randn(24).astype(np.float32)
    np.testing.assert_allclose(
        TL.layer_norm(_t(x), _t(s), _t(c), 1e-6).numpy(),
        np.asarray(JL.layer_norm({"scale": jnp.asarray(s), "bias": jnp.asarray(c)},
                                 jnp.asarray(x), 1e-6)), atol=2e-6)
    np.testing.assert_allclose(TL.gelu(_t(x)).numpy(), np.asarray(JL.gelu(jnp.asarray(x))),
                               atol=1e-6)
    images = rng.randn(2, 3, 32, 32).astype(np.float32)
    kern = (rng.randn(3 * 8 * 8, 24) * 0.05).astype(np.float32)
    pe = {"kernel": jnp.asarray(kern), "bias": jnp.asarray(b[:24])}
    conv_w = kern.T.reshape(24, 3, 8, 8)
    np.testing.assert_allclose(
        TL.patch_embed(_t(images), _t(conv_w), _t(b[:24])).numpy(),
        np.asarray(JL.patch_embed(pe, jnp.asarray(images))), atol=1e-5)
    # the conv weight's (c, kh, kw) rows reproduce the convolution
    ref = torch.nn.functional.conv2d(_t(images), _t(conv_w), _t(b[:24]), stride=8)
    np.testing.assert_allclose(TL.patch_embed(_t(images), _t(conv_w), _t(b[:24])).numpy(),
                               ref.flatten(2).transpose(1, 2).numpy(), atol=1e-5)


def test_query_model_matches_jax():
    rng = np.random.RandomState(3)
    ft = rng.randn(2, 30, 32).astype(np.float32)
    sd = rng.randn(10, 32).astype(np.float32)
    alive = rng.rand(2, 30) > 0.4
    alive[:, 0] = True
    j_ta, j_sd = j_query_model(None, jnp.asarray(ft), jnp.asarray(sd), alive=jnp.asarray(alive))
    t_ta, t_sd = t_query_model(_t(ft), _t(sd), _t(alive))
    np.testing.assert_allclose(t_ta.numpy(), np.asarray(j_ta), atol=1e-5)
    np.testing.assert_allclose(t_sd.numpy(), np.asarray(j_sd), atol=1e-5)
