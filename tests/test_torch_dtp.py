"""The port's DTP, capacity calibration and FLOPs model against the JAX
package (CPU, fp32): masks, kept counts and overflow exactly equal, token
features within 1e-6, scores with exact ties included."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from madtp_tpu.core.config import MedConfig as JMed, ViTConfig as JViT
from madtp_tpu.prune import calibrate as JC, dtp as JD, flops as JF
from madtp_tpu_torch.core.config import MedConfig as TMed, ViTConfig as TViT
from madtp_tpu_torch.prune import calibrate as TC, dtp as TD, flops as TF

PAD_BIAS = -10000.0


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _case(seed, B=3, S=24, D=8, K=5, with_bias=True, dead_tail=4):
    """A token buffer with dead slots and signals whose scores tie: the
    column mass and CLS attention repeat in blocks, token_attn rows repeat."""
    rng = np.random.RandomState(seed)
    x = rng.randn(B, S, D).astype(np.float32)
    alive = rng.rand(B, S) > 0.2
    alive[:, 0] = True
    alive[:, S - dead_tail:] = False
    P = S - 1
    col = np.repeat(rng.rand(B, P // 4 + 1), 4, axis=1)[:, :P].astype(np.float32)
    cls = np.repeat(rng.rand(B, P // 4 + 1) * 0.05, 4, axis=1)[:, :P].astype(np.float32)
    ta = np.repeat(rng.randn(B, P // 4 + 1, K), 4, axis=1)[:, :P].astype(np.float32)
    col *= alive[:, 1:]
    bias = ((rng.rand(B, S) < 0.3) * PAD_BIAS).astype(np.float32) if with_bias else None
    return x, alive, bias, (cls, col, ta)


def _states(x, alive, bias):
    j = JD.TokenState(jnp.asarray(x), jnp.asarray(alive),
                      None if bias is None else jnp.asarray(bias))
    t = TD.TokenState(_t(x), _t(alive), None if bias is None else _t(bias))
    return j, t


def _signals(sig):
    return (JD.DTPSignals(*(jnp.asarray(s) for s in sig)),
            TD.DTPSignals(*(_t(s) for s in sig)))


def _assert_state(t, j):
    np.testing.assert_array_equal(t.alive.numpy(), np.asarray(j.alive))
    np.testing.assert_allclose(t.x.numpy(), np.asarray(j.x), atol=1e-6)
    if j.bias is None:
        assert t.bias is None
    else:
        np.testing.assert_array_equal(t.bias.numpy(), np.asarray(j.bias))


def test_scores_have_ties():
    x, alive, bias, sig = _case(0)
    score = TD.importance_score(TD.DTPSignals(*(_t(s) for s in sig)), _t(alive[:, 1:]))
    alive_scores = score[0][_t(alive[0, 1:])]
    assert len(torch.unique(alive_scores)) < len(alive_scores)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("row_independent", [False, True])
@pytest.mark.parametrize("temperature", [0.5, 3.0])
def test_dtp_prune_matches_jax(seed, with_bias, row_independent, temperature):
    x, alive, bias, sig = _case(seed, with_bias=with_bias)
    js, ts = _states(x, alive, bias)
    jsig, tsig = _signals(sig)
    merge_slot = 20
    j_state, j_kept = JD.dtp_prune(js, jsig, temperature, merge_slot,
                                   row_independent=row_independent)
    t_state, t_kept = TD.dtp_prune(ts, tsig, temperature, merge_slot,
                                   row_independent=row_independent)
    _assert_state(t_state, j_state)
    np.testing.assert_array_equal(t_kept.numpy(), np.asarray(j_kept))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("row_independent", [False, True])
@pytest.mark.parametrize("capacity", [20, 6])  # 6 forces overflow
def test_dtp_prune_gather_matches_jax(seed, with_bias, row_independent, capacity):
    x, alive, bias, sig = _case(seed, with_bias=with_bias)
    js, ts = _states(x, alive, bias)
    jsig, tsig = _signals(sig)
    j_state, j_kept, j_ovf = JD.dtp_prune_gather(
        js, jsig, 2.0, capacity, row_independent=row_independent)
    t_state, t_kept, t_ovf = TD.dtp_prune_gather(
        ts, tsig, 2.0, capacity, row_independent=row_independent)
    _assert_state(t_state, j_state)
    np.testing.assert_array_equal(t_kept.numpy(), np.asarray(j_kept))
    np.testing.assert_array_equal(t_ovf.numpy(), np.asarray(j_ovf))
    if capacity == 6:
        assert int(t_ovf.max()) > 0


@pytest.mark.parametrize("gather", [False, True])
def test_clip_variant_takes_a_per_row_max_keep(gather):
    """The CLIP text tower's row-independent EOT guard: the ``"clip"``
    variant with ``max_keep`` per row ([B], each row's ``eot_pos + 2``)
    against the JAX step, decisions and kept counts per row."""
    x, alive, bias, sig = _case(3, with_bias=False)
    js, ts = _states(x, alive, bias)
    jsig, tsig = _signals(sig)
    max_keep = np.array([2, 5, 9])
    kw = dict(variant="clip", row_independent=True)
    if gather:
        j_out = JD.dtp_prune_gather(js, jsig, 2.0, 20, max_keep=jnp.asarray(max_keep), **kw)
        t_out = TD.dtp_prune_gather(ts, tsig, 2.0, 20, max_keep=_t(max_keep), **kw)
    else:
        j_out = JD.dtp_prune(js, jsig, 2.0, 20, max_keep=jnp.asarray(max_keep), **kw)
        t_out = TD.dtp_prune(ts, tsig, 2.0, 20, max_keep=_t(max_keep), **kw)
    _assert_state(t_out[0], j_out[0])
    for t, j in zip(t_out[1:], j_out[1:]):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    # the per-row guard changed some row's decision from the default guard of 1
    t_none = (TD.dtp_prune_gather(ts, tsig, 2.0, 20, **kw) if gather
              else TD.dtp_prune(ts, tsig, 2.0, 20, **kw))
    assert not torch.equal(t_out[1], t_none[1])


def test_compact_and_init_token_state_match_jax():
    x, alive, bias, _ = _case(2)
    js, ts = _states(x, alive, bias)
    (j_state, j_idx), (t_state, t_idx) = JD.compact(js, 16), TD.compact(ts, 16)
    _assert_state(t_state, j_state)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    j0 = JD.init_token_state(jnp.asarray(x[:, :13]), depth=4, bias=jnp.asarray(bias[:, :13]),
                             pad_to=8)
    t0 = TD.init_token_state(_t(x[:, :13]), depth=4, bias=_t(bias[:, :13]), pad_to=8)
    _assert_state(t0, j0)
    assert t0.x.shape[1] == 24


def test_calibrate_and_flops_match_jax():
    rng = np.random.RandomState(4)
    kept = np.sort(rng.randint(100, 577, size=(3, 12)), axis=1)[:, ::-1]
    for kw in (dict(margin=16, multiple=64, mode="ceil"),
               dict(margin=8, multiple=128, mode="nearest"), dict(margin=4, multiple=8)):
        assert TC.calibrate_capacities(kept, **kw) == JC.calibrate_capacities(kept, **kw)
    jv, jm = JViT(), JMed(twin_cross=True)
    tv, tm = TViT(**dataclasses.asdict(jv)), TMed(**dataclasses.asdict(jm))
    tk = rng.randint(5, 26, size=12)
    assert TF.nlvr_gflops(tv, tm, kept[0], tk, 26) == JF.nlvr_gflops(jv, jm, kept[0], tk, 26)
    dense = TF.nlvr_gflops(tv, tm, [576] * 12, [25] * 12, 26)
    assert dense == JF.nlvr_gflops(jv, jm, [576] * 12, [25] * 12, 26)
    assert abs(dense - 132.54) / 132.54 < 0.02  # the reference's Ori_Gflops
