"""The port's BLIP retrieval compression training against the JAX package on
the CPU (fp32 unless amp, a tiny BLIP retrieval model on one set of random
weights: ViT 64 px with patch 16, width 64, 2 layers; the MED width 64 with 2
layers; 16-wide projections; a queue of 8): the ITC and ITM losses, the
hard-negative sampler fed JAX's own Gumbel noise (equal picks) and its
distribution, the EMA and the queue's wrap-around, the train state carried
from JAX, the step's losses, gradients and state after it (momentum towers
after the EMA that precedes the loss, queue, pointer, the clamped ``temp``)
in mask and gather mode, gather against mask at lossless capacities, the
train step and a two-batch ``train_epoch`` against the JAX step with
``optax.adamw``, the amp step's fp32 state, the checkpoint in both packages,
the device rule.

Tolerances: losses atol 1e-4; gradients atol 1e-5 + rtol 1e-3; the sampler's
distribution 1e-6 (tests/test_golden_train_losses.py); momentum weights and
queue features 1e-6 (an EMA of equal weights); parameters after AdamW steps
atol 1e-6 + rtol 1e-4, but for the attention key biases, whose gradient is
zero in exact arithmetic: Adam turns their rounding noise into steps of
about the learning rate, in signs of their own in either package, so they
are held to the reach of the steps taken (``_key_bias``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madtp_tpu.cli.common import init_blip_params
from madtp_tpu.core.config import MedConfig as JMedConfig
from madtp_tpu.core.config import ViTConfig as JViTConfig
from madtp_tpu.data.tokenizer_bert import BertWordPieceTokenizer as JTokenizer
from madtp_tpu.models.blip import BlipConfig as JBlipConfig
from madtp_tpu.models.blip import load_blip_retrieval
from madtp_tpu.train import losses as JL
from madtp_tpu.train import momentum as JMo
from madtp_tpu.train import optim as JO
from madtp_tpu.train.loops import MOMENTUM_KEYS as J_MOMENTUM_KEYS
from madtp_tpu.train.loops import RetrievalTrainState as JState
from madtp_tpu.train.loops import make_retrieval_train_step as j_make_step
from madtp_tpu_torch.ckpt.convert import (load_retrieval_state_dict, retrieval_from_jax_params,
                                          retrieval_train_state_from_jax,
                                          save_retrieval_checkpoint)
from madtp_tpu_torch.core.config import BlipConfig, MedConfig, ViTConfig
from madtp_tpu_torch.data.tokenizer_bert import BertWordPieceTokenizer
from madtp_tpu_torch.tasks import retrieval as TR
from madtp_tpu_torch.train import losses as L
from madtp_tpu_torch.train import momentum as Mo
from madtp_tpu_torch.train.loops import (MOMENTUM_KEYS, init_retrieval_train_state,
                                         make_retrieval_train_step)
from madtp_tpu_torch.train.optim import make_adamw

WORDS = ("a dog cat man woman sitting on the table with red blue in front of street "
         "car").split()
J_TOKENIZER = JTokenizer.toy(WORDS)
TOKENIZER = BertWordPieceTokenizer.toy(WORDS)
V = len(TOKENIZER.vocab)
ENC = TOKENIZER.enc_token_id
VIT = dict(image_size=64, patch_size=16, embed_dim=64, depth=2, num_heads=4, sd_dim=64)
MED = dict(vocab_size=V, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
           intermediate_size=128, max_position_embeddings=40, encoder_width=64, sd_dim=64)
JCFG = JBlipConfig(JViTConfig(**VIT), JMedConfig(**MED), sd_num=8, sd_dim=64)
TCFG = BlipConfig(ViTConfig(**VIT), MedConfig(**MED), sd_num=8, sd_dim=64)
TEMPERATURE = 2.0
B, Q, E = 4, 8, 16
TEXT_LEN = 12
CAPTIONS = [["a dog on the table", "a man in front of the red car",
             "the man sitting in front of a car", "a woman with a blue cat"],
            ["a cat", "a red car on the street", "a woman sitting on the table",
             "the dog in front of the street with a man"]]
IDX = [np.array([0, 1, 1, 2]), np.array([3, 4, 5, 3])]  # same-id pairs in each batch


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _tok(captions):
    tok = J_TOKENIZER(list(captions), padding="max_length", max_length=TEXT_LEN)
    return tok["input_ids"], tok["attention_mask"]


def _noise(key):
    """What the JAX step's two categorical draws add to the log-weights."""
    k1, k2 = jax.random.split(key)
    return tuple(np.asarray(jax.random.gumbel(k, (B, B), jnp.float32)) for k in (k1, k2))


@pytest.fixture(scope="module")
def setup():
    params = init_blip_params(JCFG, 0, heads=("retrieval",))
    rng = np.random.RandomState(5)
    # momentum towers that differ from the online ones, so the EMA shows
    params_m = {k: jax.tree.map(lambda a: a + 0.01 * rng.randn(*a.shape).astype(np.float32),
                                jax.tree.map(np.asarray, params[k])) for k in J_MOMENTUM_KEYS}
    queue = JMo.FeatureQueue(*(rng.randn(E, Q).astype(np.float32) for _ in range(2)),
                             np.full((Q,), -100, np.int32), np.int32(0))
    queue = queue._replace(idx=np.array([-100, -100, 1, -100, 7, 0, -100, 2], np.int32))
    images = [rng.randn(B, 3, 64, 64).astype(np.float32) for _ in range(2)]
    batch = _tok(CAPTIONS[0])
    model = retrieval_from_jax_params(jax.tree.map(np.asarray, params), TCFG, device="cpu")
    with torch.no_grad():
        _, vout = model.image_features(_t(images[0]), temperature=TEMPERATURE,
                                       prune_active=True)
        _, tout = model.text_features(_t(batch[0]), _t(batch[1]), temperature=TEMPERATURE,
                                      prune_active=True)
        merged = {**params, **{k: jax.tree.map(jnp.asarray, v) for k, v in params_m.items()}}
        _, vout_m = retrieval_from_jax_params(jax.tree.map(np.asarray, merged), TCFG,
                                              device="cpu").image_features(
            _t(images[0]), temperature=TEMPERATURE, prune_active=True)
    assert int(vout.kept_counts[-1]) < 16  # the temperature prunes
    # lossless for the online and the momentum image towers; the text passes
    # (the ITM's 3B rows too) keep at most all their tokens
    kept_v = torch.maximum(vout.kept_counts, vout_m.kept_counts)
    caps = {"mask": (None, None),
            "gather": (tuple(int(k) + 2 for k in kept_v), (TEXT_LEN + 1,) * 2)}
    return dict(params=params, params_m=params_m, queue=queue, images=images, caps=caps,
                batch=batch)


def _jstate(setup, tx, temp=0.07):
    params = jax.tree.map(jnp.asarray, setup["params"])
    return JState(params, jax.tree.map(jnp.asarray, setup["params_m"]), tx.init(params),
                  JMo.FeatureQueue(*map(jnp.asarray, setup["queue"])), jnp.float32(temp))


def _state(setup, temp=0.07):
    return retrieval_train_state_from_jax(
        jax.tree.map(np.asarray, setup["params"]), setup["params_m"], setup["queue"], temp,
        TCFG, device="cpu")


def _momentum_sd(tree):
    """The JAX momentum towers by the port's names."""
    m = retrieval_train_state_from_jax(
        {**tree, "itm_head": {"kernel": np.zeros((64, 2), np.float32),
                              "bias": np.zeros(2, np.float32)},
         "space_dict": np.zeros((8, 64), np.float32)},
        jax.tree.map(np.asarray, tree), JMo.FeatureQueue(np.zeros((E, Q)), np.zeros((E, Q)),
                                                         np.zeros(Q), 0), 0.07, TCFG, "cpu")
    return m.params_m


# --- losses, sampler, EMA, queue ----------------------------------------------


def test_itc_losses_match_jax():
    rng = np.random.RandomState(0)
    feat, feat_m = (rng.randn(B, E).astype(np.float32) for _ in range(2))
    other = rng.randn(E, B + Q).astype(np.float32)
    idx = np.array([0, 1, 1, 2])
    idx_all = np.concatenate([idx, [1, -100, 2, 9, -100, -100, 0, 5]])
    temp, alpha = 0.07, 0.3
    st = L.id_match_targets(_t(idx), _t(idx_all))
    jst = JL.id_match_targets(jnp.asarray(idx), jnp.asarray(idx_all))
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), atol=1e-7)
    tt = L.itc_soft_targets(_t(feat_m), _t(other), st, temp, alpha)
    jt = JL.itc_soft_targets(jnp.asarray(feat_m), jnp.asarray(other), jst, temp, alpha)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-6)
    got = L.itc_loss(_t(feat), _t(other), tt, temp)
    want = JL.itc_loss(jnp.asarray(feat), jnp.asarray(other), jt, temp)
    assert float(got) == pytest.approx(float(want), abs=1e-5)


def test_itm_loss_matches_jax():
    logits = np.random.RandomState(1).randn(3 * B, 2).astype(np.float32)
    assert float(L.itm_loss(_t(logits), B)) == pytest.approx(
        float(JL.itm_loss(jnp.asarray(logits), B)), abs=1e-6)


@pytest.mark.parametrize("groups", [False, True])
def test_hard_negatives_match_jax_draws(groups):
    """Fed the Gumbel noise jax.random.categorical adds, the sampler picks
    what sample_hard_negatives picks, row for row, over 8 keys."""
    rng = np.random.RandomState(2)
    n = 8
    # unit features, as the towers give them: a masked-out row's 1e-20 floor
    # then stays far below every candidate's weight
    fa, fb = (f / np.linalg.norm(f, axis=1, keepdims=True)
              for f in (rng.randn(n, E).astype(np.float32) for _ in range(2)))
    idx = np.array([0, 1, 1, 2, 3, 3, 4, 5])
    group = np.arange(n) * 2 // n if groups else None
    kw = {} if group is None else dict(group_a=group, group_b=group)
    for seed in range(8):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(JL.sample_hard_negatives(
            key, jnp.asarray(fa), jnp.asarray(fb), jnp.asarray(idx), jnp.asarray(idx), 0.3,
            **{k: jnp.asarray(v) for k, v in kw.items()}))
        noise = np.asarray(jax.random.gumbel(key, (n, n), jnp.float32))
        got = L.sample_hard_negatives(_t(fa), _t(fb), _t(idx), _t(idx), 0.3, noise=_t(noise),
                                      **{k: _t(v) for k, v in kw.items()}).numpy()
        np.testing.assert_array_equal(got, want)
        assert not np.any(idx[got] == idx)
        if groups:
            assert np.all(group[got] == group)


def test_hard_negative_distribution_and_no_same_id():
    """The induced distribution is the reference's masked softmax, within 1e-6
    (as tests/test_golden_train_losses.py holds the JAX one), and no draw
    from a generator picks a same-id row."""
    rng = np.random.RandomState(30)
    fa, fb = (rng.randn(5, 8).astype(np.float32) for _ in range(2))
    idx = np.array([1, 2, 2, 3, 4])
    temp = 0.3
    w = torch.softmax(_t(fa) @ _t(fb).t() / temp, dim=1)
    w = w.masked_fill(_t(idx)[:, None] == _t(idx)[None, :], 0)
    ref = (w / w.sum(1, keepdim=True)).numpy()
    sim = _t(fa) @ _t(fb).T / temp
    logw = torch.log(torch.softmax(sim, 1).masked_fill(
        _t(idx)[:, None] == _t(idx)[None, :], 0).clamp(min=1e-20))
    np.testing.assert_allclose(torch.softmax(logw, 1).numpy(), ref, atol=1e-6)
    g = torch.Generator().manual_seed(0)
    picks = torch.stack([L.sample_hard_negatives(_t(fa), _t(fb), _t(idx), _t(idx), temp,
                                                 generator=g) for _ in range(200)])
    assert not (_t(idx)[picks] == _t(idx)).any()
    freq = torch.stack([(picks == j).float().mean(0) for j in range(5)], 1).numpy()
    np.testing.assert_allclose(freq, ref, atol=0.12)  # 200 draws a row


def test_momentum_update_matches_jax():
    rng = np.random.RandomState(3)
    p = {"a": rng.randn(4, 3).astype(np.float32), "b": rng.randn(5).astype(np.float32)}
    m = {k: rng.randn(*v.shape).astype(np.float32) for k, v in p.items()}
    want = JMo.momentum_update(p, m, 0.995)
    mt = {k: _t(v) for k, v in m.items()}
    Mo.momentum_update([_t(p[k]) for k in p], [mt[k] for k in p], 0.995)
    for k in p:
        np.testing.assert_allclose(mt[k].numpy(), np.asarray(want[k]), atol=1e-7, rtol=1e-6)


def test_enqueue_wraps_like_jax():
    """Three batches into a queue of two batches: the third overwrites the
    first's slots, the pointer wraps to the start and on."""
    rng = np.random.RandomState(4)
    jq = JMo.FeatureQueue(*(jnp.asarray(rng.randn(E, Q).astype(np.float32))
                            for _ in range(2)), jnp.full((Q,), -100, jnp.int32),
                          jnp.zeros((), jnp.int32))
    tq = Mo.FeatureQueue(_t(jq.image), _t(jq.text), torch.full((Q,), -100), torch.tensor(0))
    for i in range(3):
        img, txt = (rng.randn(B, E).astype(np.float32) for _ in range(2))
        idx = np.arange(B) + 10 * i
        jq = JMo.enqueue(jq, jnp.asarray(img), jnp.asarray(txt), jnp.asarray(idx))
        Mo.enqueue(tq, _t(img), _t(txt), _t(idx))
        assert int(tq.ptr) == int(jq.ptr) == (i + 1) * B % Q
        for got, want in zip(tq[:3], jq[:3]):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tq.ptr.dim() == 0 and tq.ptr.dtype == torch.long


def test_init_queue_is_unit_columns():
    q = Mo.init_queue(E, Q, seed=3, device="cpu")
    for feats in (q.image, q.text):
        np.testing.assert_allclose(torch.linalg.vector_norm(feats, dim=0).numpy(), 1.0,
                                   atol=1e-6)
    assert (q.idx == -100).all() and int(q.ptr) == 0
    again = Mo.init_queue(E, Q, seed=3, device="cpu")
    assert torch.equal(again.image, q.image) and torch.equal(again.text, q.text)


def test_train_state_from_jax(setup):
    state = _state(setup, temp=0.05)
    want = _momentum_sd(setup["params_m"])
    assert set(state.params_m) == {n for n, _ in state.model.named_parameters()
                                   if n.split(".")[0] in MOMENTUM_KEYS}
    for n, t in state.params_m.items():
        assert torch.equal(t, want[n]) and not t.requires_grad, n
    q = setup["queue"]
    assert torch.equal(state.queue.image, _t(q.image)) and torch.equal(state.queue.idx,
                                                                       _t(q.idx).long())
    assert int(state.queue.ptr) == 0 and float(state.temp) == pytest.approx(0.05)
    fresh = init_retrieval_train_state(state.model, queue_size=Q)
    assert all(torch.equal(fresh.params_m[n], p) for n, p in state.model.named_parameters()
               if n in fresh.params_m)
    assert float(fresh.temp) == pytest.approx(0.07)


# --- the step -------------------------------------------------------------------


LR, WD = 1e-5, 0.05  # configs/retrieval_coco.yaml trains at 1e-7, which hardly moves the weights
TX = JO.make_adamw_injectable(WD)


@pytest.fixture(scope="module")
def jax_steps(setup):
    """The JAX step per mode with optax.adamw, jitted once each: every test
    calls it with a traced alpha, so one compile serves them all."""
    return {mode: j_make_step(JCFG, TX, enc_token_id=ENC, capacities_v=cv, capacities_t=ct)
            for mode, (cv, ct) in setup["caps"].items()}


def _jstate_lr(setup, temp=0.07):
    state = _jstate(setup, TX, temp)
    state.opt_state.hyperparams["learning_rate"] = jnp.float32(LR)
    return state


@pytest.fixture(scope="module")
def jax_step(setup, jax_steps):
    """The JAX step per mode, from ``temp`` 0.6 (clamped to 0.5), alpha 0.3:
    metrics, gradients (Adam's first moment after one step is 0.1 g) and the
    state after it."""
    out = {}
    for mode, step in jax_steps.items():
        st, m = step(_jstate_lr(setup, temp=0.6), jax.random.PRNGKey(7),
                     jnp.asarray(setup["images"][0]), *map(jnp.asarray, setup["batch"]),
                     jnp.asarray(IDX[0]), jnp.float32(TEMPERATURE), jnp.float32(0.3))
        mu = st.opt_state.inner_state[0].mu
        out[mode] = ({k: float(v) for k, v in m.items()},
                     jax.tree.map(lambda a: np.asarray(a) / np.float32(1 - 0.9), mu), st)
    return out


@pytest.fixture(scope="module")
def port_step(setup):
    out = {}
    noise = tuple(map(_t, _noise(jax.random.PRNGKey(7))))
    for mode, (cv, ct) in setup["caps"].items():
        state = _state(setup, temp=0.6)
        opt = make_adamw(state.model.parameters(), lr=0.0, weight_decay=0.0)
        step = make_retrieval_train_step(state, opt, enc_token_id=ENC, capacities_v=cv,
                                         capacities_t=ct, device="cpu")
        m = step(_t(setup["images"][0]), *map(_t, setup["batch"]), _t(IDX[0]), TEMPERATURE,
                 0.3, noise=noise)
        out[mode] = ({k: float(v) for k, v in m.items()},
                     {n: p.grad.clone() for n, p in state.model.named_parameters()}, state)
    return out


@pytest.mark.parametrize("mode", ["mask", "gather"])
def test_retrieval_losses_match_jax(jax_step, port_step, mode):
    jm, pm = jax_step[mode][0], port_step[mode][0]
    assert jm.keys() == pm.keys()
    for k in jm:
        assert pm[k] == pytest.approx(jm[k], abs=1e-4), k
    assert pm["loss_fdt"] != pm["loss_ita"] and pm["loss_fdt_m"] != pm["loss_ita"]


@pytest.mark.parametrize("mode", ["mask", "gather"])
def test_retrieval_grads_match_jax(jax_step, port_step, mode):
    """Whole-model gradients; the momentum towers and ``temp`` take none."""
    want = retrieval_from_jax_params(jax_step[mode][1], TCFG, device="cpu").state_dict()
    grads = port_step[mode][1]
    assert want.keys() == grads.keys()
    assert float(grads["space_dict"].abs().sum()) > 0 and not port_step[mode][2].temp.requires_grad
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=1e-5, rtol=1e-3,
                                   err_msg=name)


@pytest.mark.parametrize("mode", ["mask", "gather"])
def test_retrieval_state_after_step_matches_jax(jax_step, port_step, mode):
    """The EMA ran before the loss with the online weights of the step's
    start (they are unchanged here), the queue took the momentum features at
    slots 0-3, the pointer moved on 4, ``temp`` was clamped to 0.5."""
    jst, state = jax_step[mode][2], port_step[mode][2]
    want = _momentum_sd(jax.tree.map(np.asarray, jst.params_m))
    for n, t in state.params_m.items():
        np.testing.assert_allclose(t.numpy(), want[n].numpy(), atol=1e-6, rtol=1e-6, err_msg=n)
    q = state.queue
    np.testing.assert_allclose(q.image.numpy(), np.asarray(jst.queue.image), atol=1e-6)
    np.testing.assert_allclose(q.text.numpy(), np.asarray(jst.queue.text), atol=1e-6)
    np.testing.assert_array_equal(q.idx.numpy(), np.asarray(jst.queue.idx))
    assert int(q.ptr) == int(jst.queue.ptr) == B
    assert float(state.temp) == float(jst.temp) == 0.5


def test_retrieval_gather_grads_match_mask(port_step):
    m_mask, g_mask, _ = port_step["mask"]
    m_gat, g_gat, _ = port_step["gather"]
    assert abs(m_mask["loss"] - m_gat["loss"]) < 1e-5
    for name in g_mask:
        np.testing.assert_allclose(g_gat[name].numpy(), g_mask[name].numpy(),
                                   rtol=2e-4, atol=2e-5, err_msg=name)


def _key_bias(name, width):
    """The entries of an attention key bias in ``name`` (a slice), else
    None.  Softmax over keys is shift-invariant per query, so their gradient
    is zero but for rounding, which Adam scales up to steps of about the
    learning rate in either package, in signs of their own."""
    if name.endswith("attn.qkv.bias"):
        return slice(width // 3, 2 * width // 3)
    if name.endswith("self.key.bias"):
        return slice(None)
    return None


def _loader(setup):
    def loader():
        for images, captions, idx in zip(setup["images"], CAPTIONS, IDX):
            yield images, captions, idx
    return loader


def test_retrieval_step_and_epoch_match_jax(setup, jax_steps):
    """One step, then a two-batch train_epoch at epoch 0 (alpha ramped over a
    4-batch epoch), against the JAX driver's loop (compress_retrieval.py:
    420-437) with optax.adamw; the port's step is fed the Gumbel noise of
    the JAX step's keys."""
    lr, wd, alpha, epoch_len = LR, WD, 0.4, 4
    jstep = jax_steps["mask"]
    jstate = _jstate_lr(setup)
    state = _state(setup)
    opt = make_adamw(state.model.parameters(), lr=lr, weight_decay=wd)
    step = make_retrieval_train_step(state, opt, alpha=alpha, enc_token_id=ENC, device="cpu")
    keys = [jax.random.PRNGKey(k) for k in (11, 12, 13)]

    jstate, jm = jstep(jstate, keys[0], jnp.asarray(setup["images"][0]),
                       *map(jnp.asarray, setup["batch"]), jnp.asarray(IDX[0]),
                       jnp.float32(TEMPERATURE), jnp.float32(alpha))
    m = step(_t(setup["images"][0]), *map(_t, setup["batch"]), _t(IDX[0]), TEMPERATURE,
             alpha, noise=tuple(map(_t, _noise(keys[0]))))
    for k in jm:
        assert float(m[k]) == pytest.approx(float(jm[k]), abs=1e-4), k
    jlosses = []
    for done, (images, captions, idx) in enumerate(_loader(setup)()):
        a = alpha * min(1.0, done / epoch_len)
        jstate, jm = jstep(jstate, keys[1 + done], jnp.asarray(images),
                           *map(jnp.asarray, _tok(captions)), jnp.asarray(idx),
                           jnp.float32(TEMPERATURE), jnp.float32(a))
        jlosses.append(float(jm["loss"]))
    noises = iter([tuple(map(_t, _noise(k))) for k in keys[1:]])

    def fed(*args, generator=None):
        return step(*args, noise=next(noises))

    stats = TR.train_epoch(state.model, fed, _loader(setup), TOKENIZER, TEMPERATURE, epoch=0,
                           epoch_len=epoch_len, alpha=alpha, max_length=TEXT_LEN,
                           print_fn=lambda *_: None, lr=lr)
    assert stats["batches_done"] == 2
    assert float(stats["alpha"]) == pytest.approx(alpha * 0.5 / epoch_len)
    assert float(stats["loss"]) == pytest.approx(np.mean(jlosses), abs=2e-4)
    want = retrieval_from_jax_params(jax.tree.map(np.asarray, jstate.params), TCFG,
                                     device="cpu").state_dict()
    start = _state(setup).model.state_dict()
    for name, p in state.model.state_dict().items():
        p, w = p.numpy().copy(), want[name].numpy().copy()
        kb = _key_bias(name, p.shape[-1])
        if kb is not None:  # noise in both packages: held to 3 steps' reach
            assert np.abs(p[kb] - start[name].numpy()[kb]).max() <= 3 * lr * 1.001, name
            p[kb] = w[kb] = 0.0
        np.testing.assert_allclose(p, w, atol=1e-6, rtol=1e-4, err_msg=name)
    want_m = _momentum_sd(jax.tree.map(np.asarray, jstate.params_m))
    for n, t in state.params_m.items():
        np.testing.assert_allclose(t.numpy(), want_m[n].numpy(), atol=1e-6, rtol=1e-4,
                                   err_msg=n)
    np.testing.assert_array_equal(state.queue.idx.numpy(), np.asarray(jstate.queue.idx))
    assert int(state.queue.ptr) == int(jstate.queue.ptr) == (3 * B) % Q


def test_retrieval_amp_step_keeps_fp32_state(setup):
    state = _state(setup)
    opt = make_adamw(state.model.parameters(), lr=1e-5, weight_decay=0.05)
    step = make_retrieval_train_step(state, opt, enc_token_id=ENC, amp=True, device="cpu")
    m = step(_t(setup["images"][0]), *map(_t, setup["batch"]), _t(IDX[0]), TEMPERATURE,
             generator=torch.Generator().manual_seed(0))
    assert all(torch.isfinite(v) and v.dtype == torch.float32 for v in m.values())
    for n, p in state.model.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, n
    assert all(t.dtype == torch.float32 for t in state.params_m.values())
    assert state.queue.image.dtype == state.queue.text.dtype == torch.float32
    assert int(state.queue.ptr) == B


def test_retrieval_checkpoint_reads_back_in_both_packages(setup, tmp_path):
    state = _state(setup)
    path = str(tmp_path / "checkpoint_best.pth")
    save_retrieval_checkpoint(state.model, path, epoch=1, temperature=0.75)
    ck = torch.load(path)
    assert not any(k.split(".")[0].endswith("_m") or "queue" in k or k == "temp"
                   for k in ck["model"])  # the online model only, as the JAX driver writes
    params, temperature = load_blip_retrieval(path, JCFG)
    assert temperature == 0.75
    sd = state.model.state_dict()
    back = retrieval_from_jax_params(jax.tree.map(np.asarray, params), TCFG,
                                     device="cpu").state_dict()
    again = load_retrieval_state_dict(ck["model"], TCFG, device="cpu").state_dict()
    for k in sd:
        assert torch.equal(back[k], sd[k]) and torch.equal(again[k], sd[k]), k


def test_retrieval_step_refuses_without_gpu(setup, monkeypatch):
    state = _state(setup)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_retrieval_train_step(state, make_adamw(state.model.parameters(), 1e-5, 0.0),
                                  enc_token_id=ENC)
