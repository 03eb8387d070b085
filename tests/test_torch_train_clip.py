"""The port's CLIP compression training against the JAX package on the CPU
(fp32 unless amp, a tiny CLIP on one set of random weights: 64 px with patch
16, 2 + 2 layers of width 64 with 2 heads, ``sd_dim`` 64, a codebook of 10,
context 32 in the CLIP BPE's id space, 16-wide features, a queue of 8), with
``optax.adamw`` (weight decay 0.2) on the JAX side: the step's losses,
whole-model gradients and state after it (momentum copies after the EMA that
precedes the loss, queue, pointer, ``space_dict`` and ``logit_scale`` after
AdamW) in mask and gather mode, the reference's momentum-text quirk, the
``logit_scale`` clamp, the online-feature enqueue, a two-batch
``train_epoch`` with the epoch-0 alpha ramp, the ``--fast_train``
capacities, the amp step's fp32 state, the checkpoint in both packages, the
per-epoch eval's gate and the device rule.

Tolerances (tests/test_torch_train_retrieval.py): losses atol 1e-4;
gradients atol 1e-5 + rtol 1e-3; momentum weights and queue 1e-6;
parameters after AdamW atol 1e-6 + rtol 1e-4, but for the attention key
biases (``in_proj_bias[W:2W]``), whose gradient is zero in exact arithmetic:
Adam turns their rounding noise into steps of about the learning rate in
either package, so they are held to the reach of the steps taken."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madtp_tpu.ckpt.export import export_clip
from madtp_tpu.ckpt.remap import remap_clip
from madtp_tpu.ckpt.torch_reader import load_state_dict
from madtp_tpu.cli.common import fast_capacity_schedule as j_fast_capacity_schedule
from madtp_tpu.core.config import CLIPConfig as JCLIPConfig
from madtp_tpu.data import tokenizer_clip as JTok
from madtp_tpu.eval.metrics import itm_eval as j_itm_eval
from madtp_tpu.models.clip import clip_encode_image, clip_encode_text, init_clip_params
from madtp_tpu.prune.flops import clip_gflops as j_clip_gflops
from madtp_tpu.train import momentum as JMo
from madtp_tpu.train import optim as JO
from madtp_tpu.train.loops import CLIP_MOMENTUM_KEYS as J_CLIP_MOMENTUM_KEYS
from madtp_tpu.train.loops import ClipTrainState as JState
from madtp_tpu.train.loops import make_clip_train_step as j_make_step
from madtp_tpu_torch.ckpt.convert import (clip_from_jax_params, clip_train_state_from_jax,
                                          load_clip_state_dict, save_clip_checkpoint)
from madtp_tpu_torch.core.config import CLIPConfig
from madtp_tpu_torch.data.tokenizer_clip import ClipBPETokenizer
from madtp_tpu_torch.tasks import clip_retrieval as TC
from madtp_tpu_torch.train.loops import (CLIP_MOMENTUM_KEYS, LOGIT_SCALE_MAX,
                                         init_clip_train_state, make_clip_train_step)
from madtp_tpu_torch.train.optim import make_adamw

CLIP = dict(embed_dim=16, image_resolution=64, vision_layers=2, vision_width=64,
            vision_patch_size=16, vision_heads_override=2, context_length=32,
            vocab_size=49408, transformer_width=64, transformer_heads=2, transformer_layers=2,
            sd_dim=64)
JCFG, TCFG = JCLIPConfig(**CLIP), CLIPConfig(**CLIP)
J_TOKENIZER = JTok.ClipBPETokenizer()
TOKENIZER = ClipBPETokenizer()
TEMPERATURE = 2.0
B, Q, E, SD_NUM = 4, 8, 16, 10
LR, WD = 1e-4, 0.2  # configs/retrieval_coco_clip.yaml: weight decay 0.2
TX = JO.make_adamw_injectable(WD)
CAPTIONS = [["a dog on the table", "a man in front of the red car",
             "the man sitting in front of a car", "a woman with a blue cat"],
            ["a cat", "a red car on the street", "a woman sitting on the table",
             "the dog in front of the street with a man"]]
IDX = [np.array([0, 1, 1, 2]), np.array([3, 4, 5, 3])]  # same-id pairs in each batch


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _text(captions):
    return JTok.clip_tokenize(J_TOKENIZER, list(captions), JCFG.context_length)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(0)
    params = init_clip_params(JCFG, rng)
    sd = rng.randn(SD_NUM, JCFG.sd_dim).astype(np.float32)
    # momentum copies that differ from the online weights, so the EMA and the
    # quirk show
    params_m = {k: jax.tree.map(lambda a: a + 0.01 * rng.randn(*a.shape).astype(np.float32),
                                _np(params[k])) for k in J_CLIP_MOMENTUM_KEYS}
    queue = JMo.FeatureQueue(*(rng.randn(E, Q).astype(np.float32) for _ in range(2)),
                             np.array([-100, -100, 1, -100, 7, 0, -100, 2], np.int32),
                             np.int32(0))
    images = [rng.randn(B, 3, 64, 64).astype(np.float32) for _ in range(2)]
    model = clip_from_jax_params(params, TCFG, sd, device="cpu")
    model_m = clip_from_jax_params({**params, **params_m}, TCFG, sd, device="cpu")
    with torch.no_grad():
        kept = [m.encode_image(_t(images[0]), temperature=TEMPERATURE,
                               prune_active=True).kept_counts for m in (model, model_m)]
    assert int(kept[0][-1]) < 16  # the temperature prunes
    caps = {"mask": None, "gather": tuple(int(k) + 2 for k in torch.maximum(*kept))}
    return dict(params=params, params_m=params_m, queue=queue, sd=sd, images=images,
                caps=caps, text=_text(CAPTIONS[0]))


def _jstate(setup, **over):
    params = jax.tree.map(jnp.asarray, {**setup["params"], **over.get("params", {})})
    params_m = jax.tree.map(jnp.asarray, {**setup["params_m"], **over.get("params_m", {})})
    sd = jnp.asarray(setup["sd"])
    opt_state = TX.init({"params": params, "space_dict": sd})
    opt_state.hyperparams["learning_rate"] = jnp.float32(LR)
    return JState(params, params_m, opt_state,
                  JMo.FeatureQueue(*map(jnp.asarray, setup["queue"])), sd)


def _state(setup, **over):
    return clip_train_state_from_jax(_np({**setup["params"], **over.get("params", {})}),
                                     {**setup["params_m"], **over.get("params_m", {})},
                                     setup["queue"], setup["sd"], TCFG, device="cpu")


def _momentum_sd(tree):
    """The JAX momentum copies by the port's names."""
    params = {**_np(tree), "logit_scale": np.float32(0.0)}
    return clip_train_state_from_jax(params, _np(tree), JMo.FeatureQueue(
        np.zeros((E, Q)), np.zeros((E, Q)), np.zeros(Q), 0), None, TCFG, "cpu").params_m


@pytest.fixture(scope="module")
def jax_steps(setup):
    """The JAX step per mode, jitted once each: every test calls it with a
    traced alpha and states of the same shapes, so one compile serves them
    all."""
    return {mode: j_make_step(JCFG, TX, capacities_v=cv) for mode, cv in setup["caps"].items()}


def _jrun(setup, jax_steps, mode="mask", alpha=0.3, **over):
    st, m = jax_steps[mode](_jstate(setup, **over), jnp.asarray(setup["images"][0]),
                            jnp.asarray(setup["text"]), jnp.asarray(IDX[0]),
                            jnp.float32(TEMPERATURE), jnp.float32(alpha))
    mu = st.opt_state.inner_state[0].mu  # Adam's first moment after one step: 0.1 g
    grads = jax.tree.map(lambda a: np.asarray(a) / np.float32(1 - 0.9), mu)
    return {k: float(v) for k, v in m.items()}, grads, st


def _run(setup, mode="mask", alpha=0.3, lr=LR, **over):
    state = _state(setup, **over)
    opt = make_adamw(state.model.parameters(), lr=lr, weight_decay=WD)
    step = make_clip_train_step(state, opt, capacities_v=setup["caps"][mode], device="cpu")
    m = step(_t(setup["images"][0]), _t(setup["text"]).long(), _t(IDX[0]), TEMPERATURE, alpha)
    grads = {n: p.grad.clone() for n, p in state.model.named_parameters()}
    return {k: float(v) for k, v in m.items()}, grads, state


@pytest.fixture(scope="module")
def steps(setup, jax_steps):
    return {mode: (_jrun(setup, jax_steps, mode), _run(setup, mode)) for mode in setup["caps"]}


# --- the state -------------------------------------------------------------------


def test_train_state_from_jax_and_init(setup):
    state = _state(setup)
    names = {n for n, _ in state.model.named_parameters()
             if n.split(".")[0] in CLIP_MOMENTUM_KEYS}
    assert set(state.params_m) == names and "logit_scale" not in names
    assert "space_dict" not in names and any(n.startswith("transformer.") for n in names)
    want = _momentum_sd(setup["params_m"])
    for n, t in state.params_m.items():
        assert torch.equal(t, want[n]) and not t.requires_grad, n
    assert torch.equal(state.queue.idx, _t(setup["queue"].idx).long())
    fresh = init_clip_train_state(state.model, queue_size=Q)
    assert set(fresh.params_m) == names
    for n, p in state.model.named_parameters():
        if n in names:
            assert torch.equal(fresh.params_m[n], p) and fresh.params_m[n] is not p, n
    assert fresh.queue.image.shape == (E, Q) and int(fresh.queue.ptr) == 0
    np.testing.assert_allclose(torch.linalg.vector_norm(fresh.queue.text, dim=0).numpy(), 1.0,
                               atol=1e-6)


# --- the step ----------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["mask", "gather"])
def test_clip_losses_match_jax(steps, mode):
    (jm, _, _), (pm, _, _) = steps[mode]
    assert jm.keys() == pm.keys() == {"loss", "loss_ita", "loss_fdt", "loss_fdt_m"}
    for k in jm:
        assert pm[k] == pytest.approx(jm[k], abs=1e-4), k
    assert pm["loss_fdt"] != pm["loss_ita"] and pm["loss_fdt_m"] != pm["loss_ita"]


@pytest.mark.parametrize("mode", ["mask", "gather"])
def test_clip_grads_match_jax(steps, mode):
    """Whole-model gradients, the codebook's and ``logit_scale``'s included."""
    (_, jg, _), (_, grads, state) = steps[mode]
    want = clip_from_jax_params(jg["params"], TCFG, jg["space_dict"], device="cpu").state_dict()
    assert want.keys() == grads.keys()
    assert float(grads["space_dict"].abs().sum()) > 0 and float(grads["logit_scale"]) != 0
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=1e-5, rtol=1e-3,
                                   err_msg=name)
    assert all(not t.requires_grad for t in state.params_m.values())


@pytest.mark.parametrize("mode", ["mask", "gather"])
def test_clip_state_after_step_matches_jax(steps, mode):
    """The EMA ran before the loss from the weights of the step's start, the
    queue took the features at slots 0-3 and the pointer moved on 4; the
    codebook and ``logit_scale`` took the same AdamW step."""
    (_, _, jst), (_, _, state) = steps[mode]
    want = _momentum_sd(jst.params_m)
    for n, t in state.params_m.items():
        np.testing.assert_allclose(t.numpy(), want[n].numpy(), atol=1e-6, rtol=1e-6, err_msg=n)
    q = state.queue
    np.testing.assert_allclose(q.image.numpy(), np.asarray(jst.queue.image), atol=1e-6)
    np.testing.assert_allclose(q.text.numpy(), np.asarray(jst.queue.text), atol=1e-6)
    np.testing.assert_array_equal(q.idx.numpy(), np.asarray(jst.queue.idx))
    assert int(q.ptr) == int(jst.queue.ptr) == B
    model = state.model
    np.testing.assert_allclose(model.space_dict.detach().numpy(), np.asarray(jst.space_dict),
                               atol=1e-6, rtol=1e-4)
    scale = float(model.logit_scale.detach())
    assert scale == pytest.approx(float(jst.params["logit_scale"]), abs=1e-6, rel=1e-4)
    assert scale != pytest.approx(np.log(1 / 0.07), abs=LR / 2)


def test_clip_queue_takes_the_online_features(setup, steps):
    """The enqueued columns are the online towers' unit features at the
    step's start (the JAX queue's too), not the momentum ones."""
    (_, _, jst), (_, _, state) = steps["mask"]
    model = _state(setup).model
    with torch.no_grad():
        img = model.encode_image(_t(setup["images"][0]), temperature=TEMPERATURE,
                                 prune_active=True).features
        txt = model.encode_text(_t(setup["text"]).long(), temperature=TEMPERATURE,
                                prune_active=True).features
    img, txt = (f / torch.linalg.vector_norm(f, dim=-1, keepdim=True) for f in (img, txt))
    for got, jq, want in ((state.queue.image, jst.queue.image, img),
                          (state.queue.text, jst.queue.text, txt)):
        np.testing.assert_allclose(got[:, :B].numpy(), want.T.numpy(), atol=1e-6)
        np.testing.assert_allclose(np.asarray(jq)[:, :B], want.T.numpy(), atol=1e-6)
    m = clip_from_jax_params({**setup["params"], **setup["params_m"]}, TCFG, setup["sd"],
                             device="cpu")
    with torch.no_grad():
        m_img = m.encode_image(_t(setup["images"][0]), temperature=TEMPERATURE,
                               prune_active=True).features
    m_img = m_img / torch.linalg.vector_norm(m_img, dim=-1, keepdim=True)
    assert float((state.queue.image[:, :B] - m_img.T).abs().max()) > 1e-4


def test_clip_momentum_text_quirk(setup, jax_steps):
    """The momentum text tower reads the online ``transformer`` (``blocks``)
    and ``ln_final``: perturbing their momentum copies leaves the loss as it
    was, perturbing the momentum token embedding moves it; in both
    packages."""
    rng = np.random.RandomState(9)
    pm = setup["params_m"]

    def noisy(tree, s=0.3):
        return jax.tree.map(lambda a: a + s * rng.randn(*a.shape).astype(np.float32), tree)

    base_j, _, _ = _jrun(setup, jax_steps)
    base_t, _, _ = _run(setup)
    unused = {"blocks": noisy(pm["blocks"]), "ln_final": noisy(pm["ln_final"])}
    used = {"token_embedding": noisy(pm["token_embedding"], 1.0)}
    jm_unused, _, _ = _jrun(setup, jax_steps, params_m=unused)
    tm_unused, _, _ = _run(setup, params_m=unused)
    assert jm_unused == base_j and tm_unused == base_t
    jm_used, _, _ = _jrun(setup, jax_steps, params_m=used)
    tm_used, _, _ = _run(setup, params_m=used)
    assert abs(jm_used["loss"] - base_j["loss"]) > 1e-4
    for k in jm_used:
        assert tm_used[k] == pytest.approx(jm_used[k], abs=1e-4), k


def test_logit_scale_clamp_stops_its_gradient(setup, jax_steps):
    """Above ln 100 the clamp holds ``logit_scale`` at 4.6052 and its
    gradient is zero in both packages; the losses agree."""
    over = {"params": {"logit_scale": np.float32(5.0)}}
    jm, jg, _ = _jrun(setup, jax_steps, **over)
    tm, grads, _ = _run(setup, **over)
    assert float(jg["params"]["logit_scale"]) == 0.0 and float(grads["logit_scale"]) == 0.0
    for k in jm:
        assert tm[k] == pytest.approx(jm[k], abs=1e-4), k
    base, _, _ = _run(setup)
    assert tm["loss_ita"] != pytest.approx(base["loss_ita"], abs=1e-4)
    assert LOGIT_SCALE_MAX == pytest.approx(np.log(100.0), abs=1e-4)


def _key_bias(name, p):
    """The key part of a packed attention bias [3W], else None."""
    return slice(len(p) // 3, 2 * len(p) // 3) if name.endswith("attn.in_proj_bias") else None


def test_clip_train_epoch_matches_jax(setup, jax_steps):
    """A two-batch ``train_epoch`` at epoch 0 over a 2-batch epoch (alpha 0,
    then 0.2) on captions it tokenizes itself, against the JAX driver's
    loop (``compress_retrieval_clip.py:463-477``) with optax.adamw."""
    alpha, epoch_len = 0.4, 2
    jstate, jlosses = _jstate(setup), []
    for done, (images, captions, idx) in enumerate(zip(setup["images"], CAPTIONS, IDX)):
        a = alpha * min(1.0, done / epoch_len)
        jstate, jm = jax_steps["mask"](jstate, jnp.asarray(images), jnp.asarray(_text(captions)),
                                       jnp.asarray(idx), jnp.float32(TEMPERATURE),
                                       jnp.float32(a))
        jlosses.append(float(jm["loss"]))
    state = _state(setup)
    opt = make_adamw(state.model.parameters(), lr=LR, weight_decay=WD)
    step = make_clip_train_step(state, opt, alpha=alpha, device="cpu")
    alphas = []

    def spy(*args):
        alphas.append(args[-1])
        return step(*args)

    stats = TC.train_epoch(state.model, spy, lambda: zip(setup["images"], CAPTIONS, IDX),
                           TOKENIZER, TEMPERATURE, epoch=0, epoch_len=epoch_len, alpha=alpha,
                           print_fn=lambda *_: None, lr=LR)
    assert alphas == [0.0, 0.2] and stats["batches_done"] == 2
    assert float(stats["alpha"]) == pytest.approx(0.1)
    assert float(stats["loss"]) == pytest.approx(np.mean(jlosses), abs=2e-4)
    want = clip_from_jax_params(_np(jstate.params), TCFG, np.asarray(jstate.space_dict),
                                device="cpu").state_dict()
    start = _state(setup).model.state_dict()
    for name, p in state.model.state_dict().items():
        p, w = p.numpy().copy(), want[name].numpy().copy()
        kb = _key_bias(name, p)
        if kb is not None:  # noise in both packages: held to 2 steps' reach
            assert np.abs(p[kb] - start[name].numpy()[kb]).max() <= 2 * LR * 1.001, name
            p[kb] = w[kb] = 0.0
        np.testing.assert_allclose(p, w, atol=1e-6, rtol=1e-4, err_msg=name)
    want_m = _momentum_sd(jstate.params_m)
    for n, t in state.params_m.items():
        np.testing.assert_allclose(t.numpy(), want_m[n].numpy(), atol=1e-6, rtol=1e-4,
                                   err_msg=n)
    np.testing.assert_array_equal(state.queue.idx.numpy(), np.asarray(jstate.queue.idx))
    assert int(state.queue.ptr) == int(jstate.queue.ptr) == 0  # 2 batches of 4 wrap a queue of 8


@pytest.mark.parametrize("temperature", [1.0, TEMPERATURE])
def test_fast_train_capacities_match_jax(setup, temperature):
    """``train_capacities`` on the cached probe batches against the JAX
    driver's ``fast_train_step`` calibration: its jitted mask-mode vision
    probe, then ``fast_capacity_schedule(vk, None, "ceil")``."""
    probe = jax.jit(lambda p, s, im, t: clip_encode_image(
        p, im, JCFG, space_dict=s, temperature=t, prune_active=True)[2])
    batches = list(zip(setup["images"], CAPTIONS, IDX))
    vk = np.stack([np.asarray(probe(setup["params"], setup["sd"], jnp.asarray(im),
                                    jnp.float32(temperature))) for im, _, _ in batches])
    want, _ = j_fast_capacity_schedule(vk, None, "ceil")
    model = _state(setup).model
    assert TC.train_capacities(model, batches, temperature) == want


def test_clip_amp_step_keeps_fp32_state(setup):
    state = _state(setup)
    opt = make_adamw(state.model.parameters(), lr=LR, weight_decay=WD)
    step = make_clip_train_step(state, opt, amp=True, device="cpu")
    m = step(_t(setup["images"][0]), _t(setup["text"]).long(), _t(IDX[0]), TEMPERATURE)
    assert all(torch.isfinite(v) and v.dtype == torch.float32 for v in m.values())
    for n, p in state.model.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, n
    assert float(state.model.logit_scale.grad) != 0.0
    assert all(t.dtype == torch.float32 for t in state.params_m.values())
    assert state.queue.image.dtype == state.queue.text.dtype == torch.float32
    assert int(state.queue.ptr) == B
    assert all(s["exp_avg"].dtype == torch.float32 for s in opt.state.values())


def test_clip_checkpoint_reads_back_in_both_packages(setup, tmp_path):
    """``save_clip_checkpoint`` writes ``export_clip``'s keys and the
    codebook; the port's loader and the JAX package's ``load_state_dict`` +
    ``remap_clip`` read it back with equal features, epoch and
    temperature."""
    state = _state(setup)
    path = str(tmp_path / "checkpoint_best.pth")
    save_clip_checkpoint(state.model, path, epoch=3, temperature=1.25)
    ck = torch.load(path)
    assert set(ck["model"]) == set(export_clip(setup["params"])) | {"space_dict"}
    sd, extras = load_state_dict(path)
    assert extras["epoch"] == ck["epoch"] == 3
    assert extras["temperature"] == ck["temperature"] == 1.25
    jparams = jax.tree.map(jnp.asarray, remap_clip(sd))
    again = load_clip_state_dict(ck["model"], TCFG, device="cpu")
    images, text = _t(setup["images"][0]), _t(setup["text"]).long()
    with torch.no_grad():
        feats = [(m.encode_image(images, temperature=TEMPERATURE, prune_active=True).features,
                  m.encode_text(text, temperature=TEMPERATURE, prune_active=True).features)
                 for m in (state.model, again)]

    @jax.jit
    def jfeats(p, s, im, tx):
        kw = dict(space_dict=s, temperature=jnp.float32(TEMPERATURE), prune_active=True)
        return clip_encode_image(p, im, JCFG, **kw)[0], clip_encode_text(p, tx, JCFG, **kw)[0]

    want = jfeats(jparams, jnp.asarray(sd["space_dict"]), jnp.asarray(setup["images"][0]),
                  jnp.asarray(setup["text"]))
    for a, b, w in zip(*feats, want):
        assert torch.equal(a, b)
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=1e-5)


def test_eval_epoch_prunes_at_the_epochs_temperature(setup):
    """The per-epoch eval prunes when the epoch's temperature is > 0 and runs
    dense at 0 (``compress_retrieval_clip.py:506-511``), with the JAX
    driver's recalls and GFLOPs; the gate is ``r_mean > best`` within 5
    GFLOPs of the target."""
    model = _state(setup).model
    images = np.concatenate(setup["images"])
    text = np.concatenate([_text(c) for c in CAPTIONS])
    txt2img = list(range(8))
    img2txt = [[i] for i in range(8)]

    @jax.jit
    def jtowers(p, s, im, tx, t):
        kw = dict(space_dict=s, temperature=t, prune_active=True)
        fi, _, vk = clip_encode_image(p, im, JCFG, **kw)
        ft, _, tk = clip_encode_text(p, tx, JCFG, **kw)
        fi, ft = (f / jnp.linalg.norm(f, axis=-1, keepdims=True) for f in (fi, ft))
        return fi, ft, vk, tk

    out = {}
    for t in (0.0, TEMPERATURE):
        stats, cur_g, improved = TC.eval_epoch(model, [images], text, txt2img, img2txt, t,
                                               best=0.0, target_gflops=0.0, graph=False)
        out[t] = cur_g
        if t > 0:
            fi, ft, vk, tk = (np.asarray(a) for a in jtowers(
                setup["params"], setup["sd"], jnp.asarray(images), jnp.asarray(text),
                jnp.float32(t)))
            want = j_itm_eval(fi @ ft.T, (fi @ ft.T).T, txt2img, img2txt)
            assert cur_g == pytest.approx(j_clip_gflops(JCFG, vk, tk), rel=1e-6)
            for k in want:
                assert stats[k] == pytest.approx(want[k], abs=1e-6), k
        assert improved == (stats["r_mean"] > 0.0 and cur_g < 5.0)
        _, _, gate = TC.eval_epoch(model, [images], text, txt2img, img2txt, t,
                                   best=0.0, target_gflops=cur_g - 4.9, graph=False)
        assert gate == (stats["r_mean"] > 0.0)
        _, _, gate = TC.eval_epoch(model, [images], text, txt2img, img2txt, t,
                                   best=stats["r_mean"], target_gflops=cur_g, graph=False)
        assert not gate
    assert out[TEMPERATURE] < out[0.0]


def test_clip_step_refuses_without_gpu(setup, monkeypatch):
    state = _state(setup)
    opt = make_adamw(state.model.parameters(), 1e-5, 0.0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_clip_train_step(state, opt)
    assert callable(make_clip_train_step(state, opt, device="cpu"))
