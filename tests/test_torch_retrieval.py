"""The port's retrieval slice against the JAX package (CPU, fp32, a tiny BLIP
on one set of random weights): K4's plain version and its gradients, the
retrieval model's towers and ITM score, both weight loaders, the corpus
encode and rerank, the capacity probe, ``itm_eval``, ``retrieval_gflops``
and the entry points' device rule.  Tolerances: attention out 2e-6 and
gradients 2e-4 (tests/test_pallas.py), features and hidden states 1e-5,
ITM and rerank scores 2e-4 (tests/test_retrieval_task.py); kept counts,
alive masks and the -100 pattern must be equal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madtp_tpu.ckpt.export import export_med, export_vit
from madtp_tpu.cli.common import init_blip_params
from madtp_tpu.core.config import MedConfig as JMedConfig
from madtp_tpu.core.config import ViTConfig as JViTConfig
from madtp_tpu.eval.metrics import itm_eval as j_itm_eval
from madtp_tpu.models import med as JM
from madtp_tpu.models.blip import BlipConfig as JBlipConfig
from madtp_tpu.models.blip import (blip_itm_score, blip_retrieval_image_features,
                                   blip_retrieval_text_features)
from madtp_tpu.models.vit import vit_forward
from madtp_tpu.ops import attention as JA
from madtp_tpu.ops.pallas.cross_attention import fused_cross_attention
from madtp_tpu.prune.flops import retrieval_gflops as j_retrieval_gflops
from madtp_tpu.tasks.retrieval import encode_corpus as j_encode_corpus
from madtp_tpu.tasks.retrieval import rerank_scores as j_rerank_scores
from madtp_tpu_torch.ckpt.convert import load_retrieval_state_dict, retrieval_from_jax_params
from madtp_tpu_torch.core.config import BlipConfig, MedConfig, ViTConfig
from madtp_tpu_torch.eval.metrics import itm_eval
from madtp_tpu_torch.models.blip import init_retrieval_model
from madtp_tpu_torch.ops import attention as TA
from madtp_tpu_torch.prune import calibrate
from madtp_tpu_torch.prune.dtp import TokenState
from madtp_tpu_torch.prune.flops import retrieval_gflops
from madtp_tpu_torch.tasks import nlvr as t_nlvr
from madtp_tpu_torch.tasks import retrieval as TR

PAD_BIAS = -10000.0
VIT = dict(image_size=32, patch_size=8, embed_dim=32, depth=2, num_heads=4, sd_dim=32)
MED = dict(vocab_size=60, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
           intermediate_size=64, max_position_embeddings=32, encoder_width=32, sd_dim=32)
JCFG = JBlipConfig(JViTConfig(**VIT), JMedConfig(**MED), sd_num=8, sd_dim=32)
TCFG = BlipConfig(ViTConfig(**VIT), MedConfig(**MED), sd_num=8, sd_dim=32)
TEMPERATURE = 20.0
CAPS = {"mask": (None, None), "gather": ((16, 12), (8, 8))}
ENC_ID = 59
K_TEST = 3


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


@pytest.fixture(scope="module")
def setup():
    params = init_blip_params(JCFG, 0, heads=("retrieval",))
    tree = jax.tree.map(np.asarray, params)
    rng = np.random.RandomState(1)
    images = [rng.randn(3, 3, 32, 32).astype(np.float32),
              rng.randn(2, 3, 32, 32).astype(np.float32)]
    n_texts = 7
    ids = rng.randint(1, 59, size=(n_texts, 9)).astype(np.int64)
    ids[:, 0] = 1  # CLS
    mask = np.ones((n_texts, 9), np.int64)
    mask[2, 6:] = 0
    mask[5, 4:] = 0
    enc_ids = ids.copy()
    enc_ids[:, 0] = ENC_ID
    return dict(params=params, tree=tree,
                model=retrieval_from_jax_params(tree, TCFG, device="cpu"),
                images=images, ids=ids, mask=mask, enc_ids=enc_ids,
                txt2img=[0, 0, 1, 2, 3, 4, 4], img2txt=[[0, 1], [2], [3], [4], [5, 6]])


# ---------------------------------------------------------------- K4's plain version


def _cross_case(Nq, with_bias, seed=0, B=2, H=2, S=20, Dh=8):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, Nq, H, Dh).astype(np.float32)
    k, v = (rng.randn(B, S, H, Dh).astype(np.float32) for _ in range(2))
    alive = rng.rand(B, S) > 0.25
    alive[:, 0] = True
    alive[1, S // 2:] = False
    bias = (rng.rand(B, S) < 0.25).astype(np.float32) * PAD_BIAS if with_bias else None
    return q, k, v, alive, bias


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("Nq", [1, 7, 12])
def test_cross_attention_plain_matches_jax(Nq, with_bias):
    """cross_attention on CPU tensors (K4's plain version) against the TPU
    kernel in interpret mode and the XLA path, with dead keys, a PAD_BIAS
    bias and ragged Nq."""
    q, k, v, alive, bias = _cross_case(Nq, with_bias)
    scale = q.shape[-1] ** -0.5
    got = TA.cross_attention(_t(q), _t(k), _t(v), _t(alive),
                             None if bias is None else _t(bias)).numpy()
    assert got.shape == (q.shape[0], Nq, q.shape[2] * q.shape[3])
    heads = [jnp.asarray(a.transpose(0, 2, 1, 3)) for a in (q, k, v)]  # [B, H, N, Dh]
    jbias = None if bias is None else jnp.asarray(bias)
    want_xla, _ = JA.attention_core(*heads, key_bias=jbias, key_alive=jnp.asarray(alive))
    lanes = [h.transpose(0, 1, 3, 2) for h in heads]  # [B, H, Dh, N]
    want_k = fused_cross_attention(*lanes, jnp.asarray(alive), jbias, scale=scale,
                                   interpret=True)
    want_k = np.asarray(want_k).transpose(0, 3, 1, 2).reshape(got.shape)
    np.testing.assert_allclose(got, np.asarray(want_xla), atol=2e-6)
    np.testing.assert_allclose(got, want_k, atol=2e-6)


@pytest.mark.parametrize("route", ["plain", "function"])
@pytest.mark.parametrize("with_bias", [False, True])
def test_cross_attention_gradients_match_jax(with_bias, route, monkeypatch):
    """Gradients of q, k, v and the bias against ``jax.vjp`` of
    ``attention_core``: through the plain version (the CPU path), and through
    :class:`CrossAttention`, whose backward recomputes the plain version
    (its forward is K4; here a stand-in that returns the plain version's
    values without a graph, as the kernel does)."""
    q, k, v, alive, bias = _cross_case(7, with_bias, seed=3)
    w = np.random.RandomState(4).randn(q.shape[0], 7, q.shape[2] * q.shape[3]).astype(
        np.float32)
    leaves = [_t(a).requires_grad_() for a in (q, k, v)]
    tb = None if bias is None else _t(bias).requires_grad_()
    scale = q.shape[-1] ** -0.5
    if route == "plain":
        out = TA.cross_attention(*leaves, _t(alive), tb)
    else:
        monkeypatch.setattr(TA, "cross_attention_cuda", lambda *a: TA.cross_attention_plain(
            *(x.detach() if torch.is_tensor(x) else x for x in a)))
        out = TA.CrossAttention.apply(*leaves, _t(alive), tb, scale)
    got = torch.autograd.grad((out * _t(w)).sum(), [*leaves] + ([tb] if tb is not None else []))

    def f(q_, k_, v_, b_):
        heads = [a.transpose(0, 2, 1, 3) for a in (q_, k_, v_)]
        out, _ = JA.attention_core(*heads, key_bias=b_, key_alive=jnp.asarray(alive))
        return out

    jb = jnp.zeros(alive.shape, jnp.float32) if bias is None else jnp.asarray(bias)
    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)), jb)
    want = vjp(jnp.asarray(w))
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), atol=2e-4)


# ---------------------------------------------------------------- the model


@pytest.fixture(scope="module")
def towers(setup):
    """JAX and port outputs of the image and text towers and the ITM, per mode."""
    params, model = setup["params"], setup["model"]
    images = np.concatenate(setup["images"])[:3]
    ids, mask, enc_ids = setup["ids"][:3], setup["mask"][:3], setup["enc_ids"][:3]
    out = {}
    for mode, (cv, ct) in CAPS.items():
        kw = dict(temperature=TEMPERATURE, prune_active=True)

        @jax.jit
        def f(params, images, ids, mask, enc_ids):
            ifeat, vstate, _ = blip_retrieval_image_features(params, images, JCFG,
                                                             capacities=cv, **kw)
            _, _, vk = vit_forward(params["visual_encoder"], images, cfg=JCFG.vit,
                                   space_dict=params["space_dict"], capacities=cv, **kw)
            tfeat, tout = blip_retrieval_text_features(params, ids, mask, JCFG,
                                                       capacities=ct, **kw)
            itm = blip_itm_score(params, enc_ids, mask, vstate, JCFG, capacities=ct, **kw)
            itm_out = JM.med_encoder(params["text_encoder"], enc_ids, mask, JCFG.med,
                                     mode="multimodal", encoder_state=vstate,
                                     space_dict=params["space_dict"], capacities=ct, **kw)
            return ifeat, vstate, vk, tfeat, tout.state, tout.kept_counts, itm, \
                itm_out.kept_counts

        j = jax.tree.map(np.asarray, f(params, images, ids, mask, enc_ids))
        with torch.no_grad():
            ifeat, iout = model.image_features(_t(images), capacities=cv, **kw)
            tfeat, tout = model.text_features(_t(ids), _t(mask), capacities=ct, **kw)
            # the ITM reads the JAX image state, so it is compared alone
            jstate = TokenState(_t(j[1].x), _t(j[1].alive), None)
            itm = model.itm_score(_t(enc_ids), _t(mask), jstate, capacities=ct, **kw)
            itm_kept = model.text_encoder(_t(enc_ids), _t(mask), encoder_state=jstate,
                                          space_dict=model.space_dict, capacities=ct,
                                          **kw).kept_counts
        out[mode] = dict(j=j, t=(ifeat, iout, tfeat, tout, itm, itm_kept))
    return out


@pytest.mark.parametrize("part", ["image", "text", "itm"])
@pytest.mark.parametrize("mode", ["mask", "gather"])
def test_retrieval_model_matches_jax(towers, mode, part):
    j_ifeat, j_vstate, j_vk, j_tfeat, j_tstate, j_tk, j_itm, j_itm_kept = towers[mode]["j"]
    ifeat, iout, tfeat, tout, itm, itm_kept = towers[mode]["t"]
    if part == "image":
        np.testing.assert_array_equal(iout.kept_counts.numpy(), j_vk)
        np.testing.assert_array_equal(iout.state.alive.numpy(), j_vstate.alive)
        np.testing.assert_allclose(iout.state.x.numpy(), j_vstate.x, atol=1e-5)
        np.testing.assert_allclose(ifeat.numpy(), j_ifeat, atol=1e-5)
        assert j_vk[-1] < TCFG.vit.num_patches  # the temperature prunes
    elif part == "text":
        np.testing.assert_array_equal(tout.kept_counts.numpy(), j_tk)
        np.testing.assert_array_equal(tout.state.alive.numpy(), j_tstate.alive)
        np.testing.assert_allclose(tout.state.x.numpy(), j_tstate.x, atol=1e-5)
        np.testing.assert_allclose(tfeat.numpy(), j_tfeat, atol=1e-5)
    else:
        np.testing.assert_array_equal(itm_kept.numpy(), j_itm_kept)
        np.testing.assert_allclose(itm.numpy(), j_itm, atol=2e-4)
        assert itm.shape == (3,)


def test_loaders_give_identical_tensors(setup):
    """The JAX-tree converter and the reference-layout loader give the same
    tensors; the momentum towers and queues of a retrieval checkpoint are
    ignored."""
    tree = setup["tree"]
    sd = export_vit(tree["visual_encoder"], patch_size=8)
    sd.update(export_med(tree["text_encoder"]))
    for name in ("vision_proj", "text_proj", "itm_head"):
        sd[f"{name}.weight"] = tree[name]["kernel"].T
        sd[f"{name}.bias"] = tree[name]["bias"]
    sd["space_dict"] = tree["space_dict"]
    sd.update({"visual_encoder_m.cls_token": np.zeros((1, 1, 32), np.float32),
               "text_proj_m.weight": np.zeros((16, 32), np.float32),
               "image_queue": np.zeros((16, 8), np.float32), "idx_queue": np.zeros((1, 8)),
               "temp": np.float32(0.07)})
    a = setup["model"].state_dict()
    b = load_retrieval_state_dict(sd, TCFG, device="cpu").state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert a["vision_proj.weight"].shape == (16, 32)
    del sd["space_dict"]
    with pytest.raises(KeyError, match="space_dict"):
        load_retrieval_state_dict(sd, TCFG, device="cpu")


# ---------------------------------------------------------------- the task


@pytest.fixture(scope="module")
def reranked(setup):
    """JAX's and the port's encode_corpus + rerank_scores per mode; JAX with
    several rows per vmapped call, the port with one ITM forward per row."""
    out = {}
    for mode, (cv, ct) in CAPS.items():
        kw = dict(temperature=TEMPERATURE, prune_active=True, capacities_v=cv,
                  capacities_t=ct)
        j = j_encode_corpus(setup["params"], JCFG, iter(setup["images"]), setup["ids"],
                            setup["mask"], **kw)
        t = TR.encode_corpus(setup["model"], iter(setup["images"]), setup["ids"],
                             setup["mask"], **kw)
        rkw = dict(k_test=K_TEST, temperature=TEMPERATURE, prune_active=True,
                   capacities_t=ct)
        out[mode] = dict(j=j, t=t, j_scores=j_rerank_scores(
            setup["params"], JCFG, *j, setup["enc_ids"], setup["mask"], rows_per_call=2,
            **rkw), t_scores=TR.rerank_scores(setup["model"], *t, setup["enc_ids"],
                                              setup["mask"], **rkw))
    return out


@pytest.mark.parametrize("mode", ["mask", "gather"])
def test_encode_and_rerank_match_jax(reranked, mode):
    """Equal alive masks and -100 pattern; features within 1e-5, scores
    within 2e-4."""
    r = reranked[mode]
    (j_if, j_st, j_tf), (t_if, t_st, t_tf) = r["j"], r["t"]
    np.testing.assert_allclose(t_if, j_if, atol=1e-5)
    np.testing.assert_allclose(t_tf, j_tf, atol=1e-5)
    np.testing.assert_array_equal(t_st.alive.numpy(), j_st.alive)
    np.testing.assert_allclose(t_st.x.numpy(), j_st.x, atol=1e-5)
    for g, w in zip(r["t_scores"], r["j_scores"]):
        np.testing.assert_array_equal(g == -100.0, w == -100.0)
        assert ((g != -100.0).sum(axis=1) == K_TEST).all()
        np.testing.assert_allclose(g, w, atol=2e-4)


def test_probe_and_evaluate_match_jax(setup, reranked):
    """--fast_eval's capacity probe against the JAX package's steps
    (``cli/compress_retrieval.py:135-164``), and the whole gather-mode eval
    against ``itm_eval`` of the JAX task's scores."""
    params = setup["params"]
    kw = dict(space_dict=params["space_dict"], temperature=TEMPERATURE, prune_active=True)

    @jax.jit
    def kept(params, images, ids, mask):
        vk = vit_forward(params["visual_encoder"], images, cfg=JCFG.vit, **kw)[2]
        tk = JM.med_encoder(params["text_encoder"], ids, mask, JCFG.med, mode="text",
                            **kw).kept_counts
        return vk, tk

    vks, tks = zip(*(kept(params, b, setup["ids"], setup["mask"]) for b in setup["images"]))
    vks, tks = np.stack(vks), np.stack(tks[:1])  # the probe reads up to 32 texts once
    want_caps = calibrate.fast_capacity_schedule(vks, tks, "nearest")
    caps = TR.probe_capacities(setup["model"], iter(setup["images"]), setup["ids"],
                               setup["mask"], TEMPERATURE, "nearest")
    assert caps == want_caps
    assert t_nlvr.fast_capacity_schedule is calibrate.fast_capacity_schedule

    cv, ct = CAPS["gather"]
    want = j_itm_eval(*reranked["gather"]["j_scores"], setup["txt2img"], setup["img2txt"])
    got = TR.evaluate(setup["model"], iter(setup["images"]), setup["ids"], setup["mask"],
                      setup["txt2img"], setup["img2txt"], TEMPERATURE, enc_token_id=ENC_ID,
                      k_test=K_TEST, capacities_v=cv, capacities_t=ct)
    assert got == want


def test_itm_eval_and_gflops_match_jax():
    rng = np.random.RandomState(7)
    s_i2t, s_t2i = rng.randn(6, 13), rng.randn(13, 6)
    txt2img = rng.randint(0, 6, size=13).tolist()
    img2txt = [[t for t in range(13) if txt2img[t] == i] or [i] for i in range(6)]
    assert itm_eval(s_i2t, s_t2i, txt2img, img2txt) == j_itm_eval(s_i2t, s_t2i, txt2img,
                                                                   img2txt)
    vit, med = ViTConfig(), MedConfig()
    jvit, jmed = JViTConfig(), JMedConfig()
    for v_kept, t_kept in (([576] * 12, [34] * 12), (list(range(500, 260, -20)), [30] * 12)):
        assert retrieval_gflops(vit, med, v_kept, t_kept, 35) == j_retrieval_gflops(
            jvit, jmed, v_kept, t_kept, 35)


def test_entry_points_refuse_without_gpu(setup, monkeypatch):
    """init_retrieval_model and both loaders default to the card and raise
    without one; given device="cpu" they build a CPU model, and evaluate
    runs where the model lives."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: init_retrieval_model(TCFG),
                 lambda: retrieval_from_jax_params(setup["tree"], TCFG),
                 lambda: load_retrieval_state_dict({}, TCFG)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    model = init_retrieval_model(TCFG, device="cpu")
    assert model.space_dict.device.type == "cpu" and model.vision_proj.out_features == 256
    stats = TR.evaluate(model, iter(setup["images"]), setup["ids"], setup["mask"],
                        setup["txt2img"], setup["img2txt"], 0.0, enc_token_id=ENC_ID)
    assert set(stats) >= {"txt_r1", "img_r1", "r_mean"} and 0 <= stats["r_mean"] <= 100
    with pytest.raises(ValueError, match="twin_cross"):
        init_retrieval_model(TCFG._replace(med=dataclasses.replace(TCFG.med, twin_cross=True)),
                             device="cpu")
