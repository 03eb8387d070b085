"""The port's VQA slice against the JAX package (CPU, fp32, a tiny BLIP VQA on
one set of random weights: ViT 64 px with patch 16 and width 64, MED width 64
with 2 layers and a 96-token vocabulary): the decoder's parts (embeddings at
an offset, the full pass, the LM head, the BOS step, the shared-memory
candidate pass with and without the BOS prefix), answer ranking with tied
first tokens at the k-th place, the model's encode in dense, mask and
gather mode, both weight loaders with a position-grid resize, ``vqa_gflops``,
the capacity probe and the eval, the device rule; and K3's function: K1's
plain version against the TPU's query-tiled kernel in interpret mode.
Tolerances: attention out 2e-6 and scores 1e-6 (tests/test_pallas.py),
hidden states, logits and states 1e-5, losses 1e-4; kept counts, alive
masks, top-k lists and answers must be equal."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madtp_tpu.ckpt.export import export_med, export_vit, save_torch_checkpoint
from madtp_tpu.cli.common import fast_capacity_schedule as j_fast_capacity_schedule
from madtp_tpu.cli.common import init_blip_params
from madtp_tpu.cli.compress_vqa import ORI_GFLOPS as J_ORI_GFLOPS_VQA
from madtp_tpu.core.config import MedConfig as JMedConfig
from madtp_tpu.core.config import ViTConfig as JViTConfig
from madtp_tpu.models import med as JM
from madtp_tpu.models.blip import BlipConfig as JBlipConfig
from madtp_tpu.models.blip import blip_vqa_encode, load_blip_vqa
from madtp_tpu.ops import attention as JA
from madtp_tpu.ops.pallas import fused_attention as FA
from madtp_tpu.prune.dtp import TokenState as JTokenState
from madtp_tpu.prune.flops import vqa_gflops as j_vqa_gflops
from madtp_tpu.tasks.vqa import rank_answers as j_rank_answers
from madtp_tpu_torch.ckpt.convert import load_vqa_state_dict, vqa_from_jax_params
from madtp_tpu_torch.core.config import BlipConfig, MedConfig, ViTConfig, vqa_config
from madtp_tpu_torch.models.blip import init_vqa_model
from madtp_tpu_torch.models.med import causal_bias
from madtp_tpu_torch.ops.attention import attention_scores_plain
from madtp_tpu_torch.prune.dtp import TokenState
from madtp_tpu_torch.prune.flops import ORI_GFLOPS_VQA, vqa_gflops
from madtp_tpu_torch.tasks import vqa as TV

PAD_BIAS = -10000.0
VIT = dict(image_size=64, patch_size=16, embed_dim=64, depth=2, num_heads=4, sd_dim=64)
MED = dict(vocab_size=96, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
           intermediate_size=128, max_position_embeddings=40, encoder_width=64, sd_dim=64)
JCFG = JBlipConfig(JViTConfig(**VIT), JMedConfig(**MED), sd_num=8, sd_dim=64)
TCFG = BlipConfig(ViTConfig(**VIT), MedConfig(**MED), sd_num=8, sd_dim=64)
TEMPERATURE = 2.0
CAPS = {"dense": None, "mask": (None, None), "gather": ((16, 16), (8, 8))}
ENC_ID, BOS_ID, SEP_ID = 95, 94, 3
N_ANSWERS, LA = 12, 5


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _questions(rng, n, lo=4, hi=12):
    """[ENC], random wordpieces and [SEP], padded to the longest (``hi``: one
    shape for every batch, so that each JAX step compiles once)."""
    lengths = rng.randint(lo, hi + 1, size=n)
    lengths[0] = hi
    ids = np.zeros((n, hi), np.int64)
    for b, length in enumerate(lengths):
        ids[b, :length] = rng.randint(5, 90, size=length)
        ids[b, 0], ids[b, length - 1] = ENC_ID, SEP_ID
    return ids, (ids > 0).astype(np.int64)


def _answers(first_tokens, rng, la=LA):
    """BOS, the given first token, 0-2 more wordpieces, [SEP], padding."""
    ids = np.zeros((len(first_tokens), la), np.int64)
    for a, t in enumerate(first_tokens):
        n = 1 + rng.randint(0, la - 2)
        ids[a, 0] = BOS_ID
        ids[a, 1:1 + n] = [t] + list(rng.randint(5, 90, size=n - 1))
        ids[a, 1 + n] = SEP_ID
    return ids, (ids > 0).astype(np.int64)


@pytest.fixture(scope="module")
def setup():
    params = init_blip_params(JCFG, 0, heads=(), with_decoder=True)
    tree = jax.tree.map(np.asarray, params)
    rng = np.random.RandomState(1)
    batches = []
    for qid0 in (0, 2, 4):
        ids, mask = _questions(rng, 2)
        images = rng.randn(2, 3, 64, 64).astype(np.float32)
        batches.append((images, ids, mask, np.arange(qid0, qid0 + 2)))
    # a memory with a padding bias and dead slots for the decoder's parts
    S = 9
    mem = JTokenState(rng.randn(2, S, 64).astype(np.float32),
                      np.array([[True] * 7 + [False] * 2, [True] * 9]),
                      np.array([[0.0] * 6 + [PAD_BIAS] * 3, [0.0] * 8 + [PAD_BIAS]], np.float32))
    a_ids, a_mask = _answers(rng.randint(5, 90, size=N_ANSWERS), rng)
    return dict(params=params, tree=tree, model=vqa_from_jax_params(tree, TCFG, device="cpu"),
                batches=batches, mem=mem, a_ids=a_ids, a_mask=a_mask)


_j_bos_step = jax.jit(JM.med_bos_step, static_argnames=("cfg",))


def _state(st):
    return TokenState(_t(st.x), _t(st.alive), None if st.bias is None else _t(st.bias))


def _jstate(st):
    return JTokenState(*(None if a is None else jnp.asarray(a) for a in st))


# ---------------------------------------------------------------- the decoder's parts


@pytest.mark.parametrize("offset", [0, 3])
def test_embeddings_at_an_offset(setup, offset):
    ids = np.random.RandomState(2).randint(0, 96, size=(2, 6))
    want = JM.bert_embeddings(setup["params"]["text_decoder"]["embeddings"], jnp.asarray(ids),
                              JCFG.med, position_offset=offset)
    with torch.no_grad():
        got = setup["model"].text_decoder.bert.embeddings(_t(ids), position_offset=offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_decoder_forward_matches_jax(setup):
    """The full causal pass over a memory with a key bias and dead slots
    (``med_decoder_forward``), with padded answers; and ``causal_bias``."""
    ids, mask = setup["a_ids"][:2], setup["a_mask"][:2]
    want = JM.med_decoder_forward(setup["params"]["text_decoder"], jnp.asarray(ids),
                                  jnp.asarray(mask), JCFG.med, encoder_state=_jstate(setup["mem"]))
    with torch.no_grad():
        got = setup["model"].text_decoder(_t(ids), _t(mask), _state(setup["mem"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_array_equal(causal_bias(_t(mask)).numpy(),
                                  np.asarray(JM.causal_bias(jnp.asarray(mask))))


def test_lm_head_matches_jax(setup):
    h = np.random.RandomState(3).randn(2, 4, 64).astype(np.float32)
    want = JM.lm_head(setup["params"]["text_decoder"], jnp.asarray(h), JCFG.med)
    with torch.no_grad():
        got = setup["model"].text_decoder.lm_head(_t(h))
    assert got.dtype == torch.float32 and got.shape == (2, 4, 96)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_bos_step_matches_jax(setup):
    bos = np.full((2, 1), BOS_ID)
    want = _j_bos_step(setup["params"]["text_decoder"], jnp.asarray(bos), JCFG.med,
                       encoder_state=_jstate(setup["mem"]))
    with torch.no_grad():
        got = setup["model"].text_decoder.bos_step(_t(bos), _state(setup["mem"]))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


@pytest.mark.parametrize("prefix", [False, True])
def test_rank_forward_matches_jax(setup, prefix):
    """The candidate pass with the memory shared by the k candidates, from
    position 0, or from position 1 with the BOS step's keys and values."""
    p, mem = setup["params"]["text_decoder"], setup["mem"]
    idx = np.array([[0, 3, 5], [1, 3, 7]])
    cand_ids, cand_mask = setup["a_ids"][idx], setup["a_mask"][idx]
    jkv = tkv = None
    if prefix:
        bos = np.full((2, 1), BOS_ID)
        jkv = _j_bos_step(p, jnp.asarray(bos), JCFG.med, encoder_state=_jstate(mem))[1:]
        tkv = tuple(_t(a) for a in jkv)
    want = JM.med_rank_forward(p, jnp.asarray(cand_ids), jnp.asarray(cand_mask), JCFG.med,
                               encoder_state=_jstate(mem), prefix_kv=jkv)
    with torch.no_grad():
        got = setup["model"].text_decoder.rank_forward(_t(cand_ids), _t(cand_mask), _state(mem),
                                                       prefix_kv=tkv)
    assert got.shape == (6, LA - 1 if prefix else LA, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("k", [3, 4])
def test_rank_answers_with_tied_first_tokens(setup, k):
    """Answers that share a first token tie in the first-token ranking;
    here the second most likely first token opens three answers that
    straddle the k-th place, so the top k keeps the lower indices, as
    ``jax.lax.top_k`` does.  The top-k lists agree in order, the answers
    too."""
    p, mem = setup["params"]["text_decoder"], setup["mem"]
    decoder = setup["model"].text_decoder
    with torch.no_grad():  # the first-token order, to place the ties
        h = decoder.bos_step(torch.full((2, 1), BOS_ID), _state(mem))[0]
        order = np.argsort(-decoder.lm_head(h)[0, 0].numpy())
    t0, t1, t2 = (int(t) for t in order[order > 4][:3])
    firsts = [t1, t0, t1, t2, t1, t0, t2, t2]
    a_ids, a_mask = _answers(firsts, np.random.RandomState(4))
    best_j, topk_j = _j_rank(p, _jstate(mem), jnp.asarray(a_ids), jnp.asarray(a_mask),
                             JCFG, k=k, pad_token_id=0)
    with torch.no_grad():
        best, topk = TV.rank_answers(decoder, _state(mem), _t(a_ids), _t(a_mask), k=k,
                                     pad_token_id=0)
    np.testing.assert_array_equal(topk.numpy(), np.asarray(topk_j))
    np.testing.assert_array_equal(best.numpy(), np.asarray(best_j))
    assert topk[0].tolist() == [1, 5, 0, 2][:k]  # t0's answers, then t1's from the lowest


# ---------------------------------------------------------------- the model


@functools.lru_cache(maxsize=None)
def _j_encoder(caps):
    cv, ct = caps or (None, None)
    return jax.jit(functools.partial(blip_vqa_encode, cfg=JCFG, temperature=TEMPERATURE,
                                     prune_active=caps is not None, capacities_v=cv,
                                     capacities_t=ct))


def _j_encode(params, batch, caps):
    out, _, vk = _j_encoder(caps)(params, *batch[:3])
    return out, vk


_j_rank = jax.jit(j_rank_answers, static_argnames=("cfg", "k", "pad_token_id"))


@pytest.mark.parametrize("mode", ["dense", "mask", "gather"])
def test_encode_matches_jax(setup, mode):
    """Image tower and question encoder over the image: equal kept counts in
    both towers and alive masks, question states within 1e-5."""
    caps = CAPS[mode]
    batch = setup["batches"][0]
    out_j, vk_j = _j_encode(setup["params"], batch, caps)
    cv, ct = caps or (None, None)
    with torch.no_grad():
        out, _, vk = setup["model"].encode(_t(batch[0]), _t(batch[1]), _t(batch[2]),
                                           temperature=TEMPERATURE, prune_active=caps is not None,
                                           capacities_v=cv, capacities_t=ct)
    np.testing.assert_array_equal(vk.numpy(), np.asarray(vk_j))
    np.testing.assert_array_equal(out.kept_counts.numpy(), np.asarray(out_j.kept_counts))
    np.testing.assert_array_equal(out.state.alive.numpy(), np.asarray(out_j.state.alive))
    np.testing.assert_array_equal(out.state.bias.numpy(), np.asarray(out_j.state.bias))
    np.testing.assert_allclose(out.state.x.numpy(), np.asarray(out_j.state.x), atol=1e-5)
    if mode != "dense":
        assert vk[-1] < TCFG.vit.num_patches  # the temperature prunes


def test_loaders_give_identical_tensors(setup, tmp_path):
    """The JAX-tree converter and the reference-layout loader give the same
    tensors; ``load_blip_vqa``'s ``.pth`` (with the tied decoder exports, a
    pooler and ``position_ids``) loads at a larger image size too, the 4 x 4
    position grid resized to 6 x 6 as the JAX loader resizes it."""
    tree = setup["tree"]
    sd = export_vit(tree["visual_encoder"], patch_size=16)
    sd.update(export_med(tree["text_encoder"], "text_encoder."))
    sd.update(export_med(tree["text_decoder"], "text_decoder.", has_lm_head=True))
    sd["space_dict"] = tree["space_dict"]
    assert "text_decoder.cls.predictions.decoder.weight" in sd
    a = setup["model"].state_dict()
    b = load_vqa_state_dict(sd, TCFG, device="cpu").state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k

    path = str(tmp_path / "vqa.pth")
    save_torch_checkpoint(path, sd)
    big_j = JCFG._replace(vit=JViTConfig(**dict(VIT, image_size=96)))
    big_t = TCFG._replace(vit=ViTConfig(**dict(VIT, image_size=96)))
    params96, _ = load_blip_vqa(path, big_j)
    want = vqa_from_jax_params(jax.tree.map(np.asarray, params96), big_t, device="cpu")
    got = load_vqa_state_dict(torch.load(path)["model"], big_t, device="cpu")
    assert got.visual_encoder.pos_embed.shape == (1, 37, 64)
    for (k, w), g in zip(want.state_dict().items(), got.state_dict().values()):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-6, err_msg=k)
    del sd["text_decoder.cls.predictions.bias"]
    with pytest.raises(KeyError, match="cls.predictions.bias"):
        load_vqa_state_dict(sd, TCFG, device="cpu")


# ---------------------------------------------------------------- the task


def test_vqa_gflops_match_jax():
    vit, med = ViTConfig(image_size=480), MedConfig()
    jvit, jmed = JViTConfig(image_size=480), JMedConfig()
    for v_kept, q_kept, n_q0, n_answers in (([900] * 12, [14] * 12, 15, 128),
                                            (list(range(800, 200, -50)), [10] * 12, 12, 0),
                                            ([1600] * 12, [19] * 12, 20, 1)):
        assert vqa_gflops(vit, med, v_kept, q_kept, n_q0, n_answers=n_answers) == \
            j_vqa_gflops(jvit, jmed, v_kept, q_kept, n_q0, n_answers=n_answers)
    assert ORI_GFLOPS_VQA == J_ORI_GFLOPS_VQA
    assert vqa_config() == BlipConfig(ViTConfig(image_size=480), MedConfig())
    assert vqa_config(640).vit.num_patches == 1600


def _j_evaluate(setup, caps, k_test):
    """The JAX composition of ``madtp_tpu/cli/compress_vqa.py:114-205``."""
    a_ids, a_mask = jnp.asarray(setup["a_ids"]), jnp.asarray(setup["a_mask"])
    results, g = [], []
    for batch in setup["batches"]:
        out, vk = _j_encode(setup["params"], batch, caps)
        best, _ = _j_rank(setup["params"]["text_decoder"], out.state, a_ids, a_mask, JCFG,
                          k=min(k_test, N_ANSWERS), pad_token_id=0)
        results += [(int(q), int(b)) for q, b in zip(batch[3], np.asarray(best))]
        g.append(j_vqa_gflops(JCFG.vit, JCFG.med, np.asarray(vk), np.asarray(out.kept_counts),
                              batch[1].shape[1], n_answers=k_test))
    return results, sum(g) / len(g)


def test_probe_and_evaluate_match_jax(setup):
    """--fast_eval's probe (questions padded to 35, mask mode) against the
    JAX package's ``compress_vqa``, and the gather-mode eval's answers and
    GFLOPs against the JAX composition at k_test 5."""
    params = setup["params"]
    vks, tks = [], []
    for images, ids, mask, qids in setup["batches"]:
        pad = ((0, 0), (0, 35 - ids.shape[1]))
        out, vk = _j_encode(params, (images, np.pad(ids, pad), np.pad(mask, pad), qids),
                            (None, None))
        vks.append(np.asarray(vk))
        tks.append(np.asarray(out.kept_counts))
    want_caps = j_fast_capacity_schedule(np.stack(vks), np.stack(tks), "ceil")
    caps = TV.probe_capacities(setup["model"], iter(setup["batches"]), TEMPERATURE, "ceil")
    assert caps == want_caps
    want = _j_evaluate(setup, caps, 5)
    got = TV.evaluate(setup["model"], iter(setup["batches"]), setup["a_ids"], setup["a_mask"],
                      temperature=TEMPERATURE, k_test=5, capacities_v=caps[0],
                      capacities_t=caps[1])
    assert got[0] == want[0] and len(got[0]) == 6
    assert got[1] == pytest.approx(want[1], rel=1e-12)


def test_entry_points_refuse_without_gpu(setup, monkeypatch):
    """init_vqa_model and both loaders default to the card and raise without
    one; given device="cpu" they build a CPU model, and evaluate runs where
    the model lives (dense at temperature 0; k_test 128 ranks all 12
    answers, and the GFLOPs count 128 decoder passes, as ``compress_vqa``'s)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: init_vqa_model(TCFG), lambda: vqa_from_jax_params(setup["tree"], TCFG),
                 lambda: load_vqa_state_dict({}, TCFG)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    model = init_vqa_model(TCFG, device="cpu")
    assert model.space_dict.device.type == "cpu"
    assert model.text_decoder.cls.predictions.bias.shape == (96,)
    results, g = TV.evaluate(model, iter(setup["batches"]), setup["a_ids"], setup["a_mask"],
                             temperature=0.0, k_test=128)
    dense = np.mean([vqa_gflops(TCFG.vit, TCFG.med, [16, 16], [b[1].shape[1] - 1] * 2,
                                b[1].shape[1], n_answers=128) for b in setup["batches"]])
    assert len(results) == 6 and all(0 <= a < N_ANSWERS for _, a in results)
    assert g == pytest.approx(dense, rel=1e-12)


# ---------------------------------------------------------------- K3's function


def _tiled_case(with_bias, B=2, H=4, N=256, Dh=16, seed=5):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, N, H, Dh).astype(np.float32) for _ in range(3))
    alive = np.ones((B, N), bool)
    alive[0, 150:] = False  # dies inside query tile 1
    alive[1, 70:] = False  # dies inside query tile 0
    alive[1, 3] = False
    bias = (rng.rand(B, N) < 0.2).astype(np.float32) * PAD_BIAS if with_bias else None
    return q, k, v, alive, bias


@pytest.mark.parametrize("with_bias", [False, True])
def test_k1_plain_matches_the_tiled_kernel(with_bias):
    """K1's plain version against K3 (``fused_attention_scores_tiled``) in
    interpret mode over two 128-query tiles, alive masks dying inside a
    tile, with and without a PAD_BIAS bias."""
    q, k, v, alive, bias = _tiled_case(with_bias)
    B, N, H, Dh = q.shape
    scale = Dh ** -0.5
    lanes = [jnp.asarray(a.transpose(0, 2, 3, 1)) for a in (q, k, v)]  # [B, H, Dh, N]
    out_j, col_j, cls_j = FA.fused_attention_scores_tiled(
        *lanes, jnp.asarray(alive), None if bias is None else jnp.asarray(bias), num_heads=H,
        scale=scale, tile_q=128, interpret=True)
    out, cls, col = attention_scores_plain(_t(q), _t(k), _t(v), _t(alive),
                                           None if bias is None else _t(bias), scale)
    out_j = np.asarray(out_j).transpose(0, 3, 1, 2).reshape(B, N, H * Dh)
    np.testing.assert_allclose(out.numpy(), out_j, atol=2e-6)
    np.testing.assert_allclose(col.numpy(), np.asarray(col_j)[:, 1:], atol=1e-6)
    np.testing.assert_allclose(cls.numpy(), np.asarray(cls_j)[:, 1:], atol=1e-6)


def test_k1_plain_matches_the_tpu_dispatch_past_1536(monkeypatch):
    """At N = 1,560 (padded to 1,664 > 1,536) the JAX package's
    ``_fused_forward`` on a TPU pads to the 512-query tile and runs K3; here
    through its production glue with the backend patched to "tpu" and the
    kernels in interpret mode, against K1's plain version on the same
    inputs."""
    monkeypatch.setattr(FA, "fused_attention_scores_tiled",
                        functools.partial(FA.fused_attention_scores_tiled, interpret=True))
    monkeypatch.setattr(FA, "fused_attention_scores",
                        functools.partial(FA.fused_attention_scores, interpret=True))
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    B, H, N, Dh = 1, 2, 1560, 8
    assert JA._needs_tiling(N)
    rng = np.random.RandomState(7)
    q, k, v = (rng.randn(B, N, H, Dh).astype(np.float32) for _ in range(3))
    alive = np.ones((B, N), bool)
    alive[0, 1490:] = False
    alive[0, 700:760] = False
    bias = (rng.rand(B, N) < 0.1).astype(np.float32) * PAD_BIAS
    scale = Dh ** -0.5
    heads = [jnp.asarray(a.transpose(0, 2, 1, 3)) for a in (q, k, v)]  # [B, H, N, Dh]
    out_j, cls_j, col_j = JA._fused_forward(*heads, jnp.asarray(alive), jnp.asarray(bias), scale)
    out, cls, col = attention_scores_plain(_t(q), _t(k), _t(v), _t(alive), _t(bias), scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=2e-6)
    np.testing.assert_allclose(col.numpy(), np.asarray(col_j), atol=1e-6)
    np.testing.assert_allclose(cls.numpy(), np.asarray(cls_j), atol=1e-6)
