"""The port's caption slice against the JAX package (CPU, fp32, a tiny BLIP
captioner on one set of random weights: ViT 64 px with patch 16 and width 64,
2 layers; MED width 64 with 2 layers and a toy vocabulary of 25 tokens): the
decoder's incremental step and its cache over every position, beam search
(three (max_length, min_length) pairs, a repetition penalty, and tied
candidate scores), the image encode in dense, mask and gather mode,
``caption_gflops``, both weight loaders with a position-grid resize, the
tokenizer, the caption scorers, the capacity probe and the eval, VQA's
``generate`` inference, the device rule.  Tolerances: hidden states, caches
and image states 1e-5; sequences, captions, kept counts and alive masks must
be equal.

The decoder's weights are drawn with fan-in scaling and N(0, 1) embeddings
(the JAX init's N(0, 0.02) makes every logit nearly equal, so each beam
repeats one token): the logits then spread over several units and the
sequences vary, end at EOS at different steps and differ from row to row.
The JAX references are jitted once per static configuration: eager
``fori_loop`` calls recompile."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madtp_tpu.ckpt.export import export_med, export_vit, save_torch_checkpoint
from madtp_tpu.cli import compress_caption as JCC
from madtp_tpu.cli.common import fast_capacity_schedule as j_fast_capacity_schedule
from madtp_tpu.cli.common import init_blip_params
from madtp_tpu.core.config import MedConfig as JMedConfig
from madtp_tpu.core.config import ViTConfig as JViTConfig
from madtp_tpu.data.tokenizer_bert import BertWordPieceTokenizer as JTokenizer
from madtp_tpu.eval.caption_metrics import coco_caption_scores as j_coco_caption_scores
from madtp_tpu.models import med as JM
from madtp_tpu.models.blip import BlipConfig as JBlipConfig
from madtp_tpu.models.blip import blip_caption_encode_image, blip_vqa_encode, load_blip_caption
from madtp_tpu.prune.dtp import TokenState as JTokenState
from madtp_tpu.prune.flops import caption_gflops as j_caption_gflops
from madtp_tpu.tasks.caption import beam_generate as j_beam_generate
from madtp_tpu_torch.ckpt.convert import (caption_from_jax_params, load_caption_state_dict,
                                          vqa_from_jax_params)
from madtp_tpu_torch.core.config import BlipConfig, MedConfig, ViTConfig, caption_config
from madtp_tpu_torch.data.tokenizer_bert import BertWordPieceTokenizer
from madtp_tpu_torch.eval.caption_metrics import coco_caption_scores
from madtp_tpu_torch.models.blip import init_caption_model
from madtp_tpu_torch.models.med import DecodeCache, init_decode_cache
from madtp_tpu_torch.prune.dtp import TokenState
from madtp_tpu_torch.prune.flops import ORI_GFLOPS_CAPTION, caption_gflops
from madtp_tpu_torch.tasks import caption as TC
from madtp_tpu_torch.tasks.vqa import generate_answers

PAD_BIAS = -10000.0
WORDS = ("a picture of dog cat man woman sitting on the table with red blue in front "
         "street car").split()
J_TOKENIZER = JTokenizer.toy(WORDS)
TOKENIZER = BertWordPieceTokenizer.toy(WORDS)
V = len(TOKENIZER.vocab)  # [PAD] [UNK] [CLS] [SEP] [MASK], 18 words, [DEC] [ENC]
EOS, BOS, ENC = TOKENIZER.sep_token_id, TOKENIZER.bos_token_id, TOKENIZER.enc_token_id
VIT = dict(image_size=64, patch_size=16, embed_dim=64, depth=2, num_heads=4, sd_dim=64)
MED = dict(vocab_size=V, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
           intermediate_size=128, max_position_embeddings=40, encoder_width=64, sd_dim=64)
JCFG = JBlipConfig(JViTConfig(**VIT), JMedConfig(**MED), sd_num=8, sd_dim=64)
TCFG = BlipConfig(ViTConfig(**VIT), MedConfig(**MED), sd_num=8, sd_dim=64)
TEMPERATURE = 2.0
CAPS = {"dense": None, "mask": None, "gather": (16, 16)}
# the beam searches' static configurations (max_length, min_length,
# repetition_penalty): the caption driver's, VQA generate's and two more
BEAMS = [(20, 5, 1.0), (10, 1, 1.0), (12, 6, 1.0), (10, 3, 1.2)]


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _state(st):
    return TokenState(*(None if a is None else _t(a) for a in st))


def _jstate(st):
    return JTokenState(*(None if a is None else jnp.asarray(a) for a in st))


def _decoder_tree(tree, rng):
    """The decoder's linears N(0, 1/fan_in), its embeddings N(0, 1), EOS's
    output bias +12: logits spread over several units."""
    def draw(path, x):
        name = jax.tree_util.keystr(path)
        if name.endswith("['kernel']"):
            return (rng.randn(*x.shape) * x.shape[-2] ** -0.5).astype(np.float32)
        if "embeddings']" in name and x.ndim == 2:
            return rng.randn(*x.shape).astype(np.float32)
        return np.array(x)

    out = jax.tree_util.tree_map_with_path(draw, tree)
    out["cls"]["bias"][EOS] += 12.0
    return out


@pytest.fixture(scope="module")
def setup():
    params = init_blip_params(JCFG, 0, heads=(), with_encoder=False, with_decoder=True)
    tree = jax.tree.map(np.asarray, params)
    tree["text_decoder"] = _decoder_tree(tree["text_decoder"], np.random.RandomState(5))
    rng = np.random.RandomState(1)
    batches = [(rng.randn(2, 3, 64, 64).astype(np.float32), np.arange(i, i + 2))
               for i in (0, 2, 4)]
    # a memory with a padding bias and dead slots
    S = 9
    mem = JTokenState(rng.randn(2, S, 64).astype(np.float32),
                      np.array([[True] * 7 + [False] * 2, [True] * 9]),
                      np.array([[0.0] * 6 + [PAD_BIAS] * 3, [0.0] * 8 + [PAD_BIAS]], np.float32))
    return dict(params=jax.tree.map(jnp.asarray, tree), tree=tree, batches=batches, mem=mem,
                model=caption_from_jax_params(tree, TCFG, device="cpu"))


_j_step = jax.jit(JM.med_decoder_step, static_argnames=("cfg",))
_j_beam = jax.jit(j_beam_generate, static_argnames=(
    "cfg", "num_beams", "max_length", "min_length", "eos_token_id", "pad_token_id",
    "length_penalty", "repetition_penalty"))


def _beams(setup, mem, prompt, max_length, min_length, repetition_penalty, params=None,
           decoder=None):
    """The JAX and the port's sequences of one beam search."""
    params = params or setup["params"]
    decoder = decoder or setup["model"].text_decoder
    kw = dict(num_beams=3, max_length=max_length, min_length=min_length, eos_token_id=EOS,
              pad_token_id=0)
    if repetition_penalty != 1.0:  # the default left out: one compile per configuration
        kw["repetition_penalty"] = repetition_penalty
    want = _j_beam(params["text_decoder"], _jstate(mem), jnp.asarray(prompt), JCFG, **kw)
    got = TC.beam_generate(decoder, _state(mem), _t(prompt), **kw)
    return got.numpy(), np.asarray(want)


# ---------------------------------------------------------------- the decode


@pytest.mark.parametrize("projected", [False, True])
def test_decoder_step_matches_jax(setup, projected):
    """``MedDecoder.step`` against ``med_decoder_step`` at every position of
    a 6-token sequence, the cache carried along: hidden states and both
    caches within 1e-5; with the memory's keys and values projected once
    (``memory_kv``) the hidden states are the same bits as without."""
    decoder, mem = setup["model"].text_decoder, setup["mem"]
    ids = np.random.RandomState(2).randint(0, V, size=(2, 6))
    jcache = JM.init_decode_cache(JCFG.med, 2, 8)
    cache = init_decode_cache(TCFG.med, 2, 8)
    kv = decoder.memory_kv(_state(mem)) if projected else None
    with torch.no_grad():
        for t in range(ids.shape[1]):
            want, jcache = _j_step(setup["params"]["text_decoder"], jnp.asarray(ids[:, t:t + 1]),
                                   jnp.int32(t), jcache, JCFG.med, encoder_state=_jstate(mem))
            got, cache = decoder.step(_t(ids[:, t:t + 1]), torch.tensor(t), cache, _state(mem),
                                      kv)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
            np.testing.assert_allclose(cache.k.numpy(), np.asarray(jcache.k), atol=1e-5)
            np.testing.assert_allclose(cache.v.numpy(), np.asarray(jcache.v), atol=1e-5)
            if projected:
                again, _ = decoder.step(_t(ids[:, t:t + 1]), torch.tensor(t),
                                        DecodeCache(cache.k.clone(), cache.v.clone()),
                                        _state(mem))
                assert torch.equal(got, again)
    assert not cache.k[:, :, :, 6:].any()  # slots past the last position stay empty


@pytest.mark.parametrize("max_length,min_length,repetition_penalty", BEAMS)
def test_beam_generate_matches_jax(setup, max_length, min_length, repetition_penalty):
    """Token-for-token the JAX sequences over a memory with a key bias and
    dead slots, from the caption prompt."""
    prompt = TC.prompt_ids(TOKENIZER, 2)
    got, want = _beams(setup, setup["mem"], prompt, max_length, min_length, repetition_penalty)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (2, max_length)
    assert (got[:, :prompt.shape[1]] == prompt).all()
    if min_length == 5:  # the rows end at EOS at different steps, padded after it
        ends = [int(np.argmax(r == EOS)) for r in got]
        assert all(e >= min_length for e in ends) and len(set(ends)) == 2
        assert all((r[e + 1:] == 0).all() for r, e in zip(got, ends))


def test_beam_generate_with_tied_candidates(setup):
    """Two tokens with equal embeddings and output bias tie exactly at every
    step, for the best candidates of a beam and, as their beams then hold
    equal states, between beams: the JAX order, lower index first, decides
    which beam carries which token and which beam survives."""
    tree = jax.tree.map(np.array, setup["tree"])
    d = tree["text_decoder"]
    a, b = TOKENIZER.vocab["dog"], TOKENIZER.vocab["cat"]
    d["embeddings"]["word_embeddings"][b] = d["embeddings"]["word_embeddings"][a]
    d["cls"]["bias"][[a, b]] = 25.0
    model = caption_from_jax_params(tree, TCFG, device="cpu")
    with torch.no_grad():  # the tie is exact in the port's first step
        h = model.text_decoder.bos_step(torch.full((2, 1), BOS), _state(setup["mem"]))[0]
        logits = model.text_decoder.lm_head(h)[:, 0]
    assert torch.equal(logits[:, a], logits[:, b])
    got, want = _beams(setup, setup["mem"], TC.prompt_ids(TOKENIZER, 2), 10, 1, 1.0,
                       params=jax.tree.map(jnp.asarray, tree), decoder=model.text_decoder)
    np.testing.assert_array_equal(got, want)
    assert (got == a).any() and not (got == b).any()  # the lower index wins every tie


# ---------------------------------------------------------------- the model


@functools.lru_cache(maxsize=None)
def _j_encoder(mode):
    return jax.jit(functools.partial(blip_caption_encode_image, cfg=JCFG,
                                     temperature=TEMPERATURE, prune_active=mode != "dense",
                                     capacities=CAPS[mode]))


@pytest.mark.parametrize("mode", ["dense", "mask", "gather"])
def test_encode_image_matches_jax(setup, mode):
    """The image tower with DTP: equal kept counts and alive masks, states
    within 1e-5."""
    images = setup["batches"][0][0]
    st_j, _, kept_j = _j_encoder(mode)(setup["params"], images)
    with torch.no_grad():
        st, _, kept = setup["model"].encode_image(_t(images), temperature=TEMPERATURE,
                                                  prune_active=mode != "dense",
                                                  capacities=CAPS[mode])
    np.testing.assert_array_equal(kept.numpy(), np.asarray(kept_j))
    np.testing.assert_array_equal(st.alive.numpy(), np.asarray(st_j.alive))
    np.testing.assert_allclose(st.x.numpy(), np.asarray(st_j.x), atol=1e-5)
    if mode != "dense":
        assert kept[-1] < TCFG.vit.num_patches  # the temperature prunes


def test_caption_gflops_match_jax():
    """Exact at the tiny config and at the full one: 66.281 with the dense
    ViT's 576 kept patches at 384 px (66.399 with 577, CLS counted; the
    reference's 65.7 is its traced count)."""
    for vcfg, jvcfg, mcfg, jmcfg, kept in (
            (TCFG.vit, JCFG.vit, TCFG.med, JCFG.med, [16, 9]),
            (caption_config().vit, JViTConfig(), caption_config().med, JMedConfig(), [576] * 12),
            (caption_config().vit, JViTConfig(), caption_config().med, JMedConfig(),
             list(range(500, 140, -30)))):
        assert caption_gflops(vcfg, mcfg, kept, 14) == j_caption_gflops(jvcfg, jmcfg, kept, 14)
    full = caption_config()
    assert round(caption_gflops(full.vit, full.med, [576] * 12, 14), 3) == 66.281
    assert round(caption_gflops(full.vit, full.med, [577] * 12, 14), 3) == 66.399
    assert ORI_GFLOPS_CAPTION == JCC.ORI_GFLOPS
    assert caption_config() == BlipConfig(ViTConfig(), MedConfig())


def test_loaders_give_identical_tensors(setup, tmp_path):
    """The JAX-tree converter and the reference-layout loader give the same
    tensors; ``load_blip_caption``'s ``.pth`` (with the tied decoder exports)
    loads at a larger image size too, the 4 x 4 position grid resized to
    6 x 6 as the JAX loader resizes it."""
    tree = setup["tree"]
    sd = export_vit(tree["visual_encoder"], patch_size=16)
    sd.update(export_med(tree["text_decoder"], "text_decoder.", has_lm_head=True))
    sd["space_dict"] = tree["space_dict"]
    assert "text_decoder.cls.predictions.decoder.weight" in sd
    a = setup["model"].state_dict()
    b = load_caption_state_dict(sd, TCFG, device="cpu").state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k

    path = str(tmp_path / "caption.pth")
    save_torch_checkpoint(path, sd)
    big_j = JCFG._replace(vit=JViTConfig(**dict(VIT, image_size=96)))
    big_t = TCFG._replace(vit=ViTConfig(**dict(VIT, image_size=96)))
    params96, _ = load_blip_caption(path, big_j)
    want = caption_from_jax_params(jax.tree.map(np.asarray, params96), big_t, device="cpu")
    got = load_caption_state_dict(torch.load(path)["model"], big_t, device="cpu")
    assert got.visual_encoder.pos_embed.shape == (1, 37, 64)
    for (k, w), g in zip(want.state_dict().items(), got.state_dict().values()):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-6, err_msg=k)
    del sd["space_dict"]
    with pytest.raises(KeyError, match="space_dict"):
        load_caption_state_dict(sd, TCFG, device="cpu")


# ---------------------------------------------------------------- text


def test_tokenizer_matches_jax():
    """Encode (with punctuation, case, accents, subwords and unknown words),
    batch padding both ways, and decode, against the JAX tokenizer."""
    words = WORDS + ["##s", "##ing", "walk", "."]
    jt, tt = JTokenizer.toy(words), BertWordPieceTokenizer.toy(words)
    assert tt.vocab == jt.vocab
    texts = ["a picture of ", "A Dog walking on the STREET.", "cats, in front of a car",
             "a café zebra", ""]
    for text in texts:
        assert tt.tokenize(text) == jt.tokenize(text)
        assert tt.encode(text, max_length=6) == jt.encode(text, max_length=6)
    for kw in (dict(padding="longest"), dict(padding="max_length", max_length=7)):
        got, want = tt(texts, **kw), jt(texts, **kw)
        for key in ("input_ids", "attention_mask"):
            np.testing.assert_array_equal(got[key], want[key])
    ids = tt(texts)["input_ids"]
    assert [tt.decode(r) for r in ids] == [jt.decode(r) for r in ids]
    assert tt.decode(ids[1], skip_special_tokens=False) == \
        jt.decode(ids[1], skip_special_tokens=False)
    with pytest.raises(ValueError, match="max_length"):
        tt(texts, padding="max_length")


def test_caption_scores_match_jax():
    """Every ``coco_caption_scores`` key equal to the JAX scorer's on a
    fixed set of captions (an image id without references is left out)."""
    gt = {"1": ["a man riding a horse on the beach", "a person rides a brown horse"],
          "2": ["two cats sleeping on a red couch", "a pair of cats lying on a sofa"],
          "3": ["a bowl of fruit on a wooden table"],
          "4": ["a red bus driving down a city street", "a double decker bus in traffic"]}
    results = [{"image_id": 1, "caption": "a man riding a horse"},
               {"image_id": 2, "caption": "cats sleeping on the couch"},
               {"image_id": 3, "caption": "fruit in a bowl on a table"},
               {"image_id": 4, "caption": "a bus on the street"},
               {"image_id": 5, "caption": "nothing to score"}]
    got, want = coco_caption_scores(results, gt), j_coco_caption_scores(results, gt)
    assert got.keys() == want.keys() and len(got) == 8
    assert got == want
    assert 0 < got["CIDEr"] and 0 < got["Bleu_1"] <= 1


# ---------------------------------------------------------------- the task


def _j_generate_captions(setup, images, caps, monkeypatch):
    """The JAX ``generate_captions`` and ``finish_captions``
    (``madtp_tpu/cli/compress_caption.py:47-92``) with their image encode
    and beam search jitted."""
    mode = "dense" if caps is None else "gather"
    encoder = (_j_encoder(mode) if caps is None else jax.jit(functools.partial(
        blip_caption_encode_image, cfg=JCFG, temperature=TEMPERATURE, prune_active=True,
        capacities=caps)))
    monkeypatch.setattr(JCC, "blip_caption_encode_image",
                        lambda params, images, cfg, **kw: encoder(params, images))
    monkeypatch.setattr(JCC, "beam_generate", _j_beam)
    out, v_kept, B = JCC.generate_captions(setup["params"], JCFG, J_TOKENIZER, images,
                                           TEMPERATURE if caps else 0.0, capacities=caps,
                                           defer=True)
    return JCC.finish_captions(J_TOKENIZER, out, B), np.asarray(v_kept)


def test_probe_and_evaluate_match_jax(setup, monkeypatch):
    """``--fast_eval``'s probe (mask mode on the first batches) against the
    JAX driver's calibration, then the gather-mode eval's captions and
    GFLOPs against the JAX driver's ``generate_captions`` /
    ``finish_captions`` on the same batches."""
    vks = [np.asarray(_j_encoder("mask")(setup["params"], images)[2])
           for images, _ in setup["batches"]]
    want_caps, _ = j_fast_capacity_schedule(np.stack(vks), None, "ceil")
    caps = TC.probe_capacities(setup["model"], iter(setup["batches"]), TEMPERATURE, "ceil")
    assert caps == want_caps
    want, g = [], []
    for images, img_ids in setup["batches"]:
        caps_j, vk = _j_generate_captions(setup, images, caps, monkeypatch)
        want += [{"image_id": int(i), "caption": c} for c, i in zip(caps_j, img_ids)]
        g.append(j_caption_gflops(JCFG.vit, JCFG.med, vk, 14))
    results, cur_g = TC.evaluate(setup["model"], TOKENIZER, iter(setup["batches"]),
                                 temperature=TEMPERATURE, capacities=caps)
    assert results == want and len(results) == 6
    assert cur_g == pytest.approx(np.mean(g), rel=1e-12)
    assert len({r["caption"] for r in results}) > 1


def test_generate_answers_matches_jax():
    """VQA ``inference: 'generate'`` against ``gen_step``'s composition
    (``madtp_tpu/cli/compress_vqa.py:128-146``): the mask-mode encode at a
    temperature, then the 3-beam decode from BOS, max_length 10, min_length
    1, over the question state (its padding bias and pruned slots)."""
    params = init_blip_params(JCFG, 0, heads=(), with_decoder=True)
    tree = jax.tree.map(np.asarray, params)
    tree["text_decoder"] = _decoder_tree(tree["text_decoder"], np.random.RandomState(6))
    params = jax.tree.map(jnp.asarray, tree)
    model = vqa_from_jax_params(tree, TCFG, device="cpu")
    rng = np.random.RandomState(3)
    images = rng.randn(2, 3, 64, 64).astype(np.float32)
    q_ids = rng.randint(5, 23, size=(2, 9))
    q_ids[:, 0], q_ids[0, 8], q_ids[1, 5], q_ids[1, 6:] = ENC, EOS, EOS, 0
    q_mask = (q_ids > 0).astype(np.int64)
    out, _, vk_j = blip_vqa_encode(params, jnp.asarray(images), jnp.asarray(q_ids),
                                   jnp.asarray(q_mask), JCFG, temperature=TEMPERATURE,
                                   prune_active=True)
    want = _j_beam(params["text_decoder"], out.state, jnp.full((2, 1), BOS, jnp.int32), JCFG,
                   num_beams=3, max_length=10, min_length=1, eos_token_id=EOS, pad_token_id=0)
    seqs, vk, tk = generate_answers(model, _t(images), _t(q_ids), _t(q_mask),
                                    temperature=TEMPERATURE, bos_token_id=BOS,
                                    eos_token_id=EOS)
    np.testing.assert_array_equal(seqs.numpy(), np.asarray(want))
    np.testing.assert_array_equal(vk.numpy(), np.asarray(vk_j))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(out.kept_counts))
    assert vk[-1] < TCFG.vit.num_patches and (seqs[:, 0] == BOS).all()


def test_entry_points_refuse_without_gpu(setup, monkeypatch):
    """init_caption_model and both loaders default to the card and raise
    without one; given device="cpu" they build a CPU model, and evaluate runs
    where the model lives (dense at temperature 0, the GFLOPs of the dense
    tower)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: init_caption_model(TCFG),
                 lambda: caption_from_jax_params(setup["tree"], TCFG),
                 lambda: load_caption_state_dict({}, TCFG)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    model = init_caption_model(TCFG, device="cpu")
    assert model.space_dict.device.type == "cpu"
    assert model.text_decoder.cls.predictions.bias.shape == (V,)
    results, g = TC.evaluate(model, TOKENIZER, iter(setup["batches"][:2]), temperature=0.0,
                             max_length=8)
    assert [r["image_id"] for r in results] == [0, 1, 2, 3]
    assert g == caption_gflops(TCFG.vit, TCFG.med, [16, 16], 14)
