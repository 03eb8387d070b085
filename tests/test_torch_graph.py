"""The port's captured steps (``madtp_tpu_torch/utils/graph.py``) in their CPU
form against the JAX package's jitted steps (CPU, fp32, tiny configs).

On the CPU a captured step has no graph: its static input buffers go through
the step eagerly, with the same copy-in and clone-out as on the card.  Held
here: the port's ``BoundedCache`` against the JAX package's on one sequence
of inserts and reads; the NLVR step in dense, mask and gather mode at two
temperatures in one cache entry, against ``madtp_tpu.tasks.nlvr.
make_eval_step``; two calls before either is read; a ``load_state_dict`` in
place and a move of the weights; the cache's key and bound; caption
sequences, VQA rank and generate, the rerank with its row buffers and the
CLIP towers against the JAX package.  Tolerances are the slices' own:
logits 1e-4 (NLVR), features 1e-5, rerank scores 2e-4; kept counts,
sequences, answers and the rerank's unscored cells must be equal."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _nlvr_setup
from madtp_tpu.cli.common import init_blip_params
from madtp_tpu.core.config import CLIPConfig as JCLIPConfig
from madtp_tpu.core.config import MedConfig as JMedConfig
from madtp_tpu.core.config import ViTConfig as JViTConfig
from madtp_tpu.models.blip import BlipConfig as JBlipConfig
from madtp_tpu.models.blip import blip_caption_encode_image, blip_vqa_encode
from madtp_tpu.models.clip import clip_encode_image, clip_encode_text, init_clip_params
from madtp_tpu.tasks.caption import beam_generate as j_beam_generate
from madtp_tpu.tasks.nlvr import make_eval_step as j_make_eval_step
from madtp_tpu.tasks.retrieval import encode_corpus as j_encode_corpus
from madtp_tpu.tasks.retrieval import rerank_scores as j_rerank_scores
from madtp_tpu.tasks.vqa import rank_answers as j_rank_answers
from madtp_tpu.utils.cache import BoundedCache as JBoundedCache
from madtp_tpu_torch.ckpt.convert import (caption_from_jax_params, clip_from_jax_params,
                                          nlvr_from_jax_params, retrieval_from_jax_params,
                                          vqa_from_jax_params)
from madtp_tpu_torch.core.config import BlipConfig, CLIPConfig, MedConfig, ViTConfig
from madtp_tpu_torch.data.tokenizer_bert import BertWordPieceTokenizer
from madtp_tpu_torch.tasks import caption as TC
from madtp_tpu_torch.tasks import clip_retrieval as TCL
from madtp_tpu_torch.tasks import retrieval as TR
from madtp_tpu_torch.tasks import vqa as TV
from madtp_tpu_torch.tasks.nlvr import make_eval_step
from madtp_tpu_torch.utils.cache import BoundedCache
from madtp_tpu_torch.utils.graph import MAXSIZE, CapturedStep, graph_count, model_cache

TEMPERATURES = (20.0, 3.0)  # the second one prunes more: other kept counts, one entry
NLVR_CAPS = {"dense": (False, None, None), "mask": (True, None, None),
             "gather": (True, (24, 16, 16), (8, 8, 8))}


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


# ---------------------------------------------------------------- the cache


@pytest.mark.parametrize("maxsize", [1, 3, MAXSIZE])
def test_bounded_cache_matches_jax(maxsize):
    """The same keys survive in the same order after every insert and read
    of one random sequence (reads of present keys refresh them)."""
    rng = np.random.RandomState(maxsize)
    port, ref = BoundedCache(maxsize), JBoundedCache(maxsize)
    for _ in range(200):
        key = int(rng.randint(0, 2 * maxsize + 2))
        if rng.rand() < 0.5:
            port[key] = ref[key] = key
        elif key in ref:
            assert port[key] == ref[key]
        assert list(port.items()) == list(ref.items())


# ---------------------------------------------------------------- the step


class _Owner(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.arange(4.0))


def _scale_step(owner, static=()):
    return CapturedStep(lambda x, t: (owner.w * x * t, None), "scale", owner, static=static)


def test_one_entry_serves_every_temperature():
    """A number is an input (a 0-d float32 buffer), not part of the key."""
    owner = _Owner()
    step = _scale_step(owner)
    x = torch.ones(4)
    for t in (1.0, 2.5, 0, -3.0):
        out, none = step(x, t)
        assert torch.equal(out, owner.w * t) and none is None
    assert len(model_cache(owner)) == 1


def test_key_takes_shapes_dtypes_and_statics_and_is_bounded():
    """Entries are keyed by the step's name and static arguments, at most
    ``MAXSIZE`` of them, least recently used dropped, as the JAX package's
    step caches; within an entry each input signature (shape, dtype) has its
    own buffers (a last partial batch, a batch padded to another length), none
    dropped, as ``jax.jit`` keeps a program per shape; anything but tensors,
    numbers and None is refused."""
    owner = _Owner()
    step = _scale_step(owner)
    step(torch.ones(4), 1.0)
    step(torch.ones(2, 4), 1.0)
    step(torch.ones(4, dtype=torch.float64), 1.0)
    _scale_step(owner, static=("other",))(torch.ones(4), 1.0)
    cache = model_cache(owner)
    assert len(cache) == 2 and graph_count(cache) == 4
    for n in range(3, 3 + 4 * MAXSIZE):
        step(torch.ones(n, 4), 1.0)
    assert len(cache) == 2 and len(cache[("scale", ())].entries) == 3 + 4 * MAXSIZE
    for n in range(MAXSIZE):
        _scale_step(owner, static=(n,))(torch.ones(4), 1.0)
    assert len(cache) == MAXSIZE and list(cache)[-1] == ("scale", (MAXSIZE - 1,))
    assert ("scale", ()) not in cache and ("other",) not in {k[1] for k in cache}
    with pytest.raises(TypeError, match="str"):
        step(torch.ones(4), "1.0")


def test_outputs_are_clones_of_the_buffers():
    """The step's outputs do not share storage with its buffers, so the next
    call cannot overwrite them, even when the step returns an input."""
    owner = _Owner()
    step = CapturedStep(lambda x: x, "identity", owner)
    a = step(torch.ones(3))
    b = step(torch.zeros(3))
    assert torch.equal(a, torch.ones(3)) and torch.equal(b, torch.zeros(3))


def test_moved_weights_drop_the_entries():
    """A load_state_dict that copies in place keeps the entry and is seen by
    the next call; a move of the weights (``.to()``) or a load that replaces
    them (``assign=True``) empties the cache."""
    owner = _Owner()
    step = _scale_step(owner)
    step(torch.ones(4), 1.0)
    entries = model_cache(owner)
    owner.load_state_dict({"w": torch.full((4,), 2.0)})
    assert torch.equal(step(torch.ones(4), 1.0)[0], torch.full((4,), 2.0))
    assert model_cache(owner) is entries and len(entries) == 1
    owner.to(torch.float64)
    assert len(model_cache(owner)) == 0
    step(torch.ones(4), 1.0)
    owner.load_state_dict({"w": torch.full((4,), 3.0, dtype=torch.float64)}, assign=True)
    assert len(model_cache(owner)) == 0
    assert torch.equal(step(torch.ones(4), 1.0)[0], torch.full((4,), 3.0, dtype=torch.float64))


def test_weights_are_listed_once_and_checked_by_address():
    """A call checks the addresses of the weights listed at the first call;
    it walks the model again only after a module registered a tensor, and
    keeps the entries when the addresses are the same."""
    owner = _Owner()
    step = _scale_step(owner)
    step(torch.ones(4), 1.0)
    walks = []
    walk = owner.parameters
    owner.parameters = lambda *a, **k: walks.append(1) or walk(*a, **k)
    entries = model_cache(owner)
    for _ in range(3):
        step(torch.ones(4), 1.0)
    assert walks == [] and model_cache(owner) is entries
    torch.nn.Linear(2, 2)  # registers tensors in another module
    step(torch.ones(4), 1.0)
    assert walks == [1] and model_cache(owner) is entries and len(entries) == 1


# ---------------------------------------------------------------- NLVR


@pytest.fixture(scope="module")
def nlvr():
    jcfg, params, images, ids, mask, _ = _nlvr_setup(
        image_size=96, B=2, text_len=12,
        vit_kw=dict(embed_dim=64, depth=3, num_heads=4),
        med_kw=dict(hidden_size=64, num_hidden_layers=3, num_attention_heads=4,
                    intermediate_size=128, merge_start_layer=1, vocab_size=500,
                    max_position_embeddings=64))
    mask = np.asarray(mask).copy()
    mask[1, 9:] = 0
    tcfg = BlipConfig(ViTConfig(**dataclasses.asdict(jcfg.vit)),
                      MedConfig(**dataclasses.asdict(jcfg.med)), jcfg.sd_num, jcfg.sd_dim)
    tree = jax.tree.map(np.asarray, params)
    return dict(jcfg=jcfg, tcfg=tcfg, params=params, tree=tree,
                model=nlvr_from_jax_params(tree, tcfg, device="cpu"),
                batch=(np.asarray(images), np.asarray(ids), mask))


def _j_nlvr(nlvr, mode, t, params=None):
    prune, cv, ct = NLVR_CAPS[mode]
    logits, vk, tk = j_make_eval_step(nlvr["jcfg"], prune, cv, ct)(
        params or nlvr["params"], *map(jnp.asarray, nlvr["batch"]), jnp.float32(t))
    return np.asarray(logits), np.asarray(vk), np.asarray(tk)


@pytest.mark.parametrize("mode", ["dense", "mask", "gather"])
def test_nlvr_step_matches_jax(nlvr, mode):
    """The captured step against the jitted JAX step at two temperatures,
    both through one cache entry; against the eager step (``graph=False``):
    equal kept counts and overflow, logits within 1e-6 (the CPU's BLAS may
    sum in another order for buffers at other addresses; the card's
    bit-equality is a ``cuda`` case)."""
    model = nlvr["model"]
    model_cache(model).clear()
    step = make_eval_step(model, *NLVR_CAPS[mode])
    eager = make_eval_step(model, *NLVR_CAPS[mode], graph=False)
    batch = tuple(map(_t, nlvr["batch"]))
    kept = []
    for t in TEMPERATURES if mode != "dense" else (0.0,):
        out = step(*batch, t)
        logits, vk, tk = _j_nlvr(nlvr, mode, t)
        np.testing.assert_allclose(out.logits.numpy(), logits, atol=1e-4)
        np.testing.assert_array_equal(out.v_kept.numpy(), vk)
        np.testing.assert_array_equal(out.t_kept.numpy(), tk)
        again = eager(*batch, t)
        torch.testing.assert_close(out.logits, again.logits, rtol=0, atol=1e-6)
        for a, b in zip(out[1:], again[1:]):
            assert (a is None and b is None) or torch.equal(a, b)
        kept.append(out.v_kept.tolist())
    assert len(model_cache(model)) == 1
    if mode == "mask":
        assert kept[0] != kept[1]  # the temperature reached the step


def test_nlvr_two_calls_before_reading(nlvr):
    """Batch i+1 is dispatched before batch i is read: the first call's
    outputs stay those of its own inputs."""
    model = nlvr["model"]
    step = make_eval_step(model, *NLVR_CAPS["mask"])
    images, ids, mask = map(_t, nlvr["batch"])
    first = step(images, ids, mask, TEMPERATURES[0])
    second = step(images.flip(0), ids.flip(0), mask.flip(0), TEMPERATURES[1])
    logits, vk, tk = _j_nlvr(nlvr, "mask", TEMPERATURES[0])
    np.testing.assert_allclose(first.logits.numpy(), logits, atol=1e-4)
    np.testing.assert_array_equal(first.v_kept.numpy(), vk)
    assert not torch.equal(first.v_kept, second.v_kept)


def test_nlvr_load_state_dict_in_place(nlvr):
    """New weights copied into the model after the first call give the next
    call the JAX result on the new weights, through the same entry."""
    model = nlvr_from_jax_params(nlvr["tree"], nlvr["tcfg"], device="cpu")
    step = make_eval_step(model, *NLVR_CAPS["gather"])
    batch = tuple(map(_t, nlvr["batch"]))
    step(*batch, TEMPERATURES[0])
    entries = model_cache(model)
    rng = np.random.RandomState(7)
    tree = jax.tree.map(lambda a: a + 0.05 * rng.randn(*a.shape).astype(np.float32),
                        nlvr["tree"])
    model.load_state_dict(nlvr_from_jax_params(tree, nlvr["tcfg"], device="cpu").state_dict())
    out = step(*batch, TEMPERATURES[0])
    logits, vk, tk = _j_nlvr(nlvr, "gather", TEMPERATURES[0], jax.tree.map(jnp.asarray, tree))
    np.testing.assert_allclose(out.logits.numpy(), logits, atol=1e-4)
    np.testing.assert_array_equal(out.v_kept.numpy(), vk)
    np.testing.assert_array_equal(out.t_kept.numpy(), tk)
    assert model_cache(model) is entries and len(entries) == 1


# ---------------------------------------------------------------- caption and VQA


WORDS = "a picture of dog cat man woman sitting on the table with red blue".split()
TOKENIZER = BertWordPieceTokenizer.toy(WORDS)
V = len(TOKENIZER.vocab)
EOS, BOS = TOKENIZER.sep_token_id, TOKENIZER.bos_token_id
VIT = dict(image_size=64, patch_size=16, embed_dim=64, depth=2, num_heads=4, sd_dim=64)
MED = dict(vocab_size=V, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
           intermediate_size=128, max_position_embeddings=40, encoder_width=64, sd_dim=64)
JCFG = JBlipConfig(JViTConfig(**VIT), JMedConfig(**MED), sd_num=8, sd_dim=64)
TCFG = BlipConfig(ViTConfig(**VIT), MedConfig(**MED), sd_num=8, sd_dim=64)

_j_beam = jax.jit(j_beam_generate, static_argnames=(
    "cfg", "num_beams", "max_length", "min_length", "eos_token_id", "pad_token_id"))


def _decoder_tree(tree, rng):
    """The decoder's linears N(0, 1/fan_in) and embeddings N(0, 1), EOS's
    output bias +12: logits spread over several units, so beams differ."""
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
def blip():
    params = init_blip_params(JCFG, 0, heads=(), with_decoder=True)
    tree = jax.tree.map(np.asarray, params)
    tree["text_decoder"] = _decoder_tree(tree["text_decoder"], np.random.RandomState(5))
    rng = np.random.RandomState(1)
    q_ids = rng.randint(5, V - 2, size=(2, 9))
    q_ids[:, 0], q_ids[0, 8], q_ids[1, 5], q_ids[1, 6:] = TOKENIZER.enc_token_id, EOS, EOS, 0
    return dict(params=jax.tree.map(jnp.asarray, tree), tree=tree,
                images=rng.randn(2, 3, 64, 64).astype(np.float32), q_ids=q_ids,
                q_mask=(q_ids > 0).astype(np.int64))


@pytest.mark.parametrize("caps", [None, (16, 12)], ids=["dense", "gather"])
def test_caption_step_matches_jax_beam_generate(blip, caps):
    """The captured encode and decode give JAX ``beam_generate``'s sequences
    token for token over the JAX encode, at two temperatures (gather mode)
    through one cache entry."""
    model = caption_from_jax_params(blip["tree"], TCFG, device="cpu")
    prompt = TC.prompt_ids(TOKENIZER, 2)
    for t in TEMPERATURES if caps else (0.0,):
        state, _, vk = jax.jit(functools.partial(
            blip_caption_encode_image, cfg=JCFG, prune_active=caps is not None,
            capacities=caps))(blip["params"], blip["images"], temperature=t)
        want = _j_beam(blip["params"]["text_decoder"], state, jnp.asarray(prompt), JCFG,
                       num_beams=3, max_length=20, min_length=5, eos_token_id=EOS,
                       pad_token_id=0)
        seqs, v_kept = TC.generate_captions(model, TOKENIZER, blip["images"], t,
                                            capacities=caps)
        np.testing.assert_array_equal(seqs.numpy(), np.asarray(want))
        np.testing.assert_array_equal(v_kept.numpy(), np.asarray(vk))
    assert len(model_cache(model)) == 1
    assert len({tuple(r) for r in seqs.tolist()}) == 2  # the rows decode apart


def test_vqa_rank_step_matches_jax(blip):
    """``evaluate``'s captured rank step (the answer list an input) against
    ``blip_vqa_encode`` and ``rank_answers`` of the JAX package, at two
    temperatures through one cache entry."""
    model = vqa_from_jax_params(blip["tree"], TCFG, device="cpu")
    rng = np.random.RandomState(4)
    a_ids = np.zeros((10, 5), np.int64)
    for a in range(10):
        n = 1 + rng.randint(0, 3)
        a_ids[a, 0], a_ids[a, 1:1 + n], a_ids[a, 1 + n] = BOS, rng.randint(5, V - 2, n), EOS
    a_mask = (a_ids > 0).astype(np.int64)
    batch = (blip["images"], blip["q_ids"], blip["q_mask"], np.arange(2))
    for t in TEMPERATURES:
        out, _, _ = jax.jit(functools.partial(blip_vqa_encode, cfg=JCFG, prune_active=True))(
            blip["params"], blip["images"], blip["q_ids"], blip["q_mask"], temperature=t)
        best, _ = j_rank_answers(blip["params"]["text_decoder"], out.state, jnp.asarray(a_ids),
                                 jnp.asarray(a_mask), JCFG, k=4, pad_token_id=0)
        got, _ = TV.evaluate(model, [batch], a_ids, a_mask, temperature=t, k_test=4)
        assert got == [(0, int(best[0])), (1, int(best[1]))]
    assert len(model_cache(model)) == 1


def test_vqa_generate_step_matches_jax(blip):
    """``generate_answers`` through its captured step against the mask-mode
    JAX encode and ``beam_generate`` from BOS (``gen_step``), at two
    temperatures through one cache entry."""
    model = vqa_from_jax_params(blip["tree"], TCFG, device="cpu")
    for t in TEMPERATURES:
        out, _, vk = jax.jit(functools.partial(blip_vqa_encode, cfg=JCFG, prune_active=True))(
            blip["params"], blip["images"], blip["q_ids"], blip["q_mask"], temperature=t)
        want = _j_beam(blip["params"]["text_decoder"], out.state,
                       jnp.full((2, 1), BOS, jnp.int32), JCFG, num_beams=3, max_length=10,
                       min_length=1, eos_token_id=EOS, pad_token_id=0)
        seqs, v_kept, q_kept = TV.generate_answers(
            model, *map(_t, (blip["images"], blip["q_ids"], blip["q_mask"])), temperature=t,
            bos_token_id=BOS, eos_token_id=EOS)
        np.testing.assert_array_equal(seqs.numpy(), np.asarray(want))
        np.testing.assert_array_equal(v_kept.numpy(), np.asarray(vk))
        np.testing.assert_array_equal(q_kept.numpy(), np.asarray(out.kept_counts))
    assert len(model_cache(model)) == 1


# ---------------------------------------------------------------- retrieval


RVIT = dict(image_size=32, patch_size=8, embed_dim=32, depth=2, num_heads=4, sd_dim=32)
RMED = dict(vocab_size=60, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=64, max_position_embeddings=32, encoder_width=32, sd_dim=32)
RJCFG = JBlipConfig(JViTConfig(**RVIT), JMedConfig(**RMED), sd_num=8, sd_dim=32)
RTCFG = BlipConfig(ViTConfig(**RVIT), MedConfig(**RMED), sd_num=8, sd_dim=32)


@pytest.mark.parametrize("mode", ["mask", "gather"])
def test_rerank_rows_match_jax(mode):
    """``encode_corpus`` and ``rerank_scores`` through their captured steps
    (one graph per direction serving every row from its index) against the
    JAX package: the same unscored (-100) cells, scores within 2e-4; the
    eager rows' within 1e-6 (CPU summation order, as the NLVR step's)."""
    params = init_blip_params(RJCFG, 0, heads=("retrieval",))
    model = retrieval_from_jax_params(jax.tree.map(np.asarray, params), RTCFG, device="cpu")
    rng = np.random.RandomState(1)
    images = [rng.randn(3, 3, 32, 32).astype(np.float32),
              rng.randn(2, 3, 32, 32).astype(np.float32)]
    ids = rng.randint(1, 59, size=(7, 9)).astype(np.int64)
    ids[:, 0] = 1
    mask = np.ones((7, 9), np.int64)
    mask[2, 6:] = 0
    enc_ids = ids.copy()
    enc_ids[:, 0] = 59
    cv, ct = (None, None) if mode == "mask" else ((16, 12), (8, 8))
    kw = dict(temperature=20.0, prune_active=True, capacities_v=cv, capacities_t=ct)
    rkw = dict(k_test=3, temperature=20.0, prune_active=True, capacities_t=ct)
    j = j_encode_corpus(params, RJCFG, iter(images), ids, mask, **kw)
    want = j_rerank_scores(params, RJCFG, *j, enc_ids, mask, rows_per_call=2, **rkw)
    t = TR.encode_corpus(model, iter(images), ids, mask, **kw)
    np.testing.assert_allclose(t[0], j[0], atol=1e-5)
    np.testing.assert_allclose(t[2], j[2], atol=1e-5)
    got = TR.rerank_scores(model, *t, enc_ids, mask, **rkw)
    eager = TR.rerank_scores(model, *t, enc_ids, mask, graph=False, **rkw)
    for g, w, e in zip(got, want, eager):
        np.testing.assert_array_equal(g == -100.0, w == -100.0)
        assert ((g != -100.0).sum(axis=1) == 3).all()
        np.testing.assert_allclose(g, w, atol=2e-4)
        np.testing.assert_allclose(g, e, rtol=0, atol=1e-6)
    assert {k[0] for k in model_cache(model)} == {"retrieval_image", "retrieval_text"}


# ---------------------------------------------------------------- CLIP


CLIP = dict(embed_dim=64, image_resolution=64, vision_layers=2, vision_width=128,
            vision_patch_size=16, vision_heads_override=2, context_length=16, vocab_size=100,
            transformer_width=128, transformer_heads=2, transformer_layers=2, sd_dim=128)


@pytest.mark.parametrize("caps", [None, (24, 16)], ids=["mask", "gather"])
def test_clip_tower_steps_match_jax(caps):
    """``encode_towers`` through its captured steps against the jitted JAX
    towers (features normalised, kept counts of the last batch), at two
    temperatures through one entry per tower, a graph per batch shape."""
    jcfg, tcfg = JCLIPConfig(**CLIP), CLIPConfig(**CLIP)
    rng = np.random.RandomState(0)
    params = init_clip_params(jcfg, rng)
    sd = rng.randn(16, jcfg.sd_dim).astype(np.float32)
    model = clip_from_jax_params(params, tcfg, sd, device="cpu")
    images = rng.randn(6, 3, 64, 64).astype(np.float32)
    text = np.zeros((6, 16), np.int64)
    for b, length in enumerate(rng.randint(5, 13, size=6)):
        text[b, :length] = rng.randint(1, 98, size=length)
        text[b, length - 1] = 99
    jp = jax.tree.map(jnp.asarray, params)

    def unit(f):
        return np.asarray(f / jnp.linalg.norm(f, axis=-1, keepdims=True))

    for t in TEMPERATURES:
        kw = dict(space_dict=jnp.asarray(sd), temperature=t, prune_active=True)
        j_img = jax.jit(lambda p, im: clip_encode_image(p, im, jcfg, capacities=caps, **kw))
        j_txt = jax.jit(lambda p, tx: clip_encode_text(p, tx, jcfg, **kw))
        img_j = [j_img(jp, images[i:i + 3]) for i in (0, 3)]
        txt_j = [j_txt(jp, text[i:i + 4]) for i in (0, 4)]
        img, txt, vk, tk = TCL.encode_towers(model, [images[:3], images[3:]], text,
                                             temperature=t, prune_active=True,
                                             capacities_v=caps, batch_size=4)
        np.testing.assert_allclose(img, np.concatenate([unit(o[0]) for o in img_j]), atol=1e-5)
        np.testing.assert_allclose(txt, np.concatenate([unit(o[0]) for o in txt_j]), atol=1e-5)
        np.testing.assert_array_equal(vk, np.asarray(img_j[-1][2]))
        np.testing.assert_array_equal(tk, np.asarray(txt_j[-1][2]))
    # the image batches share a shape; the text batches are 4 and a partial 2:
    # one entry per tower, the text's with two signatures
    cache = model_cache(model)
    assert sorted(k[0] for k in cache) == ["clip_image", "clip_text"]
    assert graph_count(cache) == 3
