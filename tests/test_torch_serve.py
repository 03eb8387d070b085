"""Serving in the port (``madtp_tpu_torch/serve``, ``cli/export_serving``)
against the JAX package on the CPU, at tiny sizes (fp32).

* Row-independent DTP through every model, in mask and gather mode, at a
  temperature where the rows' own decisions differ from the batch's: NLVR,
  BLIP retrieval (both towers and the ITM), VQA (encode and rank), caption
  (encode) and CLIP (both towers), on the JAX weights carried across by
  ``ckpt/convert.py``.  Logits and scores within 1e-4, states and features
  within 1e-5, kept counts equal.
* Artifacts of all five tasks: one ``.pth`` each, exported by both CLIs
  (the port's with ``--device cpu``), plain, ``--fast_eval`` and
  ``--row_independent``; the port's ``ServingModel`` gives the JAX
  ``ServingModel``'s outputs within the same tolerances (caption sequences,
  VQA answers and kept counts equal), and ``meta.json`` the same inputs,
  batching and capacities.
* ``rebind`` gives the outputs of a fresh load of the new weights.

The counterparts of ``tests/test_serve.py``; its mesh test's counterpart is
in ``tests/test_torch_tp.py``."""

import functools
import os
import shutil
import sys

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
from madtp_tpu.models import blip as JB
from madtp_tpu.models.clip import clip_encode_image, clip_encode_text, init_clip_params
from madtp_tpu.prune.dtp import TokenState as JTokenState
from madtp_tpu.tasks.vqa import rank_answers as j_rank_answers
from madtp_tpu_torch.ckpt.convert import (caption_from_jax_params, clip_from_jax_params,
                                          nlvr_from_jax_params, retrieval_from_jax_params,
                                          vqa_from_jax_params)
from madtp_tpu_torch.core.config import BlipConfig, CLIPConfig, MedConfig, ViTConfig
from madtp_tpu_torch.prune.dtp import TokenState
from madtp_tpu_torch.serve import load_artifact
from madtp_tpu_torch.tasks.vqa import rank_answers

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_driver_common import make_setup  # noqa: E402

T = 3.0  # prunes the tiny models, and their rows' own decisions differ from the batch's
VIT = dict(image_size=64, patch_size=16, embed_dim=64, depth=2, num_heads=4, sd_dim=64)
MED = dict(vocab_size=60, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
           intermediate_size=128, max_position_embeddings=40, encoder_width=64, sd_dim=64)
JCFG = JB.BlipConfig(JViTConfig(**VIT), JMedConfig(**MED), sd_num=8, sd_dim=64)
TCFG = BlipConfig(ViTConfig(**VIT), MedConfig(**MED), sd_num=8, sd_dim=64)
CAPS = {"mask": (None, None), "gather": ((24, 16), (16, 8))}
EOS = 58


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _differs(coupled, per_row):
    """The rows' own kept counts ``[L, B]`` are not all the batch's ``[L]``."""
    return bool((per_row.numpy() != coupled.numpy()[:, None]).any())


def _sharpen(tree, rng):
    """A decoder whose logits spread over several units (linears N(0,
    1/fan_in), embeddings N(0, 1)), so its rankings do not hang on rounding."""
    def draw(path, x):
        name = jax.tree_util.keystr(path)
        if name.endswith("['kernel']"):
            return (rng.randn(*x.shape) * x.shape[-2] ** -0.5).astype(np.float32)
        if "embeddings']" in name and x.ndim == 2:
            return rng.randn(*x.shape).astype(np.float32)
        return np.array(x)
    return jax.tree_util.tree_map_with_path(draw, tree)


# ---------------------------------------------------------------- the models


@pytest.fixture(scope="module")
def nlvr():
    jcfg, params, images, ids, mask, _ = _nlvr_setup(
        image_size=64, B=3, text_len=10,
        vit_kw=dict(embed_dim=64, depth=2, num_heads=4),
        med_kw=dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                    intermediate_size=128, merge_start_layer=1, vocab_size=200,
                    max_position_embeddings=40))
    mask = np.asarray(mask).copy()
    mask[1, 7:] = 0
    tcfg = BlipConfig(ViTConfig(**jcfg.vit.__dict__), MedConfig(**jcfg.med.__dict__),
                      jcfg.sd_num, jcfg.sd_dim)
    return dict(jcfg=jcfg, params=params, model=nlvr_from_jax_params(_np(params), tcfg, "cpu"),
                batch=(np.asarray(images), np.asarray(ids), mask))


@pytest.fixture(scope="module")
def blip():
    params = _np(init_blip_params(JCFG, 0, heads=("retrieval",), with_decoder=True))
    params["text_decoder"] = _sharpen(params["text_decoder"], np.random.RandomState(5))
    rng = np.random.RandomState(1)
    ids = rng.randint(5, 57, size=(3, 9))
    ids[0, 8], ids[1, 5], ids[1, 6:] = EOS, EOS, 0
    a_ids = np.zeros((10, 5), np.int64)
    for a in range(10):
        n = 1 + rng.randint(0, 3)
        a_ids[a, 0], a_ids[a, 1:1 + n], a_ids[a, 1 + n] = 2, rng.randint(5, 57, n), EOS
    return dict(params=jax.tree.map(jnp.asarray, params), tree=params,
                images=rng.randn(3, 3, 64, 64).astype(np.float32), ids=ids,
                mask=(ids > 0).astype(np.int64), a_ids=a_ids, a_mask=(a_ids > 0).astype(np.int64))


@pytest.mark.parametrize("mode", ["mask", "gather"])
def test_nlvr_row_independent_matches_jax(nlvr, mode):
    """Per-row DTP through the NLVR model: each image of a pair on its own
    counts, kept ``[L, 2B]`` and ``[L, B]``."""
    cv, ct = CAPS[mode]
    images, ids, mask = nlvr["batch"]
    logits, (vk, tk) = jax.jit(functools.partial(
        JB.blip_nlvr_forward, cfg=nlvr["jcfg"], temperature=T, prune_active=True,
        capacities_v=cv, capacities_t=ct, row_independent=True))(
            nlvr["params"], images, ids, mask)
    kw = dict(temperature=T, prune_active=True, capacities_v=cv, capacities_t=ct)
    with torch.inference_mode():
        got = nlvr["model"](_t(images), _t(ids), _t(mask), row_independent=True, **kw)
        coupled = nlvr["model"](_t(images), _t(ids), _t(mask), **kw)
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(logits), atol=1e-4)
    np.testing.assert_array_equal(got.v_kept.numpy(), np.asarray(vk))
    np.testing.assert_array_equal(got.t_kept.numpy(), np.asarray(tk))
    assert got.v_kept.shape == (2, 6) and got.t_kept.shape == (2, 3)
    assert _differs(coupled.v_kept, got.v_kept)


@pytest.mark.parametrize("mode", ["mask", "gather"])
def test_retrieval_row_independent_matches_jax(blip, mode):
    """Both retrieval towers and the ITM score over the image tower's state."""
    cv, ct = CAPS[mode]
    model = retrieval_from_jax_params(blip["tree"], TCFG, device="cpu")
    p, images, ids, mask = blip["params"], blip["images"], blip["ids"], blip["mask"]
    kw = dict(temperature=T, prune_active=True, row_independent=True)

    @jax.jit
    def jfn(p):
        feat, state, _ = JB.blip_retrieval_image_features(p, images, JCFG, capacities=cv, **kw)
        tfeat, tout = JB.blip_retrieval_text_features(p, ids, mask, JCFG, capacities=ct, **kw)
        _, _, vk = JB.vit_forward(p["visual_encoder"], images, cfg=JCFG.vit,
                                  space_dict=p["space_dict"], capacities=cv, **kw)
        itm = JB.blip_itm_score(p, ids, mask, JTokenState(state.x, state.alive, None), JCFG,
                                capacities=ct, **kw)
        return feat, state.x, vk, tfeat, tout.kept_counts, itm

    j = _np(jfn(p))
    with torch.inference_mode():
        feat, vout = model.image_features(_t(images), capacities=cv, **kw)
        tfeat, tout = model.text_features(_t(ids), _t(mask), capacities=ct, **kw)
        itm = model.itm_score(_t(ids), _t(mask), TokenState(vout.state.x, vout.state.alive, None),
                              capacities=ct, **kw)
        coupled = model.image_features(_t(images), temperature=T, prune_active=True,
                                       capacities=cv)[1]
    np.testing.assert_allclose(feat.numpy(), j[0], atol=1e-5)
    np.testing.assert_allclose(vout.state.x.numpy(), j[1], atol=1e-5)
    np.testing.assert_array_equal(vout.kept_counts.numpy(), j[2])
    np.testing.assert_allclose(tfeat.numpy(), j[3], atol=1e-5)
    np.testing.assert_array_equal(tout.kept_counts.numpy(), j[4])
    np.testing.assert_allclose(itm.numpy(), j[5], atol=1e-4)
    assert _differs(coupled.kept_counts, vout.kept_counts)


@pytest.mark.parametrize("mode", ["mask", "gather"])
def test_vqa_row_independent_matches_jax(blip, mode):
    """The VQA encode (both towers per row) and the rank over its state."""
    cv, ct = CAPS[mode]
    model = vqa_from_jax_params(blip["tree"], TCFG, device="cpu")
    p, images, ids, mask = blip["params"], blip["images"], blip["ids"], blip["mask"]

    @jax.jit
    def jfn(p):
        out, _, vk = JB.blip_vqa_encode(p, images, ids, mask, JCFG, temperature=T,
                                        prune_active=True, capacities_v=cv, capacities_t=ct,
                                        row_independent=True)
        best, topk = j_rank_answers(p["text_decoder"], out.state, jnp.asarray(blip["a_ids"]),
                                    jnp.asarray(blip["a_mask"]), JCFG, k=4, pad_token_id=0)
        return out.state.x, vk, out.kept_counts, best, topk

    j = _np(jfn(p))
    kw = dict(temperature=T, prune_active=True, capacities_v=cv, capacities_t=ct)
    with torch.inference_mode():
        out, _, vk = model.encode(_t(images), _t(ids), _t(mask), row_independent=True, **kw)
        best, topk = rank_answers(model.text_decoder, out.state, _t(blip["a_ids"]),
                                  _t(blip["a_mask"]), k=4)
        coupled = model.encode(_t(images), _t(ids), _t(mask), **kw)[2]
    np.testing.assert_allclose(out.state.x.numpy(), j[0], atol=1e-5)
    np.testing.assert_array_equal(vk.numpy(), j[1])
    np.testing.assert_array_equal(out.kept_counts.numpy(), j[2])
    np.testing.assert_array_equal(best.numpy(), j[3])
    np.testing.assert_array_equal(topk.numpy(), j[4])
    assert _differs(coupled, vk)


@pytest.mark.parametrize("mode", ["mask", "gather"])
def test_caption_row_independent_matches_jax(blip, mode):
    cv, _ = CAPS[mode]
    model = caption_from_jax_params(blip["tree"], TCFG, device="cpu")
    state, _, vk = jax.jit(functools.partial(
        JB.blip_caption_encode_image, cfg=JCFG, temperature=T, prune_active=True,
        capacities=cv, row_independent=True))(blip["params"], blip["images"])
    with torch.inference_mode():
        got, _, kept = model.encode_image(_t(blip["images"]), temperature=T, prune_active=True,
                                          capacities=cv, row_independent=True)
        coupled = model.encode_image(_t(blip["images"]), temperature=T, prune_active=True,
                                     capacities=cv)[2]
    np.testing.assert_allclose(got.x.numpy(), np.asarray(state.x), atol=1e-5)
    np.testing.assert_array_equal(got.alive.numpy(), np.asarray(state.alive))
    np.testing.assert_array_equal(kept.numpy(), np.asarray(vk))
    assert _differs(coupled, kept)


CLIP = dict(embed_dim=64, image_resolution=64, vision_layers=2, vision_width=128,
            vision_patch_size=16, vision_heads_override=2, context_length=16, vocab_size=100,
            transformer_width=128, transformer_heads=2, transformer_layers=2, sd_dim=128)


@pytest.mark.parametrize("mode", ["mask", "gather"])
def test_clip_row_independent_matches_jax(mode):
    """Both CLIP towers per row; the text tower's EOT guard is each row's
    own (``eot_pos + 2``), and its tower runs in mask mode in both modes."""
    cv = None if mode == "mask" else (24, 16)
    jcfg, tcfg = JCLIPConfig(**CLIP), CLIPConfig(**CLIP)
    rng = np.random.RandomState(0)
    params = init_clip_params(jcfg, rng)
    sd = rng.randn(16, jcfg.sd_dim).astype(np.float32)
    model = clip_from_jax_params(params, tcfg, sd, device="cpu")
    images = rng.randn(3, 3, 64, 64).astype(np.float32)
    text = np.zeros((3, 16), np.int64)
    for b, length in enumerate((5, 9, 14)):
        text[b, :length] = rng.randint(1, 98, size=length)
        text[b, length - 1] = 99
    kw = dict(space_dict=jnp.asarray(sd), temperature=T, prune_active=True,
              row_independent=True)
    jp = jax.tree.map(jnp.asarray, params)
    fi, _, ki = jax.jit(lambda p: clip_encode_image(p, images, jcfg, capacities=cv, **kw))(jp)
    ft, _, kt = jax.jit(lambda p: clip_encode_text(p, text, jcfg, **kw))(jp)
    with torch.inference_mode():
        img = model.encode_image(_t(images), temperature=T, prune_active=True, capacities=cv,
                                 row_independent=True)
        txt = model.encode_text(_t(text), temperature=T, prune_active=True,
                                row_independent=True)
        coupled = model.encode_text(_t(text), temperature=T, prune_active=True)
    np.testing.assert_allclose(img.features.numpy(), np.asarray(fi), atol=1e-5)
    np.testing.assert_array_equal(img.kept_counts.numpy(), np.asarray(ki))
    np.testing.assert_allclose(txt.features.numpy(), np.asarray(ft), atol=1e-5)
    np.testing.assert_array_equal(txt.kept_counts.numpy(), np.asarray(kt))
    assert _differs(coupled.kept_counts, txt.kept_counts)


# ---------------------------------------------------------------- artifacts


def _sharpen_pth(path):
    """The decoder of a reference-layout ``.pth`` redrawn as :func:`_sharpen`
    draws it, the tied export kept tied."""
    ckpt = torch.load(path, weights_only=False)
    sd, g = ckpt["model"], torch.Generator().manual_seed(5)
    for k, v in sd.items():
        if k.startswith("text_decoder.") and v.dim() == 2 and "decoder.weight" not in k:
            scale = 1.0 if "embeddings" in k else v.shape[1] ** -0.5
            sd[k] = torch.randn(v.shape, generator=g) * scale
    sd["text_decoder.cls.predictions.decoder.weight"] = \
        sd["text_decoder.bert.embeddings.word_embeddings.weight"].clone()
    torch.save(ckpt, path)


def _clip_pth(root):
    """A tiny CLIP ``.pth`` with its codebook (heads = width // 64, so both
    packages infer the architecture from the weights)."""
    import yaml

    from madtp_tpu.ckpt.export import export_clip, save_torch_checkpoint

    cfg = JCLIPConfig(embed_dim=16, image_resolution=64, vision_layers=2, vision_width=64,
                      vision_patch_size=16, context_length=32, vocab_size=49408,
                      transformer_width=64, transformer_heads=1, transformer_layers=2,
                      sd_dim=64)
    rng = np.random.RandomState(3)
    sd = export_clip(init_clip_params(cfg, rng))
    sd["space_dict"] = rng.randn(10, 64).astype(np.float32)
    pth, yml = os.path.join(root, "clip.pth"), os.path.join(root, "clip.yaml")
    save_torch_checkpoint(pth, sd, temperature=1.0)
    with open(yml, "w") as f:
        yaml.safe_dump({"sd_dim": 64}, f)
    return yml, pth


@pytest.fixture(scope="module")
def pths(tmp_path_factory):
    out = {}
    for family in ("nlvr", "caption", "vqa", "retrieval"):
        yml, pth, _ = make_setup(tmp_path_factory.mktemp(family), family)
        if family in ("caption", "vqa"):
            _sharpen_pth(pth)
        out[family] = (yml, pth)
    out["clip"] = _clip_pth(str(tmp_path_factory.mktemp("clip")))
    return out


TASK_ARGS = {
    "nlvr": ["--batch", "2", "--text_len", "12"],
    "caption": ["--batch", "2", "--prompt_len", "3", "--max_length", "8", "--min_length", "2"],
    "vqa": ["--batch", "2", "--text_len", "10", "--num_answers", "12", "--answer_len", "6",
            "--k_test", "4"],
    "retrieval": ["--batch", "2", "--text_len", "10", "--rerank_batch", "2"],
    "clip": ["--batch", "2"],
}
VARIANTS = {"plain": [], "fast_eval": ["--fast_eval"], "row_independent": ["--row_independent"]}
UNITS = {"nlvr": [""], "caption": [""], "vqa": [""], "clip": ["image_encoder", "text_encoder"],
         "retrieval": ["image_encoder", "text_encoder", "itm_rerank"]}


def _inputs(task, unit, rng, jax_outputs):
    """One request of full batch for a unit, as numpy arrays (the rerank's
    image states are the JAX image encoder's)."""
    ids = rng.randint(1000, 30000, size=(2, 12)).astype(np.int32)
    mask = np.ones((2, 12), np.int32)
    mask[1, 8:] = 0
    t = np.float32(1.0)
    if task == "nlvr":
        return [rng.randn(4, 3, 96, 96).astype(np.float32), ids, mask, t]
    if task == "caption":
        prompt = rng.randint(1000, 30000, size=(2, 3)).astype(np.int32)
        prompt[:, 0] = 30522
        return [rng.randn(2, 3, 96, 96).astype(np.float32), prompt, t]
    if task == "vqa":
        a_ids = rng.randint(1000, 30000, size=(12, 6)).astype(np.int32)
        a_ids[:, 0], a_ids[:, 4:] = 30522, 0
        return [rng.randn(2, 3, 96, 96).astype(np.float32), ids[:, :10], mask[:, :10],
                a_ids, (a_ids > 0).astype(np.int32), t]
    if task == "clip":
        if unit == "image_encoder":
            return [rng.randn(2, 3, 64, 64).astype(np.float32), t]
        text = np.zeros((2, 32), np.int32)
        for b, n in enumerate((7, 20)):
            text[b, :n] = rng.randint(1, 49000, size=n)
            text[b, n - 1] = 49407
        return [text, t]
    if unit == "image_encoder":
        return [rng.randn(2, 3, 96, 96).astype(np.float32), t]
    if unit == "text_encoder":
        return [ids[:, :10], mask[:, :10], t]
    _, sx, sa = jax_outputs["image_encoder"]
    return [ids[:, :10], mask[:, :10], sx, sa, t]


def export_both(task, variant, pths, root, monkeypatch, extra=()):
    """The task exported by the JAX CLI and the port's (``--device cpu``);
    returns their output directories."""
    from madtp_tpu.cli import export_serving as j_export
    from madtp_tpu_torch.cli import export_serving as t_export

    yml, pth = pths[task]
    argv = ["--task", task, "--config", yml, "--pretrained", pth, "--temperature", "1.0",
            *TASK_ARGS[task], *VARIANTS[variant], *extra]
    jdir, tdir = os.path.join(root, "jax"), os.path.join(root, "port")
    monkeypatch.setattr(sys, "argv", ["x", *argv, "--output_dir", jdir])
    j_export.main()
    t_export.main([*argv, "--output_dir", tdir, "--device", "cpu"])
    return jdir, tdir


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("task", sorted(TASK_ARGS))
def test_artifact_matches_jax_artifact(task, variant, pths, tmp_path, monkeypatch):
    from madtp_tpu.serve import load_artifact as j_load_artifact

    jdir, tdir = export_both(task, variant, pths, str(tmp_path), monkeypatch)
    rng = np.random.RandomState(11)
    jax_outputs = {}
    for unit in UNITS[task]:
        jm = j_load_artifact(os.path.join(jdir, unit))
        tm = load_artifact(os.path.join(tdir, unit), "cpu")
        for key in ("capacities_vision", "capacities_text", "batching", "inputs", "mode",
                    "temperature", "task", "outputs"):
            assert tm.meta.get(key) == jm.meta.get(key), (unit, key)
        inputs = _inputs(task, unit, rng, jax_outputs)
        want = [np.asarray(o) for o in jax.tree.leaves(jm(*map(jnp.asarray, inputs)))]
        got = tm(*inputs)
        jax_outputs[unit] = want
        assert len(got) == len(want)
        atol = 1e-4 if task == "nlvr" or unit == "itm_rerank" else 1e-5
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == torch.from_numpy(w).dtype, (unit, g, w)
            if w.dtype.kind == "f":
                np.testing.assert_allclose(g.numpy(), w, atol=atol)
            else:
                np.testing.assert_array_equal(g.numpy(), w)
    if variant == "fast_eval" and task != "clip":
        assert tm.meta["mode"] == "gather" and tm.meta["capacities_vision"]


def test_rebind_equals_a_fresh_load(pths, tmp_path, monkeypatch):
    """New weights copied in place by ``rebind`` give the outputs of a fresh
    load of them, through the same captured step."""
    from madtp_tpu_torch.utils.graph import model_cache

    _, tdir = export_both("nlvr", "fast_eval", pths, str(tmp_path), monkeypatch)
    model = load_artifact(tdir, "cpu")
    rng = np.random.RandomState(2)
    inputs = _inputs("nlvr", "", rng, {})
    base = model(*inputs)
    sd = torch.load(os.path.join(tdir, "weights.pt"), weights_only=True)
    new = {k: v * 1.5 if v.is_floating_point() else v for k, v in sd.items()}
    entries = model_cache(model.model)
    assert model.rebind(new) is model
    swapped = model(*inputs)
    fresh_dir = str(tmp_path / "fresh")
    shutil.copytree(tdir, fresh_dir)
    torch.save(new, os.path.join(fresh_dir, "weights.pt"))
    fresh = load_artifact(fresh_dir, "cpu")(*inputs)
    assert not torch.equal(base[0], swapped[0])
    for a, b in zip(swapped, fresh):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    assert model_cache(model.model) is entries and len(entries) == 1
