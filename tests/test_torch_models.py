"""The port's ViT, MED, NLVR model, weight loaders and eval loop against the
JAX package on one set of tiny random weights (CPU, fp32).  Both twin-cross
branches run (merge_start_layer=1 of 3 layers).  Kept counts and overflow
must be equal; hidden states agree within 1e-5 and logits within 1e-4."""

import dataclasses

import numpy as np
import jax
import pytest
import torch

from __graft_entry__ import _nlvr_setup
from madtp_tpu.ckpt.export import export_med, export_vit
from madtp_tpu.ckpt.remap import interpolate_pos_embed as j_interpolate_pos_embed
from madtp_tpu.models import med as JM
from madtp_tpu.models.blip import _split_state, blip_nlvr_forward
from madtp_tpu.models.vit import vit_forward
from madtp_tpu.tasks.nlvr import evaluate as j_evaluate
from madtp_tpu_torch.ckpt.convert import (interpolate_pos_embed, load_nlvr_state_dict,
                                          nlvr_from_jax_params)
from madtp_tpu_torch.core.config import BlipConfig, MedConfig, ViTConfig
from madtp_tpu_torch.models.blip import split_state
from madtp_tpu_torch.prune.dtp import TokenState
from madtp_tpu_torch.tasks.nlvr import evaluate as t_evaluate
from madtp_tpu_torch.tasks.nlvr import fast_capacity_schedule

TEMPERATURE = 20.0
CAPS_V = (24, 16, 16)
CAPS_T = (8, 8, 8)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


@pytest.fixture(scope="module")
def setup():
    jcfg, params, images, ids, mask, targets = _nlvr_setup(
        image_size=96, B=2, text_len=12,
        vit_kw=dict(embed_dim=64, depth=3, num_heads=4),
        med_kw=dict(hidden_size=64, num_hidden_layers=3, num_attention_heads=4,
                    intermediate_size=128, merge_start_layer=1, vocab_size=500,
                    max_position_embeddings=64))
    mask = np.asarray(mask).copy()
    mask[1, 9:] = 0  # a padded caption: PAD_BIAS keys in the text attention
    tcfg = BlipConfig(ViTConfig(**dataclasses.asdict(jcfg.vit)),
                      MedConfig(**dataclasses.asdict(jcfg.med)), jcfg.sd_num, jcfg.sd_dim)
    tree = jax.tree.map(np.asarray, params)
    model = nlvr_from_jax_params(tree, tcfg, device="cpu")
    return dict(jcfg=jcfg, tcfg=tcfg, params=params, tree=tree, model=model,
                images=np.asarray(images), ids=np.asarray(ids), mask=mask,
                targets=np.asarray(targets))


@pytest.fixture(scope="module")
def runs(setup):
    """JAX and port outputs of the towers and the whole model, per mode."""
    jcfg, model = setup["jcfg"], setup["model"]
    images, ids, mask = setup["images"], setup["ids"], setup["mask"]
    B = ids.shape[0]

    def jax_fn(caps_v, caps_t):
        @jax.jit
        def f(params, images, ids, mask):
            v = vit_forward(params["visual_encoder"], images, cfg=jcfg.vit,
                            space_dict=params["space_dict"], temperature=TEMPERATURE,
                            prune_active=True, capacities=caps_v)
            st0, st1 = _split_state(v[0], B)
            m = JM.med_encoder(params["text_encoder"], ids, mask, jcfg.med,
                               encoder_state=st0, encoder_state1=st1,
                               space_dict=params["space_dict"], temperature=TEMPERATURE,
                               prune_active=True, capacities=caps_t)
            logits, kept = blip_nlvr_forward(
                params, images, ids, mask, jcfg, temperature=TEMPERATURE,
                prune_active=True, capacities_v=caps_v, capacities_t=caps_t)
            return v, m, logits, kept
        return jax.tree.map(np.asarray, f(setup["params"], images, ids, mask))

    out = {}
    for mode, caps in (("mask", (None, None)), ("gather", (CAPS_V, CAPS_T))):
        (jv_state, jv_sd, jv_kept), jm, j_logits, j_kept = jax_fn(*caps)
        with torch.no_grad():
            tv = model.visual_encoder(_t(images), space_dict=model.space_dict,
                                      temperature=TEMPERATURE, prune_active=True,
                                      capacities=caps[0])
            # the text tower reads the JAX image states, so it is compared alone
            enc = TokenState(_t(jv_state.x), _t(jv_state.alive), None)
            st0, st1 = split_state(enc, B)
            tm = model.text_encoder(_t(ids), _t(mask), encoder_state=st0,
                                    encoder_state1=st1, space_dict=model.space_dict,
                                    temperature=TEMPERATURE, prune_active=True,
                                    capacities=caps[1])
            tn = model(_t(images), _t(ids), _t(mask), temperature=TEMPERATURE,
                       prune_active=True, capacities_v=caps[0], capacities_t=caps[1])
        out[mode] = dict(jv=(jv_state, jv_sd, jv_kept), jm=jm, j_logits=j_logits,
                         j_kept=j_kept, tv=tv, tm=tm, tn=tn)
    return out


def _assert_tower(t_out, j_state, j_sd, j_kept):
    np.testing.assert_array_equal(t_out.kept_counts.numpy(), j_kept)
    np.testing.assert_array_equal(t_out.state.alive.numpy(), j_state.alive)
    np.testing.assert_allclose(t_out.state.x.numpy(), j_state.x, atol=1e-5)
    np.testing.assert_allclose(t_out.sd_ft.numpy(), j_sd, atol=1e-5)


@pytest.mark.parametrize("mode", ["mask", "gather"])
def test_vit_matches_jax(runs, mode):
    r = runs[mode]
    _assert_tower(r["tv"], *r["jv"])
    # mask: 1 + 36 patches + 3 merge slots, padded to 8; gather: the last capacity
    assert r["tv"].state.x.shape[1] == (40 if mode == "mask" else CAPS_V[-1])


@pytest.mark.parametrize("mode", ["mask", "gather"])
def test_med_encoder_matches_jax(runs, mode):
    r = runs[mode]
    jm = r["jm"]
    _assert_tower(r["tm"], jm.state, jm.sd_txt_ft, jm.kept_counts)
    np.testing.assert_array_equal(r["tm"].state.bias.numpy(), jm.state.bias)


@pytest.mark.parametrize("mode", ["mask", "gather"])
def test_nlvr_forward_matches_jax(runs, mode):
    r = runs[mode]
    tn, (jv_kept, jt_kept) = r["tn"], r["j_kept"]
    np.testing.assert_array_equal(tn.v_kept.numpy(), jv_kept)
    np.testing.assert_array_equal(tn.t_kept.numpy(), jt_kept)
    np.testing.assert_allclose(tn.logits.numpy(), r["j_logits"], atol=1e-4)
    # the weights and temperature prune in both towers
    assert jv_kept[-1] < 36 and jt_kept[-1] < 11
    if mode == "gather":
        assert int(tn.overflow) > 0  # CAPS_V is tighter than the mask-mode keep


def _reference_state_dict(setup, twin_keys=True):
    tree, jcfg = setup["tree"], setup["jcfg"]
    sd = export_vit(tree["visual_encoder"])
    sd.update(export_med(tree["text_encoder"], twin_cross=True,
                         merge_start_layer=jcfg.med.merge_start_layer))
    head = tree["cls_head"]
    sd["cls_head.0.weight"], sd["cls_head.0.bias"] = head["fc1"]["kernel"].T, head["fc1"]["bias"]
    sd["cls_head.2.weight"], sd["cls_head.2.bias"] = head["fc2"]["kernel"].T, head["fc2"]["bias"]
    sd["space_dict"] = tree["space_dict"]
    if not twin_keys:  # a base checkpoint: one cross-attention for both twins
        for k in [k for k in sd if ".self1." in k or ".dense1." in k or ".merge_layer." in k]:
            del sd[k]
        for k in [k for k in sd if ".self0." in k or ".dense0." in k]:
            sd[k.replace(".self0.", ".self.").replace(".dense0.", ".dense.")] = sd.pop(k)
    return sd


def test_loaders_give_identical_tensors(setup):
    a = setup["model"].state_dict()
    b = load_nlvr_state_dict(_reference_state_dict(setup), setup["tcfg"],
                             device="cpu").state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert not any(".layer.0.crossattention.output.merge_layer" in k for k in a)


def test_load_base_state_dict_duplicates_twins(setup):
    sd = load_nlvr_state_dict(_reference_state_dict(setup, twin_keys=False),
                              setup["tcfg"], device="cpu").state_dict()
    p = "text_encoder.encoder.layer.2.crossattention."
    assert torch.equal(sd[p + "self0.query.weight"], sd[p + "self1.query.weight"])
    assert torch.equal(sd[p + "output.dense0.weight"], sd[p + "output.dense1.weight"])
    assert not sd[p + "output.merge_layer.weight"].any()


@pytest.mark.parametrize("new_grid", [8, 4])  # grow and shrink a 6x6 grid
def test_interpolate_pos_embed_matches_jax(new_grid):
    pos = np.random.RandomState(5).randn(1, 1 + 36, 16).astype(np.float32)
    want = j_interpolate_pos_embed(pos, new_grid ** 2)
    got = interpolate_pos_embed(_t(pos), new_grid ** 2)
    assert got.shape == (1, 1 + new_grid ** 2, 16)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_evaluate_matches_jax(setup):
    """The single-process gather eval loop: same accuracy and GFLOPs."""
    images, ids, mask = setup["images"], setup["ids"], setup["mask"]
    B = ids.shape[0]

    def loader():
        for shift in (0, 1):
            im = np.roll(images, shift, axis=0)
            yield im[:B], im[B:], ["s"] * B, setup["targets"]

    def tokenize(sentences):
        return ids.copy(), mask.copy()

    kw = dict(prune_active=True, enc_token_id=2, capacities_v=CAPS_V,
              capacities_t=CAPS_T, print_fn=lambda *_: None)
    j_stats, j_g = j_evaluate(setup["params"], loader, tokenize, setup["jcfg"],
                              TEMPERATURE, **kw)
    t_stats, t_g = t_evaluate(setup["model"], loader, tokenize, TEMPERATURE, **kw)
    assert t_stats["acc"] == j_stats["acc"]
    assert t_g == pytest.approx(j_g, rel=1e-12)
    assert int(t_stats["overflow"]) > 0


def test_fast_capacity_schedule():
    caps_v, caps_t = fast_capacity_schedule([448, 357, 320], [25, 25, 20], "ceil")
    assert caps_v == (512, 384, 384) and caps_t == (32, 32, 32)
    assert fast_capacity_schedule([448, 357, 320], None, "nearest")[1] is None
