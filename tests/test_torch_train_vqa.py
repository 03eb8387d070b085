"""The port's VQA compression training against the JAX package on the CPU
(fp32 unless amp, a tiny BLIP VQA on one set of random weights: ViT 64 px
with patch 16, width 64, 2 layers; the MED question encoder and answer
decoder width 64 with 2 layers and a toy vocabulary): the batch (answers
padded to ``MAX_A`` with zero weights), the decoder's logits over the tiled
question states, the soft-weighted loss and the FDT loss and their gradients
in mask and gather mode, gather against mask at lossless capacities, the
train step and a two-batch ``train_epoch`` against the JAX step with
``optax.adamw``, the amp step's fp32 masters, the checkpoint in both
packages, the device rule.

Tolerances: losses and logits atol 1e-4; gradients atol 1e-5 + rtol 1e-3;
parameters after AdamW steps at configs/vqa.yaml's learning rate atol 1e-6 +
rtol 1e-4 (as tests/test_torch_train_caption.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madtp_tpu.cli.common import init_blip_params
from madtp_tpu.cli.compress_vqa import tokenize_answers as j_tokenize_answers
from madtp_tpu.core.config import MedConfig as JMedConfig
from madtp_tpu.core.config import ViTConfig as JViTConfig
from madtp_tpu.data.tokenizer_bert import BertWordPieceTokenizer as JTokenizer
from madtp_tpu.models import med as JM
from madtp_tpu.models.blip import BlipConfig as JBlipConfig
from madtp_tpu.models.blip import blip_vqa_encode, load_blip_vqa
from madtp_tpu.train import optim as JO
from madtp_tpu.train.loops import make_vqa_train_step as j_make_step
from madtp_tpu_torch.ckpt.convert import (load_vqa_state_dict, save_vqa_checkpoint,
                                          vqa_from_jax_params)
from madtp_tpu_torch.core.config import BlipConfig, MedConfig, ViTConfig
from madtp_tpu_torch.data.tokenizer_bert import BertWordPieceTokenizer
from madtp_tpu_torch.prune.dtp import TokenState
from madtp_tpu_torch.tasks import vqa as TV
from madtp_tpu_torch.train.loops import make_vqa_train_step
from madtp_tpu_torch.train.optim import make_adamw

WORDS = ("what is the man woman sitting on in front of color red blue table car street "
         "yes no two dog").split()
J_TOKENIZER = JTokenizer.toy(WORDS)
TOKENIZER = BertWordPieceTokenizer.toy(WORDS)
V = len(TOKENIZER.vocab)
VIT = dict(image_size=64, patch_size=16, embed_dim=64, depth=2, num_heads=4, sd_dim=64)
MED = dict(vocab_size=V, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
           intermediate_size=128, max_position_embeddings=40, encoder_width=64, sd_dim=64)
JCFG = JBlipConfig(JViTConfig(**VIT), JMedConfig(**MED), sd_num=8, sd_dim=64)
TCFG = BlipConfig(ViTConfig(**VIT), MedConfig(**MED), sd_num=8, sd_dim=64)
TEMPERATURE = 2.0
MAX_A = TV.MAX_A
# vqa_collate's batches: questions, the answers flat, their weights, counts
BATCHES = [
    (["what is the man sitting on", "what color is the car"],
     ["table", "the table", "street", "red", "blue"], [0.5, 0.3, 0.2, 0.7, 0.3], [3, 2]),
    (["is the dog on the car", "what is the woman sitting on"],
     ["yes", "no", "car", "the car", "red table", "two"], [1.0, 0.4, 0.3, 0.2, 0.1, 0.0],
     [2, 4]),
]  # both batches pad to 8 question and 4 answer tokens: one compile of the JAX step


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _driver_batch(questions, answers, weights, n):
    """The JAX driver's batch (``compress_vqa.py:425-446``, one process), on
    the JAX package's tokenizer."""
    B = len(n)
    q = J_TOKENIZER(list(questions), padding="longest", max_length=35)
    q_ids = q["input_ids"]
    q_ids[:, 0] = J_TOKENIZER.enc_token_id
    a = J_TOKENIZER(list(answers), padding="longest")
    La = a["input_ids"].shape[1]
    ans_ids = np.zeros((B, MAX_A, La), np.int32)
    ans_msk = np.zeros((B, MAX_A, La), np.int32)
    w = np.zeros((B, MAX_A), np.float32)
    pos = 0
    for b, cnt in enumerate(n):
        cnt = min(cnt, MAX_A)
        ans_ids[b, :cnt] = a["input_ids"][pos:pos + cnt]
        ans_ids[b, :cnt, 0] = J_TOKENIZER.bos_token_id
        ans_msk[b, :cnt] = a["attention_mask"][pos:pos + cnt]
        w[b, :cnt] = weights[pos:pos + cnt]
        pos += cnt
    return q_ids, q["attention_mask"], ans_ids, ans_msk, w


@pytest.fixture(scope="module")
def setup():
    params = init_blip_params(JCFG, 0, heads=(), with_decoder=True)
    tree = jax.tree.map(np.asarray, params)
    rng = np.random.RandomState(3)
    images = [rng.randn(2, 3, 64, 64).astype(np.float32) for _ in range(2)]
    batch = _driver_batch(*BATCHES[0])
    model = vqa_from_jax_params(tree, TCFG, device="cpu")
    with torch.no_grad():
        out, _, v_kept = model.encode(_t(images[0]), _t(batch[0]), _t(batch[1]),
                                      temperature=TEMPERATURE, prune_active=True)
    assert int(v_kept[-1]) < 16  # the temperature prunes
    caps = {"mask": (None, None),
            "gather": (tuple(int(k) + 2 for k in v_kept),
                       tuple(int(k) + 2 for k in out.kept_counts))}
    return dict(params=params, tree=tree, images=images, caps=caps, batch=batch)


def _model(setup):
    return vqa_from_jax_params(setup["tree"], TCFG, device="cpu")


def test_tokenize_answers_matches_jax():
    answers = ["table", "the red car", "yes"]
    got = TV.tokenize_answers(TOKENIZER, answers)
    want = j_tokenize_answers(J_TOKENIZER, answers, J_TOKENIZER.bos_token_id)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("which", [0, 1])
def test_train_batch_pads_to_max_a(which):
    """Each question's answers, then zero rows with weight 0 up to MAX_A: the
    driver's batch, and the weights sum per question as given."""
    questions, answers, weights, n = BATCHES[which]
    got = TV.train_batch(TOKENIZER, questions, answers, weights, n)
    for g, w in zip(got, _driver_batch(questions, answers, weights, n)):
        np.testing.assert_array_equal(g, w)
    a_ids, w = got[2], got[4]
    assert a_ids.shape[:2] == (len(n), MAX_A)
    for b, cnt in enumerate(n):
        assert (a_ids[b, cnt:] == 0).all() and (w[b, cnt:] == 0).all()
        assert (a_ids[b, :cnt, 0] == TOKENIZER.bos_token_id).all()
    np.testing.assert_allclose(w.sum(1), [sum(weights[sum(n[:b]):sum(n[:b + 1])])
                                          for b in range(len(n))], rtol=1e-6)


def _j_loss(params, images, q_ids, q_mask, a_ids, a_mask, weights, caps):
    """The JAX step's loss_fn (madtp_tpu/train/loops.py:153-186), with the
    decoder's logits."""
    from madtp_tpu.models.blip import fdt_alignment_loss
    from madtp_tpu.prune.dtp import TokenState as JTokenState

    B, K = a_ids.shape[:2]
    out, sd_img, _ = blip_vqa_encode(params, images, q_ids, q_mask, JCFG,
                                     temperature=TEMPERATURE, prune_active=True,
                                     capacities_v=caps[0], capacities_t=caps[1])
    qs = out.state
    tiled = JTokenState(*(None if a is None else jnp.repeat(a, K, axis=0)
                          for a in (qs.x, qs.alive, qs.bias)))
    ids, msk = a_ids.reshape(B * K, -1), a_mask.reshape(B * K, -1)
    hidden = JM.med_decoder_forward(params["text_decoder"], ids, msk, JCFG.med,
                                    encoder_state=tiled)
    logits = JM.lm_head(params["text_decoder"], hidden, JCFG.med)
    per = JM.lm_loss(logits, jnp.where(ids == 0, -100, ids), reduction="none")
    loss_vqa = jnp.sum(weights.reshape(-1) * per) / B
    loss_fdt = fdt_alignment_loss(sd_img, out.sd_txt_ft, JCFG.sd_dim)
    return loss_vqa + 0.1 * loss_fdt, (loss_vqa, loss_fdt, logits)


@pytest.fixture(scope="module")
def jax_train(setup):
    args = (jnp.asarray(setup["images"][0]), *map(jnp.asarray, setup["batch"]))
    out = {}
    for mode, caps in setup["caps"].items():
        f = jax.jit(jax.value_and_grad(lambda p: _j_loss(p, *args, caps), has_aux=True))
        (_, (lv, lf, logits)), g = f(setup["params"])
        out[mode] = (float(lv), float(lf), np.asarray(logits), jax.tree.map(np.asarray, g))
    return out


@pytest.fixture(scope="module")
def port_train(setup):
    model = _model(setup)
    opt = make_adamw(model.parameters(), lr=0.0, weight_decay=0.0)
    images, q_ids, q_mask, a_ids, a_mask, w = (_t(setup["images"][0]),
                                               *map(_t, setup["batch"]))
    out = {}
    for mode, (cv, ct) in setup["caps"].items():
        step = make_vqa_train_step(model, opt, capacities_v=cv, capacities_t=ct, device="cpu")
        model.zero_grad(set_to_none=True)
        loss, lv, lf = step.loss_fn(images, q_ids, q_mask, a_ids, a_mask, w, TEMPERATURE)
        loss.backward()
        with torch.no_grad():
            enc, _, _ = model.encode(images, q_ids, q_mask, temperature=TEMPERATURE,
                                     prune_active=True, capacities_v=cv, capacities_t=ct)
            K = a_ids.shape[1]
            tiled = TokenState(*(None if a is None else a.repeat_interleave(K, 0)
                                 for a in enc.state))
            dec = model.text_decoder
            logits = dec.lm_head(dec(a_ids.flatten(0, 1), a_mask.flatten(0, 1), tiled))
        out[mode] = (float(lv.detach()), float(lf.detach()), logits.numpy(),
                     {n: p.grad.clone() for n, p in model.named_parameters()})
    return out


@pytest.mark.parametrize("mode", ["mask", "gather"])
def test_vqa_loss_and_logits_match_jax(jax_train, port_train, mode):
    jlv, jlf, jlogits, _ = jax_train[mode]
    lv, lf, logits, _ = port_train[mode]
    assert lv == pytest.approx(jlv, abs=1e-4)
    assert lf == pytest.approx(jlf, abs=1e-4)
    assert lf != lv  # pruning aligns the image's and the question's MAG features
    np.testing.assert_allclose(logits, jlogits, atol=1e-4)


@pytest.mark.parametrize("mode", ["mask", "gather"])
def test_vqa_grads_match_jax(jax_train, port_train, mode):
    want = vqa_from_jax_params(jax_train[mode][3], TCFG, device="cpu").state_dict()
    grads = port_train[mode][3]
    assert want.keys() == grads.keys()
    assert float(grads["space_dict"].abs().sum()) > 0
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=1e-5, rtol=1e-3,
                                   err_msg=name)


def test_vqa_gather_grads_match_mask(port_train):
    lv_m, _, _, g_mask = port_train["mask"]
    lv_g, _, _, g_gat = port_train["gather"]
    assert abs(lv_m - lv_g) < 1e-5
    for name in g_mask:
        np.testing.assert_allclose(g_gat[name].numpy(), g_mask[name].numpy(),
                                   rtol=2e-4, atol=2e-5, err_msg=name)


def _loader(setup):
    def loader():
        for images, (questions, answers, weights, n) in zip(setup["images"], BATCHES):
            yield images, questions, answers, np.asarray(weights, np.float32), n
    return loader


def test_vqa_step_and_epoch_match_jax(setup):
    """One step of make_vqa_train_step, then a two-batch train_epoch, against
    the JAX step (max_answers_per_q=MAX_A) with optax.adamw on the driver's
    batches, at configs/vqa.yaml's learning rate and weight decay."""
    lr, wd = 2e-5, 0.05
    tx = JO.make_adamw_injectable(wd)
    jstep = j_make_step(JCFG, tx, max_answers_per_q=MAX_A)
    jparams = jax.tree.map(jnp.asarray, setup["tree"])
    jstate = tx.init(jparams)
    jstate.hyperparams["learning_rate"] = jnp.float32(lr)
    model = _model(setup)
    opt = make_adamw(model.parameters(), lr=lr, weight_decay=wd)
    step = make_vqa_train_step(model, opt, device="cpu")

    jparams, jstate, jm = jstep(jparams, jstate, jnp.asarray(setup["images"][0]),
                                *map(jnp.asarray, setup["batch"]), jnp.float32(TEMPERATURE))
    m = step(_t(setup["images"][0]), *map(_t, setup["batch"]), TEMPERATURE)
    for k in ("loss", "loss_vqa", "loss_fdt"):
        assert float(m[k]) == pytest.approx(float(jm[k]), abs=1e-4), k
    jlosses = []
    for images, questions, answers, weights, n in _loader(setup)():
        jparams, jstate, jm = jstep(jparams, jstate, jnp.asarray(images),
                                    *map(jnp.asarray, _driver_batch(questions, answers,
                                                                    weights, n)),
                                    jnp.float32(TEMPERATURE))
        jlosses.append(float(jm["loss"]))
    stats = TV.train_epoch(model, step, _loader(setup), TOKENIZER, TEMPERATURE,
                           print_fn=lambda *_: None, lr=lr)
    assert stats["batches_done"] == 2
    assert float(stats["loss"]) == pytest.approx(np.mean(jlosses), abs=2e-4)
    want = vqa_from_jax_params(jax.tree.map(np.asarray, jparams), TCFG,
                               device="cpu").state_dict()
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=1e-6, rtol=1e-4,
                                   err_msg=name)


def test_vqa_amp_step_keeps_fp32_masters(setup):
    model = _model(setup)
    opt = make_adamw(model.parameters(), lr=1e-5, weight_decay=0.05)
    caps = setup["caps"]["gather"]
    step = make_vqa_train_step(model, opt, capacities_v=caps[0], capacities_t=caps[1],
                               amp=True, device="cpu")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    m = step(_t(setup["images"][0]), *map(_t, setup["batch"]), TEMPERATURE)
    assert torch.isfinite(m["loss"]) and m["loss"].dtype == torch.float32
    for n, p in model.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, n
    assert any(not torch.equal(before[n], p) for n, p in model.named_parameters())


def test_vqa_checkpoint_reads_back_in_both_packages(setup, tmp_path):
    model = _model(setup)
    path = str(tmp_path / "checkpoint_02.pth")
    save_vqa_checkpoint(model, path, epoch=2, temperature=1.25)
    params, temperature = load_blip_vqa(path, JCFG)
    assert temperature == 1.25
    sd = model.state_dict()
    back = vqa_from_jax_params(jax.tree.map(np.asarray, params), TCFG,
                               device="cpu").state_dict()
    ck = torch.load(path)
    assert ck["epoch"] == 2 and all(v.dtype == torch.float32 for v in ck["model"].values())
    again = load_vqa_state_dict(ck["model"], TCFG, device="cpu").state_dict()
    for k in sd:
        assert torch.equal(back[k], sd[k]) and torch.equal(again[k], sd[k]), k


def test_vqa_step_refuses_without_gpu(setup, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = _model(setup)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_vqa_train_step(model, make_adamw(model.parameters(), 1e-5, 0.0))
