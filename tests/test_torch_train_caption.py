"""The port's caption compression training against the JAX package on the CPU
(fp32 unless amp, a tiny BLIP captioner on one set of random weights: ViT 64
px with patch 16, width 64, 2 layers; the MED decoder width 64 with 2 layers
and a toy vocabulary): ``lm_loss``, the training pass's loss and logits and
its gradients in mask and gather mode, gather against mask at lossless
capacities, the train step and a two-batch ``train_epoch`` against the JAX
step with ``optax.adamw``, the amp step's fp32 masters, the batch, the
pre-search, the checkpoint in both packages, the device rule.

Tolerances: losses and logits atol 1e-4; gradients atol 1e-5 + rtol 1e-3
(fp32 through the DTP merge weights, summed in another order); parameters
after AdamW steps atol 1e-6 + rtol 1e-4 at the config's learning rate (Adam
divides by the gradient's own running norm, so a gradient entry's relative
rounding noise moves its update by that share of the learning rate)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madtp_tpu.cli.common import init_blip_params
from madtp_tpu.core.config import MedConfig as JMedConfig
from madtp_tpu.core.config import ViTConfig as JViTConfig
from madtp_tpu.data.tokenizer_bert import BertWordPieceTokenizer as JTokenizer
from madtp_tpu.models import med as JM
from madtp_tpu.models.blip import BlipConfig as JBlipConfig
from madtp_tpu.models.blip import blip_caption_forward, load_blip_caption
from madtp_tpu.prune.flops import caption_gflops as j_caption_gflops
from madtp_tpu.train import controller as JC
from madtp_tpu.train import optim as JO
from madtp_tpu.train.loops import make_caption_train_step as j_make_step
from madtp_tpu_torch.ckpt.convert import (caption_from_jax_params, load_caption_state_dict,
                                          save_caption_checkpoint)
from madtp_tpu_torch.core.config import BlipConfig, MedConfig, ViTConfig
from madtp_tpu_torch.data.tokenizer_bert import BertWordPieceTokenizer
from madtp_tpu_torch.models.med import lm_loss
from madtp_tpu_torch.tasks import caption as TC
from madtp_tpu_torch.train.loops import make_caption_train_step
from madtp_tpu_torch.train.optim import make_adamw

WORDS = ("a picture of dog cat man woman sitting on the table with red blue in front "
         "street car").split()
J_TOKENIZER = JTokenizer.toy(WORDS)
TOKENIZER = BertWordPieceTokenizer.toy(WORDS)
V = len(TOKENIZER.vocab)
VIT = dict(image_size=64, patch_size=16, embed_dim=64, depth=2, num_heads=4, sd_dim=64)
MED = dict(vocab_size=V, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
           intermediate_size=128, max_position_embeddings=40, encoder_width=64, sd_dim=64)
JCFG = JBlipConfig(JViTConfig(**VIT), JMedConfig(**MED), sd_num=8, sd_dim=64)
TCFG = BlipConfig(ViTConfig(**VIT), MedConfig(**MED), sd_num=8, sd_dim=64)
TEMPERATURE = 2.0
CAPTIONS = [["a picture of a dog sitting on the table",
             "a picture of a man in front of the red car"],
            ["a picture of a cat", "a picture of the woman with a blue car on street"]]
# both batches pad to 13 tokens: one compile of each JAX step
PROMPT_LENGTH = len(TOKENIZER.encode(TC.PROMPT)) - 1


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _driver_batch(captions):
    """The JAX driver's batch (``compress_caption.py:400-409``), on the JAX
    package's tokenizer."""
    tok = J_TOKENIZER(list(captions), padding="longest", max_length=40)
    ids, mask = tok["input_ids"], tok["attention_mask"]
    ids[:, 0] = J_TOKENIZER.bos_token_id
    labels = np.where(ids == J_TOKENIZER.pad_token_id, -100, ids)
    labels[:, :PROMPT_LENGTH] = -100
    return ids, mask, labels


@pytest.fixture(scope="module")
def setup():
    params = init_blip_params(JCFG, 0, heads=(), with_encoder=False, with_decoder=True)
    tree = jax.tree.map(np.asarray, params)
    rng = np.random.RandomState(2)
    images = [rng.randn(2, 3, 64, 64).astype(np.float32) for _ in range(2)]
    model = caption_from_jax_params(tree, TCFG, device="cpu")
    with torch.no_grad():
        _, _, kept = model.encode_image(_t(images[0]), temperature=TEMPERATURE,
                                        prune_active=True)
    assert int(kept[-1]) < 16  # the temperature prunes
    caps = {"mask": None, "gather": tuple(int(k) + 2 for k in kept)}  # lossless
    return dict(params=params, tree=tree, images=images, caps=caps,
                batch=_driver_batch(CAPTIONS[0]))


def _model(setup):
    return caption_from_jax_params(setup["tree"], TCFG, device="cpu")


@pytest.mark.parametrize("reduction", ["mean", "none"])
def test_lm_loss_matches_jax(reduction):
    rng = np.random.RandomState(3)
    logits = rng.randn(3, 7, 11).astype(np.float32)
    labels = rng.randint(0, 11, size=(3, 7))
    labels[0, :3] = -100
    labels[1, 5:] = -100
    labels[2, :] = -100  # a sample with nothing to predict
    got = lm_loss(_t(logits), _t(labels), reduction=reduction)
    want = JM.lm_loss(jnp.asarray(logits), jnp.asarray(labels), reduction=reduction)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


def test_train_batch_matches_driver(setup):
    ids, mask, labels = TC.train_batch(TOKENIZER, CAPTIONS[0], PROMPT_LENGTH)
    for got, want in zip((ids, mask, labels), setup["batch"]):
        np.testing.assert_array_equal(got, want)
    assert (labels[:, :PROMPT_LENGTH] == -100).all() and (ids[:, 0] == TOKENIZER.bos_token_id).all()


@pytest.fixture(scope="module")
def jax_train(setup):
    images = jnp.asarray(setup["images"][0])
    ids, mask, labels = map(jnp.asarray, setup["batch"])
    out = {}
    for mode, cv in setup["caps"].items():
        def loss(p):
            lm, _, logits = blip_caption_forward(p, images, ids, mask, JCFG,
                                                 temperature=TEMPERATURE, prune_active=True,
                                                 labels=labels, capacities=cv)
            return lm + 0.1 * lm, (lm, logits)

        (_, (lm, logits)), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(setup["params"])
        out[mode] = (float(lm), np.asarray(logits), jax.tree.map(np.asarray, g))
    return out


@pytest.fixture(scope="module")
def port_train(setup):
    model = _model(setup)
    opt = make_adamw(model.parameters(), lr=0.0, weight_decay=0.0)
    out = {}
    for mode, cv in setup["caps"].items():
        step = make_caption_train_step(model, opt, capacities_v=cv, device="cpu")
        model.zero_grad(set_to_none=True)
        loss, lm, fdt = step.loss_fn(_t(setup["images"][0]),
                                     *map(_t, setup["batch"]), TEMPERATURE)
        loss.backward()
        with torch.no_grad():
            logits = model(_t(setup["images"][0]), *map(_t, setup["batch"][:2]),
                           temperature=TEMPERATURE, prune_active=True, capacities=cv)
        out[mode] = (float(lm.detach()), float(fdt.detach()), logits.numpy(),
                     {n: p.grad.clone() for n, p in model.named_parameters()})
    return out


@pytest.mark.parametrize("mode", ["mask", "gather"])
def test_caption_loss_and_logits_match_jax(jax_train, port_train, mode):
    jlm, jlogits, _ = jax_train[mode]
    lm, fdt, logits, _ = port_train[mode]
    assert lm == pytest.approx(jlm, abs=1e-4)
    assert fdt == lm  # the decoder gives no text MAG features: loss_fdt falls back
    np.testing.assert_allclose(logits, jlogits, atol=1e-4)


@pytest.mark.parametrize("mode", ["mask", "gather"])
def test_caption_grads_match_jax(setup, jax_train, port_train, mode):
    want = caption_from_jax_params(jax_train[mode][2], TCFG, device="cpu").state_dict()
    grads = port_train[mode][3]
    assert want.keys() == grads.keys()
    assert float(grads["space_dict"].abs().sum()) > 0  # learns through the merge weights
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=1e-5, rtol=1e-3,
                                   err_msg=name)


def test_caption_gather_grads_match_mask(port_train):
    """At lossless capacities gather mode re-indexes the mask-mode buffer."""
    lm_m, _, _, g_mask = port_train["mask"]
    lm_g, _, _, g_gat = port_train["gather"]
    assert abs(lm_m - lm_g) < 1e-5
    for name in g_mask:
        np.testing.assert_allclose(g_gat[name].numpy(), g_mask[name].numpy(),
                                   rtol=2e-4, atol=2e-5, err_msg=name)


def _loader(setup):
    def loader():
        for images, captions in zip(setup["images"], CAPTIONS):
            yield images, captions, np.arange(2)
    return loader


@pytest.mark.parametrize("mode", ["mask", "gather"])
def test_caption_step_and_epoch_match_jax(setup, mode):
    """One step of make_caption_train_step, then a two-batch train_epoch,
    against the JAX step with optax.adamw on the driver's batches, at
    configs/caption_coco.yaml's learning rate and weight decay."""
    lr, wd = 1e-5, 0.05
    cv = setup["caps"][mode]
    tx = JO.make_adamw_injectable(wd)
    jstep = j_make_step(JCFG, tx, capacities_v=cv)
    jparams = jax.tree.map(jnp.asarray, setup["tree"])
    jstate = tx.init(jparams)
    jstate.hyperparams["learning_rate"] = jnp.float32(lr)
    model = _model(setup)
    opt = make_adamw(model.parameters(), lr=lr, weight_decay=wd)
    step = make_caption_train_step(model, opt, capacities_v=cv, device="cpu")

    jparams, jstate, jm = jstep(jparams, jstate, jnp.asarray(setup["images"][0]),
                                *map(jnp.asarray, setup["batch"]), jnp.float32(TEMPERATURE))
    m = step(_t(setup["images"][0]), *map(_t, setup["batch"]), TEMPERATURE)
    for k in ("loss", "loss_lm", "loss_fdt"):
        assert float(m[k]) == pytest.approx(float(jm[k]), abs=1e-4), k
    jlosses = []
    for images, captions, _ in _loader(setup)():
        jparams, jstate, jm = jstep(jparams, jstate, jnp.asarray(images),
                                    *map(jnp.asarray, _driver_batch(captions)),
                                    jnp.float32(TEMPERATURE))
        jlosses.append(float(jm["loss"]))
    stats = TC.train_epoch(model, step, _loader(setup), TOKENIZER, TEMPERATURE,
                           print_fn=lambda *_: None, lr=lr)
    assert stats["batches_done"] == 2
    assert float(stats["loss"]) == pytest.approx(np.mean(jlosses), abs=2e-4)
    want = caption_from_jax_params(jax.tree.map(np.asarray, jparams), TCFG,
                                   device="cpu").state_dict()
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=1e-6, rtol=1e-4,
                                   err_msg=name)


def test_caption_amp_step_keeps_fp32_masters(setup):
    model = _model(setup)
    opt = make_adamw(model.parameters(), lr=1e-5, weight_decay=0.05)
    step = make_caption_train_step(model, opt, amp=True, device="cpu")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    m = step(_t(setup["images"][0]), *map(_t, setup["batch"]), TEMPERATURE)
    assert torch.isfinite(m["loss"]) and m["loss"].dtype == torch.float32
    for n, p in model.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, n
    assert any(not torch.equal(before[n], p) for n, p in model.named_parameters())


def test_presearch_matches_jax(setup):
    """The pre-search's measure (the mask-mode image tower, caption_gflops at
    14 decoder tokens) and the controller's ladder, against the JAX ones."""
    model = _model(setup)
    images = setup["images"][0]
    target = 0.8 * j_caption_gflops(JCFG.vit, JCFG.med, [16] * 2, 14)

    def measure(t):
        from madtp_tpu.models.blip import blip_caption_encode_image
        _, _, kept = blip_caption_encode_image(setup["params"], jnp.asarray(images), JCFG,
                                               temperature=jnp.float32(t), prune_active=True)
        return j_caption_gflops(JCFG.vit, JCFG.med, np.asarray(kept), 14)

    want = JC.presearch_temperature(measure, target, t0=1.0, tol=1.0 / 64, max_iters=6)
    assert TC.presearch(model, images, target, tol=1.0 / 64, max_iters=6) == want


def test_caption_checkpoint_reads_back_in_both_packages(setup, tmp_path):
    model = _model(setup)
    path = str(tmp_path / "checkpoint_best.pth")
    save_caption_checkpoint(model, path, epoch=2, temperature=1.5)
    params, temperature = load_blip_caption(path, JCFG)
    assert temperature == 1.5
    sd = model.state_dict()
    back = caption_from_jax_params(jax.tree.map(np.asarray, params), TCFG,
                                   device="cpu").state_dict()
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    ck = torch.load(path)
    assert ck["epoch"] == 2 and all(v.dtype == torch.float32 for v in ck["model"].values())
    assert "text_decoder.cls.predictions.decoder.weight" in ck["model"]  # as export_med writes
    again = load_caption_state_dict(ck["model"], TCFG, device="cpu").state_dict()
    for k in sd:
        assert torch.equal(again[k], sd[k]), k


def test_caption_step_refuses_without_gpu(setup, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = _model(setup)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_caption_train_step(model, make_adamw(model.parameters(), 1e-5, 0.0))
