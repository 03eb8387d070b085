"""The legacy BLIP heads and the small remaining modules of the port against
the JAX package on the CPU (fp32, tests/test_train.py:244-285's tiny model:
ViT 32 px, patch 8, width 32, 2 layers; MED width 32, 2 layers, vocabulary
60; projections 16 wide), every value held to 1e-5 where that test holds it
finite:

* ``blip_base_features`` in its three modes, ``blip_itm_logits`` (ITM and
  ITC, dense and with DTP), ``blip_pretrain_losses`` with JAX's own Gumbel
  draws for the two hard negatives, the pretrain layout through the weight
  carrier in both directions;
* ``sparsemax``, ``dtp_prune_static``, ``load_flax_vit_npz`` on a synthetic
  npz built as tests/test_ckpt.py:170-210 builds it (with and without a
  position-grid resize), ``tree_param_counts`` and ``print_params_and_flops``
  against JAX's, ``device_memory_stats`` without a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madtp_tpu.ckpt import load_state_dict, remap_med, remap_vit
from madtp_tpu.ckpt.remap import load_flax_vit_npz as j_load_flax_vit_npz
from madtp_tpu.core.config import MedConfig as JMedConfig
from madtp_tpu.core.config import ViTConfig as JViTConfig
from madtp_tpu.models.blip import BlipConfig as JBlipConfig
from madtp_tpu.models.blip import (blip_base_features as j_base_features,
                                   blip_itm_logits as j_itm_logits,
                                   blip_pretrain_losses as j_pretrain_losses,
                                   blip_retrieval_image_features as j_image_features)
from madtp_tpu.models.med import init_med_params
from madtp_tpu.models.vit import init_vit_params, vit_forward
from madtp_tpu.prune.dtp import TokenState as JTokenState
from madtp_tpu.prune.dtp import dtp_prune_static as j_dtp_prune_static
from madtp_tpu.prune.sparsemax import sparsemax as j_sparsemax
from madtp_tpu.train.momentum import init_queue as j_init_queue
from madtp_tpu.utils import profiling as JP
from madtp_tpu_torch.ckpt.convert import (load_flax_vit_npz, load_pretrain_state_dict,
                                          pretrain_from_jax_params, save_pretrain_checkpoint)
from madtp_tpu_torch.core.config import BlipConfig, CLIPConfig, MedConfig, ViTConfig
from madtp_tpu_torch.models.blip import (blip_base_features, blip_itm_logits,
                                         blip_pretrain_losses)
from madtp_tpu_torch.models.vit import VisionTransformer
from madtp_tpu_torch.prune import sparsemax
from madtp_tpu_torch.prune.dtp import TokenState, dtp_prune_static
from madtp_tpu_torch.train.momentum import FeatureQueue
from madtp_tpu_torch.utils import profiling as TP

VIT = dict(image_size=32, patch_size=8, embed_dim=32, depth=2, num_heads=4, sd_dim=32)
MED = dict(vocab_size=60, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
           intermediate_size=64, max_position_embeddings=32, encoder_width=32, sd_dim=32)
JCFG = JBlipConfig(JViTConfig(**VIT), JMedConfig(**MED), sd_num=8, sd_dim=32)
TCFG = BlipConfig(ViTConfig(**VIT), MedConfig(**MED), sd_num=8, sd_dim=32)
ENC = 58
TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


@pytest.fixture(scope="module")
def setup():
    """tests/test_train.py:250-268's tree and batch, the head widths 16."""
    rng = np.random.RandomState(0)
    tree = {
        "visual_encoder": init_vit_params(JCFG.vit, rng),
        "text_encoder": init_med_params(JCFG.med, rng),
        "text_decoder": init_med_params(JCFG.med, rng),
        "space_dict": rng.randn(8, 32).astype(np.float32),
        "vision_proj": {"kernel": rng.randn(32, 16).astype(np.float32) * 0.1,
                        "bias": np.zeros(16, np.float32)},
        "text_proj": {"kernel": rng.randn(32, 16).astype(np.float32) * 0.1,
                      "bias": np.zeros(16, np.float32)},
        "itm_head": {"kernel": rng.randn(32, 2).astype(np.float32) * 0.1,
                     "bias": np.zeros(2, np.float32)},
    }
    tree = jax.tree.map(np.asarray, tree)
    B = 3
    images = rng.randn(B, 3, 32, 32).astype(np.float32)
    ids = rng.randint(1, 60, (B, 8))
    mask = np.ones((B, 8), np.int64)
    mask[2, 6:] = 0
    return dict(tree=tree, params=jax.tree.map(jnp.asarray, tree), images=images, ids=ids,
                mask=mask, model=pretrain_from_jax_params(tree, TCFG, device="cpu"))


@pytest.mark.parametrize("mode", ["image", "text", "multimodal"])
def test_base_features_match_jax(setup, mode):
    kw = dict(images=setup["images"], text_ids=setup["ids"], text_mask=setup["mask"],
              mode=mode)
    enc = ENC if mode == "multimodal" else None
    want = j_base_features(setup["params"], JCFG, enc_token_id=enc,
                           **{k: None if v is None else (v if k == "mode" else jnp.asarray(v))
                              for k, v in kw.items()})
    with torch.no_grad():
        got = blip_base_features(setup["model"], enc_token_id=enc,
                                 **{k: (v if k == "mode" else _t(v)) for k, v in kw.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("head", ["itm", "itc"])
@pytest.mark.parametrize("temperature", [0.0, 3.0])
def test_itm_logits_match_jax(setup, head, temperature):
    """Both heads over the dense image states, the text tower dense and at
    a temperature that prunes it."""
    params, model = setup["params"], setup["model"]
    _, jstate, _ = j_image_features(params, jnp.asarray(setup["images"]), JCFG)
    prune = temperature > 0
    want = j_itm_logits(params, jnp.asarray(setup["ids"]), jnp.asarray(setup["mask"]), jstate,
                        JCFG, head=head, temperature=temperature, prune_active=prune)
    with torch.no_grad():
        _, vout = model.image_features(_t(setup["images"]))
        got = blip_itm_logits(model, _t(setup["ids"]), _t(setup["mask"]), vout.state,
                              head=head, temperature=temperature, prune_active=prune)
    assert got.shape == ((3, 2) if head == "itm" else (3,))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if head == "itc":
        assert (got.abs() <= 1.0 + 1e-5).all()


def _j_pretrain(fn, cache={}):
    """``fn``'s value and gradient, jitted once for the file."""
    if "f" not in cache:
        cache["f"] = jax.jit(jax.value_and_grad(fn, has_aux=True))
    return cache["f"]


@pytest.mark.parametrize("seed", [0, 5])
def test_pretrain_losses_match_jax(setup, seed):
    """ITC against the queue, hard-negative ITM (the two draws fed the Gumbel
    noise of ``split(rng)``'s keys), LM: each loss within 1e-5, and their
    gradients on the fp32 weights within 1e-5 + 1e-4 of each value."""
    params, model = setup["params"], setup["model"]
    rng = np.random.RandomState(seed + 1)
    B = 3
    dec_ids = rng.randint(1, 60, (B, 6))
    dec_mask = np.ones((B, 6), np.int64)
    dec_mask[1, 4:] = 0
    labels = np.where(dec_mask == 0, -100, dec_ids)
    idx = np.array([0, 1, 1]) if seed else np.arange(B)  # two captions of one image
    jq = j_init_queue(16, 6, jax.random.PRNGKey(seed))
    key = jax.random.PRNGKey(seed + 10)

    def jloss(p, dec_ids, dec_mask, labels, idx, queue, key):
        losses = j_pretrain_losses(p, jnp.asarray(setup["images"]), jnp.asarray(setup["ids"]),
                                   jnp.asarray(setup["mask"]), dec_ids, dec_mask, labels, idx,
                                   queue, jnp.float32(0.07), 0.4, key, JCFG, enc_token_id=ENC)
        return sum(losses), losses

    (_, want), jgrads = _j_pretrain(jloss)(params, *map(jnp.asarray, (dec_ids, dec_mask, labels,
                                                                       idx)), jq, key)
    k1, k2 = jax.random.split(key)
    noise = tuple(_t(jax.random.gumbel(k, (B, B), jnp.float32)) for k in (k1, k2))
    queue = FeatureQueue(_t(jq.image), _t(jq.text), _t(jq.idx).long(), _t(jq.ptr).long())
    model.zero_grad(set_to_none=True)
    got = blip_pretrain_losses(model, _t(setup["images"]), _t(setup["ids"]), _t(setup["mask"]),
                               _t(dec_ids), _t(dec_mask), _t(labels), _t(idx), queue,
                               torch.tensor(0.07), enc_token_id=ENC, noise=noise)
    np.testing.assert_allclose([float(v.detach()) for v in got], [float(v) for v in want],
                               **TOL)
    sum(got).backward()
    back = pretrain_from_jax_params(jax.tree.map(np.asarray, jgrads), TCFG,
                                    device="cpu").state_dict()
    for name, p in model.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad  # space_dict: unused unpruned
        np.testing.assert_allclose(g.numpy(), back[name].numpy(), atol=1e-5, rtol=1e-4,
                                   err_msg=name)


def test_pretrain_layout_both_ways(setup, tmp_path):
    """The carrier's pretrain layout: the checkpoint written by
    ``save_pretrain_checkpoint`` read back by ``load_pretrain_state_dict``
    and by the JAX package's ``remap_vit``/``remap_med``, bit for bit."""
    path = str(tmp_path / "pretrain.pth")
    save_pretrain_checkpoint(setup["model"], path, epoch=1, temperature=0.5)
    ck = torch.load(path)
    again = load_pretrain_state_dict(ck["model"], TCFG, device="cpu")
    for (name, a), b in zip(setup["model"].state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), name
    sd, extras = load_state_dict(path)
    tree = dict(setup["tree"], visual_encoder=remap_vit(sd, num_patches=16),
                text_encoder=remap_med(sd, "text_encoder."),
                text_decoder=remap_med(sd, "text_decoder.", has_lm_head=True))
    back = pretrain_from_jax_params(tree, TCFG, device="cpu").state_dict()
    for name, a in setup["model"].state_dict().items():
        assert torch.equal(a, back[name]), name
    assert float(extras["temperature"]) == 0.5


@pytest.mark.parametrize("shape,dim", [((4, 7), -1), ((3, 5, 6), 1), ((2, 1, 9), 2)])
def test_sparsemax_matches_jax(shape, dim):
    x = np.random.RandomState(len(shape) + dim).randn(*shape).astype(np.float32) * 2
    x.reshape(-1)[3] = x.reshape(-1)[4]  # a tie
    got = sparsemax(_t(x), dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(j_sparsemax(jnp.asarray(x), dim)), **TOL)
    np.testing.assert_allclose(got.sum(dim).numpy(), 1.0, atol=1e-5)


@pytest.mark.parametrize("keep_num", [1, 4, 20])
def test_dtp_prune_static_matches_jax(keep_num):
    rng = np.random.RandomState(keep_num)
    B, P, D = 3, 10, 4
    x = rng.randn(B, 1 + P, D).astype(np.float32)
    alive = rng.rand(B, 1 + P) > 0.3
    alive[:, 0] = True
    cls_attn = rng.rand(B, P).astype(np.float32)
    cls_attn[0, 2] = cls_attn[0, 5]  # a tie: the lower index ranks first
    alive[0, 3] = alive[0, 6] = True
    jst, jkept = j_dtp_prune_static(JTokenState(jnp.asarray(x), jnp.asarray(alive), None),
                                    jnp.asarray(cls_attn), keep_num)
    st, kept = dtp_prune_static(TokenState(_t(x), _t(alive), None), _t(cls_attn), keep_num)
    np.testing.assert_array_equal(st.alive.numpy(), np.asarray(jst.alive))
    assert torch.equal(st.x, _t(x)) and int(kept) == int(jkept)


def _flax_npz(path, D=32, depth=2, heads=4, p=8, grid=4, prefix=""):
    """tests/test_ckpt.py:177-202's synthetic Flax ViT, keys under ``prefix``."""
    rng = np.random.RandomState(8)
    npz = {
        "embedding/kernel": rng.randn(p, p, 3, D).astype(np.float32) * 0.05,
        "embedding/bias": rng.randn(D).astype(np.float32) * 0.01,
        "cls": rng.randn(1, 1, D).astype(np.float32) * 0.02,
        "Transformer/posembed_input/pos_embedding":
            rng.randn(1, grid * grid + 1, D).astype(np.float32) * 0.02,
        "Transformer/encoder_norm/scale": 1.0 + 0.1 * rng.randn(D).astype(np.float32),
        "Transformer/encoder_norm/bias": 0.1 * rng.randn(D).astype(np.float32),
    }
    Dh = D // heads
    for i in range(depth):
        b = f"Transformer/encoderblock_{i}/"
        mha = b + "MultiHeadDotProductAttention_1/"
        for n in ("query", "key", "value"):
            npz[mha + f"{n}/kernel"] = rng.randn(D, heads, Dh).astype(np.float32) * 0.05
            npz[mha + f"{n}/bias"] = rng.randn(heads, Dh).astype(np.float32) * 0.01
        npz[mha + "out/kernel"] = rng.randn(heads, Dh, D).astype(np.float32) * 0.05
        npz[mha + "out/bias"] = rng.randn(D).astype(np.float32) * 0.01
        for ln in ("LayerNorm_0", "LayerNorm_2"):
            npz[b + ln + "/scale"] = 1.0 + 0.1 * rng.randn(D).astype(np.float32)
            npz[b + ln + "/bias"] = 0.1 * rng.randn(D).astype(np.float32)
        npz[b + "MlpBlock_3/Dense_0/kernel"] = rng.randn(D, 4 * D).astype(np.float32) * 0.05
        npz[b + "MlpBlock_3/Dense_0/bias"] = rng.randn(4 * D).astype(np.float32) * 0.01
        npz[b + "MlpBlock_3/Dense_1/kernel"] = rng.randn(4 * D, D).astype(np.float32) * 0.05
        npz[b + "MlpBlock_3/Dense_1/bias"] = rng.randn(D).astype(np.float32) * 0.01
    np.savez(path, **{prefix + k: v for k, v in npz.items()})


@pytest.mark.parametrize("image_size,prefix", [(32, ""), (48, "opt/target/")])
def test_load_flax_vit_npz_matches_jax(tmp_path, image_size, prefix):
    """The npz into the port's ViT and into the JAX tree: the same forward
    within 1e-5, at the checkpoint's grid (4 x 4) and resized to 6 x 6.  The
    JAX loader counts the blocks of an ``opt/target/`` file as one (it splits
    the key before stripping the prefix), so a prefixed file is held against
    the JAX tree of the same arrays without the prefix."""
    path, plain = str(tmp_path / "vit.npz"), str(tmp_path / "plain.npz")
    _flax_npz(path, prefix=prefix)
    _flax_npz(plain)
    cfg = dict(image_size=image_size, patch_size=8, embed_dim=32, depth=2, num_heads=4)
    n = (image_size // 8) ** 2
    tree = j_load_flax_vit_npz(plain, num_patches=n)
    vit = VisionTransformer(ViTConfig(**cfg))
    vit.load_state_dict(load_flax_vit_npz(path, num_patches=n), strict=True)
    x = np.random.RandomState(1).randn(2, 3, image_size, image_size).astype(np.float32)
    want, _, _ = vit_forward(jax.tree.map(jnp.asarray, tree), jnp.asarray(x),
                             cfg=JViTConfig(**cfg))
    with torch.no_grad():
        got = vit.eval()(_t(x)).state.x
    np.testing.assert_allclose(got.numpy(), np.asarray(want.x), **TOL)


def test_param_counts_and_report_match_jax(setup, tmp_path):
    """``tree_param_counts`` on the pretrain model equals the JAX package's on
    the tree of the same weights as the JAX package reads them from the
    model's checkpoint (its ``init_med_params`` adds a pooler and an LM head
    to every MED, which neither the reference's encoder nor the port's
    has); the report prints the same line for every task."""
    path = str(tmp_path / "pretrain.pth")
    save_pretrain_checkpoint(setup["model"], path, epoch=0, temperature=0.0)
    sd, _ = load_state_dict(path)
    tree = dict(setup["tree"], visual_encoder=remap_vit(sd, num_patches=16),
                text_encoder=remap_med(sd, "text_encoder."),
                text_decoder=remap_med(sd, "text_decoder.", has_lm_head=True))
    assert TP.tree_param_counts(setup["model"]) == JP.tree_param_counts(tree)
    cfgs = {t: (JCFG, TCFG) for t in ("nlvr", "caption", "vqa", "retrieval")}
    clip = dict(embed_dim=32, image_resolution=32, vision_layers=2, vision_width=64,
                vision_patch_size=8, context_length=16, vocab_size=100,
                transformer_width=32, transformer_heads=2, transformer_layers=2)
    from madtp_tpu.core.config import CLIPConfig as JCLIPConfig

    cfgs["retrieval_clip"] = (JCLIPConfig(**clip), CLIPConfig(**clip))
    for task, (jc, tc) in cfgs.items():
        lines, jlines = [], []
        g = TP.print_params_and_flops(task, tc, print_fn=lines.append)
        jg = JP.print_params_and_flops(task, jc, print_fn=jlines.append)
        assert lines == jlines and g == pytest.approx(jg, rel=1e-12), task
    with pytest.raises(ValueError):
        TP.print_params_and_flops("nope", TCFG)


def test_device_memory_stats_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TP.device_memory_stats()
