"""The port's training recipe (dropout and drop-path, ``use_dropout``) against
the JAX package on the CPU, given the same keep masks: tiny NLVR and caption
models (ViT 64 px, patch 16, width 64, 2 layers, drop-path rate 0.5; MED
width 64, 2 layers, dropout 0.1), the NLVR and caption train steps' losses and
whole-model gradients in mask and gather mode, fp32 and amp.

The masks are the port's own draws through ``ops.layers.keep_mask``, recorded
and handed to the JAX loss in its order of ``jax.random.bernoulli`` calls
(each call's shape checked, every mask used once).  The JAX loss is jitted,
in mask mode with ``jax.lax.scan`` unrolled into a Python loop, what the scan
does under ``jax.disable_jit``: a scan traces its body once, so the layers'
masks need one call each; and under amp the drop-path's fp32 division
promotes the ViT's residual stream to fp32 in the first block, which a
jitted scan refuses as a changed carry dtype (``TypeError``), so the
unrolled loop is the only way the JAX package runs that step.

Tolerances: fp32 losses 1e-4 and gradients atol 2e-4 + rtol 1e-3 (the JAX
package's kernel-test tolerance, tests/test_pallas.py:94).  Under amp the two
packages round bf16 products at different points, and their amp steps differ
without dropout already (the FDT loss by ~3e-4; the caption loss by ~2e-4; a
ReLU unit of the NLVR head sits within bf16 noise of 0 and flips, zeroing
one bias gradient entry in one package): amp holds the dtype of the ViT's
output in both packages exactly (fp32 in mask mode, where the drop-path
promotes it), the masks' count, order and shapes, the losses to 1e-3 and
the whole-model gradient to a cosine of 0.99 with JAX's.  Gather mode is
held in fp32 (the NLVR step: only the text embeddings drop out); the
caption's gather mode draws no mask at all (the gather ViT takes no rng, the
decoder none).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _nlvr_setup
from madtp_tpu.cli.common import init_blip_params
from madtp_tpu.core.config import MedConfig as JMedConfig
from madtp_tpu.core.config import ViTConfig as JViTConfig
from madtp_tpu.models import blip as JB
from madtp_tpu.models.blip import BlipConfig as JBlipConfig
from madtp_tpu.models.blip import blip_caption_forward, blip_nlvr_forward
from madtp_tpu.train.loops import _amp_cast
from madtp_tpu_torch.ckpt.convert import caption_from_jax_params, nlvr_from_jax_params
from madtp_tpu_torch.core.config import BlipConfig, MedConfig, ViTConfig
from madtp_tpu_torch.ops import layers as TL
from madtp_tpu_torch.train.loops import make_caption_train_step, make_nlvr_train_step
from madtp_tpu_torch.train.optim import make_adamw

NLVR_T = 20.0  # prunes in both towers
CAPTION_T = 2.0
CAP_VIT = dict(image_size=64, patch_size=16, embed_dim=64, depth=2, num_heads=4, sd_dim=64,
               drop_path_rate=0.5)
CAP_MED = dict(vocab_size=40, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
               intermediate_size=128, max_position_embeddings=40, encoder_width=64, sd_dim=64)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _zero_rates(cfg):
    """``cfg`` with every dropout and drop-path rate 0."""
    vit = dataclasses.replace(cfg.vit, drop_path_rate=0.0)
    med = dataclasses.replace(cfg.med, hidden_dropout_prob=0.0,
                              attention_probs_dropout_prob=0.0)
    return cfg._replace(vit=vit, med=med)


@pytest.fixture(scope="module")
def nlvr():
    jcfg, params, images, ids, mask, targets = _nlvr_setup(
        image_size=64, B=2, text_len=10,
        vit_kw=dict(embed_dim=64, depth=2, num_heads=4, drop_path_rate=0.5),
        med_kw=dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                    intermediate_size=128, merge_start_layer=1, vocab_size=100,
                    max_position_embeddings=32))
    mask = np.asarray(mask).copy()
    mask[1, 8:] = 0  # a padded caption
    tcfg = BlipConfig(ViTConfig(**dataclasses.asdict(jcfg.vit)),
                      MedConfig(**dataclasses.asdict(jcfg.med)), jcfg.sd_num, jcfg.sd_dim)
    tree = jax.tree.map(np.asarray, params)
    inputs = (np.asarray(images), np.asarray(ids), mask, np.asarray(targets))
    with torch.no_grad():
        out = nlvr_from_jax_params(tree, tcfg, device="cpu")(
            *map(_t, inputs[:3]), temperature=NLVR_T, prune_active=True)
    caps = {"mask": (None, None),
            "gather": (tuple(int(k) + 2 for k in out.v_kept),
                       tuple(int(k) + 2 for k in out.t_kept))}
    return dict(family="nlvr", jcfg=jcfg, tcfg=tcfg, params=params, tree=tree,
                inputs=inputs, caps=caps, T=NLVR_T)


@pytest.fixture(scope="module")
def caption():
    jcfg = JBlipConfig(JViTConfig(**CAP_VIT), JMedConfig(**CAP_MED), sd_num=8, sd_dim=64)
    tcfg = BlipConfig(ViTConfig(**CAP_VIT), MedConfig(**CAP_MED), sd_num=8, sd_dim=64)
    params = init_blip_params(jcfg, 0, heads=(), with_encoder=False, with_decoder=True)
    tree = jax.tree.map(np.asarray, params)
    rng = np.random.RandomState(5)
    images = rng.randn(2, 3, 64, 64).astype(np.float32)
    ids = rng.randint(5, 40, size=(2, 9))
    ids[:, 0] = 1
    mask = np.ones_like(ids)
    mask[1, 6:] = 0
    labels = np.where(mask == 0, -100, ids)
    labels[:, :3] = -100
    with torch.no_grad():
        _, _, kept = caption_from_jax_params(tree, tcfg, device="cpu").encode_image(
            _t(images), temperature=CAPTION_T, prune_active=True)
    caps = {"mask": (None,), "gather": (tuple(int(k) + 2 for k in kept),)}
    return dict(family="caption", jcfg=jcfg, tcfg=tcfg, params=params, tree=tree,
                inputs=(images, ids, mask, labels), caps=caps, T=CAPTION_T)


def _port_step(setup, mode, *, amp, use_dropout=True, zero=False):
    """The port's step ``loss_fn`` and model for one case."""
    cfg = _zero_rates(setup["tcfg"]) if zero else setup["tcfg"]
    caps = setup["caps"][mode]
    if setup["family"] == "nlvr":
        model = nlvr_from_jax_params(setup["tree"], cfg, device="cpu")
        make, kw = make_nlvr_train_step, dict(capacities_v=caps[0], capacities_t=caps[1])
    else:
        model = caption_from_jax_params(setup["tree"], cfg, device="cpu")
        make, kw = make_caption_train_step, dict(capacities_v=caps[0])
    opt = make_adamw(model.parameters(), lr=0.0, weight_decay=0.0)
    step = make(model, opt, use_dropout=use_dropout, amp=amp, device="cpu", **kw)
    return model, step


def _port_run(setup, mode, *, amp, seed=1, **kw):
    """Losses and gradients of one forward and backward of the port's step,
    and the keep masks it drew."""
    model, step = _port_step(setup, mode, amp=amp, **kw)
    masks, real = [], TL.keep_mask
    dtypes = []
    hook = model.visual_encoder.register_forward_hook(
        lambda mod, args, out: dtypes.append(out.state.x.dtype))

    def recorder(shape, p, generator, device):
        m = real(shape, p, generator, device)
        masks.append(m.numpy().copy())
        return m

    TL.keep_mask = recorder
    try:
        out = step.loss_fn(*map(_t, setup["inputs"]), setup["T"],
                           generator=torch.Generator().manual_seed(seed))
        out[0].backward()
    finally:
        TL.keep_mask = real
        hook.remove()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    _port_run.vit_dtype = dtypes[0]
    return [float(v.detach()) for v in out], grads, masks


def _unrolled_scan(f, init, xs, **_):
    """``jax.lax.scan`` as a Python loop (what it runs under ``disable_jit``)."""
    n = jax.tree_util.tree_leaves(xs)[0].shape[0]
    carry, ys = init, []
    for i in range(n):
        carry, y = f(carry, jax.tree.map(lambda a: a[i], xs))
        ys.append(y)
    return carry, jax.tree.map(lambda *a: jnp.stack(a), *ys)


def _jax_run(setup, mode, masks, *, amp, zero=False):
    """The JAX loss (``madtp_tpu/train/loops.py:74-87`` / ``:115-126``) and its
    gradients, its ``jax.random.bernoulli`` calls answered with ``masks`` in
    order.  Returns the losses, the gradients in the port's layout, and the
    dtype of the ViT's final states."""
    cfg = _zero_rates(setup["jcfg"]) if zero else setup["jcfg"]
    images, ids, mask, last = map(jnp.asarray, setup["inputs"])
    caps = setup["caps"][mode]
    seen = {}

    def loss(p):
        p, x = _amp_cast(amp, p, images)
        rng = jax.random.PRNGKey(0)
        if setup["family"] == "nlvr":
            lo, lf, _ = blip_nlvr_forward(p, x, ids, mask, cfg, temperature=setup["T"],
                                          prune_active=True, train=True, targets=last,
                                          dropout_rng=rng, capacities_v=caps[0],
                                          capacities_t=caps[1])
        else:
            lo, _, _ = blip_caption_forward(p, x, ids, mask, cfg, temperature=setup["T"],
                                            prune_active=True, labels=last, dropout_rng=rng,
                                            capacities=caps[0])
            lf = lo
        return lo + 0.1 * lf, (lo, lf)

    def vit(*args, **kw):
        out = vit_forward(*args, **kw)
        seen["dtype"] = out[0].x.dtype
        return out

    queue = list(masks)

    def bernoulli(key, p=0.5, shape=None):
        m = queue.pop(0)
        assert tuple(shape) == m.shape, (shape, m.shape)
        return jnp.asarray(m)

    vit_forward = JB.vit_forward
    real = jax.random.bernoulli, jax.lax.scan
    scan = _unrolled_scan if mode == "mask" else jax.lax.scan
    jax.random.bernoulli, jax.lax.scan, JB.vit_forward = bernoulli, scan, vit
    try:
        (total, (lo, lf)), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(setup["params"])
    finally:
        (jax.random.bernoulli, jax.lax.scan), JB.vit_forward = real, vit_forward
    tree = jax.tree.map(np.asarray, g)
    tcfg = _zero_rates(setup["tcfg"]) if zero else setup["tcfg"]
    back = (nlvr_from_jax_params if setup["family"] == "nlvr" else caption_from_jax_params)
    return [float(total), float(lo), float(lf)], back(tree, tcfg, device="cpu").state_dict(), \
        seen["dtype"], queue


# gather mode in fp32 only: under amp it is the amp step without dropout bar the text
# embeddings (test_zero_rates_amp_keeps_the_promotion); the caption's gather mode draws
# no mask at all
CASES = [("nlvr", "mask", False, False), ("nlvr", "gather", False, False),
         ("nlvr", "mask", True, False), ("caption", "mask", False, False),
         ("caption", "mask", True, False), ("nlvr", "mask", True, True)]


@pytest.mark.parametrize("family,mode,amp,zero", CASES,
                         ids=[f"{f}-{m}-{'amp' if a else 'fp32'}{'-rate0' if z else ''}"
                              for f, m, a, z in CASES])
def test_dropout_step_matches_jax(request, family, mode, amp, zero):
    """The step's losses and gradients against the JAX loss on the same
    masks: the ViT's drop-path at every rate (0 included) in mask mode, the
    MED's embedding, probability, output and FFN dropout (NLVR), the text
    embeddings alone in gather mode, none in the caption decoder; under amp
    the mask-mode ViT's residual stream fp32 in both packages."""
    setup = request.getfixturevalue(family)
    losses, grads, masks = _port_run(setup, mode, amp=amp, zero=zero)
    want, jgrads, vit_dtype, left = _jax_run(setup, mode, masks, amp=amp, zero=zero)
    assert not left  # JAX drew as many masks as the port
    n_vit = 2 * setup["tcfg"].vit.depth if mode == "mask" else 0
    n_med = 1 + 3 * setup["tcfg"].med.num_hidden_layers if family == "nlvr" else 0
    if family == "nlvr" and mode == "gather":
        n_med = 1
    if zero:
        n_med = 0  # dropout at rate 0 draws nothing; drop-path draws at every rate
    assert len(masks) == n_vit + n_med
    want_dtype = torch.float32 if not amp or mode == "mask" else torch.bfloat16
    assert _port_run.vit_dtype == want_dtype
    assert vit_dtype == {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[want_dtype]
    if not amp:
        np.testing.assert_allclose(losses, want, atol=1e-4)
        for name, g in grads.items():
            np.testing.assert_allclose(g.numpy(), jgrads[name].numpy(), atol=2e-4, rtol=1e-3,
                                       err_msg=name)
        return
    np.testing.assert_allclose(losses, want, atol=1e-3)
    a = torch.cat([g.double().flatten() for g in grads.values()])
    b = torch.cat([jgrads[n].double().flatten() for n in grads])
    assert float(a @ b) / float(a.norm() * b.norm()) >= 0.99


@pytest.mark.parametrize("family", ["nlvr", "caption"])
@pytest.mark.parametrize("mode", ["mask", "gather"])
def test_zero_rates_fp32_step_is_the_plain_step(request, family, mode):
    """In fp32, ``use_dropout`` with every rate 0 gives the step without
    dropout bit for bit (losses and every gradient)."""
    setup = request.getfixturevalue(family)
    losses0, grads0, _ = _port_run(setup, mode, amp=False, use_dropout=False)
    losses, grads, masks = _port_run(setup, mode, amp=False, zero=True)
    assert losses == losses0
    for name in grads0:
        assert torch.equal(grads[name], grads0[name]), name


@pytest.mark.parametrize("mode,equal", [("mask", False), ("gather", True)])
def test_zero_rates_amp_keeps_the_promotion(nlvr, mode, equal):
    """Under amp at rate 0 the mask-mode ViT still draws its drop-path and
    computes in fp32 from the first block on, as the JAX package does, so
    the step differs from the amp step without dropout; the gather path
    takes no drop-path and stays bit-equal."""
    losses0, _, _ = _port_run(nlvr, mode, amp=True, use_dropout=False)
    losses, _, masks = _port_run(nlvr, mode, amp=True, zero=True)
    assert (losses == losses0) == equal
    assert len(masks) == (2 * nlvr["tcfg"].vit.depth if mode == "mask" else 0)


def test_generator_sets_the_masks(nlvr):
    """The same seed twice draws the same masks and gives bit-equal losses
    and gradients; another seed draws other masks.  Kept shares are near
    ``1 - p``."""
    a_losses, a_grads, a_masks = _port_run(nlvr, "mask", amp=False, seed=7)
    b_losses, b_grads, b_masks = _port_run(nlvr, "mask", amp=False, seed=7)
    c_losses, _, c_masks = _port_run(nlvr, "mask", amp=False, seed=8)
    assert a_losses == b_losses
    assert all(torch.equal(a_grads[n], b_grads[n]) for n in a_grads)
    assert all(np.array_equal(x, y) for x, y in zip(a_masks, b_masks))
    assert any(not np.array_equal(x, y) for x, y in zip(a_masks, c_masks))
    assert a_losses != c_losses
    big = [m for m in a_masks if m.size > 1000]  # the MED's dropout at 0.1
    share = np.concatenate([m.ravel() for m in big]).mean()
    n = sum(m.size for m in big)
    assert abs(share - 0.9) < 6 * np.sqrt(0.9 * 0.1 / n)


def test_keys_fold_into_distinct_streams():
    """A step's key, its halves and its layers' keys are distinct, 63-bit,
    and the same every time."""
    key = TL.draw_key(torch.Generator().manual_seed(3))
    assert key == TL.draw_key(torch.Generator().manual_seed(3))
    kids = [TL.fold_in(key, i) for i in range(64)] + [TL.fold_in(TL.fold_in(key, 0), i)
                                                      for i in range(64)]
    assert len(set(kids)) == len(kids) and all(0 <= k < 2 ** 63 for k in kids)
    a = torch.rand(8, generator=TL.stream(kids[5], "cpu"))
    assert torch.equal(a, torch.rand(8, generator=TL.stream(kids[5], "cpu")))


def test_dropout_and_drop_path_values():
    """``dropout`` divides by ``1 - rate`` rounded to the input's dtype and
    zeroes the dropped elements; ``drop_path`` drops whole rows and returns
    fp32 for a bf16 branch, at rate 0 too."""
    x = torch.randn(4, 5, 6, generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    y = TL.dropout(x, 0.25, g)
    kept = y != 0
    torch.testing.assert_close(y[kept], x[kept] / 0.75, rtol=0, atol=0)
    assert TL.dropout(x, 0.0, g) is x and TL.dropout(x, 0.5, None) is x
    xb = x.bfloat16()
    yb = TL.dropout(xb, 0.1, torch.Generator().manual_seed(2))
    scale = float(torch.tensor(0.9, dtype=torch.bfloat16))
    kb = yb != 0
    assert yb.dtype == torch.bfloat16 and torch.equal(yb[kb], (xb / scale)[kb])
    z = TL.drop_path(xb, torch.tensor(0.5), torch.Generator().manual_seed(3))
    assert z.dtype == torch.float32
    rows = (z != 0).flatten(1).any(1)
    assert torch.equal(z[rows], xb.float()[rows] / 0.5)
    assert not (z[~rows] != 0).any()
    z0 = TL.drop_path(xb, torch.tensor(0.0), torch.Generator().manual_seed(3))
    assert z0.dtype == torch.float32 and torch.equal(z0, xb.float())
