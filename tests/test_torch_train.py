"""The port's NLVR compression training against the JAX package on the CPU:
K2's plain version against ``jax.grad`` and the TPU backward kernel in
interpret mode, the train-mode model's losses and gradients, remat, the
optimizer, schedules and controller, the train step and epoch, and the
checkpoint.  Tiny configs (those of tests/test_torch_models.py), fp32,
inputs from numpy seeds.

Tolerances: the scoring-attention backward atol 2e-4, rtol 1e-3 (the JAX
package's own, tests/test_pallas.py:90-96); losses 1e-5 and logits 1e-4;
whole-model gradients atol 1e-5 + rtol 1e-3 (fp32 through 6 layers and the
DTP merge weights, summed in another order); parameters after AdamW steps
atol 1e-6 + rtol 1e-4 (Adam divides the gradient by its own running norm, so
gradient noise moves an update by its relative size times the learning rate).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from __graft_entry__ import _nlvr_setup
from madtp_tpu.models.blip import blip_nlvr_forward, load_blip_nlvr
from madtp_tpu.ops.attention import _xla_attention_scores
from madtp_tpu.ops.pallas.fused_attention import fused_attention_scores_bwd
from madtp_tpu.tasks.nlvr import train_epoch as j_train_epoch
from madtp_tpu.train import controller as JC
from madtp_tpu.train import optim as JO
from madtp_tpu.train.loops import make_nlvr_train_step as j_make_step
from madtp_tpu_torch.ckpt.convert import (load_nlvr_state_dict, nlvr_from_jax_params,
                                          save_nlvr_checkpoint)
from madtp_tpu_torch.core.config import BlipConfig, MedConfig, ViTConfig
from madtp_tpu_torch.models.blip import NLVRModel
from madtp_tpu_torch.ops.attention import attention_scores_bwd_plain
from madtp_tpu_torch.tasks.nlvr import (cached_probe_batches, probe_capacities,
                                        train_epoch)
from madtp_tpu_torch.train import controller as TC
from madtp_tpu_torch.train import optim as TO
from madtp_tpu_torch.train.loops import make_nlvr_train_step

TEMPERATURE = 20.0  # prunes in both towers: kept vision 21, 13, 11 of 36; text 9 of 11
PAD_BIAS = -10000.0
ENC = 2  # encoder token id written into slot 0 of every caption


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
    ids = np.asarray(ids).copy()
    ids[:, 0] = ENC
    tcfg = BlipConfig(ViTConfig(**dataclasses.asdict(jcfg.vit)),
                      MedConfig(**dataclasses.asdict(jcfg.med)), jcfg.sd_num, jcfg.sd_dim)
    tree = jax.tree.map(np.asarray, params)
    data = dict(images=np.asarray(images), ids=ids, mask=mask,
                targets=np.array([0, 1]))
    # lossless gather capacities (kept + 2) from a mask-mode forward
    with torch.no_grad():
        out = nlvr_from_jax_params(tree, tcfg, device="cpu")(
            _t(data["images"]), _t(ids), _t(mask), temperature=TEMPERATURE,
            prune_active=True)
    caps = {"mask": (None, None),
            "gather": (tuple(int(k) + 2 for k in out.v_kept),
                       tuple(int(k) + 2 for k in out.t_kept))}
    return dict(jcfg=jcfg, tcfg=tcfg, params=params, tree=tree, caps=caps, **data)


def _model(setup, **vit_kw):
    cfg = setup["tcfg"]
    if vit_kw:
        cfg = cfg._replace(vit=dataclasses.replace(cfg.vit, **vit_kw))
    return nlvr_from_jax_params(setup["tree"], cfg, device="cpu")


def _inputs(setup):
    return tuple(_t(setup[k]) for k in ("images", "ids", "mask", "targets"))


def _port_loss_and_grads(model, setup, caps):
    images, ids, mask, targets = _inputs(setup)
    model.zero_grad(set_to_none=True)
    lo, lf, logits = model(images, ids, mask, temperature=TEMPERATURE, prune_active=True,
                           capacities_v=caps[0], capacities_t=caps[1], targets=targets)[:3]
    (lo + 0.1 * lf).backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return (float(lo.detach()), float(lf.detach()), logits.detach().numpy()), grads


# --- the scoring-attention backward (K2's plain version) ---------------------


@pytest.mark.parametrize("with_bias", [False, True])
def test_attention_scores_bwd_plain_matches_jax(with_bias):
    """Against jax.grad through _xla_attention_scores and against the TPU
    backward kernel in interpret mode, with dead keys (a dead tail on one
    row) and random cotangents on out, cls_attn and col_mass."""
    B, H, N, Dh = 2, 4, 128, 16
    rng = np.random.RandomState(0)
    q, k, v = (rng.randn(B, H, N, Dh).astype(np.float32) for _ in range(3))
    alive = np.ones((B, N), bool)
    alive[0, 90:] = False
    alive[1] = rng.rand(N) > 0.3
    alive[:, 0] = True
    bias = ((rng.rand(B, N) < 0.2).astype(np.float32) * PAD_BIAS if with_bias
            else np.zeros((B, N), np.float32))
    w_out = rng.randn(B, N, H * Dh).astype(np.float32)
    w_cls, w_col = (rng.randn(B, N - 1).astype(np.float32) for _ in range(2))
    scale = Dh ** -0.5

    def loss(q_, k_, v_, b_):
        out, cls, col = _xla_attention_scores(q_, k_, v_, jnp.asarray(alive), b_, scale)
        return jnp.sum(out * w_out) + jnp.sum(cls * w_cls) + jnp.sum(col * w_col)

    ref = jax.grad(loss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (q, k, v, bias)))
    z = jnp.zeros((B, 1), jnp.float32)
    kern = fused_attention_scores_bwd(
        *(jnp.asarray(x.transpose(0, 1, 3, 2)) for x in (q, k, v)), jnp.asarray(alive),
        jnp.asarray(bias), jnp.asarray(w_out.reshape(B, N, H, Dh).transpose(0, 2, 3, 1)),
        jnp.concatenate([z, jnp.asarray(w_col)], 1), jnp.concatenate([z, jnp.asarray(w_cls)], 1),
        num_heads=H, scale=scale, interpret=True)
    kern = [np.asarray(x).transpose(0, 1, 3, 2) for x in kern[:3]] + [np.asarray(kern[3])]

    got = attention_scores_bwd_plain(
        *(_t(x.transpose(0, 2, 1, 3)) for x in (q, k, v)), _t(alive),
        _t(bias) if with_bias else None, scale, _t(w_out), _t(w_cls), _t(w_col))
    for name, g, r, kr in zip(("dq", "dk", "dv", "dbias"), got, ref, kern):
        g = g.numpy() if name == "dbias" else g.numpy().transpose(0, 2, 1, 3)
        np.testing.assert_allclose(g, np.asarray(r), atol=2e-4, rtol=1e-3, err_msg=name)
        np.testing.assert_allclose(g, kr, atol=2e-4, rtol=1e-3, err_msg=name + " kernel")


# --- the train-mode model ---------------------------------------------------


@pytest.fixture(scope="module")
def jax_train(setup):
    """JAX losses, logits and gradients per mode."""
    jcfg, params = setup["jcfg"], setup["params"]
    images, ids, mask, targets = (jnp.asarray(setup[k])
                                  for k in ("images", "ids", "mask", "targets"))
    out = {}
    for mode, (cv, ct) in setup["caps"].items():
        def loss(p):
            lo, lf, logits = blip_nlvr_forward(
                p, images, ids, mask, jcfg, temperature=TEMPERATURE, prune_active=True,
                train=True, targets=targets, capacities_v=cv, capacities_t=ct)
            return lo + 0.1 * lf, (lo, lf, logits)

        (_, (lo, lf, logits)), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
        out[mode] = ((float(lo), float(lf), np.asarray(logits)),
                     jax.tree.map(np.asarray, g))
    return out


@pytest.fixture(scope="module")
def port_train(setup):
    model = _model(setup)
    return {mode: _port_loss_and_grads(model, setup, caps)
            for mode, caps in setup["caps"].items()}


@pytest.mark.parametrize("mode", ["mask", "gather"])
def test_train_forward_matches_jax(setup, jax_train, port_train, mode):
    (jlo, jlf, jlog), _ = jax_train[mode]
    (lo, lf, logits), _ = port_train[mode]
    assert lo == pytest.approx(jlo, abs=1e-5)
    assert lf == pytest.approx(jlf, abs=1e-5)
    assert lf != lo  # the FDT loss is the alignment loss, not the task loss again
    np.testing.assert_allclose(logits, jlog, atol=1e-4)


@pytest.mark.parametrize("mode", ["mask", "gather"])
def test_train_grads_match_jax(setup, jax_train, port_train, mode):
    """Whole-model gradients, the JAX tree mapped to the port's names and
    layouts by nlvr_from_jax_params (the same transposes as the weights)."""
    _, jgrads = jax_train[mode]
    _, grads = port_train[mode]
    want = nlvr_from_jax_params(jgrads, setup["tcfg"], device="cpu").state_dict()
    assert want.keys() == grads.keys()
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=1e-5, rtol=1e-3,
                                   err_msg=name)


def test_space_dict_receives_gradients(setup):
    """Port of tests/test_train.py::test_space_dict_receives_gradients: the
    codebook learns through the FDT loss and, with the task loss alone,
    through the DTP merge weights (K1's col_mass and cls_attn)."""
    model = _model(setup)
    images, ids, mask, targets = _inputs(setup)
    lo, lf = model(images, ids, mask, temperature=TEMPERATURE, prune_active=True,
                   targets=targets)[:2]
    g_all = torch.autograd.grad(lo + 0.1 * lf, model.space_dict, retain_graph=True)[0]
    g_ori = torch.autograd.grad(lo, model.space_dict)[0]
    assert float(g_all.abs().sum()) > 0.0
    assert float(g_ori.abs().sum()) > 0.0


def test_gather_mode_training_grads_match_mask_mode(setup, port_train):
    """Port of tests/test_train.py::test_gather_mode_training_grads_match_mask_mode:
    at lossless capacities gather mode re-indexes the mask-mode buffer, so
    the loss and the gradients agree."""
    (lo_m, _, _), g_mask = port_train["mask"]
    (lo_g, _, _), g_gat = port_train["gather"]
    assert abs(lo_m - lo_g) < 1e-5
    for name in g_mask:
        np.testing.assert_allclose(g_gat[name].numpy(), g_mask[name].numpy(),
                                   rtol=2e-4, atol=2e-5, err_msg=name)


def test_remat_matches_no_remat(setup, port_train):
    """Recomputing the last two ViT blocks in the backward pass gives the
    same losses and gradients."""
    (lo, lf, _), grads = port_train["mask"]
    model = _model(setup, grad_checkpoint=True, ckpt_layers=2)
    assert model.visual_encoder.remat_layers() == 2
    (lo_r, lf_r, _), grads_r = _port_loss_and_grads(model, setup, (None, None))
    assert (lo_r, lf_r) == (lo, lf)
    for name in grads:
        torch.testing.assert_close(grads_r[name], grads[name], rtol=1e-6, atol=1e-8,
                                   msg=lambda m: f"{name}: {m}")


# --- schedules, controller, optimizer ----------------------------------------


@pytest.mark.parametrize("cur,target", [(100, 60), (75, 60), (67, 60), (62, 60),
                                        (60.5, 60), (20, 60), (45, 60), (54, 60),
                                        (58.5, 60), (59.5, 60)])
def test_temperature_step_matches_jax(cur, target):
    assert TC.temperature_step(cur, target) == JC.temperature_step(cur, target)


def test_controller_and_presearch_match_jax():
    t, j = TC.TemperatureController(60.0), JC.TemperatureController(60.0)
    for g in (100.0, 80.0, 58.0, 61.0):
        assert t.update(g) == j.update(g)
    measure = lambda t: 100.0 / (1.0 + t)  # noqa: E731
    assert TC.presearch_temperature(measure, 50.0, tol=0.5) == \
        JC.presearch_temperature(measure, 50.0, tol=0.5)


@pytest.mark.parametrize("epoch", [0, 1, 3, 7])
def test_schedules_match_jax(epoch):
    assert TO.cosine_lr(epoch, 8, 3e-5, 1e-6) == JO.cosine_lr(epoch, 8, 3e-5, 1e-6)
    assert TO.warmup_lr(epoch, 5, 3e-5, 1e-6) == JO.warmup_lr(epoch, 5, 3e-5, 1e-6)
    assert TO.step_lr(epoch, 3e-5, 1e-6, 0.5) == JO.step_lr(epoch, 3e-5, 1e-6, 0.5)


def test_adamw_matches_optax():
    """Two AdamW steps on the same gradients, weight decay on every
    parameter, the learning rate changed between them through param_groups
    (optax: inject_hyperparams)."""
    rng = np.random.RandomState(4)
    p0 = {"w": rng.randn(5, 3).astype(np.float32), "b": rng.randn(3).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) for k, v in p0.items()}
             for _ in range(2)]
    tp = {k: torch.nn.Parameter(_t(v)) for k, v in p0.items()}
    opt = TO.make_adamw(tp.values(), lr=1e-2, weight_decay=0.05)
    tx = JO.make_adamw_injectable(0.05)
    jp = jax.tree.map(jnp.asarray, p0)
    state = tx.init(jp)
    for lr, g in zip((1e-2, 5e-3), grads):
        TO.set_lr(opt, lr)
        for k, p in tp.items():
            p.grad = _t(g[k])
        opt.step()
        state.hyperparams["learning_rate"] = jnp.float32(lr)
        upd, state = tx.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, upd)
    for k in p0:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   atol=1e-6, rtol=1e-6)


# --- the train step and epoch ------------------------------------------------


def _loader(setup, n):
    B = setup["ids"].shape[0]

    def loader():
        for shift in range(n):
            im = np.roll(setup["images"], shift, axis=0)
            yield im[:B], im[B:], ["s"] * B, np.roll(setup["targets"], shift)
    return loader


def test_train_step_and_epoch_match_jax(setup):
    """Two steps of make_nlvr_train_step, then a two-batch train_epoch,
    against the JAX step with make_adamw_injectable on the same batches."""
    lr, wd = 1e-4, 0.05
    jcfg = setup["jcfg"]
    tx = JO.make_adamw_injectable(wd)
    jstep = j_make_step(jcfg, tx)
    jparams = jax.tree.map(jnp.asarray, setup["tree"])
    jstate = tx.init(jparams)
    jstate.hyperparams["learning_rate"] = jnp.float32(lr)
    model = _model(setup)
    opt = TO.make_adamw(model.parameters(), lr=lr, weight_decay=wd)
    step = make_nlvr_train_step(model, opt, device="cpu")
    tokenize = lambda s: (setup["ids"].copy(), setup["mask"].copy())  # noqa: E731

    for image0, image1, _, targets in _loader(setup, 2)():
        images = np.concatenate([image0, image1])
        jparams, jstate, jm = jstep(jparams, jstate, jnp.asarray(images),
                                    jnp.asarray(setup["ids"]), jnp.asarray(setup["mask"]),
                                    jnp.asarray(targets), jnp.float32(TEMPERATURE))
        m = step(_t(images), _t(setup["ids"]), _t(setup["mask"]), _t(targets), TEMPERATURE)
        for k in ("loss", "loss_ori", "loss_fdt"):
            assert float(m[k]) == pytest.approx(float(jm[k]), abs=1e-5)
    kw = dict(print_fn=lambda *_: None, lr=lr)
    jparams, jstate, jstats = j_train_epoch(jparams, jstate, jstep, _loader(setup, 2),
                                            tokenize, ENC, TEMPERATURE, **kw)
    stats = train_epoch(model, step, _loader(setup, 2), tokenize, ENC, TEMPERATURE, **kw)
    assert stats["batches_done"] == jstats["batches_done"] == 2
    for k in ("loss", "loss_ori", "loss_fdt", "temperature", "lr"):
        assert float(stats[k]) == pytest.approx(float(jstats[k]), abs=2e-4), k
    want = nlvr_from_jax_params(jax.tree.map(np.asarray, jparams), setup["tcfg"],
                                device="cpu").state_dict()
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=1e-6, rtol=1e-4,
                                   err_msg=name)


def test_train_epoch_stops_after_the_polled_step(setup):
    model = _model(setup)
    opt = TO.make_adamw(model.parameters(), lr=1e-5, weight_decay=0.05)
    step = make_nlvr_train_step(model, opt, device="cpu")
    polls = []
    stats = train_epoch(model, step, _loader(setup, 3),
                        lambda s: (setup["ids"].copy(), setup["mask"].copy()), ENC,
                        TEMPERATURE, print_fn=lambda *_: None,
                        stop=lambda: polls.append(1) or len(polls) >= 2)
    assert stats["batches_done"] == 2 and len(polls) == 2


def test_fast_train_probe_gives_gather_step(setup):
    """--fast_train: cached probe batches, capacities from the mask-mode
    probe, then a gather-mode step with a finite loss."""
    model = _model(setup)
    cache = [None]
    tokenize = lambda s: (setup["ids"].copy(), setup["mask"].copy())  # noqa: E731
    batches = cached_probe_batches(cache, _loader(setup, 3), n=2)
    assert len(batches) == 2 and cached_probe_batches(cache, None) is batches
    caps_v, caps_t = probe_capacities(model, batches, tokenize, ENC, TEMPERATURE, "ceil")
    assert len(caps_v) == 3 and len(caps_t) == 3
    opt = TO.make_adamw(model.parameters(), lr=1e-5, weight_decay=0.05)
    step = make_nlvr_train_step(model, opt, capacities_v=caps_v, capacities_t=caps_t,
                                device="cpu")
    images, ids, mask, targets = _inputs(setup)
    assert torch.isfinite(step(images, ids, mask, targets, TEMPERATURE)["loss"])


def test_amp_step_keeps_fp32_masters(setup):
    """amp=True computes in bf16 and lands fp32 gradients on the fp32
    masters."""
    model = _model(setup)
    opt = TO.make_adamw(model.parameters(), lr=1e-5, weight_decay=0.05)
    step = make_nlvr_train_step(model, opt, amp=True, device="cpu")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    m = step(*_inputs(setup), TEMPERATURE)
    assert torch.isfinite(m["loss"]) and m["loss"].dtype == torch.float32
    for n, p in model.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, n
    assert any(not torch.equal(before[n], p) for n, p in model.named_parameters())


def test_checkpoint_reads_back_in_both_packages(setup, tmp_path):
    """save_nlvr_checkpoint, then the JAX package's load_blip_nlvr and the
    port's load_nlvr_state_dict read the same weights and temperature."""
    model = _model(setup)
    path = str(tmp_path / "checkpoint_best.pth")
    save_nlvr_checkpoint(model, path, epoch=3, temperature=1.75)
    params, temperature = load_blip_nlvr(path, setup["jcfg"])
    assert temperature == 1.75
    back = nlvr_from_jax_params(jax.tree.map(np.asarray, params), setup["tcfg"],
                                device="cpu").state_dict()
    sd = model.state_dict()
    assert back.keys() == sd.keys()
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    ck = torch.load(path)
    assert ck["epoch"] == 3 and all(v.dtype == torch.float32 for v in ck["model"].values())
    again = load_nlvr_state_dict(ck["model"], setup["tcfg"], device="cpu")
    images, ids, mask, _ = _inputs(setup)
    with torch.no_grad():
        a = model(images, ids, mask, temperature=TEMPERATURE, prune_active=True)
        b = again(images, ids, mask, temperature=TEMPERATURE, prune_active=True)
    assert torch.equal(a.logits, b.logits)
    assert isinstance(again, NLVRModel)
