"""The port's CLIP retrieval slice against the JAX package (CPU, a tiny CLIP
on one set of random weights: widths 128, 2 heads, patch 16 at 64 px,
context 16, 2 layers per tower): K5's plain version and its gradients, the
MAG query with ``q_map``, the ``"clip"`` DTP variant, both towers in mask
and gather mode, both weight loaders, ``infer_clip_config``,
``clip_gflops``, the capacity probe and the eval, and the entry points'
device rule.  Tolerances: fp32 FFN 1e-5 (tests/test_pallas.py), bf16 FFN
2e-2 (both round h, g and y to bf16, where a sum next to a rounding edge may
land one step apart), gradients 1e-4, features and MAG features 1e-5; kept
counts, alive masks and capacities must be equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madtp_tpu.ckpt.export import export_clip
from madtp_tpu.cli.compress_retrieval_clip import infer_clip_config as j_infer_clip_config
from madtp_tpu.core.config import CLIPConfig as JCLIPConfig
from madtp_tpu.eval.metrics import itm_eval as j_itm_eval
from madtp_tpu.models.clip import clip_encode_image, clip_encode_text, init_clip_params
from madtp_tpu.ops import layers as JL
from madtp_tpu.ops.pallas.fused_ffn import fused_mlp_2d
from madtp_tpu.prune import dtp as JD
from madtp_tpu.prune.calibrate import calibrate_capacities
from madtp_tpu.prune.flops import clip_gflops as j_clip_gflops
from madtp_tpu.prune.query import query_model as j_query_model
from madtp_tpu_torch.ckpt.convert import clip_from_jax_params, load_clip_state_dict
from madtp_tpu_torch.core.config import CLIPConfig, infer_clip_config
from madtp_tpu_torch.models.clip import init_clip_model
from madtp_tpu_torch.ops import layers as TL
from madtp_tpu_torch.prune import dtp as TD
from madtp_tpu_torch.prune.flops import ORI_GFLOPS, clip_gflops
from madtp_tpu_torch.prune.query import query_model
from madtp_tpu_torch.tasks import clip_retrieval as TC

CLIP = dict(embed_dim=64, image_resolution=64, vision_layers=2, vision_width=128,
            vision_patch_size=16, vision_heads_override=2, context_length=16, vocab_size=100,
            transformer_width=128, transformer_heads=2, transformer_layers=2, sd_dim=128)
JCFG, TCFG = JCLIPConfig(**CLIP), CLIPConfig(**CLIP)
L14 = dict(embed_dim=768, image_resolution=336, vision_layers=24, vision_width=1024,
           vision_patch_size=14, transformer_width=768, transformer_heads=12,
           transformer_layers=12, sd_dim=768)
TEMPERATURE = 2.0
CAPS = (24, 16)  # gather-mode vision capacities of the model tests
EOT = 99


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _text(rng, n, context=16, lo=5, hi=13):
    """Token ids as ``tools/bench_clip.py`` makes them: random ids, EOT (the
    highest id) ending a random length, zeros after."""
    text = np.zeros((n, context), np.int64)
    for b, length in enumerate(rng.randint(lo, hi, size=n)):
        text[b, :length] = rng.randint(1, EOT - 1, size=length)
        text[b, length - 1] = EOT
    return text


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(0)
    params = init_clip_params(JCFG, rng)
    sd = rng.randn(16, JCFG.sd_dim).astype(np.float32)
    images = rng.randn(6, 3, 64, 64).astype(np.float32)
    text = _text(rng, 7)
    jparams = jax.tree.map(jnp.asarray, params)
    return dict(params=params, jparams=jparams, sd=sd, images=images, text=text,
                model=clip_from_jax_params(params, TCFG, sd, device="cpu"))


# ---------------------------------------------------------------- K5's plain version


def _ffn_case(dtype, seed=3, M=300, D=128, F=256):
    rng = np.random.RandomState(seed)
    x = rng.randn(M, D).astype(np.float32)
    w1, w2 = rng.randn(D, F).astype(np.float32) * 0.05, rng.randn(F, D).astype(np.float32) * 0.05
    b1, b2 = rng.randn(F).astype(np.float32) * 0.1, rng.randn(D).astype(np.float32) * 0.1
    jax_args = [jnp.asarray(a).astype(dtype) for a in (x, w1, b1, w2, b2)]
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    torch_args = [_t(a).to(tdt) for a in (x, w1.T, b1, w2.T, b2)]
    return jax_args, torch_args


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
def test_mlp_plain_matches_fused_ffn(act, dtype):
    """K5's plain version against the TPU kernel in interpret mode (M not a
    multiple of its row tile) and the XLA mlp, fp32 and bf16."""
    jargs, targs = _ffn_case(dtype)
    got = TL.mlp_plain(*targs, act=act).float().numpy()
    want_k = np.asarray(fused_mlp_2d(*jargs, act=act, interpret=True).astype(jnp.float32))
    x, w1, b1, w2, b2 = jargs
    want_x = JL.mlp({"fc1": {"kernel": w1, "bias": b1}, "fc2": {"kernel": w2, "bias": b2}}, x,
                    act=JL.gelu if act == "gelu" else JL.quick_gelu)
    tol = 1e-5 if dtype == jnp.float32 else 2e-2
    np.testing.assert_allclose(got, want_k, rtol=tol, atol=tol)
    np.testing.assert_allclose(got, np.asarray(want_x.astype(jnp.float32)), rtol=tol, atol=tol)


@pytest.mark.parametrize("route", ["plain", "function"])
@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
def test_fused_mlp_gradients_match_jax(act, route, monkeypatch):
    """Gradients of x, both weights and both biases against ``jax.grad`` of
    the XLA mlp: through ``mlp`` on CPU tensors (the plain path), and through
    :class:`FusedMLP`, whose backward recomputes the plain version (its
    forward is K5; here a stand-in that returns the plain version's values
    without a graph, as the kernel does)."""
    jargs, targs = _ffn_case(jnp.float32, seed=5, M=70)
    leaves = [t.requires_grad_() for t in targs]
    w = np.random.RandomState(6).randn(70, 128).astype(np.float32)
    if route == "plain":
        fc1, fc2 = torch.nn.Linear(128, 256), torch.nn.Linear(256, 128)
        fc1.weight, fc1.bias, fc2.weight, fc2.bias = (torch.nn.Parameter(t) for t in leaves[1:])
        leaves[1:] = [fc1.weight, fc1.bias, fc2.weight, fc2.bias]
        y = TL.mlp(leaves[0], fc1, fc2, act=act)
    else:
        monkeypatch.setattr(TL, "ffn_cuda", lambda *a: TL.mlp_plain(
            *(t.detach() if torch.is_tensor(t) else t for t in a)))
        y = TL.FusedMLP.apply(*leaves, act)
    got = torch.autograd.grad((y * _t(w)).sum(), leaves)
    act_fn = JL.gelu if act == "gelu" else JL.quick_gelu

    def f(x, w1, b1, w2, b2):
        p = {"fc1": {"kernel": w1, "bias": b1}, "fc2": {"kernel": w2, "bias": b2}}
        return jnp.sum(JL.mlp(p, x, act=act_fn) * jnp.asarray(w))

    want = jax.grad(f, argnums=(0, 1, 2, 3, 4))(*jargs)
    for g, wnt, transpose in zip(got, want, (False, True, False, True, False)):
        wnt = np.asarray(wnt).T if transpose else np.asarray(wnt)
        np.testing.assert_allclose(g.numpy(), wnt, rtol=1e-4, atol=1e-4)


def test_quick_gelu_and_normalize_images_match_jax():
    x = np.random.RandomState(8).randn(4, 33).astype(np.float32) * 3
    np.testing.assert_allclose(TL.quick_gelu(_t(x)).numpy(), np.asarray(JL.quick_gelu(x)),
                               rtol=1e-6, atol=1e-6)
    u8 = np.random.RandomState(9).randint(0, 256, size=(2, 8, 8, 3)).astype(np.uint8)
    np.testing.assert_allclose(TL.normalize_images(_t(u8)).numpy(),
                               np.asarray(JL.normalize_images(jnp.asarray(u8))), atol=1e-6)


# ---------------------------------------------------------------- MAG query and DTP


def test_query_model_with_q_map_matches_jax(setup):
    """query_model with CLIP's per-block q_map (JAX ``map_func=True``),
    tokens of width 128 mapped to the codebook's, dead tokens masked."""
    rng = np.random.RandomState(10)
    ft = rng.randn(3, 11, 128).astype(np.float32)
    alive = rng.rand(3, 11) > 0.3
    blk = setup["model"].visual.transformer.resblocks[0]
    qm = jax.tree.map(lambda a: a[0], setup["params"]["visual"]["blocks"]["query_model"])
    want = j_query_model(qm, jnp.asarray(ft), jnp.asarray(setup["sd"]),
                         alive=jnp.asarray(alive), map_func=True)
    with torch.no_grad():
        got = query_model(_t(ft), _t(setup["sd"]), _t(alive), q_map=blk.query_model.q_map[0])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def _dtp_case(seed=11, B=3, S=20, D=16, K=6):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, S, D).astype(np.float32)
    alive = np.ones((B, S), bool)
    alive[:, S - 3:] = False  # dead merge slots, as in mask mode
    alive[1, 4] = False
    signals = (rng.rand(B, S - 1).astype(np.float32), rng.rand(B, S - 1).astype(np.float32),
               rng.randn(B, S - 1, K).astype(np.float32) * 3)
    return x, alive, signals


@pytest.mark.parametrize("kind", ["scalar", "tensor"])
@pytest.mark.parametrize("mode", ["mask", "gather"])
def test_dtp_clip_variant_matches_jax(mode, kind):
    """dtp_prune / dtp_prune_gather with variant="clip" against the JAX
    package, for a max_keep the keep count passes (the step applies) and
    one it does not (the EOT guard skips the step); max_keep as a Python int
    or, like the text tower's ``max(eot_pos) + 2``, a tensor."""
    x, alive, (cls, col, tok) = _dtp_case()
    col = col * alive[:, 1:]
    kepts = []
    for max_keep in (2, 15):
        jmk = max_keep if kind == "scalar" else jnp.asarray(max_keep)
        tmk = max_keep if kind == "scalar" else torch.tensor(max_keep)
        jstate = JD.TokenState(jnp.asarray(x), jnp.asarray(alive), None)
        jsig = JD.DTPSignals(cls_attn=jnp.asarray(cls), col_mass=jnp.asarray(col),
                             token_attn=jnp.asarray(tok))
        tstate = TD.TokenState(_t(x), _t(alive), None)
        tsig = TD.DTPSignals(cls_attn=_t(cls), col_mass=_t(col), token_attn=_t(tok))
        if mode == "mask":
            want = JD.dtp_prune(jstate, jsig, 1.5, 17, variant="clip", max_keep=jmk)
            got = TD.dtp_prune(tstate, tsig, 1.5, 17, variant="clip", max_keep=tmk)
        else:
            want = JD.dtp_prune_gather(jstate, jsig, 1.5, 20, variant="clip", max_keep=jmk)
            got = TD.dtp_prune_gather(tstate, tsig, 1.5, 20, variant="clip", max_keep=tmk)
        (wst, wkept), (gst, gkept) = want[:2], got[:2]
        np.testing.assert_array_equal(gst.alive.numpy(), np.asarray(wst.alive))
        np.testing.assert_allclose(gst.x.numpy(), np.asarray(wst.x), atol=1e-6)
        assert int(gkept) == int(wkept)
        kepts.append(int(gkept))
    assert kepts[0] != kepts[1]  # the guard held one step back and let the other through


# ---------------------------------------------------------------- the towers


@pytest.fixture(scope="module")
def towers(setup):
    """JAX and port outputs of both towers: dense, mask mode, gather mode."""
    jp, model, sd = setup["jparams"], setup["model"], jnp.asarray(setup["sd"])
    images, text = setup["images"][:3], setup["text"][:4]
    out = {}
    for mode in ("dense", "mask", "gather"):
        kw = dict(space_dict=sd, temperature=TEMPERATURE if mode != "dense" else 0.0,
                  prune_active=mode != "dense")
        caps = CAPS if mode == "gather" else None
        j_img = jax.jit(lambda p, im: clip_encode_image(p, im, JCFG, capacities=caps, **kw))
        j_txt = jax.jit(lambda p, tx: clip_encode_text(p, tx, JCFG, **kw))
        j = jax.tree.map(np.asarray, (j_img(jp, images), j_txt(jp, text)))
        tkw = dict(temperature=kw["temperature"], prune_active=kw["prune_active"])
        with torch.no_grad():
            t = (model.encode_image(_t(images), capacities=caps, **tkw),
                 model.encode_text(_t(text), **tkw))
        out[mode] = (j, t)
    return out


@pytest.mark.parametrize("tower", ["image", "text"])
@pytest.mark.parametrize("mode", ["dense", "mask", "gather"])
def test_towers_match_jax(towers, mode, tower):
    """Equal kept counts; features and the MAG features within 1e-5.  The
    text tower has no gather mode: it runs in mask mode there too."""
    if tower == "text" and mode == "gather":
        mode = "mask"
    j, t = towers[mode]
    (jf, jsd, jk), tout = (j[0], t[0]) if tower == "image" else (j[1], t[1])
    np.testing.assert_array_equal(tout.kept_counts.numpy(), jk)
    np.testing.assert_allclose(tout.features.numpy(), jf, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tout.sd_ft.numpy(), jsd, rtol=1e-5, atol=1e-5)
    full = TCFG.vision_num_patches if tower == "image" else TCFG.context_length - 1
    if mode == "dense":
        assert (jk == full).all()
    else:
        assert jk[-1] < full  # the temperature prunes


def test_uint8_feed_and_causal_text(setup):
    """A uint8 image feed is normalised on the device side; tokens after a
    row's EOT change nothing of its features (causal mask over slots)."""
    model = setup["model"]
    u8 = np.random.RandomState(12).randint(0, 256, size=(2, 64, 64, 3)).astype(np.uint8)
    text = setup["text"][:2].copy()
    with torch.no_grad():
        a = model.encode_image(_t(u8)).features
        b = model.encode_image(TL.normalize_images(_t(u8))).features
        f1 = model.encode_text(_t(text)).features
        text[0, text[0].argmax() + 1:] = 7
        f2 = model.encode_text(_t(text)).features
    assert torch.equal(a, b)
    torch.testing.assert_close(f2[0], f1[0], rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------- weights and config


def test_loaders_give_identical_tensors(setup):
    """clip_from_jax_params and load_clip_state_dict (the reference layout,
    through the JAX package's export_clip, in fp16 as OpenAI ships it) give
    the same tensors; a block without q_map gets a zero map; without
    space_dict the model has no codebook and refuses to prune."""
    params, sd = setup["params"], export_clip(setup["params"])
    sd["space_dict"] = setup["sd"]
    a = setup["model"].state_dict()
    b = load_clip_state_dict(sd, TCFG, device="cpu").state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    half = {k: v.astype(np.float16) for k, v in sd.items()}
    c = load_clip_state_dict(half, TCFG, device="cpu").state_dict()
    assert all(c[k].dtype == torch.float32 for k in c)
    torch.testing.assert_close(c["visual.proj"], a["visual.proj"], rtol=1e-3, atol=1e-3)
    del sd["transformer.resblocks.1.query_model.q_map.0.weight"]
    del sd["transformer.resblocks.1.query_model.q_map.0.bias"]
    del sd["space_dict"]
    model = load_clip_state_dict(sd, TCFG, device="cpu")
    q_map = model.transformer.resblocks[1].query_model.q_map[0]
    assert q_map.weight.shape == (128, 128) and not q_map.weight.any() and not q_map.bias.any()
    assert model.space_dict is None
    again = clip_from_jax_params(params, TCFG, device="cpu")
    assert again.space_dict is None
    with pytest.raises(ValueError, match="codebook"):
        with torch.no_grad():
            model.encode_image(_t(setup["images"][:1]), temperature=1.0, prune_active=True)
    del sd["visual.proj"]
    with pytest.raises(KeyError, match="visual.proj"):
        load_clip_state_dict(sd, TCFG, device="cpu")


@pytest.mark.parametrize("which", ["tiny", "L14"])
def test_infer_clip_config_matches_jax(setup, which):
    """The ViT branch of infer_clip_config against the JAX package's CLI, on the
    tiny model's state dict and on ViT-L/14@336's shapes; a ModifiedResNet
    checkpoint raises."""
    if which == "tiny":
        sd = export_clip(setup["params"])
    else:
        shapes = {"visual.conv1.weight": (1024, 3, 14, 14),
                  "visual.positional_embedding": (577, 1024), "visual.proj": (1024, 768),
                  "text_projection": (768, 768), "positional_embedding": (77, 768),
                  "token_embedding.weight": (49408, 768), "ln_final.weight": (768,)}
        shapes.update({f"visual.transformer.resblocks.{i}.attn.in_proj_weight": (3072, 1024)
                       for i in range(24)})
        shapes.update({f"transformer.resblocks.{i}.ln_1.weight": (768,) for i in range(12)})
        sd = {k: np.zeros(s, np.float16) for k, s in shapes.items()}
    want = j_infer_clip_config(sd)
    got = infer_clip_config(sd)
    for f in ("embed_dim", "image_resolution", "vision_layers", "vision_width",
              "vision_patch_size", "context_length", "vocab_size", "transformer_width",
              "transformer_heads", "transformer_layers", "sd_dim"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.vision_heads == want.vision_heads
    assert got.vision_num_patches == want.vision_num_patches
    if which == "L14":
        assert got == CLIPConfig(**L14)
    with pytest.raises(NotImplementedError, match="ModifiedResNet"):
        infer_clip_config({k: v for k, v in sd.items() if k != "visual.proj"})
    with pytest.raises(NotImplementedError):
        CLIPConfig(resnet_layers=(3, 4, 6, 3))


def test_clip_gflops_matches_jax():
    cfg, jcfg = CLIPConfig(**L14), JCLIPConfig(**L14)
    for v_kept, t_kept in (([576] * 24, [76] * 12), (list(range(570, 90, -20)), [40] * 12),
                           ([300] * 24, list(range(70, 10, -5)))):
        assert clip_gflops(cfg, v_kept, t_kept) == j_clip_gflops(jcfg, v_kept, t_kept)
    assert abs(clip_gflops(cfg, [576] * 24, [76] * 12) - ORI_GFLOPS) / ORI_GFLOPS < 0.05
    assert clip_gflops(TCFG, [9, 5], [8, 8]) == j_clip_gflops(JCFG, [9, 5], [8, 8])


# ---------------------------------------------------------------- the task


def test_probe_and_evaluate_match_jax(setup):
    """--fast_eval's probe against the JAX package's CLI composition (mask-mode
    vision kept counts over the first images in batches of 16, then
    ``fast_capacity_schedule``'s vision schedule); the pruned gather-mode
    eval and the dense eval against the same JAX tower calls, ``sims =
    img @ txt.T`` and the JAX ``itm_eval``."""
    jp, sd, model = setup["jparams"], jnp.asarray(setup["sd"]), setup["model"]
    images, text = setup["images"], setup["text"]
    batches = [images[:4], images[4:]]
    vk = jax.jit(lambda p, im: clip_encode_image(p, im, JCFG, space_dict=sd,
                                                 temperature=TEMPERATURE,
                                                 prune_active=True)[2])(jp, images)
    want_caps = calibrate_capacities(np.asarray(vk)[None], margin=16, multiple=64)
    caps = TC.probe_capacities(model, iter(batches), TEMPERATURE)
    assert caps == want_caps
    txt2img = {t: t % 6 for t in range(7)}
    img2txt = {i: [t for t in range(7) if t % 6 == i] for i in range(6)}
    for temperature, cv in ((TEMPERATURE, caps), (0.0, None)):
        prune = temperature > 0

        def unit(f):
            return f / jnp.linalg.norm(f, axis=-1, keepdims=True)

        img, vks = zip(*(clip_encode_image(jp, jnp.asarray(b), JCFG, space_dict=sd,
                                           temperature=temperature, prune_active=prune,
                                           capacities=cv)[::2] for b in batches))
        txt, tks = zip(*(clip_encode_text(jp, jnp.asarray(text[i:i + 4]), JCFG, space_dict=sd,
                                          temperature=temperature, prune_active=prune)[::2]
                         for i in (0, 4)))
        sims = np.concatenate([unit(f) for f in img]) @ np.concatenate([unit(f) for f in txt]).T
        want = j_itm_eval(sims, sims.T, txt2img, img2txt)
        want_g = j_clip_gflops(JCFG, np.asarray(vks[-1]), np.asarray(tks[-1]))
        got, got_g = TC.evaluate(model, iter(batches), text, txt2img, img2txt, temperature,
                                 capacities_v=cv, batch_size=4)
        assert got == want and got_g == pytest.approx(want_g, rel=1e-12)
        img_t, txt_t, _, _ = TC.encode_towers(model, iter(batches), text,
                                              temperature=temperature, prune_active=prune,
                                              capacities_v=cv, batch_size=4)
        np.testing.assert_allclose(img_t @ txt_t.T, sims, atol=1e-5)


def test_entry_points_refuse_without_gpu(setup, monkeypatch):
    """init_clip_model and both loaders default to the card and raise
    without one; given device="cpu" they build a CPU model, and the eval
    runs where the model lives."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sd = export_clip(setup["params"])
    for call in (lambda: init_clip_model(TCFG),
                 lambda: clip_from_jax_params(setup["params"], TCFG),
                 lambda: load_clip_state_dict(sd, TCFG)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    model = init_clip_model(TCFG, device="cpu")
    assert model.space_dict.shape == (100, 128) and model.space_dict.device.type == "cpu"
    stats, g = TC.evaluate(model, iter([setup["images"]]), setup["text"][:6],
                           list(range(6)), [[i] for i in range(6)], 0.0)
    assert set(stats) >= {"txt_r1", "img_r1", "r_mean"} and 0 <= stats["r_mean"] <= 100
    assert g == clip_gflops(TCFG, [16, 16], [15, 15])
