"""Tensor parallelism and mesh serving artifacts in the port
(``madtp_tpu_torch/parallel/mesh.py``, ``serve/artifact.py``) against the JAX
package on the CPU, at the JAX tests' tiny sizes.

* ``model_parallel_param_specs`` splits every parameter of tiny BLIP NLVR,
  retrieval, caption and VQA models and a tiny CLIP as JAX's
  ``model_parallel_param_shardings`` does: each JAX leaf is replaced by a
  marker that counts along its split axis, carried into the port's names
  by the ``*_from_jax_params`` converters (which transpose the kernels), and
  the port's split dim must be the marker's (a column-split linear's bias
  splits with its weight, where JAX keeps it whole).
* On two gloo ranks (``tests/torch_tp_worker.py``, ``n_model=2``), the
  tensor-parallel ViT equals JAX ``vit_forward`` and the tensor-parallel MED
  multimodal encoder equals JAX ``med_encoder`` (the ``tests/test_spmd.py``
  cases), within 2e-5 with equal kept counts; each rank holds half of every
  split weight.
* K1's planes variant: its plain version on the two halves of the heads,
  combined, gives the full-head ``col_mass`` and ``cls_attn`` within 1e-6.
* A 2x2 NLVR mesh artifact on four gloo ranks equals JAX's single-device
  ``blip_nlvr_forward`` (logits 1e-5, kept counts equal); its ``meta.json``
  records JAX's ``nr_devices`` and ``mesh`` for the same mesh; ``rebind``
  changes the output and back; an export of a model placed on several
  devices without the mesh, and a load in a smaller group, are refused.
* Every unit of caption, VQA, BLIP retrieval, CLIP and CLIP RN exported
  with ``--mesh 1x2`` and served on two ranks equals JAX's single-device
  artifact exported from the same ``.pth``, and the same export served by
  one process; ``python -m madtp_tpu_torch.cli.serve`` serves a mesh
  artifact over the ranks it starts itself."""

import dataclasses
import os
import socket
import subprocess
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
from madtp_tpu.models.clip import init_clip_params
from madtp_tpu.models.med import init_med_params, med_encoder
from madtp_tpu.models.vit import init_vit_params, vit_forward
from madtp_tpu.parallel.mesh import make_mesh as j_make_mesh
from madtp_tpu.parallel.mesh import model_parallel_param_shardings
from madtp_tpu.prune.dtp import TokenState as JTokenState
from madtp_tpu_torch.ckpt.convert import (_JaxTree, caption_from_jax_params, clip_from_jax_params,
                                          nlvr_from_jax_params, retrieval_from_jax_params,
                                          vqa_from_jax_params)
from madtp_tpu_torch.core.config import BlipConfig, CLIPConfig, MedConfig, ViTConfig
from madtp_tpu_torch.models.med import MedEncoder
from madtp_tpu_torch.models.vit import VisionTransformer
from madtp_tpu_torch.ops.attention import attention_planes_plain, attention_scores_plain
from madtp_tpu_torch.parallel.mesh import Mesh, model_parallel_param_specs, shard_state_dict
from madtp_tpu_torch.prune.dtp import TokenState
from madtp_tpu_torch.serve.artifact import load_artifact, save_artifact

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO}
TIMEOUT = 300

VIT = dict(image_size=64, patch_size=16, embed_dim=64, depth=2, num_heads=4, sd_dim=64)
MED = dict(vocab_size=60, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
           intermediate_size=128, max_position_embeddings=40, encoder_width=64, sd_dim=64)
JCFG = JB.BlipConfig(JViTConfig(**VIT), JMedConfig(**MED), sd_num=8, sd_dim=64)
TCFG = BlipConfig(ViTConfig(**VIT), MedConfig(**MED), sd_num=8, sd_dim=64)
CLIP = dict(embed_dim=32, image_resolution=32, vision_layers=2, vision_width=64,
            vision_patch_size=16, context_length=16, vocab_size=100, transformer_width=64,
            transformer_heads=2, transformer_layers=2, sd_dim=32)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ranks(job, world, root):
    """``world`` ranks of ``tests/torch_tp_worker.py`` on ``job``; returns
    their processes (``_join`` waits for them)."""
    torch.save(job, root / "job.pt")
    coord = f"127.0.0.1:{_free_port()}"
    return [subprocess.Popen([sys.executable, os.path.join(REPO, "tests", "torch_tp_worker.py"),
                              str(r), str(world), coord, str(root / "job.pt"), str(root)],
                             cwd=REPO, env=ENV, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in range(world)]


def _join(procs, root):
    try:
        for r, p in enumerate(procs):
            out = p.communicate(timeout=TIMEOUT)[0].decode()
            assert p.returncode == 0, f"rank {r}:\n{out[-3000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return [torch.load(root / f"rank{r}.pt", weights_only=False) for r in range(len(procs))]


# ---- the split rule ---------------------------------------------------------


def _markers(params):
    """Each leaf of ``params`` as a marker: its index along the axis JAX
    splits over 'model' (4x2 mesh of the 8 CPU devices), -1 where it keeps
    the leaf whole."""
    specs = model_parallel_param_shardings(j_make_mesh(n_data=4, n_model=2), params)

    def mark(x, sharding):
        x = np.asarray(x)
        axes = [i for i, a in enumerate(sharding.spec) if a == "model"]
        if not axes:
            return np.full(x.shape, -1.0, np.float32)
        shape = [1] * x.ndim
        shape[axes[0]] = x.shape[axes[0]]
        return np.broadcast_to(np.arange(x.shape[axes[0]], dtype=np.float32).reshape(shape),
                               x.shape).copy()
    return jax.tree.map(mark, params, specs)


def _marked_dim(t: torch.Tensor):
    if bool((t == -1).all()):
        return None
    dims = [d for d in range(t.dim()) if not torch.equal(t, t.narrow(d, 0, 1).expand_as(t))]
    assert len(dims) == 1, dims
    return dims[0]


def _family(name):
    if name == "nlvr":
        jcfg, params, *_ = _nlvr_setup(image_size=64, B=2, text_len=12,
                                       vit_kw=dict(patch_size=16, embed_dim=64, depth=2,
                                                   num_heads=4, sd_dim=64),
                                       med_kw=dict(vocab_size=120, hidden_size=64,
                                                   num_hidden_layers=2, num_attention_heads=4,
                                                   intermediate_size=256,
                                                   max_position_embeddings=64,
                                                   merge_start_layer=1))
        tcfg = BlipConfig(ViTConfig(**dataclasses.asdict(jcfg.vit)),
                          MedConfig(**dataclasses.asdict(jcfg.med)), jcfg.sd_num, jcfg.sd_dim)
        return params, lambda t: nlvr_from_jax_params(t, tcfg, device="cpu")
    if name == "clip":
        cfg = JCLIPConfig(**CLIP)
        params = init_clip_params(cfg, np.random.RandomState(0))
        sd = np.full((8, 32), -1.0, np.float32)  # the codebook, outside JAX's tree: whole
        return params, lambda t: clip_from_jax_params(t, CLIPConfig(**CLIP), sd, device="cpu")
    kw = {"retrieval": dict(heads=("retrieval",)),
          "caption": dict(heads=(), with_encoder=False, with_decoder=True),
          "vqa": dict(heads=(), with_decoder=True)}[name]
    conv = {"retrieval": retrieval_from_jax_params, "caption": caption_from_jax_params,
            "vqa": vqa_from_jax_params}[name]
    return init_blip_params(JCFG, 0, **kw), lambda t: conv(t, TCFG, device="cpu")


@pytest.mark.parametrize("name", ["nlvr", "retrieval", "caption", "vqa", "clip"])
def test_param_specs_match_jax(name):
    params, convert = _family(name)
    marked = dict(convert(jax.tree.map(np.asarray, _markers(params))).named_parameters())
    specs = model_parallel_param_specs(marked)
    split = 0
    for n, t in marked.items():
        want = _marked_dim(t)
        if n.endswith(".bias") and specs.get(n[:-len("bias")] + "weight") == 0:
            assert want is None and specs[n] == 0, n  # JAX keeps it whole, XLA slices it
        else:
            assert specs[n] == want, (n, specs[n], want)
        split += specs[n] is not None
    assert split > 0
    # what stays whole, named
    for n in marked:
        if any(k in n for k in ("attn.qkv", "in_proj", "merge_layer", "cls.predictions",
                                "space_dict", "word_embeddings")):
            assert specs[n] is None, n


def test_shard_state_dict_halves_split_tensors():
    params, convert = _family("nlvr")
    sd = convert(jax.tree.map(np.asarray, params)).state_dict()
    specs = model_parallel_param_specs(sd)
    halves = [shard_state_dict(sd, Mesh((1, 2), (0, j))) for j in range(2)]
    for k, v in sd.items():
        if specs[k] is None:
            assert halves[0][k] is v and halves[1][k] is v
        else:
            assert torch.equal(torch.cat([h[k] for h in halves], dim=specs[k]), v), k
    assert specs["cls_head.0.weight"] == 0 and specs["cls_head.2.weight"] == 1


# ---- K1's planes variant ----------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_planes_combine_to_full_heads(dtype):
    rng = np.random.RandomState(4)
    B, N, H = 3, 29, 6
    q, k, v = (torch.from_numpy(rng.randn(B, N, H, 64).astype(np.float32)).to(dtype)
               for _ in range(3))
    alive = torch.from_numpy(rng.rand(B, N) > 0.3)
    alive[:, 0] = True
    bias = torch.from_numpy((rng.rand(B, N) < 0.2).astype(np.float32) * -10000.0)
    out, cls, col = attention_scores_plain(q, k, v, alive, bias, 0.125)
    parts = [attention_planes_plain(q[:, :, s], k[:, :, s], v[:, :, s], alive, bias, 0.125)
             for s in (slice(0, 3), slice(3, 6))]
    plane = torch.maximum(parts[0][1], parts[1][1])
    num, den = parts[0][2] + parts[1][2], parts[0][3] + parts[1][3]
    torch.testing.assert_close(num / (den + 1e-8), cls, rtol=0, atol=1e-6)
    torch.testing.assert_close(plane.sum(dim=1), col, rtol=0, atol=1e-6)
    torch.testing.assert_close(torch.cat([p[0].unflatten(-1, (3, 64)) for p in parts], dim=2),
                               out.unflatten(-1, (H, 64)), rtol=0, atol=0)
    assert not plane[~alive[:, 1:]].any()  # dead queries add nothing


# ---- the tensor-parallel towers on two ranks --------------------------------


def _vit_case():
    cfg = JViTConfig(image_size=32, patch_size=8, embed_dim=32, depth=2, num_heads=4, sd_dim=32)
    rng = np.random.RandomState(1)
    params = jax.tree.map(jnp.asarray, init_vit_params(cfg, rng))
    images = rng.randn(4, 3, 32, 32).astype(np.float32)
    sd = rng.randn(6, 32).astype(np.float32)
    j = _JaxTree()
    tcfg = BlipConfig(ViTConfig(**dataclasses.asdict(cfg)), MedConfig(), sd_dim=32)
    j.vit(jax.tree.map(np.asarray, params), tcfg)
    model = VisionTransformer(tcfg.vit)
    model.load_state_dict({k.removeprefix("visual_encoder."): v for k, v in j.sd.items()})
    return cfg, params, images, sd, model


def _med_case():
    med = JMedConfig(vocab_size=60, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                     intermediate_size=128, max_position_embeddings=32, encoder_width=32,
                     sd_dim=32)
    rng = np.random.RandomState(3)
    params = jax.tree.map(jnp.asarray, init_med_params(med, rng))
    sd = rng.randn(6, 32).astype(np.float32)
    ids = rng.randint(1, 60, (4, 12)).astype(np.int32)
    enc = rng.randn(4, 9, 32).astype(np.float32)
    j = _JaxTree()
    tcfg = BlipConfig(ViTConfig(), MedConfig(**dataclasses.asdict(med)), sd_dim=32)
    j.med(jax.tree.map(np.asarray, params), tcfg, prefix="")
    model = MedEncoder(tcfg.med)
    model.load_state_dict(j.sd)
    return med, params, sd, ids, enc, model


@pytest.fixture(scope="module")
def tp_ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp")
    vcfg, vparams, images, vsd, vit = _vit_case()
    med, mparams, msd, ids, enc, medm = _med_case()
    alive = torch.ones(4, 9, dtype=torch.bool)
    job = {"tp": [
        dict(model=vit, mesh=(1, 2), args=(torch.from_numpy(images),), kwargs={}),
        dict(model=vit, mesh=(1, 2), args=(torch.from_numpy(images),),
             kwargs=dict(space_dict=torch.from_numpy(vsd), temperature=1.0,
                         prune_active=True)),
        dict(model=medm, mesh=(1, 2),
             args=(torch.from_numpy(ids).long(), torch.ones(4, 12, dtype=torch.long)),
             kwargs=dict(encoder_state=TokenState(torch.from_numpy(enc), alive, None),
                         space_dict=torch.from_numpy(msd), temperature=1.0,
                         prune_active=True))]}
    procs = _ranks(job, 2, root)
    want = []  # the JAX references while the ranks run
    st, _, kept = jax.jit(lambda p, im: vit_forward(p, im, cfg=vcfg))(vparams, images)
    want.append((np.asarray(st.x), None))
    st, _, kept = jax.jit(lambda p, im, s: vit_forward(
        p, im, cfg=vcfg, space_dict=s, temperature=1.0, prune_active=True))(vparams, images, vsd)
    want.append((np.asarray(st.x), np.asarray(kept)))
    out = jax.jit(lambda p, i, e, s: med_encoder(
        p, i, jnp.ones((4, 12), jnp.int32), med, mode="multimodal",
        encoder_state=JTokenState(e, jnp.ones((4, 9), jnp.float32), None), space_dict=s,
        temperature=1.0, prune_active=True))(mparams, ids, enc, msd)
    want.append((np.asarray(out.state.x), np.asarray(out.kept_counts)))
    return _join(procs, root), want, (vit, medm)


@pytest.mark.parametrize("case", ["vit", "vit_pruned", "med"])
def test_tensor_parallel_matches_jax(tp_ranks, case):
    got, want, models = tp_ranks
    i = ["vit", "vit_pruned", "med"].index(case)
    wx, wk = want[i]
    for r in range(2):
        g = got[r][i]
        x = g["x"].numpy()
        if x.shape[1] != wx.shape[1]:  # mask mode's merge slots: the port pads to 8
            x = x[:, :wx.shape[1]]
        np.testing.assert_allclose(x, wx, rtol=2e-5, atol=2e-5)
        if wk is not None:
            np.testing.assert_array_equal(g["kept"].numpy(), wk)
    assert torch.equal(got[0][i]["x"], got[1][i]["x"])
    whole = dict((models[0] if i < 2 else models[1]).named_parameters())
    specs = model_parallel_param_specs(whole)
    for n, shape in got[0][i]["shapes"].items():
        want_shape = list(whole[n].shape)
        if specs[n] is not None:
            want_shape[specs[n]] //= 2
        assert list(shape) == want_shape, n
    assert any(s is not None for s in specs.values())


# ---- mesh serving artifacts -------------------------------------------------


def _tiny_nlvr():
    return _nlvr_setup(image_size=64, B=4, text_len=12,
                       vit_kw=dict(patch_size=16, embed_dim=64, depth=2, num_heads=4, sd_dim=64),
                       med_kw=dict(vocab_size=120, hidden_size=64, num_hidden_layers=2,
                                   num_attention_heads=4, intermediate_size=256,
                                   max_position_embeddings=64))


def _jax_mesh_meta(tmp_path, jcfg, params, images, ids, mask):
    """JAX's meta.json for the tiny NLVR step exported over a 2x2 mesh."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from madtp_tpu.serve import save_artifact as j_save_artifact

    def fn(params, images, ids, mask, t):
        logits, (vk, tk) = JB.blip_nlvr_forward(params, images, ids, mask, jcfg,
                                                temperature=t, prune_active=True)
        return logits, vk, tk

    mesh = j_make_mesh(n_data=2, n_model=2)
    data = NamedSharding(mesh, P("data"))
    jf = jax.jit(fn, in_shardings=(model_parallel_param_shardings(mesh, params), data, data,
                                   data, NamedSharding(mesh, P())))
    art = str(tmp_path / "jax_pod")
    j_save_artifact(art, jf, params, (images, ids, mask, jnp.float32(1.0)), meta={}, mesh=mesh)
    import json

    with open(os.path.join(art, "meta.json")) as f:
        return json.load(f)


def test_mesh_artifact_matches_jax(tmp_path):
    import json

    jcfg, params, images, ids, mask, _ = _tiny_nlvr()
    tcfg = BlipConfig(ViTConfig(**dataclasses.asdict(jcfg.vit)),
                      MedConfig(**dataclasses.asdict(jcfg.med)), jcfg.sd_num, jcfg.sd_dim)
    tree = jax.tree.map(np.asarray, params)
    model = nlvr_from_jax_params(tree, tcfg, device="cpu")
    x = (*(torch.from_numpy(np.array(a)) for a in (images, ids, mask)), torch.tensor(1.0))
    art = str(tmp_path / "nlvr_mesh")
    save_artifact(art, model, "nlvr", "eval", x, meta={"task": "nlvr", "mode": "mask"},
                  mesh=(2, 2))
    weights = {k: v.clone() for k, v in model.state_dict().items()}
    job = {"serve": dict(dir=art, inputs=x, weights=weights, resave=str(tmp_path / "resaved"),
                         rebind={k: v * 1.5 for k, v in weights.items()})}
    procs = _ranks(job, 4, tmp_path)
    want = jax.jit(lambda p, im, i, m: JB.blip_nlvr_forward(
        p, im, i, m, jcfg, temperature=1.0, prune_active=True))(params, images, ids, mask)
    jmeta = _jax_mesh_meta(tmp_path, jcfg, params, images, ids, mask)
    got = _join(procs, tmp_path)
    with open(os.path.join(art, "meta.json")) as f:
        meta = json.load(f)
    for key in ("nr_devices", "mesh"):
        assert meta[key] == jmeta[key], (key, meta[key], jmeta[key])
    logits, vk, tk = got[0]["first"]
    np.testing.assert_allclose(logits.numpy(), np.asarray(want[0]), atol=1e-5)
    np.testing.assert_array_equal(vk.numpy(), np.asarray(want[1][0]))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(want[1][1]))
    assert not torch.allclose(got[0]["rebound"][0], logits)
    assert all(torch.equal(a, b) for a, b in zip(got[0]["back"], got[0]["first"]))
    # the sharded model exported again: its shards gathered back into the
    # whole weights, the same mesh recorded
    resaved = torch.load(tmp_path / "resaved" / "weights.pt", weights_only=True)
    assert resaved.keys() == weights.keys()
    assert all(torch.equal(resaved[k], v) for k, v in weights.items())
    with open(tmp_path / "resaved" / "meta.json") as f:
        assert json.load(f)["mesh"] == meta["mesh"]
    # every rank holds its model index's half of each split weight
    specs = model_parallel_param_specs(dict(model.named_parameters()))
    for n, shape in got[1]["shapes"].items():
        want_shape = list(model.get_parameter(n).shape)
        if specs[n] is not None:
            want_shape[specs[n]] //= 2
        assert list(shape) == want_shape, n


def test_mesh_refusals(tmp_path):
    jcfg, params, images, ids, mask, _ = _tiny_nlvr()
    tcfg = BlipConfig(ViTConfig(**dataclasses.asdict(jcfg.vit)),
                      MedConfig(**dataclasses.asdict(jcfg.med)), jcfg.sd_num, jcfg.sd_dim)
    model = nlvr_from_jax_params(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    x = (*(torch.from_numpy(np.array(a)) for a in (images, ids, mask)), torch.tensor(1.0))
    model.mesh = Mesh((2, 2), (0, 0))  # as shard_model leaves a model of a 2x2 mesh
    with pytest.raises(ValueError, match="pass the mesh"):
        save_artifact(str(tmp_path / "bad"), model, "nlvr", "eval", x)
    del model.mesh
    art = save_artifact(str(tmp_path / "pod"), model, "nlvr", "eval", x, mesh=(2, 2))
    with pytest.raises(ValueError, match="needs 4 devices"):
        load_artifact(art, "cpu")  # one process: a group smaller than the mesh


def _rn_clip_pth(root):
    """A tiny RN CLIP ``.pth`` (``test_torch_driver_clip``'s ModifiedResNet
    tower under the tiny CLIP's text tower) with its codebook."""
    from madtp_tpu.ckpt.export import save_torch_checkpoint
    from test_torch_driver_clip import rn_state_dict

    sd = rn_state_dict(np.random.RandomState(4))
    sd["space_dict"] = np.random.RandomState(5).randn(10, 64).astype(np.float32)
    os.makedirs(root, exist_ok=True)
    pth, yml = os.path.join(root, "rn.pth"), os.path.join(root, "rn.yaml")
    save_torch_checkpoint(pth, sd, temperature=1.0)
    with open(yml, "w") as f:
        f.write("sd_dim: 64\n")
    return yml, pth


def _jax_rn_clip_units(pth):
    """JAX's steps of the CLIP export's two units on an RN ``.pth``
    (``madtp_tpu/cli/export_serving.py`` ``_export_clip``'s ``img_fn`` and
    ``txt_fn``), jitted: the JAX package's artifact of an RN tower does not
    load back (its ``load_artifact`` refuses the tree's object arrays), so
    the steps run here on the same weights."""
    from madtp_tpu.ckpt import load_state_dict, remap_clip
    from madtp_tpu.cli.compress_retrieval_clip import infer_clip_config
    from madtp_tpu.models.clip import clip_encode_image, clip_encode_text

    sd, _ = load_state_dict(pth)
    cfg = infer_clip_config(sd, sd_dim=64)
    assert cfg.is_resnet
    params = jax.tree.map(jnp.asarray, remap_clip(sd))
    space = jnp.asarray(np.asarray(sd["space_dict"], np.float32))

    def img(images, t):
        feats, _, kept = clip_encode_image(params, images, cfg, space_dict=space,
                                           temperature=t, prune_active=False)
        return feats, kept

    def txt(text, t):
        feats, _, kept = clip_encode_text(params, text, cfg, space_dict=space, temperature=t,
                                          prune_active=True)
        return feats, kept
    return {"image_encoder": jax.jit(img), "text_encoder": jax.jit(txt)}


def test_mesh_artifacts_of_every_task_equal_one_process(tmp_path, monkeypatch):
    """Every unit of caption, VQA, BLIP retrieval, CLIP and CLIP RN exported
    by the port's CLI with ``--mesh 1x2`` and served on two gloo ranks gives
    the outputs of JAX's single-device artifact, exported by the JAX CLI from
    the same ``.pth`` (RN: JAX's steps of that export, ``_jax_rn_clip_units``;
    floats within 1e-5, the ITM rerank's 1e-4 as in
    ``test_torch_serve``; caption sequences, VQA answers and every kept
    count equal), and of the port's export without a mesh in one process
    (1e-5): the decoder's heads and its decode cache, VQA's ranking, the ITM
    rerank and RN's attention pool split over the ranks."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_torch_driver_common import make_setup
    from test_torch_serve import TASK_ARGS, UNITS, _clip_pth, _inputs, _sharpen_pth

    from madtp_tpu.cli import export_serving as j_export
    from madtp_tpu.serve import load_artifact as j_load_artifact
    from madtp_tpu_torch.cli import export_serving

    rng = np.random.RandomState(0)
    jobs, want = [], []
    for name in ("caption", "vqa", "retrieval", "clip", "clip_rn"):
        task = name.removesuffix("_rn")
        if name == "clip":
            yml, pth = _clip_pth(str(tmp_path))
        elif name == "clip_rn":
            yml, pth = _rn_clip_pth(str(tmp_path / name))
        else:
            yml, pth, _ = make_setup(tmp_path / task, task)
            if task in ("caption", "vqa"):
                _sharpen_pth(pth)
        argv = ["--task", task, "--config", yml, "--pretrained", pth, "--temperature", "1.0",
                *TASK_ARGS[task]]
        jdir, one, two = (str(tmp_path / f"{name}_{k}") for k in ("jax", "one", "mesh"))
        if name == "clip_rn":
            jax_units = _jax_rn_clip_units(pth)
        else:
            monkeypatch.setattr(sys, "argv", ["x", *argv, "--output_dir", jdir])
            j_export.main()
            jax_units = {u: j_load_artifact(os.path.join(jdir, u)) for u in UNITS[task]}
        export_serving.main([*argv, "--device", "cpu", "--output_dir", one])
        export_serving.main([*argv, "--device", "cpu", "--output_dir", two, "--mesh", "1x2"])
        jax_outputs = {}
        for unit in UNITS[task]:
            inputs = _inputs(task, unit, rng, jax_outputs)
            jax_outputs[unit] = [np.asarray(o) for o in jax.tree.leaves(
                jax_units[unit](*map(jnp.asarray, inputs)))]
            one_out = [o.numpy() for o in load_artifact(os.path.join(one, unit), "cpu")(*inputs)]
            jobs.append(dict(dir=os.path.join(two, unit), inputs=inputs))
            want.append((f"{name}/{unit}", jax_outputs[unit], one_out,
                         1e-4 if unit == "itm_rerank" else 1e-5))
    got = _join(_ranks({"serve": jobs}, 2, tmp_path), tmp_path)[0]
    for (name, jw, ow, atol), g in zip(want, got):
        assert len(jw) == len(g["first"]) == len(ow), name
        for i, (a, j, o) in enumerate(zip(g["first"], jw, ow)):
            a = a.numpy()
            assert a.shape == j.shape and a.dtype == j.dtype, (name, i, a.dtype, j.dtype)
            if np.issubdtype(j.dtype, np.integer):
                np.testing.assert_array_equal(a, j, err_msg=f"{name} output {i} against JAX")
                np.testing.assert_array_equal(a, o, err_msg=f"{name} output {i}")
            else:
                np.testing.assert_allclose(a, j, rtol=0, atol=atol,
                                           err_msg=f"{name} output {i} against JAX")
                np.testing.assert_allclose(a, o, rtol=1e-5, atol=1e-5,
                                           err_msg=f"{name} output {i}")


def test_serve_cli_over_a_mesh(tmp_path):
    """``python -m madtp_tpu_torch.cli.serve`` on a 1x2 NLVR mesh artifact
    starts its second rank itself; a request's reply equals JAX's
    single-device forward, and a terminated server leaves no rank behind."""
    import time

    from madtp_tpu_torch.serve.server import ServingClient

    jcfg, params, images, ids, mask, _ = _tiny_nlvr()
    tcfg = BlipConfig(ViTConfig(**dataclasses.asdict(jcfg.vit)),
                      MedConfig(**dataclasses.asdict(jcfg.med)), jcfg.sd_num, jcfg.sd_dim)
    model = nlvr_from_jax_params(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    x = (*(torch.from_numpy(np.array(a)) for a in (images, ids, mask)), torch.tensor(1.0))
    art = save_artifact(str(tmp_path / "nlvr_1x2"), model, "nlvr", "eval", x,
                        meta={"task": "nlvr", "mode": "mask"}, mesh=(1, 2))
    port = _free_port()
    proc = subprocess.Popen([sys.executable, "-m", "madtp_tpu_torch.cli.serve", "--artifact",
                             art, "--port", str(port), "--device", "cpu"],
                            cwd=REPO, env=ENV, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    want = jax.jit(lambda p, im, i, m: JB.blip_nlvr_forward(
        p, im, i, m, jcfg, temperature=1.0, prune_active=True))(params, images, ids, mask)
    try:
        client = ServingClient(f"http://127.0.0.1:{port}", timeout=60)
        deadline = time.time() + 120
        while time.time() < deadline and not client.healthy():
            if proc.poll() is not None:
                raise AssertionError("server died:\n" + proc.stdout.read().decode())
            time.sleep(0.3)
        assert client.healthy(), "server never became healthy"
        assert client.meta["mesh"] == {"axis_names": ["data", "model"], "shape": [1, 2]}
        got = client.predict(*(np.asarray(a) for a in (images, ids, mask)), np.float32(1.0))
        np.testing.assert_allclose(got[0], np.asarray(want[0]), atol=1e-5)
        np.testing.assert_array_equal(got[1], np.asarray(want[1][0]))
        np.testing.assert_array_equal(got[2], np.asarray(want[1][1]))
    finally:
        proc.terminate()
        out = proc.communicate(timeout=60)[0].decode()
    assert "over 2 processes" in out, out[-2000:]
    ps = subprocess.run(["ps", "-eo", "args"], capture_output=True, text=True).stdout
    assert art not in ps, "a rank outlived the server"
