"""Weights into and out of the port's NLVR, retrieval, VQA, caption and CLIP
models.  In, from two sources that must give the same tensors:

* :func:`nlvr_from_jax_params`, :func:`retrieval_from_jax_params`,
  :func:`vqa_from_jax_params`, :func:`caption_from_jax_params`,
  :func:`clip_from_jax_params` — the JAX package's param tree as numpy
  arrays (layers stacked ``[L, ...]``, linear kernels ``[in, out]``);
* :func:`load_nlvr_state_dict`, :func:`load_retrieval_state_dict`,
  :func:`load_vqa_state_dict`, :func:`load_caption_state_dict`,
  :func:`load_clip_state_dict` — a state dict in the reference ``.pth`` key
  layout (``madtp_tpu/ckpt/remap.py`` ``remap_vit``, ``remap_med``,
  ``remap_clip``, and the head and codebook handling of ``load_blip_nlvr``,
  ``load_blip_retrieval``, ``load_blip_vqa`` and ``load_blip_caption``).

The reference NLVR layout carries ``crossattention.output.merge_layer`` only
at layers >= ``merge_start_layer``, like the port's modules; a base checkpoint
may carry ``self``/``dense`` where the twin layers need ``self0``/``self1`` and
``dense0``/``dense1``, and both twins then start from the same weights.  A
retrieval checkpoint's momentum towers (``*_m.``) and queues are read only by
training and are ignored here.

Out: :func:`save_nlvr_checkpoint`, :func:`save_caption_checkpoint`,
:func:`save_vqa_checkpoint`, :func:`save_retrieval_checkpoint` and
:func:`save_clip_checkpoint` write what a
compression run leaves behind, the weights and the temperature, in the
reference ``.pth`` layout, with the keys the JAX drivers write.

:func:`retrieval_train_state_from_jax` and :func:`clip_train_state_from_jax`
carry the JAX package's retrieval and CLIP train states (momentum copies,
queue, retrieval's ``temp``) across, for training.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from madtp_tpu_torch.core.config import BlipConfig, CLIPConfig
from madtp_tpu_torch.core.device import resolve_device
from madtp_tpu_torch.models.blip import CaptionModel, NLVRModel, RetrievalModel, VQAModel
from madtp_tpu_torch.models.clip import CLIPModel
from madtp_tpu_torch.train.loops import (CLIP_MOMENTUM_KEYS, MOMENTUM_KEYS, ClipTrainState,
                                         RetrievalTrainState)
from madtp_tpu_torch.train.momentum import FeatureQueue


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys cubic kernel with a = -0.5 (the kernel of ``jax.image.resize``'s
    "bicubic"; torch's bicubic uses a = -0.75)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _resize_weights(n_in: int, n_out: int) -> torch.Tensor:
    """[n_in, n_out] interpolation weights, antialiased when shrinking, as
    ``jax.image.scale_and_translate`` builds them (fp32, zero translation)."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    src = torch.arange(n_in, dtype=torch.float32)
    w = _keys_cubic((sample[None, :] - src[:, None]).abs() / kernel_scale)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def interpolate_pos_embed(pos_embed: torch.Tensor, num_patches: int,
                          num_extra: int = 1) -> torch.Tensor:
    """Bicubic grid resize of ViT position embeddings ``[1, N_old, D]`` to
    ``num_patches`` grid tokens, matching ``madtp_tpu/ckpt/remap.py``
    ``interpolate_pos_embed`` (``jax.image.resize(method="bicubic")``)."""
    orig = int(round((pos_embed.shape[1] - num_extra) ** 0.5))
    new = int(round(num_patches ** 0.5))
    if orig == new:
        return pos_embed
    extra = pos_embed[:, :num_extra]
    grid = pos_embed[:, num_extra:].reshape(orig, orig, -1).float()
    w = _resize_weights(orig, new)
    resized = torch.einsum("ai,abd->ibd", w, grid)
    resized = torch.einsum("bj,ibd->ijd", w, resized).reshape(1, new * new, -1)
    return torch.cat([extra, resized.to(pos_embed.dtype)], dim=1)


def _tensor(x) -> torch.Tensor:
    """A contiguous fp32 copy (the model must not alias the caller's arrays);
    0-d stays 0-d."""
    return torch.from_numpy(np.array(x, dtype=np.float32, order="C"))


def _keys(model_fn) -> list:
    """The state-dict keys of ``model_fn()``, built on the meta device."""
    with torch.device("meta"):
        return list(model_fn().state_dict())


def _make(model_fn, dev: torch.device, sd: Dict[str, torch.Tensor]):
    """``model_fn()`` built on the meta device, ``sd`` assigned (strict), on ``dev``."""
    with torch.device("meta"):
        model = model_fn()
    model.load_state_dict(sd, strict=True, assign=True)
    return model.to(dev).eval()


def _reference_key_map(cfg: BlipConfig) -> Dict[str, list]:
    """NLVR model key -> reference keys to try in order (twin fallbacks)."""
    out = {}
    for k in _keys(lambda: NLVRModel(cfg)):
        cands = [k]
        for twin, base in ((".self0.", ".self."), (".self1.", ".self."),
                           (".dense0.", ".dense."), (".dense1.", ".dense.")):
            if ".crossattention." in k and twin in k:
                cands.append(k.replace(twin, base))
        out[k] = cands
    return out


def load_nlvr_state_dict(sd: Mapping[str, object], cfg: BlipConfig,
                         device="cuda") -> NLVRModel:
    """An NLVR model from a reference-layout state dict (numpy arrays or
    tensors).  Position embeddings are resized to ``cfg.vit``'s grid; a
    missing ``merge_layer`` starts at zero and a missing codebook at
    ``RandomState(0)`` normals, as the JAX loader does.  Keys the model does
    not have (``position_ids``, a pooler) are ignored."""
    dev = resolve_device(device)
    new: Dict[str, torch.Tensor] = {}
    for k, cands in _reference_key_map(cfg).items():
        found = next((c for c in cands if c in sd), None)
        if found is not None:
            new[k] = _tensor(sd[found])
        elif k.endswith(".output.merge_layer.weight"):
            H = cfg.med.hidden_size
            new[k] = torch.zeros(H, 2 * H)
        elif k.endswith(".output.merge_layer.bias"):
            new[k] = torch.zeros(cfg.med.hidden_size)
        elif k == "space_dict":
            new[k] = _tensor(np.random.RandomState(0).randn(cfg.sd_num, cfg.sd_dim))
        else:
            raise KeyError(f"state dict has no {k}")
    new["visual_encoder.pos_embed"] = interpolate_pos_embed(
        new["visual_encoder.pos_embed"], cfg.vit.num_patches)
    return _make(lambda: NLVRModel(cfg), dev, new)


def load_retrieval_state_dict(sd: Mapping[str, object], cfg: BlipConfig,
                              device="cuda") -> RetrievalModel:
    """A retrieval model from a reference-layout state dict (numpy arrays or
    tensors), as ``load_blip_retrieval`` reads it (``madtp_tpu/models/
    blip.py:292-326``): every key of the model must be there, the codebook
    included; position embeddings are resized to ``cfg.vit``'s grid; the
    momentum towers (``visual_encoder_m.`` ...), the queues, ``temp`` and
    ``position_ids`` are ignored.  The projection width comes from
    ``vision_proj.weight``."""
    dev = resolve_device(device)
    embed_dim = int(np.shape(sd["vision_proj.weight"])[0])
    return _load_every_key(sd, lambda: RetrievalModel(cfg, embed_dim), cfg, dev)


def _load_every_key(sd: Mapping[str, object], model_fn, cfg: BlipConfig,
                    dev: torch.device):
    """``model_fn()`` with every one of its keys read from ``sd`` (other keys
    ignored) and the position embeddings resized to ``cfg.vit``'s grid."""
    keys = _keys(model_fn)
    missing = [k for k in keys if k not in sd]
    if missing:
        raise KeyError(f"state dict has no {missing[0]} ({len(missing)} keys missing)")
    new = {k: _tensor(sd[k]) for k in keys}
    new["visual_encoder.pos_embed"] = interpolate_pos_embed(
        new["visual_encoder.pos_embed"], cfg.vit.num_patches)
    return _make(model_fn, dev, new)


def load_vqa_state_dict(sd: Mapping[str, object], cfg: BlipConfig,
                        device="cuda") -> VQAModel:
    """A VQA model from a reference-layout state dict (numpy arrays or
    tensors), as ``load_blip_vqa`` reads it (``madtp_tpu/models/blip.py:
    341-351``): every key of the model must be there, the codebook included;
    the decoder comes from ``text_decoder.bert.*`` and
    ``text_decoder.cls.predictions.{transform.*, bias}``; the tied exports
    ``cls.predictions.decoder.*``, ``position_ids`` and a pooler are
    ignored; position embeddings are resized to ``cfg.vit``'s grid (a
    480-px checkpoint loads at 640 px: 30 x 30 -> 40 x 40)."""
    return _load_every_key(sd, lambda: VQAModel(cfg), cfg, resolve_device(device))


def load_caption_state_dict(sd: Mapping[str, object], cfg: BlipConfig,
                            device="cuda") -> CaptionModel:
    """A caption model from a reference-layout state dict (numpy arrays or
    tensors), as ``load_blip_caption`` reads it (``madtp_tpu/models/blip.py:
    329-339``): every key of the model must be there, the codebook included;
    the decoder comes from ``text_decoder.bert.*`` and
    ``text_decoder.cls.predictions.{transform.*, bias}``; the tied exports
    ``cls.predictions.decoder.*``, ``position_ids`` and a pooler are
    ignored; position embeddings are resized to ``cfg.vit``'s grid."""
    return _load_every_key(sd, lambda: CaptionModel(cfg), cfg, resolve_device(device))


def load_clip_state_dict(sd: Mapping[str, object], cfg: CLIPConfig,
                         device="cuda") -> CLIPModel:
    """A CLIP model from a state dict in the reference ``clip/model.py``
    layout (numpy arrays or tensors; fp16 weights are upcast), as
    ``remap_clip`` reads it: a block without ``query_model.q_map.0`` gets a
    zero map, and the codebook ``space_dict`` is taken when present (without
    it the model runs dense only).  Keys the model does not have are
    ignored.  ``cfg`` usually comes from :func:`~madtp_tpu_torch.core.config.
    infer_clip_config`."""
    dev = resolve_device(device)
    sd_num = int(np.shape(sd["space_dict"])[0]) if "space_dict" in sd else 0
    new: Dict[str, torch.Tensor] = {}
    for k in _keys(lambda: CLIPModel(cfg, sd_num)):
        if k in sd:
            new[k] = _tensor(sd[k])
        elif ".query_model.q_map.0." in k:
            width = cfg.vision_width if k.startswith("visual.") else cfg.transformer_width
            new[k] = torch.zeros((cfg.sd_dim, width) if k.endswith("weight") else (cfg.sd_dim,))
        else:
            raise KeyError(f"state dict has no {k}")
    return _make(lambda: CLIPModel(cfg, sd_num), dev, new)


class _JaxTree:
    """Collects reference-named fp32 tensors from JAX param-tree leaves."""

    def __init__(self):
        self.sd: Dict[str, torch.Tensor] = {}

    def lin(self, key, p, i=None):
        k, b = np.asarray(p["kernel"]), np.asarray(p["bias"])
        if i is not None:
            k, b = k[i], b[i]
        self.sd[key + ".weight"] = _tensor(k.T)
        self.sd[key + ".bias"] = _tensor(b)

    def ln(self, key, p, i=None):
        s, b = np.asarray(p["scale"]), np.asarray(p["bias"])
        if i is not None:
            s, b = s[i], b[i]
        self.sd[key + ".weight"] = _tensor(s)
        self.sd[key + ".bias"] = _tensor(b)

    def vit(self, v, cfg: BlipConfig):
        sd, D, p = self.sd, cfg.vit.embed_dim, cfg.vit.patch_size
        sd["visual_encoder.cls_token"] = _tensor(v["cls_token"])
        sd["visual_encoder.pos_embed"] = _tensor(v["pos_embed"])
        sd["visual_encoder.patch_embed.proj.weight"] = _tensor(
            np.asarray(v["patch_embed"]["kernel"]).T.reshape(D, 3, p, p))
        sd["visual_encoder.patch_embed.proj.bias"] = _tensor(v["patch_embed"]["bias"])
        blocks = v["blocks"]
        for i in range(cfg.vit.depth):
            b = f"visual_encoder.blocks.{i}."
            self.ln(b + "norm1", blocks["norm1"], i)
            self.lin(b + "attn.qkv", blocks["attn"]["qkv"], i)
            self.lin(b + "attn.proj", blocks["attn"]["proj"], i)
            self.ln(b + "norm2", blocks["norm2"], i)
            self.lin(b + "mlp.fc1", blocks["mlp"]["fc1"], i)
            self.lin(b + "mlp.fc2", blocks["mlp"]["fc2"], i)
        self.ln("visual_encoder.norm", v["norm"])

    def med(self, t, cfg: BlipConfig, prefix: str = "text_encoder."):
        """A MED under ``prefix`` (``text_decoder.bert.`` for the decoder),
        with twin or single-stream cross-attention."""
        emb = t["embeddings"]
        self.sd[prefix + "embeddings.word_embeddings.weight"] = _tensor(
            emb["word_embeddings"])
        self.sd[prefix + "embeddings.position_embeddings.weight"] = _tensor(
            emb["position_embeddings"])
        self.ln(prefix + "embeddings.LayerNorm", emb["LayerNorm"])
        L = t["layers"]
        for i in range(cfg.med.num_hidden_layers):
            b = f"{prefix}encoder.layer.{i}."
            for nm in ("query", "key", "value"):
                self.lin(b + f"attention.self.{nm}", L["attention"]["self"][nm], i)
            self.lin(b + "attention.output.dense", L["attention"]["output"]["dense"], i)
            self.ln(b + "attention.output.LayerNorm", L["attention"]["output"]["LayerNorm"], i)
            ca, c = L["crossattention"], b + "crossattention."
            streams = ("self0", "self1") if cfg.med.twin_cross else ("self",)
            for s in streams:
                for nm in ("query", "key", "value"):
                    self.lin(c + f"{s}.{nm}", ca[s][nm], i)
            if cfg.med.twin_cross:
                self.lin(c + "output.dense0", ca["output"]["dense0"], i)
                self.lin(c + "output.dense1", ca["output"]["dense1"], i)
                if i >= cfg.med.merge_start_layer:
                    self.lin(c + "output.merge_layer", ca["output"]["merge_layer"], i)
            else:
                self.lin(c + "output.dense", ca["output"]["dense"], i)
            self.ln(c + "output.LayerNorm", ca["output"]["LayerNorm"], i)
            self.lin(b + "intermediate.dense", L["intermediate"]["dense"], i)
            self.lin(b + "output.dense", L["output"]["dense"], i)
            self.ln(b + "output.LayerNorm", L["output"]["LayerNorm"], i)

    def lm_head(self, t, prefix: str = "text_decoder.cls.predictions."):
        """The LM head's transform and output bias (its decoder weight is
        the tied word embeddings)."""
        c = t["cls"]
        self.lin(prefix + "transform.dense", c["transform"]["dense"])
        self.ln(prefix + "transform.LayerNorm", c["transform"]["LayerNorm"])
        self.sd[prefix + "bias"] = _tensor(c["bias"])

    def clip_blocks(self, prefix: str, blocks, depth: int):
        for i in range(depth):
            b = f"{prefix}.resblocks.{i}."
            self.ln(b + "ln_1", blocks["ln_1"], i)
            ip = blocks["attn"]["in_proj"]
            self.sd[b + "attn.in_proj_weight"] = _tensor(np.asarray(ip["kernel"])[i].T)
            self.sd[b + "attn.in_proj_bias"] = _tensor(np.asarray(ip["bias"])[i])
            self.lin(b + "attn.out_proj", blocks["attn"]["out_proj"], i)
            self.ln(b + "ln_2", blocks["ln_2"], i)
            self.lin(b + "mlp.c_fc", blocks["mlp"]["c_fc"], i)
            self.lin(b + "mlp.c_proj", blocks["mlp"]["c_proj"], i)
            self.lin(b + "query_model.q_map.0", blocks["query_model"]["q_map"], i)


def nlvr_from_jax_params(tree: Mapping, cfg: BlipConfig, device="cuda") -> NLVRModel:
    """An NLVR model from the JAX package's param tree (numpy leaves)."""
    dev = resolve_device(device)
    j = _JaxTree()
    j.vit(tree["visual_encoder"], cfg)
    j.med(tree["text_encoder"], cfg)
    j.lin("cls_head.0", tree["cls_head"]["fc1"])
    j.lin("cls_head.2", tree["cls_head"]["fc2"])
    j.sd["space_dict"] = _tensor(tree["space_dict"])
    return _make(lambda: NLVRModel(cfg), dev, j.sd)


def retrieval_from_jax_params(tree: Mapping, cfg: BlipConfig,
                              device="cuda") -> RetrievalModel:
    """A retrieval model from the JAX package's param tree (numpy leaves;
    ``init_blip_params(heads=("retrieval",))`` or ``load_blip_retrieval``'s
    layout).  The projection width comes from ``vision_proj``."""
    dev = resolve_device(device)
    j = _JaxTree()
    j.vit(tree["visual_encoder"], cfg)
    j.med(tree["text_encoder"], cfg)
    for name in ("vision_proj", "text_proj", "itm_head"):
        j.lin(name, tree[name])
    j.sd["space_dict"] = _tensor(tree["space_dict"])
    embed_dim = j.sd["vision_proj.weight"].shape[0]
    return _make(lambda: RetrievalModel(cfg, embed_dim), dev, j.sd)


def vqa_from_jax_params(tree: Mapping, cfg: BlipConfig, device="cuda") -> VQAModel:
    """A VQA model from the JAX package's param tree (numpy leaves;
    ``init_blip_params(heads=(), with_decoder=True)`` or ``load_blip_vqa``'s
    layout: ``visual_encoder``, ``text_encoder``, ``text_decoder`` with its
    ``cls`` head, ``space_dict``).  The decoder's pooler, if any, is not
    read."""
    dev = resolve_device(device)
    j = _JaxTree()
    j.vit(tree["visual_encoder"], cfg)
    j.med(tree["text_encoder"], cfg)
    j.med(tree["text_decoder"], cfg, prefix="text_decoder.bert.")
    j.lm_head(tree["text_decoder"])
    j.sd["space_dict"] = _tensor(tree["space_dict"])
    return _make(lambda: VQAModel(cfg), dev, j.sd)


def caption_from_jax_params(tree: Mapping, cfg: BlipConfig, device="cuda") -> CaptionModel:
    """A caption model from the JAX package's param tree (numpy leaves;
    ``load_blip_caption``'s layout: ``visual_encoder``, ``text_decoder`` with
    its ``cls`` head, ``space_dict``)."""
    dev = resolve_device(device)
    j = _JaxTree()
    j.vit(tree["visual_encoder"], cfg)
    j.med(tree["text_decoder"], cfg, prefix="text_decoder.bert.")
    j.lm_head(tree["text_decoder"])
    j.sd["space_dict"] = _tensor(tree["space_dict"])
    return _make(lambda: CaptionModel(cfg), dev, j.sd)


def clip_from_jax_params(tree: Mapping, cfg: CLIPConfig, space_dict=None,
                         device="cuda") -> CLIPModel:
    """A CLIP model from the JAX package's param tree (numpy leaves;
    ``init_clip_params`` or ``remap_clip``'s layout) and the codebook, which
    the JAX package keeps outside the tree (``None``: a dense-only model)."""
    dev = resolve_device(device)
    j = _JaxTree()
    v = tree["visual"]
    W, p = cfg.vision_width, cfg.vision_patch_size
    j.sd["visual.conv1.weight"] = _tensor(np.asarray(v["conv1"]["kernel"]).T.reshape(W, 3, p, p))
    for name in ("class_embedding", "positional_embedding", "proj"):
        j.sd[f"visual.{name}"] = _tensor(v[name])
    j.ln("visual.ln_pre", v["ln_pre"])
    j.clip_blocks("visual.transformer", v["blocks"], cfg.vision_layers)
    j.ln("visual.ln_post", v["ln_post"])
    j.sd["token_embedding.weight"] = _tensor(tree["token_embedding"])
    for name in ("positional_embedding", "text_projection", "logit_scale"):
        j.sd[name] = _tensor(tree[name])
    j.clip_blocks("transformer", tree["blocks"], cfg.transformer_layers)
    j.ln("ln_final", tree["ln_final"])
    sd_num = 0
    if space_dict is not None:
        j.sd["space_dict"] = _tensor(space_dict)
        sd_num = j.sd["space_dict"].shape[0]
    return _make(lambda: CLIPModel(cfg, sd_num), dev, j.sd)


def _save(model: torch.nn.Module, path: str, epoch: int, temperature: float,
          lm_head: bool = False) -> None:
    """Write ``{"model": state_dict, "epoch", "temperature"}`` with fp32 CPU
    tensors in the reference key layout (``madtp_tpu/ckpt/export.py:121-128``);
    ``lm_head`` adds the decoder's tied exports ``cls.predictions.decoder.*``,
    as ``export_med(has_lm_head=True)`` writes them."""
    sd = {k: v.detach().float().cpu().contiguous() for k, v in model.state_dict().items()}
    if lm_head:
        sd["text_decoder.cls.predictions.decoder.weight"] = \
            sd["text_decoder.bert.embeddings.word_embeddings.weight"].clone()
        sd["text_decoder.cls.predictions.decoder.bias"] = \
            sd["text_decoder.cls.predictions.bias"].clone()
    torch.save({"model": sd, "epoch": int(epoch), "temperature": float(temperature)}, path)


def save_nlvr_checkpoint(model: NLVRModel, path: str, *, epoch: int,
                         temperature: float) -> None:
    """The NLVR checkpoint (:func:`_save`); :func:`load_nlvr_state_dict` and
    the JAX package's ``load_blip_nlvr`` read it back."""
    _save(model, path, epoch, temperature)


def save_caption_checkpoint(model: CaptionModel, path: str, *, epoch: int,
                            temperature: float) -> None:
    """The caption checkpoint (``compress_caption.py:497-507``): the ViT, the
    decoder with its LM head and tied exports, the codebook;
    :func:`load_caption_state_dict` and ``load_blip_caption`` read it back."""
    _save(model, path, epoch, temperature, lm_head=True)


def save_vqa_checkpoint(model: VQAModel, path: str, *, epoch: int,
                        temperature: float) -> None:
    """The VQA checkpoint (``compress_vqa.py:484-497``): the ViT, the
    question encoder, the answer decoder with its LM head and tied exports,
    the codebook; :func:`load_vqa_state_dict` and ``load_blip_vqa`` read it
    back."""
    _save(model, path, epoch, temperature, lm_head=True)


def save_retrieval_checkpoint(model: RetrievalModel, path: str, *, epoch: int,
                              temperature: float) -> None:
    """The retrieval checkpoint (``compress_retrieval.py:492-505``): the
    online towers, the projections, ``itm_head`` and the codebook, and no
    momentum tower, queue or ``temp``, as the JAX driver writes it;
    :func:`load_retrieval_state_dict` and ``load_blip_retrieval`` read it
    back."""
    _save(model, path, epoch, temperature)


def retrieval_train_state_from_jax(params: Mapping, params_m: Mapping, queue, temp,
                                   cfg: BlipConfig, device="cuda"):
    """A :class:`~madtp_tpu_torch.train.loops.RetrievalTrainState` from the
    JAX package's ``RetrievalTrainState`` parts (numpy leaves): ``params``
    through :func:`retrieval_from_jax_params`, the momentum towers
    ``params_m`` (``visual_encoder``, ``text_encoder``, ``vision_proj``,
    ``text_proj``) by the model's parameter names, the ``FeatureQueue``
    (``image``, ``text``, ``idx``, ``ptr``) and ``temp``."""
    dev = resolve_device(device)
    model = retrieval_from_jax_params(params, cfg, device=dev)
    j = _JaxTree()
    j.vit(params_m["visual_encoder"], cfg)
    j.med(params_m["text_encoder"], cfg)
    j.lin("vision_proj", params_m["vision_proj"])
    j.lin("text_proj", params_m["text_proj"])
    names = {n for n, _ in model.named_parameters() if n.split(".", 1)[0] in MOMENTUM_KEYS}
    if set(j.sd) != names:
        raise KeyError(f"momentum towers: {sorted(set(j.sd) ^ names)[:3]} do not match")
    params_m_t = {n: j.sd[n].to(dev) for n, _ in model.named_parameters() if n in names}
    q = FeatureQueue(_tensor(queue.image).to(dev), _tensor(queue.text).to(dev),
                     torch.from_numpy(np.asarray(queue.idx, np.int64)).to(dev),
                     torch.tensor(int(np.asarray(queue.ptr)), dtype=torch.long, device=dev))
    return RetrievalTrainState(model, params_m_t, q,
                               torch.tensor(float(np.asarray(temp)), device=dev))


def save_clip_checkpoint(model: CLIPModel, path: str, *, epoch: int,
                         temperature: float) -> None:
    """The CLIP checkpoint (``compress_retrieval_clip.py:521-531``): the two
    towers in ``export_clip``'s layout with ``logit_scale``, and the
    codebook ``space_dict``; no momentum copy or queue.
    :func:`load_clip_state_dict` and the JAX package's ``load_state_dict``
    + ``remap_clip`` read it back."""
    _save(model, path, epoch, temperature)


def clip_train_state_from_jax(params: Mapping, params_m: Mapping, queue, space_dict,
                              cfg: CLIPConfig, device="cuda"):
    """A :class:`~madtp_tpu_torch.train.loops.ClipTrainState` from the JAX
    package's ``ClipTrainState`` parts (numpy leaves): ``params`` and the
    codebook through :func:`clip_from_jax_params`, the momentum copies
    ``params_m`` (``visual``, ``token_embedding``, ``positional_embedding``,
    ``blocks``, ``ln_final``, ``text_projection``) by the model's parameter
    names, and the ``FeatureQueue`` (``image``, ``text``, ``idx``,
    ``ptr``)."""
    dev = resolve_device(device)
    model = clip_from_jax_params(params, cfg, space_dict, device=dev)
    if set(params_m) != {"visual", "token_embedding", "positional_embedding", "blocks",
                         "ln_final", "text_projection"}:
        raise KeyError(f"momentum copies: {sorted(params_m)}")
    merged = clip_from_jax_params({**params, **params_m}, cfg, None, device="cpu")
    params_m_t = {n: p.detach().to(dev, copy=True) for n, p in merged.named_parameters()
                  if n.split(".", 1)[0] in CLIP_MOMENTUM_KEYS}
    q = FeatureQueue(_tensor(queue.image).to(dev), _tensor(queue.text).to(dev),
                     torch.from_numpy(np.asarray(queue.idx, np.int64)).to(dev),
                     torch.tensor(int(np.asarray(queue.ptr)), dtype=torch.long, device=dev))
    return ClipTrainState(model, params_m_t, q)
