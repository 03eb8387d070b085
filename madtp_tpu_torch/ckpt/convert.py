"""Weights into the port's NLVR model, from two sources that must give the
same tensors:

* :func:`nlvr_from_jax_params` — the JAX package's NLVR param tree as numpy
  arrays (layers stacked ``[L, ...]``, linear kernels ``[in, out]``);
* :func:`load_nlvr_state_dict` — a state dict in the reference ``.pth`` key
  layout (``madtp_tpu/ckpt/remap.py`` ``remap_vit``, ``remap_med`` with
  ``twin_cross=True``, and ``load_blip_nlvr``'s head and codebook handling).

The reference layout carries ``crossattention.output.merge_layer`` only at
layers >= ``merge_start_layer``, like the port's modules; a base checkpoint
may carry ``self``/``dense`` where the twin layers need ``self0``/``self1`` and
``dense0``/``dense1``, and both twins then start from the same weights.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from madtp_tpu_torch.core.config import BlipConfig
from madtp_tpu_torch.core.device import resolve_device
from madtp_tpu_torch.models.blip import NLVRModel


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
    """A contiguous fp32 copy (the model must not alias the caller's arrays)."""
    return torch.tensor(np.ascontiguousarray(x, dtype=np.float32))


def _reference_key_map(cfg: BlipConfig) -> Dict[str, list]:
    """Model key -> reference keys to try in order (twin fallbacks)."""
    out = {}
    for k in _model_keys(cfg):
        cands = [k]
        for twin, base in ((".self0.", ".self."), (".self1.", ".self."),
                           (".dense0.", ".dense."), (".dense1.", ".dense.")):
            if ".crossattention." in k and twin in k:
                cands.append(k.replace(twin, base))
        out[k] = cands
    return out


def _model_keys(cfg: BlipConfig):
    with torch.device("meta"):
        return list(NLVRModel(cfg).state_dict().keys())


def _load(cfg: BlipConfig, sd: Dict[str, torch.Tensor], dev: torch.device) -> NLVRModel:
    with torch.device("meta"):
        model = NLVRModel(cfg)
    model.load_state_dict(sd, strict=True, assign=True)
    return model.to(dev).eval()


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
    return _load(cfg, new, dev)


def nlvr_from_jax_params(tree: Mapping, cfg: BlipConfig, device="cuda") -> NLVRModel:
    """An NLVR model from the JAX package's param tree (numpy leaves)."""
    dev = resolve_device(device)
    sd: Dict[str, torch.Tensor] = {}

    def lin(key, p, i=None):
        k = np.asarray(p["kernel"]) if i is None else np.asarray(p["kernel"])[i]
        b = np.asarray(p["bias"]) if i is None else np.asarray(p["bias"])[i]
        sd[key + ".weight"] = _tensor(k.T)
        sd[key + ".bias"] = _tensor(b)

    def ln(key, p, i=None):
        s = np.asarray(p["scale"]) if i is None else np.asarray(p["scale"])[i]
        b = np.asarray(p["bias"]) if i is None else np.asarray(p["bias"])[i]
        sd[key + ".weight"] = _tensor(s)
        sd[key + ".bias"] = _tensor(b)

    v = tree["visual_encoder"]
    D, p = cfg.vit.embed_dim, cfg.vit.patch_size
    sd["visual_encoder.cls_token"] = _tensor(v["cls_token"])
    sd["visual_encoder.pos_embed"] = _tensor(v["pos_embed"])
    sd["visual_encoder.patch_embed.proj.weight"] = _tensor(
        np.asarray(v["patch_embed"]["kernel"]).T.reshape(D, 3, p, p))
    sd["visual_encoder.patch_embed.proj.bias"] = _tensor(v["patch_embed"]["bias"])
    blocks = v["blocks"]
    for i in range(cfg.vit.depth):
        b = f"visual_encoder.blocks.{i}."
        ln(b + "norm1", blocks["norm1"], i)
        lin(b + "attn.qkv", blocks["attn"]["qkv"], i)
        lin(b + "attn.proj", blocks["attn"]["proj"], i)
        ln(b + "norm2", blocks["norm2"], i)
        lin(b + "mlp.fc1", blocks["mlp"]["fc1"], i)
        lin(b + "mlp.fc2", blocks["mlp"]["fc2"], i)
    ln("visual_encoder.norm", v["norm"])

    t = tree["text_encoder"]
    emb = t["embeddings"]
    sd["text_encoder.embeddings.word_embeddings.weight"] = _tensor(emb["word_embeddings"])
    sd["text_encoder.embeddings.position_embeddings.weight"] = _tensor(
        emb["position_embeddings"])
    ln("text_encoder.embeddings.LayerNorm", emb["LayerNorm"])
    L = t["layers"]
    for i in range(cfg.med.num_hidden_layers):
        b = f"text_encoder.encoder.layer.{i}."
        for nm in ("query", "key", "value"):
            lin(b + f"attention.self.{nm}", L["attention"]["self"][nm], i)
        lin(b + "attention.output.dense", L["attention"]["output"]["dense"], i)
        ln(b + "attention.output.LayerNorm", L["attention"]["output"]["LayerNorm"], i)
        ca = L["crossattention"]
        for s in ("self0", "self1"):
            for nm in ("query", "key", "value"):
                lin(b + f"crossattention.{s}.{nm}", ca[s][nm], i)
        lin(b + "crossattention.output.dense0", ca["output"]["dense0"], i)
        lin(b + "crossattention.output.dense1", ca["output"]["dense1"], i)
        if i >= cfg.med.merge_start_layer:
            lin(b + "crossattention.output.merge_layer", ca["output"]["merge_layer"], i)
        ln(b + "crossattention.output.LayerNorm", ca["output"]["LayerNorm"], i)
        lin(b + "intermediate.dense", L["intermediate"]["dense"], i)
        lin(b + "output.dense", L["output"]["dense"], i)
        ln(b + "output.LayerNorm", L["output"]["LayerNorm"], i)

    lin("cls_head.0", tree["cls_head"]["fc1"])
    lin("cls_head.2", tree["cls_head"]["fc2"])
    sd["space_dict"] = _tensor(tree["space_dict"])
    return _load(cfg, sd, dev)
