"""Plain PyTorch BLIP-NLVR2 with MADTP, the benchmark's yardstick for the
``blip-nlvr-b16-384`` cells.  Written from BLIP (Li et al. 2022;
``models/blip_nlvr.py``, ``models/vit.py``, ``models/med.py``) and MADTP's
pruning (:mod:`dtp`), on a state dict in the published checkpoint's names
(``visual_encoder.blocks.{i}.attn.qkv.weight``,
``text_encoder.encoder.layer.{i}.crossattention.self0.query.weight``, ...).

* ViT: patch embedding, CLS and positions; each block queries the codebook
  with its input tokens, adds pre-norm attention, prunes, adds the pre-norm
  GELU MLP; a final LayerNorm.
* MED (BERT-base): embeddings and LayerNorm; each layer queries the codebook,
  runs post-norm self-attention with the padding as an additive -10000,
  prunes, attends to both images (their two outputs averaged below
  ``merge_start_layer``, concatenated through ``merge_layer`` from it on),
  post-norm GELU MLP.  Slot 0 carries the [ENC] token.
* Head: ReLU MLP on the multimodal CLS; the loss is the cross-entropy plus
  0.1 x the FDT alignment loss (1 - cosine between the pair's averaged image
  codebook features and the text's, summed over layers).

Pruning is physical (:func:`dtp.prune_physical`); with capacities a layer
keeps at most ``capacity - 2`` tokens, as the gather schedule allows.  No
batching tricks and no kernels: the attention probabilities are formed in
full.  Departures from the published code: none in the mathematics; the
buffer a capacity clamps is the one a schedule of capacities implies (577
tokens padded to 584 slots, then the previous layer's capacity).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from benchmark.reference.dtp import Signals, attend, codebook_query, prune_physical, scores_of

PAD_BIAS = -10000.0


class NLVRRef(NamedTuple):
    logits: torch.Tensor  # [B, 2]
    v_kept: list
    t_kept: list
    overflow: int
    sd_img: torch.Tensor  # [2B, K, D] codebook features summed over the ViT's layers
    sd_txt: torch.Tensor  # [B, K, D]


def _lin(x, W, name, bias=True):
    return F.linear(x, W[name + ".weight"], W.get(name + ".bias") if bias else None)


def _ln(x, W, name, eps):
    return F.layer_norm(x, (x.shape[-1],), W[name + ".weight"], W[name + ".bias"], eps)


def vit(W, images, cfg, temperature, capacities: Optional[Sequence[int]]):
    """The image tower: ``(x [B, n, D], kept per layer, overflow, sd_ft)``."""
    p = "visual_encoder."
    ps = cfg["patch_size"]
    x = F.conv2d(images, W[p + "patch_embed.proj.weight"], W[p + "patch_embed.proj.bias"],
                 stride=ps).flatten(2).transpose(1, 2)
    x = torch.cat([W[p + "cls_token"].expand(x.shape[0], 1, -1), x], dim=1)
    x = x + W[p + "pos_embed"][:, :x.shape[1]]
    eps, heads, D = cfg["layer_norm_eps"], cfg["num_heads"], cfg["embed_dim"]
    slots = -(-x.shape[1] // 8) * 8
    sd_all, kept, overflow = 0.0, [], 0
    for i in range(cfg["depth"]):
        b = f"{p}blocks.{i}."
        token_attn, sd_ft = codebook_query(x[:, 1:], W["space_dict"])
        sd_all = sd_all + sd_ft
        qkv = _lin(_ln(x, W, b + "norm1", eps), W, b + "attn.qkv")
        out, probs, out_h = attend(qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:], heads)
        x = x + _lin(out, W, b + "attn.proj")
        cap = None if capacities is None else min(capacities[i], slots)
        x, _, k, ovf = prune_physical(x, Signals(*scores_of(probs, out_h), token_attn),
                                      temperature, capacity=cap)
        slots = slots if cap is None else cap
        kept.append(k)
        overflow += ovf
        h = _lin(F.gelu(_lin(_ln(x, W, b + "norm2", eps), W, b + "mlp.fc1")), W, b + "mlp.fc2")
        x = x + h
    return _ln(x, W, p + "norm", eps), kept, overflow, sd_all


def med(W, ids, mask, enc0, enc1, cfg, temperature, capacities: Optional[Sequence[int]]):
    """The twin-cross text encoder over the two images' states:
    ``(x, kept per layer, overflow, sd_ft)``."""
    p = "text_encoder."
    eps, heads = cfg["layer_norm_eps"], cfg["num_attention_heads"]
    N = ids.shape[1]
    x = W[p + "embeddings.word_embeddings.weight"][ids]
    x = x + W[p + "embeddings.position_embeddings.weight"][:N][None]
    x = _ln(x, W, p + "embeddings.LayerNorm", eps)
    bias = (1.0 - mask.to(x.dtype)) * PAD_BIAS
    slots = N
    sd_all, kept, overflow = 0.0, [], 0
    for i in range(cfg["num_hidden_layers"]):
        b = f"{p}encoder.layer.{i}."
        token_attn, sd_ft = codebook_query(x[:, 1:], W["space_dict"])
        sd_all = sd_all + sd_ft
        sa = b + "attention.self."
        out, probs, out_h = attend(_lin(x, W, sa + "query"), _lin(x, W, sa + "key"),
                                   _lin(x, W, sa + "value"), heads, key_bias=bias)
        x = _ln(_lin(out, W, b + "attention.output.dense") + x, W,
                b + "attention.output.LayerNorm", eps)
        cap = None if capacities is None else min(capacities[i], slots)
        x, bias, k, ovf = prune_physical(x, Signals(*scores_of(probs, out_h), token_attn),
                                         temperature, capacity=cap, bias=bias)
        slots = slots if cap is None else cap
        kept.append(k)
        overflow += ovf
        c = b + "crossattention."
        h = []
        for j, enc in enumerate((enc0, enc1)):
            s = f"{c}self{j}."
            o, _, _ = attend(_lin(x, W, s + "query"), _lin(enc, W, s + "key"),
                             _lin(enc, W, s + "value"), heads)
            h.append(_lin(o, W, f"{c}output.dense{j}"))
        if i >= cfg["merge_start_layer"]:
            hh = _lin(torch.cat(h, dim=-1), W, c + "output.merge_layer")
        else:
            hh = (h[0] + h[1]) / 2.0
        x = _ln(hh + x, W, c + "output.LayerNorm", eps)
        f = _lin(F.gelu(_lin(x, W, b + "intermediate.dense")), W, b + "output.dense")
        x = _ln(f + x, W, b + "output.LayerNorm", eps)
    return x, kept, overflow, sd_all


def forward(W, images, ids, mask, cfg, temperature, capacities_v=None,
            capacities_t=None) -> NLVRRef:
    """``images`` [2B, 3, H, W]: the pairs' first images, then their second;
    ``ids`` [B, N] with [ENC] at slot 0, ``mask`` [B, N]."""
    B = ids.shape[0]
    v, v_kept, v_ovf, sd_img = vit(W, images, cfg["vit"], temperature, capacities_v)
    t, t_kept, t_ovf, sd_txt = med(W, ids, mask, v[:B], v[B:], cfg["med"], temperature,
                                   capacities_t)
    h = torch.relu(_lin(t[:, 0], W, "cls_head.0"))
    return NLVRRef(_lin(h, W, "cls_head.2"), v_kept, t_kept, v_ovf + t_ovf, sd_img, sd_txt)


def losses(W, images, ids, mask, targets, cfg, temperature, capacities_v=None,
           capacities_t=None):
    """``(loss, loss_ori, loss_fdt)``: the pairs' mean cross-entropy and the
    FDT alignment loss, the total weighting the latter by 0.1."""
    out = forward(W, images, ids, mask, cfg, temperature, capacities_v, capacities_t)
    B = ids.shape[0]
    loss_ori = F.cross_entropy(out.logits, targets)
    sd_dim = W["space_dict"].shape[-1]
    img = (out.sd_img[:B] + out.sd_img[B:]) / 2.0
    a = img / (torch.linalg.vector_norm(img, dim=-1, keepdim=True) + 1e-10)
    t = out.sd_txt / (torch.linalg.vector_norm(out.sd_txt, dim=-1, keepdim=True) + 1e-10)
    a, t = a.reshape(-1, sd_dim), t.reshape(-1, sd_dim)
    cos = (a * t).sum(-1) / torch.clamp_min(
        torch.linalg.vector_norm(a, dim=-1) * torch.linalg.vector_norm(t, dim=-1), 1e-8)
    loss_fdt = (1.0 - cos).mean()
    return loss_ori + 0.1 * loss_fdt, loss_ori, loss_fdt
