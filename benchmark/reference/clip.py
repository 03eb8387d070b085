"""Plain PyTorch CLIP (Radford et al. 2021, ``clip/model.py``) with MADTP's
pruning in both towers, the benchmark's yardstick for the ``clip-l14-336``
cells, on a state dict in the published checkpoint's names
(``visual.transformer.resblocks.{i}.attn.in_proj_weight``, ...) plus MADTP's
codebook ``space_dict`` and each block's ``query_model.q_map.0``, the
linear that maps the tokens to the codebook's width before the query.

* Vision: patch embedding (no bias), class token, positions, ``ln_pre``;
  each block maps its input tokens and queries the codebook, adds pre-norm
  attention (packed ``in_proj``), prunes (the CLIP rule: a step applies
  only while it keeps more than one token), adds the pre-norm QuickGELU MLP;
  ``ln_post`` of the class token, times ``proj``.  Pruning is physical,
  at most ``capacity - 2`` tokens kept with a capacity.
* Text: token and position embeddings over a buffer of the 77 slots and one
  merge slot per layer, causal over slot indices; pruning masks slots (the
  features are read at the end-of-text slot, the sequence's highest id, as
  the published model reads them), applying only while it keeps more than
  the end-of-text slot + 1 tokens of the batch; ``ln_final`` times
  ``text_projection``.

Both return L2-normalised features and the kept counts per layer.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.dtp import (Signals, attend, codebook_query, prune_masked,
                                     prune_physical, scores_of)

LN_EPS = 1e-5


def _ln(x, W, name):
    return F.layer_norm(x, (x.shape[-1],), W[name + ".weight"], W[name + ".bias"], LN_EPS)


def _quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def _block_attn(W, b, x, heads, **kw):
    width = x.shape[-1]
    qkv = F.linear(_ln(x, W, b + "ln_1"), W[b + "attn.in_proj_weight"],
                   W[b + "attn.in_proj_bias"])
    out, probs, out_h = attend(qkv[..., :width], qkv[..., width:2 * width],
                               qkv[..., 2 * width:], heads, **kw)
    return x + F.linear(out, W[b + "attn.out_proj.weight"], W[b + "attn.out_proj.bias"]), \
        probs, out_h


def _block_mlp(W, b, x):
    h = F.linear(_ln(x, W, b + "ln_2"), W[b + "mlp.c_fc.weight"], W[b + "mlp.c_fc.bias"])
    return x + F.linear(_quick_gelu(h), W[b + "mlp.c_proj.weight"], W[b + "mlp.c_proj.bias"])


def _query(W, b, tokens):
    mapped = F.linear(tokens, W[b + "query_model.q_map.0.weight"],
                      W[b + "query_model.q_map.0.bias"])
    return codebook_query(mapped, W["space_dict"])[0]


def encode_image(W, images, cfg, temperature, capacities=None):
    """``(features [B, E] unit-norm, kept per layer)``."""
    p = "visual."
    ps = cfg["vision_patch_size"]
    x = F.conv2d(images, W[p + "conv1.weight"], stride=ps).flatten(2).transpose(1, 2)
    x = torch.cat([W[p + "class_embedding"].expand(x.shape[0], 1, -1), x], dim=1)
    x = _ln(x + W[p + "positional_embedding"], W, p + "ln_pre")
    heads = cfg["vision_width"] // 64
    slots = -(-x.shape[1] // 8) * 8
    kept = []
    for i in range(cfg["vision_layers"]):
        b = f"{p}transformer.resblocks.{i}."
        token_attn = _query(W, b, x[:, 1:])
        x, probs, out_h = _block_attn(W, b, x, heads)
        cap = None if capacities is None else min(capacities[i], slots)
        x, _, k, _ = prune_physical(x, Signals(*scores_of(probs, out_h), token_attn),
                                    temperature, capacity=cap, variant="clip", max_keep=1)
        slots = slots if cap is None else cap
        kept.append(k)
        x = _block_mlp(W, b, x)
    feat = _ln(x[:, 0], W, p + "ln_post") @ W[p + "proj"]
    return feat / torch.linalg.vector_norm(feat, dim=-1, keepdim=True), kept


def encode_text(W, text, cfg, temperature):
    """``text`` [B, 77] ids, each row's end-of-text the highest id.
    ``(features [B, E] unit-norm, kept per layer)``."""
    B, N = text.shape
    L = cfg["transformer_layers"]
    x = W["token_embedding.weight"][text] + W["positional_embedding"]
    S = N + L
    x = torch.cat([x, x.new_zeros(B, L, x.shape[-1])], dim=1)
    alive = torch.zeros((B, S), dtype=torch.bool, device=x.device)
    alive[:, :N] = True
    ids = torch.arange(S, device=x.device)
    causal = torch.zeros((S, S), dtype=x.dtype, device=x.device).masked_fill(
        ids[None, :] > ids[:, None], float("-inf"))
    eot = text.argmax(dim=-1)
    max_keep = int(eot.max()) + 2
    kept = []
    for i in range(L):
        b = f"transformer.resblocks.{i}."
        # the codebook query over alive slots only
        mapped = F.linear(x[:, 1:], W[b + "query_model.q_map.0.weight"],
                          W[b + "query_model.q_map.0.bias"])
        token_attn = mapped @ W["space_dict"].t()
        x, probs, out_h = _block_attn(W, b, x, cfg["transformer_heads"], key_alive=alive,
                                      attn_bias=causal)
        sig = Signals(*scores_of(probs, out_h, query_alive=alive), token_attn)
        x, alive, k = prune_masked(x, alive, sig, temperature, N + i, variant="clip",
                                   max_keep=max_keep)
        kept.append(k)
        x = _block_mlp(W, b, x)
    feat = _ln(x[torch.arange(B, device=x.device), eot], W, "ln_final") @ W["text_projection"]
    return feat / torch.linalg.vector_norm(feat, dim=-1, keepdim=True), kept
