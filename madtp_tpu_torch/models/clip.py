"""CLIP dual-tower encoders with per-layer DTP
(counterpart of ``madtp_tpu/models/clip.py:44-343``), the ViT visual tower.

Parameter names follow the reference ``clip/model.py`` state dict
(``visual.conv1``, ``visual.transformer.resblocks.{i}.attn.in_proj_weight``,
``transformer.resblocks.{i}.query_model.q_map.0``, ``ln_final``, ...), so a
reference state dict loads by name.  The model computes in the dtype of its
weights.

* Each block runs the MAG query through its own ``q_map`` (width -> sd_dim),
  then LN -> packed in_proj -> attention -> DTP -> LN -> QuickGELU FFN, with
  ``LN_EPS`` 1e-5 (reference ``clip/model.py:174-261``).
* DTP variant ``"clip"``: a step applies only while it keeps more than
  ``max_keep`` tokens: 1 in the vision tower, ``max(eot_pos) + 2`` (a device
  tensor) in the text tower, which keeps the EOT token alive.
* Vision, mask mode: 577 tokens and 24 merge slots in a buffer padded to 8
  (608 slots), the merge slot of layer ``i`` at ``1 + P0 + i``; gather mode
  (``capacities``): 577 tokens padded to 584, compacted after each layer's
  decision.  The scoring attention goes to K1.
* Text, mask mode only: 77 tokens and 12 merge slots padded to 96, a causal
  bias over slot indices (merge slots included), features read at the
  *original* EOT slot.  Its causal scoring attention runs on the plain
  attention core, on the card too: K1 has no causal mask, and the JAX
  package's ``attention_core`` also leaves the fused path whenever an
  ``attn_bias`` is given.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import torch
from torch import nn

from madtp_tpu_torch.core.config import CLIPConfig
from madtp_tpu_torch.core.device import resolve_device
from madtp_tpu_torch.ops.attention import AttnAux, attention_core, multi_head_attention
from madtp_tpu_torch.ops.layers import layer_norm, linear, mlp, normalize_images, patch_embed
from madtp_tpu_torch.prune.dtp import (DTPSignals, TokenState, dtp_prune, dtp_prune_gather,
                                       init_token_state)
from madtp_tpu_torch.prune.query import query_model

LN_EPS = 1e-5  # torch nn.LayerNorm's default, CLIP's


class TowerOut(NamedTuple):
    features: torch.Tensor  # [B, E] projected, not normalized, in the model's dtype
    sd_ft: Optional[torch.Tensor]  # [B, K, sd_dim] MAG features summed over layers
    kept_counts: torch.Tensor  # [L]


class _InProj(nn.Module):
    """``nn.MultiheadAttention``'s parameter names: packed ``in_proj`` and
    ``out_proj``."""

    def __init__(self, width: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = nn.Linear(width, width)


class _Mlp(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.c_fc = nn.Linear(width, 4 * width)
        self.c_proj = nn.Linear(4 * width, width)


class _QueryModel(nn.Module):
    def __init__(self, width: int, sd_dim: int):
        super().__init__()
        self.q_map = nn.Sequential(nn.Linear(width, sd_dim))


class ResidualAttentionBlock(nn.Module):
    """MAG query -> x += attn(ln_1(x)) -> (DTP, done by the tower) ->
    x += mlp(ln_2(x))."""

    def __init__(self, width: int, heads: int, sd_dim: int):
        super().__init__()
        self.heads = heads
        self.attn = _InProj(width)
        self.ln_1 = nn.LayerNorm(width, eps=LN_EPS)
        self.mlp = _Mlp(width)
        self.ln_2 = nn.LayerNorm(width, eps=LN_EPS)
        self.query_model = _QueryModel(width, sd_dim)

    def attn_part(self, state: TokenState, causal_bias: Optional[torch.Tensor],
                  need_scores: bool):
        x, alive, bias = state
        W = x.shape[-1]
        packed = linear(layer_norm(x, self.ln_1.weight, self.ln_1.bias, LN_EPS),
                        self.attn.in_proj_weight, self.attn.in_proj_bias)
        q, k, v = packed[..., :W], packed[..., W:2 * W], packed[..., 2 * W:]
        if causal_bias is None:
            out, aux = multi_head_attention(q, k, v, self.heads, key_alive=alive,
                                            need_scores=need_scores)
        else:
            qh, kh, vh = (t.unflatten(-1, (self.heads, W // self.heads)).transpose(1, 2)
                          for t in (q, k, v))
            out, aux = attention_core(qh, kh, vh, attn_bias=causal_bias, key_alive=alive,
                                      query_alive=alive, need_scores=need_scores)
        h = linear(out, self.attn.out_proj.weight, self.attn.out_proj.bias)
        return TokenState(x + h, alive, bias), aux

    def ffn_part(self, state: TokenState) -> TokenState:
        x, alive, bias = state
        h = mlp(layer_norm(x, self.ln_2.weight, self.ln_2.bias, LN_EPS),
                self.mlp.c_fc, self.mlp.c_proj, act="quick_gelu")
        return TokenState(x + h, alive, bias)


class _Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int, sd_dim: int):
        super().__init__()
        self.resblocks = nn.ModuleList(ResidualAttentionBlock(width, heads, sd_dim)
                                       for _ in range(layers))


class _Visual(nn.Module):
    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        W, p = cfg.vision_width, cfg.vision_patch_size
        self.conv1 = nn.Conv2d(3, W, p, p, bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(W))
        self.positional_embedding = nn.Parameter(torch.zeros(cfg.vision_num_patches + 1, W))
        self.ln_pre = nn.LayerNorm(W, eps=LN_EPS)
        self.transformer = _Transformer(W, cfg.vision_layers, cfg.vision_heads, cfg.sd_dim)
        self.ln_post = nn.LayerNorm(W, eps=LN_EPS)
        self.proj = nn.Parameter(torch.zeros(W, cfg.embed_dim))


class CLIPModel(nn.Module):
    """CLIP's two towers and, with ``sd_num`` > 0, the FDT codebook
    ``space_dict`` [sd_num, sd_dim] that pruning needs (a model without one
    runs dense only, as the JAX package's CLI does for a checkpoint without it)."""

    def __init__(self, cfg: CLIPConfig, sd_num: int = 100):
        super().__init__()
        self.cfg = cfg
        TW = cfg.transformer_width
        self.visual = _Visual(cfg)
        self.token_embedding = nn.Embedding(cfg.vocab_size, TW)
        self.positional_embedding = nn.Parameter(torch.zeros(cfg.context_length, TW))
        self.transformer = _Transformer(TW, cfg.transformer_layers, cfg.transformer_heads,
                                        cfg.sd_dim)
        self.ln_final = nn.LayerNorm(TW, eps=LN_EPS)
        self.text_projection = nn.Parameter(torch.zeros(TW, cfg.embed_dim))
        self.logit_scale = nn.Parameter(torch.zeros(()))
        self.space_dict = (nn.Parameter(torch.zeros(sd_num, cfg.sd_dim)) if sd_num > 0
                           else None)

    def encode_image(self, images: torch.Tensor, *, temperature=0.0,
                     prune_active: bool = False,
                     capacities: Optional[Sequence[int]] = None) -> TowerOut:
        """Vision tower (``clip_encode_image``).  ``images`` [B, 3, H, W]
        floats, or the uint8 feed [B, H, W, 3] normalized here.
        ``prune_active`` must be True exactly when the temperature is > 0;
        ``capacities`` (one per layer) switches to gather mode."""
        v = self.visual
        dtype = v.positional_embedding.dtype
        if images.dtype == torch.uint8:
            images = normalize_images(images, dtype)
        x = patch_embed(images.to(dtype), v.conv1.weight, None)
        cls = v.class_embedding.expand(x.shape[0], 1, x.shape[-1])
        x = torch.cat([cls, x], dim=1) + v.positional_embedding
        x = layer_norm(x, v.ln_pre.weight, v.ln_pre.bias, LN_EPS)
        blocks = v.transformer.resblocks
        if capacities is not None and prune_active:
            state, sd_all, kept = self._tower_gather(blocks, x, temperature, capacities)
        else:
            state, sd_all, kept = self._tower(blocks, x, temperature, prune_active,
                                              causal=False, max_keep=1)
        feats = layer_norm(state.x[:, 0, :], v.ln_post.weight, v.ln_post.bias, LN_EPS)
        return TowerOut(linear(feats, v.proj.t()), sd_all, kept)

    def encode_text(self, text: torch.Tensor, *, temperature=0.0,
                    prune_active: bool = False) -> TowerOut:
        """Text tower (``clip_encode_text``).  ``text`` [B, context_length]
        token ids, EOT the highest id of each row."""
        x = self.token_embedding.weight[text] + self.positional_embedding
        eot_pos = text.argmax(dim=-1)
        max_keep = eot_pos.max() + 2  # the reference's batch-coupled EOT guard
        state, sd_all, kept = self._tower(self.transformer.resblocks, x, temperature,
                                          prune_active, causal=True, max_keep=max_keep)
        feats = state.x[torch.arange(x.shape[0], device=x.device), eot_pos]
        feats = layer_norm(feats, self.ln_final.weight, self.ln_final.bias, LN_EPS)
        return TowerOut(linear(feats, self.text_projection.t()), sd_all, kept)

    def _query(self, blk: ResidualAttentionBlock, state: TokenState, prune_active: bool):
        if self.space_dict is None:
            if prune_active:
                raise ValueError("pruning needs the codebook: this model has no space_dict")
            return None, None
        return query_model(state.x[:, 1:], self.space_dict, state.alive[:, 1:],
                           q_map=blk.query_model.q_map[0])

    def _tower(self, blocks, x, temperature, prune_active: bool, *, causal: bool, max_keep):
        """Mask mode (``_tower``): ``1 + P0 + depth`` slots padded to 8 when
        pruning.  Returns ``(state, sd_all, kept [L])``."""
        B, N, _ = x.shape
        depth = len(blocks)
        state = init_token_state(x, depth=depth if prune_active else 0,
                                 pad_to=8 if prune_active else 1)
        causal_bias = None
        if causal:
            S = state.x.shape[1]
            ids = torch.arange(S, device=x.device)
            causal_bias = torch.zeros((S, S), device=x.device).masked_fill(
                ids[None, :] > ids[:, None], float("-inf"))[None, None]
        sd_all, kept_list = None, []
        for i, blk in enumerate(blocks):
            token_attn, sd_ft = self._query(blk, state, prune_active)
            if sd_ft is not None:
                sd_all = sd_ft.float() if sd_all is None else sd_all + sd_ft
            state, aux = blk.attn_part(state, causal_bias, need_scores=prune_active)
            kept = state.alive[0, 1:].sum()
            if prune_active:
                state, kept = dtp_prune(state, _signals(aux, token_attn), temperature,
                                        N + i, variant="clip", max_keep=max_keep)
            state = blk.ffn_part(state)
            kept_list.append(kept)
        return state, sd_all, torch.stack(kept_list)

    def _tower_gather(self, blocks, x, temperature, capacities):
        """Gather mode (``_tower_gather``), vision only: 1 + P0 tokens padded
        to 8 slots, compacted to ``capacities[i]`` after layer ``i``."""
        if len(capacities) != len(blocks):
            raise ValueError(f"{len(capacities)} capacities for {len(blocks)} layers")
        state = init_token_state(x, depth=0, pad_to=8)
        sd_all, kept_list = None, []
        for i, blk in enumerate(blocks):
            token_attn, sd_ft = self._query(blk, state, True)
            sd_all = sd_ft.float() if sd_all is None else sd_all + sd_ft
            state, aux = blk.attn_part(state, None, need_scores=True)
            cap = min(capacities[i], state.x.shape[1])
            state, kept, _ = dtp_prune_gather(state, _signals(aux, token_attn), temperature,
                                              cap, variant="clip", max_keep=1)
            state = blk.ffn_part(state)
            kept_list.append(kept)
        return state, sd_all, torch.stack(kept_list)


def _signals(aux: AttnAux, token_attn: torch.Tensor) -> DTPSignals:
    return DTPSignals(cls_attn=aux.cls_attn, col_mass=aux.col_mass, token_attn=token_attn)


def init_clip_model(cfg: CLIPConfig, seed: int = 0, device="cuda", dtype=torch.float32,
                    sd_num: int = 100) -> CLIPModel:
    """A CLIP model with seeded random weights, drawn from a
    ``torch.Generator`` on the CPU so every device gets the same ones, at the
    scales of ``init_clip_params``: linears N(0, 1/fan_in), biases 0,
    LayerNorms 1; ``conv1`` and the token embedding N(0, 0.02^2), the text
    position embedding N(0, 0.01^2); the class and vision position embeddings
    and both projections N(0, 1/width); ``logit_scale`` log(1/0.07); the
    codebook N(0, 1)."""
    dev = resolve_device(device)
    model = CLIPModel(cfg, sd_num)
    g = torch.Generator().manual_seed(seed)
    norms = {id(m.weight) for m in model.modules() if isinstance(m, nn.LayerNorm)}
    scales = {"visual.conv1.weight": 0.02, "token_embedding.weight": 0.02,
              "positional_embedding": 0.01, "space_dict": 1.0,
              "visual.class_embedding": cfg.vision_width ** -0.5,
              "visual.positional_embedding": cfg.vision_width ** -0.5,
              "visual.proj": cfg.vision_width ** -0.5,
              "text_projection": cfg.transformer_width ** -0.5}
    with torch.no_grad():
        for name, p in model.named_parameters():
            if id(p) in norms:
                p.fill_(1.0)
            elif name.endswith("bias"):
                p.zero_()
            elif name == "logit_scale":
                p.fill_(math.log(1.0 / 0.07))
            else:
                scale = scales.get(name, p.shape[-1] ** -0.5 if p.dim() == 2 else None)
                if scale is None:
                    raise AssertionError(f"no init rule for {name}")
                p.copy_(torch.randn(p.shape, generator=g) * scale)
    return model.to(device=dev, dtype=dtype).eval()
