"""BLIP ViT image encoder with per-layer DTP
(counterpart of ``madtp_tpu/models/vit.py:33-275``).

Parameter names follow the timm layout of the reference ``.pth`` files
(``patch_embed.proj``, ``blocks.{i}.attn.qkv``, ...), so a reference state
dict loads by name.  The modules hold the weights; the math runs through the
plain functions of :mod:`madtp_tpu_torch.ops` and :mod:`madtp_tpu_torch.prune`
in the dtype of the weights.

* mask mode: a buffer of ``1 + P0 + depth`` slots padded to 8, the merge slot
  of layer ``i`` at ``1 + P0 + i``;
* gather mode (``capacities``): the 577 tokens padded to 584, compacted after
  each layer's DTP decision to that layer's capacity.

With ``ViTConfig.grad_checkpoint`` the last ``ckpt_layers`` blocks of the
mask-mode path (all of them when ``ckpt_layers < 0``) are recomputed in the
backward pass (``madtp_tpu/models/vit.py:178-198``).  The recompute takes
the same DTP decisions only because K1 is deterministic (fixed-order sums, no
float atomics); it launches K1 once more per recomputed block.

Stochastic depth (``dropout_key``, the training recipe): layer ``i`` drops
each residual branch of a row with probability ``drop_path_rate * i /
max(depth - 1, 1)`` (fp32), from streams of its own, as ``fold_in(rng, i)``
gives one in JAX (``madtp_tpu/models/vit.py:33-52,152-158``).  The gather
path takes no key, as ``vit_forward`` passes none to ``_vit_forward_gather``.
Under amp the drop-path's fp32 division promotes the residual stream to fp32
from the first block's attention on (:func:`~madtp_tpu_torch.ops.layers.
drop_path`): the rest of the tower computes in fp32 over its bf16 weights, as
the JAX package computes it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from madtp_tpu_torch.core.config import ViTConfig
from madtp_tpu_torch.ops.attention import AttnAux, self_attention
from madtp_tpu_torch.ops.layers import (drop_path, fold_in, layer_norm, mlp, normalize_images,
                                        patch_embed, stream)
from madtp_tpu_torch.prune.dtp import (DTPSignals, TokenState, dtp_prune,
                                       dtp_prune_gather, init_token_state)
from madtp_tpu_torch.prune.query import query_model


class EncoderOut(NamedTuple):
    state: TokenState  # final hidden states
    sd_ft: Optional[torch.Tensor]  # [B, K, sd_dim] MAG features summed over layers
    kept_counts: torch.Tensor  # [L], or [L, B] when row-independent
    overflow: Optional[torch.Tensor]  # gather mode: tokens folded into merge slots, summed


class PatchEmbed(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.proj = nn.Conv2d(3, cfg.embed_dim, cfg.patch_size, cfg.patch_size)


class Attention(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class Block(nn.Module):
    """attn -> (DTP, done by the caller) -> FFN."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        D = cfg.embed_dim
        self.num_heads = cfg.num_heads
        self.eps = cfg.layer_norm_eps
        self.norm1 = nn.LayerNorm(D, eps=cfg.layer_norm_eps)
        self.attn = Attention(D)
        self.norm2 = nn.LayerNorm(D, eps=cfg.layer_norm_eps)
        self.mlp = Mlp(D, int(D * cfg.mlp_ratio))

    def attn_part(self, state: TokenState, need_scores: bool, drop=None):
        """``drop``: ``(rate, generator)`` of the branch's drop-path, or None."""
        x, alive, bias = state
        h, aux = self_attention(
            layer_norm(x, self.norm1.weight, self.norm1.bias, self.eps),
            self.attn.qkv, self.attn.proj, self.num_heads,
            key_alive=alive, need_scores=need_scores)
        if drop is not None:
            h = drop_path(h, *drop)
        return TokenState(x + h, alive, bias), aux

    def ffn_part(self, state: TokenState, drop=None) -> TokenState:
        x, alive, bias = state
        h = mlp(layer_norm(x, self.norm2.weight, self.norm2.bias, self.eps),
                self.mlp.fc1, self.mlp.fc2)
        if drop is not None:
            h = drop_path(h, *drop)
        return TokenState(x + h, alive, bias)


class VisionTransformer(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        D = cfg.embed_dim
        self.patch_embed = PatchEmbed(cfg)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, D))
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.num_patches + 1, D))
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.depth))
        self.norm = nn.LayerNorm(D, eps=cfg.layer_norm_eps)

    def embed(self, images: torch.Tensor) -> torch.Tensor:
        """Patch tokens with CLS and position embeddings, [B, 1+P0, D].
        ``images`` [B, 3, H, W] floats, or the uint8 feed [B, H, W, 3]
        normalized here (``madtp_tpu/models/vit.py:119-124``)."""
        dtype = self.pos_embed.dtype
        if images.dtype == torch.uint8:
            images = normalize_images(images, dtype)
        x = patch_embed(images.to(dtype), self.patch_embed.proj.weight,
                        self.patch_embed.proj.bias)
        cls = self.cls_token.expand(x.shape[0], 1, x.shape[-1])
        x = torch.cat([cls, x], dim=1)
        return x + self.pos_embed[:, :x.shape[1]]

    def forward(self, images: torch.Tensor, space_dict: Optional[torch.Tensor] = None,
                temperature=0.0, prune_active: bool = False,
                capacities: Optional[Sequence[int]] = None,
                row_independent: bool = False,
                dropout_key: Optional[int] = None) -> EncoderOut:
        """``prune_active`` must be True exactly when the temperature is > 0;
        ``capacities`` (one per layer) switches to gather mode.
        ``row_independent`` (serving): each row keeps its own count, so its
        result does not depend on the other rows, and ``kept_counts`` is
        per row, ``[L, B]`` (``madtp_tpu/models/vit.py:101-108``).
        ``dropout_key`` (training, mask mode and dense): stochastic depth
        from that key's streams."""
        x = self.embed(images)
        if capacities is not None and prune_active:
            return self._forward_gather(x, space_dict, temperature, capacities,
                                        row_independent)
        B = x.shape[0]
        P0 = x.shape[1] - 1
        depth = self.cfg.depth
        state = init_token_state(x, depth=depth if prune_active else 0,
                                 pad_to=8 if prune_active else 1)
        sd_all = None if space_dict is None else _zeros_sd(B, space_dict)
        first_remat = depth - self.remat_layers() if torch.is_grad_enabled() else depth
        kept_list = []
        for i, blk in enumerate(self.blocks):
            args = (blk, state, sd_all, space_dict, temperature, prune_active, 1 + P0 + i,
                    row_independent, self._drop(dropout_key, i))
            if i >= first_remat:
                state, sd_all, kept = checkpoint(_mask_layer, *args, use_reentrant=False)
            else:
                state, sd_all, kept = _mask_layer(*args)
            kept_list.append(kept)
        return EncoderOut(self._final_norm(state), sd_all,
                          torch.stack(kept_list), None)

    def _drop(self, key: Optional[int], i: int):
        """Layer ``i``'s drop-path: ``(rate, key)``, or None without a key."""
        if key is None:
            return None
        depth = self.cfg.depth
        rate = torch.tensor(self.cfg.drop_path_rate, dtype=torch.float32) * i / max(depth - 1, 1)
        return rate, fold_in(key, i)

    def remat_layers(self) -> int:
        """How many of the last blocks the mask-mode path recomputes."""
        if not self.cfg.grad_checkpoint:
            return 0
        depth = self.cfg.depth
        return depth if self.cfg.ckpt_layers < 0 else min(self.cfg.ckpt_layers, depth)

    def _forward_gather(self, x, space_dict, temperature, capacities,
                        row_independent: bool = False) -> EncoderOut:
        if len(capacities) != self.cfg.depth:
            raise ValueError(f"{len(capacities)} capacities for {self.cfg.depth} layers")
        # 1 + 576 tokens padded to 584 slots, like the JAX gather path
        state = init_token_state(x, depth=0, pad_to=8)
        sd_all = _zeros_sd(x.shape[0], space_dict)
        kept_list, overflow = [], 0
        for i, blk in enumerate(self.blocks):
            token_attn, sd_ft = query_model(state.x[:, 1:], space_dict,
                                            state.alive[:, 1:])
            sd_all = sd_all + sd_ft
            state, aux = blk.attn_part(state, need_scores=True)
            cap = min(capacities[i], state.x.shape[1])
            state, kept, ovf = dtp_prune_gather(
                state, _signals(aux, token_attn), temperature, cap,
                row_independent=row_independent)
            state = blk.ffn_part(state)
            kept_list.append(kept)
            overflow = overflow + ovf
        return EncoderOut(self._final_norm(state), sd_all,
                          torch.stack(kept_list), overflow)

    def _final_norm(self, state: TokenState) -> TokenState:
        x = layer_norm(state.x, self.norm.weight, self.norm.bias,
                       self.cfg.layer_norm_eps)
        return TokenState(x, state.alive, state.bias)


def _mask_layer(blk: Block, state: TokenState, sd_all, space_dict, temperature,
                prune_active: bool, merge_slot: int, row_independent: bool = False,
                drop=None):
    """One mask-mode layer: MAG query, attention, DTP into ``merge_slot``,
    FFN.  Returns ``(state, sd_all, kept)``, ``kept`` per row with
    ``row_independent``.  ``drop``: the layer's ``(rate, key)``; its two
    branches draw from the streams of the key's two halves."""
    token_attn = None
    if space_dict is not None:
        token_attn, sd_ft = query_model(state.x[:, 1:], space_dict, state.alive[:, 1:])
        sd_all = sd_all + sd_ft
    d1 = d2 = None
    if drop is not None:
        rate, key = drop
        dev = state.x.device
        d1, d2 = ((rate, stream(fold_in(key, j), dev)) for j in (0, 1))
    state, aux = blk.attn_part(state, need_scores=prune_active, drop=d1)
    kept = placeholder_kept(state.alive, row_independent)
    if prune_active:
        state, kept = dtp_prune(state, _signals(aux, token_attn), temperature, merge_slot,
                                row_independent=row_independent)
    return blk.ffn_part(state, drop=d2), sd_all, kept


def placeholder_kept(alive: torch.Tensor, row_independent: bool) -> torch.Tensor:
    """A layer's kept count when it does not prune: the alive non-CLS slots
    of row 0, or of each row with ``row_independent``."""
    return alive[:, 1:].sum(dim=1) if row_independent else alive[0, 1:].sum()


def _zeros_sd(B: int, space_dict: torch.Tensor) -> torch.Tensor:
    return torch.zeros((B,) + tuple(space_dict.shape), dtype=torch.float32,
                       device=space_dict.device)


def _signals(aux: AttnAux, token_attn: torch.Tensor) -> DTPSignals:
    return DTPSignals(cls_attn=aux.cls_attn, col_mass=aux.col_mass,
                      token_attn=token_attn)
