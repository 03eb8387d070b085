"""MED: the BERT-style text / multimodal encoder with DTP
(counterpart of ``madtp_tpu/models/med.py:40-320``).

Parameter names follow the reference BERT layout (``embeddings``,
``encoder.layer.{i}.attention.self.query``, ``crossattention.self0``, ...).
Text padding rides along as the finite key bias ``PAD_BIAS`` so padded tokens
score as in the reference, while pruned slots are masked exactly.  With twin
cross-attention (NLVR) the two image streams are averaged below
``merge_start_layer`` and concatenated through ``merge_layer`` from it on; as
in the reference, ``merge_layer`` exists only at those layers.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from madtp_tpu_torch.core.config import MedConfig
from madtp_tpu_torch.models.vit import EncoderOut, _signals, _zeros_sd
from madtp_tpu_torch.ops.attention import multi_head_attention
from madtp_tpu_torch.ops.layers import layer_norm, linear, mlp
from madtp_tpu_torch.prune.dtp import (TokenState, dtp_prune, dtp_prune_gather,
                                       init_token_state)
from madtp_tpu_torch.prune.query import query_model

PAD_BIAS = -10000.0


def _lin(x, mod: nn.Linear):
    return linear(x, mod.weight, mod.bias)


def _ln(x, mod: nn.LayerNorm):
    return layer_norm(x, mod.weight, mod.bias, mod.eps)


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: MedConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """Word + absolute position embeddings, then LayerNorm."""
        N = input_ids.shape[1]
        x = (self.word_embeddings.weight[input_ids]
             + self.position_embeddings.weight[:N][None])
        return _ln(x, self.LayerNorm)


class QKV(nn.Module):
    def __init__(self, dim: int, kv_dim: int):
        super().__init__()
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(kv_dim, dim)
        self.value = nn.Linear(kv_dim, dim)


class DenseNorm(nn.Module):
    def __init__(self, cfg: MedConfig, in_dim: int):
        super().__init__()
        self.dense = nn.Linear(in_dim, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


class AttentionBlock(nn.Module):
    """Self- or single-stream cross-attention + output dense + residual LN."""

    def __init__(self, cfg: MedConfig, kv_dim: int):
        super().__init__()
        self.num_heads = cfg.num_attention_heads
        self.self = QKV(cfg.hidden_size, kv_dim)
        self.output = DenseNorm(cfg, cfg.hidden_size)

    def forward(self, x, kv, *, key_alive, key_bias=None, need_scores=False):
        p = self.self
        out, aux = multi_head_attention(
            _lin(x, p.query), _lin(kv, p.key), _lin(kv, p.value), self.num_heads,
            key_alive=key_alive, key_bias=key_bias, need_scores=need_scores)
        return _ln(_lin(out, self.output.dense) + x, self.output.LayerNorm), aux


class TwinOutput(nn.Module):
    def __init__(self, cfg: MedConfig, merge: bool):
        super().__init__()
        D = cfg.hidden_size
        self.dense0 = nn.Linear(D, D)
        self.dense1 = nn.Linear(D, D)
        if merge:
            self.merge_layer = nn.Linear(2 * D, D)
        self.LayerNorm = nn.LayerNorm(D, eps=cfg.layer_norm_eps)


class TwinCrossAttention(nn.Module):
    """NLVR twin cross-attention over two image streams."""

    def __init__(self, cfg: MedConfig, merge: bool):
        super().__init__()
        self.num_heads = cfg.num_attention_heads
        self.merge = merge
        self.self0 = QKV(cfg.hidden_size, cfg.encoder_width)
        self.self1 = QKV(cfg.hidden_size, cfg.encoder_width)
        self.output = TwinOutput(cfg, merge)

    def forward(self, x, enc0: TokenState, enc1: TokenState):
        def one(p: QKV, enc: TokenState):
            out, _ = multi_head_attention(
                _lin(x, p.query), _lin(enc.x, p.key), _lin(enc.x, p.value),
                self.num_heads, key_alive=enc.alive)
            return out

        o = self.output
        h0 = _lin(one(self.self0, enc0), o.dense0)
        h1 = _lin(one(self.self1, enc1), o.dense1)
        if self.merge:
            h = _lin(torch.cat([h0, h1], dim=-1), o.merge_layer)
        else:
            h = (h0 + h1) / 2.0
        return _ln(h + x, o.LayerNorm)


class Layer(nn.Module):
    def __init__(self, cfg: MedConfig, index: int):
        super().__init__()
        self.attention = AttentionBlock(cfg, cfg.hidden_size)
        if cfg.add_cross_attention:
            if cfg.twin_cross:
                self.crossattention = TwinCrossAttention(
                    cfg, merge=index >= cfg.merge_start_layer)
            else:
                self.crossattention = AttentionBlock(cfg, cfg.encoder_width)
        self.intermediate = nn.Module()
        self.intermediate.dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.output = DenseNorm(cfg, cfg.intermediate_size)

    def cross(self, x, enc0: TokenState, enc1: Optional[TokenState]):
        if enc1 is not None:
            return self.crossattention(x, enc0, enc1)
        h, _ = self.crossattention(x, enc0.x, key_alive=enc0.alive)
        return h

    def ffn(self, x):
        h = mlp(x, self.intermediate.dense, self.output.dense)
        return _ln(h + x, self.output.LayerNorm)


class Encoder(nn.Module):
    def __init__(self, cfg: MedConfig):
        super().__init__()
        self.layer = nn.ModuleList(Layer(cfg, i) for i in range(cfg.num_hidden_layers))


class MedEncoder(nn.Module):
    def __init__(self, cfg: MedConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg)
        self.encoder = Encoder(cfg)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor, *,
                encoder_state: Optional[TokenState] = None,
                encoder_state1: Optional[TokenState] = None,
                space_dict: Optional[torch.Tensor] = None, temperature=0.0,
                prune_active: bool = False,
                capacities: Optional[Sequence[int]] = None) -> EncoderOut:
        """BertModel encoder pass (``med_encoder``): multimodal with
        ``encoder_state`` (twin cross-attention with ``encoder_state1``), text
        only without; ``capacities`` switches to gather mode."""
        emb = self.embeddings(input_ids)
        pad_bias = (1.0 - attention_mask.float()) * PAD_BIAS
        # cross-attention memories compute in the text tower's dtype
        enc0, enc1 = (None if st is None else TokenState(st.x.to(emb.dtype), st.alive, st.bias)
                      for st in (encoder_state, encoder_state1))
        layers = self.encoder.layer
        B, N = input_ids.shape
        gather = capacities is not None and prune_active
        if gather:
            if len(capacities) != len(layers):
                raise ValueError(f"{len(capacities)} capacities for {len(layers)} layers")
            state = init_token_state(emb, depth=0, bias=pad_bias)
        else:
            state = init_token_state(emb, depth=len(layers) if prune_active else 0,
                                     bias=pad_bias, pad_to=8 if prune_active else 1)
        use_fdt = space_dict is not None
        sd_all = _zeros_sd(B, space_dict) if use_fdt else None
        kept_list, overflow = [], 0
        for i, layer in enumerate(layers):
            x, alive, bias = state
            token_attn = None
            if use_fdt:
                token_attn, sd_ft = query_model(x[:, 1:], space_dict, alive[:, 1:])
                sd_all = sd_all + sd_ft
            h, aux = layer.attention(x, x, key_alive=alive, key_bias=bias,
                                     need_scores=prune_active)
            state = TokenState(h, alive, bias)
            kept = alive[0, 1:].sum()
            if gather:
                cap = min(capacities[i], h.shape[1])
                state, kept, ovf = dtp_prune_gather(
                    state, _signals(aux, token_attn), temperature, cap)
                overflow = overflow + ovf
            elif prune_active:
                state, kept = dtp_prune(state, _signals(aux, token_attn),
                                        temperature, N + i)
            x, alive, bias = state
            if enc0 is not None:
                x = layer.cross(x, enc0, enc1)
            state = TokenState(layer.ffn(x), alive, bias)
            kept_list.append(kept)
        return EncoderOut(state, sd_all, torch.stack(kept_list),
                          overflow if gather else None)
