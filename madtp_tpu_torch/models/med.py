"""MED: the BERT-style text / multimodal encoder with DTP
(counterpart of ``madtp_tpu/models/med.py:40-320``).

Parameter names follow the reference BERT layout (``embeddings``,
``encoder.layer.{i}.attention.self.query``, ``crossattention.self0``, ...).
Text padding rides along as the finite key bias ``PAD_BIAS`` so padded tokens
score as in the reference, while pruned slots are masked exactly.  With twin
cross-attention (NLVR) the two image streams are averaged below
``merge_start_layer`` and concatenated through ``merge_layer`` from it on; as
in the reference, ``merge_layer`` exists only at those layers.

:class:`MedDecoder` is the answer decoder of VQA and the caption decoder
(the reference's ``BertLMHeadModel`` layout,
``madtp_tpu/models/med.py:328-593``): causal self-attention on the plain
attention core (K1 has no causal mask), cross-attention over the memory
through :func:`cross_attention` with the memory's key bias, the FFN through
:func:`mlp`, and the LM head on the tied word embeddings.  Its
:meth:`MedDecoder.step` decodes one token against a fixed-capacity
:class:`DecodeCache` (``med_decoder_step``, ``:526-580``); :func:`lm_loss`
is the decoder's training loss (``:596-611``).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from madtp_tpu_torch.core.config import MedConfig
from madtp_tpu_torch.models.vit import EncoderOut, _signals, _zeros_sd
from madtp_tpu_torch.ops.attention import (attention_core, cross_attention,
                                           multi_head_attention)
from madtp_tpu_torch.ops.layers import gelu, layer_norm, linear, mlp
from madtp_tpu_torch.prune.dtp import (TokenState, dtp_prune, dtp_prune_gather,
                                       init_token_state)
from madtp_tpu_torch.prune.query import query_model

PAD_BIAS = -10000.0


def _lin(x, mod: nn.Linear):
    return linear(x, mod.weight, mod.bias)


def _ln(x, mod: nn.LayerNorm):
    return layer_norm(x, mod.weight, mod.bias, mod.eps)


def _attend_memory(x, p: QKV, enc: TokenState, num_heads: int, key_bias=None):
    """Text queries over a memory through :func:`cross_attention` (kernel K4
    on the card): ``x`` [B, Nq, D] -> [B, Nq, D].  Dead memory slots get
    weight exactly 0.  The encoder's image memories are attended without a
    bias, as in the JAX package; the decoder passes the question state's
    ``key_bias`` (``PAD_BIAS`` on padded question tokens)."""
    q, k, v = (_lin(t, m).unflatten(-1, (num_heads, -1))
               for t, m in ((x, p.query), (enc.x, p.key), (enc.x, p.value)))
    return cross_attention(q, k, v, enc.alive, key_bias)


def _heads(x, num_heads: int):
    """[B, N, D] -> [B, H, N, Dh]."""
    return x.unflatten(-1, (num_heads, -1)).transpose(1, 2)


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: MedConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, input_ids: torch.Tensor, position_offset=0) -> torch.Tensor:
        """Word + absolute position embeddings from ``position_offset`` on
        (an int, or a 0-d device tensor that is never read back), then
        LayerNorm."""
        pos = torch.arange(input_ids.shape[1], device=input_ids.device) + position_offset
        x = self.word_embeddings.weight[input_ids] + self.position_embeddings.weight[pos][None]
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
    """Self-attention (``forward``) or single-stream cross-attention
    (``cross``), then output dense and residual LN."""

    def __init__(self, cfg: MedConfig, kv_dim: int):
        super().__init__()
        self.num_heads = cfg.num_attention_heads
        self.self = QKV(cfg.hidden_size, kv_dim)
        self.output = DenseNorm(cfg, cfg.hidden_size)

    def forward(self, x, *, key_alive, key_bias=None, need_scores=False):
        """Self-attention over ``x``; the scoring attention when ``need_scores``."""
        p = self.self
        out, aux = multi_head_attention(
            _lin(x, p.query), _lin(x, p.key), _lin(x, p.value), self.num_heads,
            key_alive=key_alive, key_bias=key_bias, need_scores=need_scores)
        return self.close(out, x), aux

    def cross(self, x, enc: TokenState, key_bias=None):
        """Single-stream cross-attention over ``enc`` + output dense + residual LN."""
        out = _attend_memory(x, self.self, enc, self.num_heads, key_bias)
        return self.close(out, x)

    def causal(self, x, attn_bias=None, prefix_kv=None):
        """Decoder self-attention on the plain attention core with the
        additive ``attn_bias`` [B, 1, Nq, Nk] (causal and padding);
        ``prefix_kv`` ([B, H, P, Dh] each) is prepended to the keys and
        values (``self_attn_prefix``, ``madtp_tpu/models/med.py:464-478``)."""
        p, H = self.self, self.num_heads
        q, k, v = (_heads(_lin(x, m), H) for m in (p.query, p.key, p.value))
        if prefix_kv is not None:
            k = torch.cat([prefix_kv[0].to(k.dtype), k], dim=2)
            v = torch.cat([prefix_kv[1].to(v.dtype), v], dim=2)
        out, _ = attention_core(q, k, v, attn_bias=attn_bias)
        return self.close(out, x)

    def close(self, out, x):
        """Output dense, residual, LayerNorm."""
        return _ln(_lin(out, self.output.dense) + x, self.output.LayerNorm)


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
        o = self.output
        h0 = _lin(_attend_memory(x, self.self0, enc0, self.num_heads), o.dense0)
        h1 = _lin(_attend_memory(x, self.self1, enc1, self.num_heads), o.dense1)
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
        return self.crossattention.cross(x, enc0)

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
            h, aux = layer.attention(x, key_alive=alive, key_bias=bias,
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


def causal_bias(attention_mask: torch.Tensor) -> torch.Tensor:
    """[B, N] padding mask -> [B, 1, N, N] additive causal and padding bias,
    finite ``PAD_BIAS`` where masked (``madtp_tpu/models/med.py:328-335``)."""
    N = attention_mask.shape[1]
    causal = torch.ones(N, N, device=attention_mask.device).tril()
    m = causal[None] * attention_mask[:, None, :].float()
    return ((1.0 - m) * PAD_BIAS)[:, None]


class DecodeCache(NamedTuple):
    """The decoder's self-attention keys and values of every position so
    far, [L, B, H, max_len, Dh] each (``DecodeCache``,
    ``madtp_tpu/models/med.py:526-528``)."""

    k: torch.Tensor
    v: torch.Tensor


def init_decode_cache(cfg: MedConfig, batch: int, max_len: int, dtype=torch.float32,
                      device=None) -> DecodeCache:
    """A zero cache of ``max_len`` slots (``init_decode_cache``)."""
    H = cfg.num_attention_heads
    shape = (cfg.num_hidden_layers, batch, H, max_len, cfg.hidden_size // H)
    return DecodeCache(*(torch.zeros(shape, dtype=dtype, device=device) for _ in range(2)))


class LMPredictionHead(nn.Module):
    """``cls.predictions``: transform (dense, GELU, LayerNorm) and the
    output bias; the decoder weight is tied to the word embeddings."""

    def __init__(self, cfg: MedConfig):
        super().__init__()
        self.transform = DenseNorm(cfg, cfg.hidden_size)
        self.bias = nn.Parameter(torch.zeros(cfg.vocab_size))


class MedDecoder(nn.Module):
    """The MED as a causal LM over a cross-attention memory: the VQA answer
    decoder (reference ``BertLMHeadModel``; ``bert.embeddings``,
    ``bert.encoder.layer.{i}``, ``cls.predictions.transform.*``,
    ``cls.predictions.bias``).  Computes in the dtype of its weights; the
    memory's cross-attention attends with its key bias."""

    def __init__(self, cfg: MedConfig):
        super().__init__()
        if not cfg.add_cross_attention or cfg.twin_cross:
            raise ValueError("the decoder needs single-stream cross-attention "
                             "(add_cross_attention=True, twin_cross=False)")
        self.cfg = cfg
        self.bert = nn.Module()
        self.bert.embeddings = BertEmbeddings(cfg)
        self.bert.encoder = Encoder(cfg)
        self.cls = nn.Module()
        self.cls.predictions = LMPredictionHead(cfg)

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype, that of the weights."""
        return self.bert.embeddings.word_embeddings.weight.dtype

    def _memory(self, encoder_state: TokenState, dtype) -> TokenState:
        # the memory computes in the decoder's dtype (``_align``)
        return TokenState(encoder_state.x.to(dtype), encoder_state.alive, encoder_state.bias)

    def memory_kv(self, encoder_state: TokenState) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Each layer's cross-attention key and value over the memory,
        [B, S, H, Dh] views of the two linears' outputs: what every
        :meth:`step` over this memory projects again, computed once."""
        x = encoder_state.x.to(self.dtype)
        out = []
        for layer in self.bert.encoder.layer:
            ca = layer.crossattention
            out.append(tuple(_lin(x, m).unflatten(-1, (ca.num_heads, -1))
                             for m in (ca.self.key, ca.self.value)))
        return out

    def step(self, input_ids: torch.Tensor, position: torch.Tensor, cache: DecodeCache,
             encoder_state: TokenState, memory_kv=None) -> Tuple[torch.Tensor, DecodeCache]:
        """One incremental decode step (``med_decoder_step``,
        ``madtp_tpu/models/med.py:538-580``): ``input_ids`` [B, 1], the token
        at ``position``, a 0-d long tensor on the model's device.  Each layer
        writes its key and value at ``position`` into ``cache`` (in place),
        attends over all ``max_len`` slots with ``PAD_BIAS`` above
        ``position``, then over the memory with its key bias and alive mask
        (:func:`cross_attention`: K4 on the card), then runs the FFN.
        ``memory_kv``: :meth:`memory_kv` of ``encoder_state``, projected here
        when None.  Nothing is read back to the host, so one step can be
        captured in a CUDA graph.  Returns ``(hidden [B, 1, D], cache)``."""
        x = self.bert.embeddings(input_ids, position_offset=position)
        enc = self._memory(encoder_state, x.dtype)
        if memory_kv is None:
            memory_kv = self.memory_kv(enc)
        slots = torch.arange(cache.k.shape[3], device=x.device)
        bias = torch.where(slots <= position, 0.0, PAD_BIAS)  # [max_len] fp32
        index = position.view(1)
        for i, layer in enumerate(self.bert.encoder.layer):
            blk = layer.attention
            p, H = blk.self, blk.num_heads
            q, k, v = (_heads(_lin(x, m), H) for m in (p.query, p.key, p.value))
            ck, cv = cache.k[i], cache.v[i]
            ck.index_copy_(2, index, k)
            cv.index_copy_(2, index, v)
            out, _ = attention_core(q, ck, cv, attn_bias=bias)
            h = blk.close(out, x)
            ca = layer.crossattention
            qc = _lin(h, ca.self.query).unflatten(-1, (H, -1))
            h = ca.close(cross_attention(qc, *memory_kv[i], enc.alive, enc.bias), h)
            x = layer.ffn(h)
        return x, cache

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                encoder_state: TokenState) -> torch.Tensor:
        """Full-sequence pass -> hidden states [B, N, D]
        (``med_decoder_forward``, ``madtp_tpu/models/med.py:338-370``)."""
        x = self.bert.embeddings(input_ids)
        enc = self._memory(encoder_state, x.dtype)
        bias = causal_bias(attention_mask)
        for layer in self.bert.encoder.layer:
            h = layer.attention.causal(x, bias)
            h = layer.crossattention.cross(h, enc, enc.bias)
            x = layer.ffn(h)
        return x

    def bos_step(self, bos_ids: torch.Tensor, encoder_state: TokenState):
        """One decoder step at position 0 that also returns each layer's
        self-attention key and value there (``med_bos_step``,
        ``madtp_tpu/models/med.py:373-402``): every ranked candidate shares
        this prefix.  Returns ``(hidden [B, 1, D], ks, vs)``, ``ks`` and
        ``vs`` [L, B, H, 1, Dh]."""
        x = self.bert.embeddings(bos_ids)
        enc = self._memory(encoder_state, x.dtype)
        ks, vs = [], []
        for layer in self.bert.encoder.layer:
            blk = layer.attention
            p, H = blk.self, blk.num_heads
            q, k, v = (_heads(_lin(x, m), H) for m in (p.query, p.key, p.value))
            out, _ = attention_core(q, k, v)
            h = layer.crossattention.cross(blk.close(out, x), enc, enc.bias)
            x = layer.ffn(h)
            ks.append(k)
            vs.append(v)
        return x, torch.stack(ks), torch.stack(vs)

    def rank_forward(self, cand_ids: torch.Tensor, cand_mask: torch.Tensor,
                     encoder_state: TokenState, prefix_kv=None) -> torch.Tensor:
        """The decoder over ``k`` candidate answers per question
        (``cand_ids`` [B, k, La]) that share one memory per question
        (``med_rank_forward``, ``madtp_tpu/models/med.py:405-523``): each
        layer projects the memory's key and value once per question, and
        the k candidates' queries attend to them in one batched product with
        the numerics of :func:`attention_core` (fp32 logits, the memory's
        key bias, ``-inf`` at dead slots).  With ``prefix_kv`` (``bos_step``'s
        ``ks, vs``) the pass runs over positions 1..La-1 only, the BOS key
        and value prepended.  Returns hidden states [B*k, La, D], or
        [B*k, La-1, D] with ``prefix_kv``."""
        B, k, La = cand_ids.shape
        mask = cand_mask.reshape(B * k, La)
        if prefix_kv is None:
            Lq = La
            x = self.bert.embeddings(cand_ids.reshape(B * k, La))
            bias = causal_bias(mask)
        else:
            Lq = La - 1
            x = self.bert.embeddings(cand_ids[:, :, 1:].reshape(B * k, Lq), position_offset=1)
            # queries: positions 1..La-1; keys: BOS, then positions 1..La-1
            allow = torch.cat([torch.ones(Lq, 1, device=x.device),
                               torch.ones(Lq, Lq, device=x.device).tril()], dim=1)
            bias = ((1.0 - allow[None] * mask[:, None, :].float()) * PAD_BIAS)[:, None]
        enc = self._memory(encoder_state, x.dtype)
        for i, layer in enumerate(self.bert.encoder.layer):
            blk = layer.attention
            prefix = None
            if prefix_kv is not None:
                prefix = tuple(t[i].repeat_interleave(k, dim=0) for t in prefix_kv)
            h = blk.causal(x, bias, prefix)
            ca = layer.crossattention
            H = ca.num_heads
            q = _lin(h, ca.self.query).view(B, k, Lq, H, -1).permute(0, 3, 1, 2, 4)
            kb, vb = (_heads(_lin(enc.x, m), H) for m in (ca.self.key, ca.self.value))
            out, _ = attention_core(q.reshape(B, H, k * Lq, -1), kb, vb,
                                    key_bias=enc.bias, key_alive=enc.alive)
            x = layer.ffn(ca.close(out.reshape(B * k, Lq, -1), h))
        return x

    def lm_head(self, hidden: torch.Tensor) -> torch.Tensor:
        """``BertLMPredictionHead`` (``madtp_tpu/models/med.py:583-593``):
        dense, exact GELU, LayerNorm, then the tied word embeddings plus
        the bias.  The logits are fp32 sums of the products of the
        transformed state and the embeddings in their own dtype (exact in
        fp32 for bf16), as ``preferred_element_type=float32`` gives, not
        logits rounded to bf16.  [..., vocab] fp32."""
        p = self.cls.predictions
        h = _ln(gelu(_lin(hidden, p.transform.dense)), p.transform.LayerNorm)
        w = self.bert.embeddings.word_embeddings.weight
        return torch.matmul(h.float(), w.float().t()) + p.bias.float()


def lm_loss(logits: torch.Tensor, labels: torch.Tensor, *, label_smoothing: float = 0.1,
            reduction: str = "mean") -> torch.Tensor:
    """Shifted next-token cross-entropy with label smoothing and ignore index
    -100 (``lm_loss``, ``madtp_tpu/models/med.py:596-611``): position ``i``'s
    logits [B, N, V] (upcast to fp32) predict ``labels`` [B, N] at ``i+1``.
    ``reduction="none"`` gives each sample's sum [B]; ``"mean"`` divides the
    total by the count of valid positions, at least 1."""
    logits, labels = logits[:, :-1], labels[:, 1:]
    valid = labels != -100
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, torch.where(valid, labels, 0)[..., None].long())[..., 0]
    loss = (1.0 - label_smoothing) * nll + label_smoothing * -logp.mean(dim=-1)
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    if reduction == "none":
        return loss.sum(dim=1)
    return loss.sum() / valid.sum().clamp(min=1)
