"""BLIP task models on the ViT image tower and the MED
(counterpart of ``madtp_tpu/models/blip.py``):

* :class:`NLVRModel` — both images of each pair through the ViT, then the
  twin cross-attention MED and the 2-way head (``:39-124``, eval and train
  branches);
* :class:`RetrievalModel` — image and text features for the ITC shortlist
  and the ITM score of the rerank (``:216-262``); its training (momentum
  towers, queue, ITC and ITM losses) is in :mod:`madtp_tpu_torch.train.loops`;
* :class:`VQAModel` — the image tower, the question encoder over the image
  (``blip_vqa_encode``, ``:180-208``) and the answer decoder; its training
  loss is in :mod:`madtp_tpu_torch.train.loops`;
* :class:`CaptionModel` — the image tower and the caption decoder over its
  tokens (``blip_caption_encode_image``, ``:132-149``), and the training
  pass with the LM loss (``blip_caption_forward``, ``:151-172``);
* the legacy heads, which no driver calls (``:354-446``):
  :func:`blip_base_features` (BLIP_Base), :func:`blip_itm_logits`
  (BLIP_ITM) on a :class:`RetrievalModel`, and :func:`blip_pretrain_losses`
  (BLIP_Pretrain's ITC, ITM and LM objectives) on a :class:`PretrainModel`,
  the retrieval layout plus a caption decoder.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from madtp_tpu_torch.core.config import BlipConfig
from madtp_tpu_torch.core.device import resolve_device
from madtp_tpu_torch.models.med import MedDecoder, MedEncoder, lm_loss
from madtp_tpu_torch.models.vit import EncoderOut, VisionTransformer
from madtp_tpu_torch.ops.layers import cosine_embedding_loss, draw_key, fold_in, linear, tp_linear
from madtp_tpu_torch.prune.dtp import TokenState
from madtp_tpu_torch.train import losses as L
from madtp_tpu_torch.train.losses import cross_entropy


class NLVROut(NamedTuple):
    logits: torch.Tensor  # [B, 2]
    v_kept: torch.Tensor  # [L_vit]
    t_kept: torch.Tensor  # [L_med]
    overflow: Optional[torch.Tensor]  # gather mode: tokens folded into merge slots


def split_state(state: TokenState, n: int) -> Tuple[TokenState, TokenState]:
    """Rows ``[:n]`` and ``[n:]`` of a token state (``_split_state``)."""
    def part(sl):
        return TokenState(state.x[sl], state.alive[sl],
                          None if state.bias is None else state.bias[sl])
    return part(slice(None, n)), part(slice(n, None))


def fdt_alignment_loss(sd_img_ft: torch.Tensor, sd_txt_ft: torch.Tensor,
                       sd_dim: int) -> torch.Tensor:
    """Cross-modal FDT loss: ``CosineEmbeddingLoss(+1)`` over the L2-normalized,
    depth-summed MAG features (``madtp_tpu/models/blip.py:48-53``)."""
    a = sd_img_ft / (torch.linalg.vector_norm(sd_img_ft, dim=-1, keepdim=True) + 1e-10)
    b = sd_txt_ft / (torch.linalg.vector_norm(sd_txt_ft, dim=-1, keepdim=True) + 1e-10)
    return cosine_embedding_loss(a.reshape(-1, sd_dim), b.reshape(-1, sd_dim))


class NLVRModel(nn.Module):
    """Parameter names follow the reference BLIP-NLVR state dict
    (``visual_encoder.``, ``text_encoder.``, ``cls_head.0``/``.2``,
    ``space_dict``).  The model computes in the dtype of its weights."""

    def __init__(self, cfg: BlipConfig):
        super().__init__()
        self.cfg = cfg
        D = cfg.med.hidden_size
        self.visual_encoder = VisionTransformer(cfg.vit)
        self.text_encoder = MedEncoder(cfg.med)
        self.cls_head = nn.Sequential(nn.Linear(D, D), nn.ReLU(), nn.Linear(D, 2))
        self.space_dict = nn.Parameter(torch.zeros(cfg.sd_num, cfg.sd_dim))

    def forward(self, images: torch.Tensor, text_ids: torch.Tensor,
                text_mask: torch.Tensor, *, temperature=0.0,
                prune_active: bool = False,
                capacities_v: Optional[Sequence[int]] = None,
                capacities_t: Optional[Sequence[int]] = None,
                targets: Optional[torch.Tensor] = None, row_independent: bool = False,
                generator: Optional[torch.Generator] = None):
        """``images`` [2B, 3, H, W]: the first images of the B pairs, then the
        second ones.  ``capacities_v``/``capacities_t`` switch the towers to
        gather mode.  ``row_independent`` (serving): per-row DTP, so each
        *image* of a pair prunes on its own counts (the vision tower runs on
        the 2B stack), and the kept counts are per row, ``[L, 2B]`` and
        ``[L, B]`` (``madtp_tpu/models/blip.py:75-96``).

        Returns an :class:`NLVROut`; with ``targets`` [B] (the train branch of
        ``blip_nlvr_forward``) ``(loss_ori, loss_fdt, logits, v_kept,
        t_kept)`` instead: the fp32 cross-entropy of the logits and, when
        pruning, the FDT alignment loss between the two images' averaged MAG
        features and the text's (else ``loss_ori`` again), then the towers'
        kept counts, which the train step records
        (:func:`madtp_tpu_torch.train.loops.make_nlvr_train_step`).

        ``generator`` (training): the reference recipe's drop-path in the
        image tower and dropout in the text tower, from one key drawn from it
        and split between the towers (``madtp_tpu/models/blip.py:90-103``)."""
        B = text_ids.shape[0]
        k_v = k_t = None
        if generator is not None:
            key = draw_key(generator)
            k_v, k_t = fold_in(key, 0), fold_in(key, 1)
        v = self.visual_encoder(images, space_dict=self.space_dict,
                                temperature=temperature, prune_active=prune_active,
                                capacities=capacities_v, row_independent=row_independent,
                                dropout_key=k_v)
        st0, st1 = split_state(v.state, B)
        t = self.text_encoder(text_ids, text_mask, encoder_state=st0, encoder_state1=st1,
                              space_dict=self.space_dict, temperature=temperature,
                              prune_active=prune_active, capacities=capacities_t,
                              row_independent=row_independent, dropout_key=k_t)
        fc1, fc2 = self.cls_head[0], self.cls_head[2]
        h = torch.relu(linear(t.state.x[:, 0, :], fc1.weight, fc1.bias))
        logits = tp_linear(h, fc2)  # fc1, fc2 split over a tensor-parallel model's ranks
        if targets is not None:
            loss_ori = cross_entropy(logits, targets)
            loss_fdt = loss_ori
            if prune_active and v.sd_ft is not None and t.sd_ft is not None:
                sd_img = (v.sd_ft[:B] + v.sd_ft[B:]) / 2.0
                loss_fdt = fdt_alignment_loss(sd_img, t.sd_ft, self.cfg.sd_dim)
            return loss_ori, loss_fdt, logits, v.kept_counts, t.kept_counts
        overflow = None
        if v.overflow is not None or t.overflow is not None:
            # summed over rows too when the towers count them per row
            overflow = (0 if v.overflow is None else v.overflow.sum()) + (
                0 if t.overflow is None else t.overflow.sum())
        return NLVROut(logits, v.kept_counts, t.kept_counts, overflow)


def _init_weights(model: nn.Module, seed: int) -> None:
    """Random weights drawn from a ``torch.Generator`` seeded with ``seed`` on
    the CPU, so every device gets the same weights: linear, conv, embedding
    and token weights N(0, 0.02), biases 0, LayerNorm scales 1, the codebook
    N(0, 1) (the JAX package's init)."""
    g = torch.Generator().manual_seed(seed)
    norms = {id(m.weight) for m in model.modules() if isinstance(m, nn.LayerNorm)}
    with torch.no_grad():
        for name, p in model.named_parameters():
            if id(p) in norms:
                p.fill_(1.0)
            elif name.endswith("bias"):
                p.zero_()
            elif name == "space_dict":
                p.copy_(torch.randn(p.shape, generator=g))
            else:
                p.copy_(torch.randn(p.shape, generator=g) * 0.02)


def init_nlvr_model(cfg: BlipConfig, seed: int = 0, device="cuda",
                    dtype=torch.float32) -> NLVRModel:
    """An NLVR model with seeded random weights (:func:`_init_weights`)."""
    dev = resolve_device(device)
    model = NLVRModel(cfg)
    _init_weights(model, seed)
    return model.to(device=dev, dtype=dtype).eval()


class RetrievalModel(nn.Module):
    """BLIP retrieval, eval side.  Parameter names follow the reference
    BLIP-retrieval state dict (``visual_encoder.``, ``text_encoder.`` with
    single-stream cross-attention, ``vision_proj``, ``text_proj``,
    ``itm_head``, ``space_dict``); the momentum towers and queues exist only
    in training and are not here.  The model computes in the dtype of its
    weights."""

    def __init__(self, cfg: BlipConfig, embed_dim: int = 256):
        super().__init__()
        if cfg.med.twin_cross:
            raise ValueError("retrieval uses single-stream cross-attention (twin_cross=False)")
        self.cfg = cfg
        D = cfg.med.hidden_size
        self.visual_encoder = VisionTransformer(cfg.vit)
        self.text_encoder = MedEncoder(cfg.med)
        self.vision_proj = nn.Linear(cfg.vit.embed_dim, embed_dim)
        self.text_proj = nn.Linear(D, embed_dim)
        self.itm_head = nn.Linear(D, 2)
        self.space_dict = nn.Parameter(torch.zeros(cfg.sd_num, cfg.sd_dim))

    def image_features(self, images: torch.Tensor, *, temperature=0.0,
                       prune_active: bool = False,
                       capacities: Optional[Sequence[int]] = None,
                       row_independent: bool = False
                       ) -> Tuple[torch.Tensor, EncoderOut]:
        """Image tower and projection (``blip_retrieval_image_features``):
        ``(feat [B, E] L2-normalized, EncoderOut)``; ``out.state`` is the
        memory the ITM attends to, ``out.kept_counts`` the GFLOPs input.
        ``row_independent``: per-row DTP here and in the next two methods."""
        out = self.visual_encoder(images, space_dict=self.space_dict,
                                  temperature=temperature, prune_active=prune_active,
                                  capacities=capacities, row_independent=row_independent)
        return _unit(linear(out.state.x[:, 0, :], self.vision_proj.weight,
                            self.vision_proj.bias)), out

    def text_features(self, text_ids: torch.Tensor, text_mask: torch.Tensor, *,
                      temperature=0.0, prune_active: bool = False,
                      capacities: Optional[Sequence[int]] = None,
                      row_independent: bool = False
                      ) -> Tuple[torch.Tensor, EncoderOut]:
        """Text tower in text mode and projection
        (``blip_retrieval_text_features``): ``(feat [B, E], EncoderOut)``."""
        out = self.text_encoder(text_ids, text_mask, space_dict=self.space_dict,
                                temperature=temperature, prune_active=prune_active,
                                capacities=capacities, row_independent=row_independent)
        return _unit(linear(out.state.x[:, 0, :], self.text_proj.weight,
                            self.text_proj.bias)), out

    def itm_score(self, text_ids: torch.Tensor, text_mask: torch.Tensor,
                  image_state: TokenState, *, temperature=0.0, prune_active: bool = False,
                  capacities: Optional[Sequence[int]] = None,
                  row_independent: bool = False) -> torch.Tensor:
        """The ITM head's match logit ``logits[:, 1]`` over the multimodal CLS
        (``blip_itm_score``); ``text_ids`` carry the encoder token at slot
        0.  [B]."""
        out = self.text_encoder(text_ids, text_mask, encoder_state=image_state,
                                space_dict=self.space_dict, temperature=temperature,
                                prune_active=prune_active, capacities=capacities,
                                row_independent=row_independent)
        logits = linear(out.state.x[:, 0, :], self.itm_head.weight, self.itm_head.bias)
        return logits[:, 1]


def _unit(feat: torch.Tensor) -> torch.Tensor:
    return feat / torch.linalg.vector_norm(feat, dim=-1, keepdim=True)


def init_retrieval_model(cfg: BlipConfig, seed: int = 0, device="cuda",
                         dtype=torch.float32, embed_dim: int = 256) -> RetrievalModel:
    """A retrieval model with seeded random weights (:func:`_init_weights`;
    the counterpart of ``init_blip_params(heads=("retrieval",))``), with
    ``embed_dim``-wide projections (the reference's 256 by default)."""
    dev = resolve_device(device)
    model = RetrievalModel(cfg, embed_dim)
    _init_weights(model, seed)
    return model.to(device=dev, dtype=dtype).eval()


class VQAModel(nn.Module):
    """BLIP VQA, eval side.  Parameter names follow the reference BLIP-VQA
    state dict (``visual_encoder.``, ``text_encoder.`` with single-stream
    cross-attention, ``text_decoder.bert.`` and ``text_decoder.cls.``,
    ``space_dict``).  The encoder and the decoder share ``cfg.med``.  The
    model computes in the dtype of its weights."""

    def __init__(self, cfg: BlipConfig):
        super().__init__()
        if cfg.med.twin_cross:
            raise ValueError("VQA uses single-stream cross-attention (twin_cross=False)")
        self.cfg = cfg
        self.visual_encoder = VisionTransformer(cfg.vit)
        self.text_encoder = MedEncoder(cfg.med)
        self.text_decoder = MedDecoder(cfg.med)
        self.space_dict = nn.Parameter(torch.zeros(cfg.sd_num, cfg.sd_dim))

    def encode(self, images: torch.Tensor, q_ids: torch.Tensor, q_mask: torch.Tensor, *,
               temperature=0.0, prune_active: bool = False,
               capacities_v: Optional[Sequence[int]] = None,
               capacities_t: Optional[Sequence[int]] = None, row_independent: bool = False
               ) -> Tuple[EncoderOut, Optional[torch.Tensor], torch.Tensor]:
        """The image tower, then the question encoder with cross-attention
        over the image (``blip_vqa_encode``); ``q_ids`` carry the encoder
        token at slot 0; ``capacities_v``/``capacities_t`` switch the towers
        to gather mode; ``row_independent`` gives both towers per-row DTP.
        Returns ``(out, sd_img_ft, v_kept)``: ``out.state`` is the decoder's
        memory, ``out.kept_counts`` and ``v_kept`` the GFLOPs inputs."""
        v = self.visual_encoder(images, space_dict=self.space_dict, temperature=temperature,
                                prune_active=prune_active, capacities=capacities_v,
                                row_independent=row_independent)
        out = self.text_encoder(q_ids, q_mask, encoder_state=v.state,
                                space_dict=self.space_dict, temperature=temperature,
                                prune_active=prune_active, capacities=capacities_t,
                                row_independent=row_independent)
        return out, v.sd_ft, v.kept_counts


def init_vqa_model(cfg: BlipConfig, seed: int = 0, device="cuda",
                   dtype=torch.float32) -> VQAModel:
    """A VQA model with seeded random weights (:func:`_init_weights`; the
    counterpart of ``init_blip_params(heads=(), with_decoder=True)``)."""
    dev = resolve_device(device)
    model = VQAModel(cfg)
    _init_weights(model, seed)
    return model.to(device=dev, dtype=dtype).eval()


class CaptionModel(nn.Module):
    """BLIP captioning (``BLIP_Decoder``).  Parameter names follow
    the reference BLIP caption state dict (``visual_encoder.``,
    ``text_decoder.bert.*``, ``text_decoder.cls.predictions.*``,
    ``space_dict``).  The model computes in the dtype of its weights."""

    def __init__(self, cfg: BlipConfig):
        super().__init__()
        if cfg.med.twin_cross:
            raise ValueError("captioning uses single-stream cross-attention (twin_cross=False)")
        self.cfg = cfg
        self.visual_encoder = VisionTransformer(cfg.vit)
        self.text_decoder = MedDecoder(cfg.med)
        self.space_dict = nn.Parameter(torch.zeros(cfg.sd_num, cfg.sd_dim))

    def encode_image(self, images: torch.Tensor, *, temperature=0.0, prune_active: bool = False,
                     capacities: Optional[Sequence[int]] = None, row_independent: bool = False,
                     dropout_key: Optional[int] = None
                     ) -> Tuple[TokenState, Optional[torch.Tensor], torch.Tensor]:
        """The image tower with DTP, run once per image
        (``blip_caption_encode_image``): dense, mask mode, or gather mode with
        ``capacities``; per-row DTP with ``row_independent``.  Returns
        ``(state, sd_img_ft, kept)``: ``state`` is the decoder's memory,
        ``kept`` [L] (``[L, B]`` per row) the GFLOPs input."""
        out = self.visual_encoder(images, space_dict=self.space_dict, temperature=temperature,
                                  prune_active=prune_active, capacities=capacities,
                                  row_independent=row_independent, dropout_key=dropout_key)
        return out.state, out.sd_ft, out.kept_counts

    def forward(self, images: torch.Tensor, text_ids: torch.Tensor, text_mask: torch.Tensor,
                *, temperature=0.0, prune_active: bool = False,
                capacities: Optional[Sequence[int]] = None,
                labels: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """The training and scoring pass (``blip_caption_forward``): the image
        tower with DTP (gather mode with ``capacities``), then the decoder,
        never pruned, over ``text_ids`` (BOS at slot 0) and the LM head.
        Returns the fp32 logits [B, N, V]; with ``labels`` [B, N] (-100 where
        ignored) ``(loss_lm, sd_img_ft, logits)``.  ``generator``
        (training): the image tower's drop-path, from one key drawn from it;
        the decoder takes no dropout, as ``blip_caption_forward`` gives it
        no rng."""
        key = None if generator is None else draw_key(generator)
        state, sd_img_ft, _ = self.encode_image(images, temperature=temperature,
                                                prune_active=prune_active,
                                                capacities=capacities, dropout_key=key)
        logits = self.text_decoder.lm_head(self.text_decoder(text_ids, text_mask, state))
        if labels is None:
            return logits
        return lm_loss(logits, labels), sd_img_ft, logits


def init_caption_model(cfg: BlipConfig, seed: int = 0, device="cuda",
                       dtype=torch.float32) -> CaptionModel:
    """A caption model with seeded random weights (:func:`_init_weights`;
    the counterpart of ``init_blip_params(heads=(), with_encoder=False,
    with_decoder=True)``)."""
    dev = resolve_device(device)
    model = CaptionModel(cfg)
    _init_weights(model, seed)
    return model.to(device=dev, dtype=dtype).eval()


class PretrainModel(RetrievalModel):
    """BLIP_Pretrain's weights: the retrieval layout (``visual_encoder.``,
    ``text_encoder.``, ``vision_proj``, ``text_proj``, ``itm_head``,
    ``space_dict``) plus the caption decoder ``text_decoder.`` (``bert.*``,
    ``cls.predictions.*``) on the same MED config, the layout
    ``blip_pretrain_losses`` takes (``madtp_tpu/models/blip.py:404-414``).
    No momentum towers: the JAX function has none either."""

    def __init__(self, cfg: BlipConfig, embed_dim: int = 256):
        super().__init__(cfg, embed_dim)
        self.text_decoder = MedDecoder(cfg.med)


def init_pretrain_model(cfg: BlipConfig, seed: int = 0, device="cuda",
                        dtype=torch.float32, embed_dim: int = 256) -> PretrainModel:
    """A pretrain model with seeded random weights (:func:`_init_weights`)."""
    dev = resolve_device(device)
    model = PretrainModel(cfg, embed_dim)
    _init_weights(model, seed)
    return model.to(device=dev, dtype=dtype).eval()


def blip_base_features(model: RetrievalModel, *, images: Optional[torch.Tensor] = None,
                       text_ids: Optional[torch.Tensor] = None,
                       text_mask: Optional[torch.Tensor] = None, mode: str = "multimodal",
                       enc_token_id: Optional[int] = None) -> torch.Tensor:
    """BLIP_Base's feature extractor (``blip_base_features``,
    ``madtp_tpu/models/blip.py:354-375``), unpruned: ``"image"`` the ViT's
    final token states [B, 1+P, D], ``"text"`` the text encoder's [B, N, D],
    ``"multimodal"`` the text encoder's over the image with ``enc_token_id``
    written into slot 0 when given."""
    if mode not in ("image", "text", "multimodal"):
        raise ValueError(f"mode must be image, text or multimodal, not {mode!r}")
    if mode == "image":
        return model.visual_encoder(images).state.x
    if mode == "text":
        return model.text_encoder(text_ids, text_mask).state.x
    vstate = model.visual_encoder(images).state
    ids = text_ids
    if enc_token_id is not None:
        ids = text_ids.clone()
        ids[:, 0] = enc_token_id
    return model.text_encoder(ids, text_mask, encoder_state=vstate).state.x


def blip_itm_logits(model: RetrievalModel, text_ids: torch.Tensor, text_mask: torch.Tensor,
                    image_state: TokenState, *, head: str = "itm", temperature=0.0,
                    prune_active: bool = False) -> torch.Tensor:
    """BLIP_ITM's heads (``blip_itm_logits``, ``madtp_tpu/models/blip.py:
    378-401``), DTP in the text tower at ``temperature`` with
    ``prune_active``: ``"itm"`` the 2-way match logits [B, 2] of the
    multimodal encoder's CLS over ``image_state``; ``"itc"`` the cosine [B]
    of the projected text CLS (text mode) and the projected image CLS."""
    if head not in ("itm", "itc"):
        raise ValueError(f"head must be itm or itc, not {head!r}")
    kw = dict(space_dict=model.space_dict, temperature=temperature, prune_active=prune_active)
    if head == "itm":
        out = model.text_encoder(text_ids, text_mask, encoder_state=image_state, **kw)
        return linear(out.state.x[:, 0, :], model.itm_head.weight, model.itm_head.bias)
    out = model.text_encoder(text_ids, text_mask, **kw)
    tf = _unit(linear(out.state.x[:, 0, :], model.text_proj.weight, model.text_proj.bias))
    vf = _unit(linear(image_state.x[:, 0, :], model.vision_proj.weight, model.vision_proj.bias))
    return (vf * tf).sum(dim=-1)


def blip_pretrain_losses(model: PretrainModel, images: torch.Tensor, text_ids: torch.Tensor,
                         text_mask: torch.Tensor, dec_ids: torch.Tensor,
                         dec_mask: torch.Tensor, dec_labels: torch.Tensor, idx: torch.Tensor,
                         queue, temp, *, enc_token_id: int,
                         noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                         generator: Optional[torch.Generator] = None):
    """BLIP_Pretrain's objectives (``blip_pretrain_losses``,
    ``madtp_tpu/models/blip.py:404-446``), unpruned: the ITC of the online
    features against themselves and the queue (``queue`` a
    :class:`~madtp_tpu_torch.train.momentum.FeatureQueue`) with the id-match
    targets; the ITM over ``[pos, text with a hard negative image, image with
    a hard negative text]``, the negatives drawn as the retrieval step draws
    them (``noise`` a pair of Gumbel tensors [B, B], image-per-text then
    text-per-image, or drawn from ``generator``); the decoder's LM loss over
    ``dec_ids`` against ``dec_labels`` with the image states as memory.
    Returns ``(loss_ita, loss_itm, loss_lm)``."""
    B = text_ids.shape[0]
    img_feat, vout = model.image_features(images)
    txt_feat, _ = model.text_features(text_ids, text_mask)
    vstate = vout.state
    sim_targets = L.id_match_targets(idx, torch.cat([idx, queue.idx]))
    img_all = torch.cat([img_feat.T, queue.image], dim=1)
    txt_all = torch.cat([txt_feat.T, queue.text], dim=1)
    loss_ita = 0.5 * (L.itc_loss(img_feat, txt_all, sim_targets, temp)
                      + L.itc_loss(txt_feat, img_all, sim_targets, temp))

    enc_ids = text_ids.clone()
    enc_ids[:, 0] = enc_token_id
    noise_i, noise_t = (None, None) if noise is None else noise
    neg_img = L.sample_hard_negatives(txt_feat, img_feat, idx, idx, temp, noise=noise_i,
                                      generator=generator)
    neg_txt = L.sample_hard_negatives(img_feat, txt_feat, idx, idx, temp, noise=noise_t,
                                      generator=generator)
    ids_all = torch.cat([enc_ids, enc_ids, enc_ids[neg_txt]])
    mask_all = torch.cat([text_mask, text_mask, text_mask[neg_txt]])
    memory = TokenState(torch.cat([vstate.x, vstate.x[neg_img], vstate.x]),
                        torch.cat([vstate.alive, vstate.alive[neg_img], vstate.alive]), None)
    out = model.text_encoder(ids_all, mask_all, encoder_state=memory)
    logits = linear(out.state.x[:, 0, :], model.itm_head.weight, model.itm_head.bias)
    loss_itm = L.itm_loss(logits, B)

    decoder = model.text_decoder
    loss_lm = lm_loss(decoder.lm_head(decoder(dec_ids, dec_mask, vstate)), dec_labels)
    return loss_ita, loss_itm, loss_lm
