"""The compression train steps
(counterpart of ``madtp_tpu/train/loops.py:42-481``): NLVR, caption, VQA,
BLIP retrieval and CLIP retrieval.

Each factory returns ``step(...)``, which runs one forward, backward and
optimizer update of the model in place and returns its losses as device
scalars; nothing in a step waits on the card.  The total loss is the task
loss plus ``0.1 * loss_fdt`` (retrieval and CLIP: plus ``0.1 * loss_fdt_m``
too).
The NLVR and caption steps take the reference's training recipe with
``use_dropout`` (BERT dropout and the ViT's stochastic depth, at the rates of
the model's config), drawn from the ``generator`` each step is given; no
driver turns it on, as no JAX driver does.  The other steps have none, as
the JAX package's have none.  ``amp`` computes in bf16 against the fp32
masters (:func:`_amp_cast`).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence

import torch
from torch import nn
from torch.func import functional_call

from madtp_tpu_torch.core.device import resolve_device
from madtp_tpu_torch.models.blip import (CaptionModel, NLVRModel, RetrievalModel, VQAModel,
                                         fdt_alignment_loss)
from madtp_tpu_torch.models.clip import CLIPModel
from madtp_tpu_torch.models.med import lm_loss
from madtp_tpu_torch.ops.layers import linear
from madtp_tpu_torch.parallel import data
from madtp_tpu_torch.prune.dtp import TokenState
from madtp_tpu_torch.train import losses as L
from madtp_tpu_torch.train.momentum import FeatureQueue, enqueue, init_queue, momentum_update

FDT_WEIGHT = 0.1
MOMENTUM_KEYS = ("visual_encoder", "vision_proj", "text_encoder", "text_proj")
# the JAX package's ``blocks`` is the port's ``transformer``
CLIP_MOMENTUM_KEYS = ("visual", "token_embedding", "positional_embedding", "transformer",
                      "ln_final", "text_projection")
LOGIT_SCALE_MAX = 4.6052  # ln 100, the reference clamp (clip/model.py:530-531)


def _amp_cast(amp: bool, params: dict, *tensors: torch.Tensor):
    """``--amp``: bf16 compute against fp32 master weights.  Returns
    ``(params, *tensors)``, cast to bf16 when ``amp``.  The bf16 copies are
    differentiable casts of the masters, so the gradients land on the fp32
    masters and the optimizer state stays fp32; bf16 carries fp32's exponent
    range, so no loss scaling is needed."""
    if not amp:
        return (params, *tensors)
    return ({n: p.to(torch.bfloat16) for n, p in params.items()},
            *(t.to(torch.bfloat16) for t in tensors))


def _check_device(model: nn.Module, device) -> None:
    dev = resolve_device(device)
    if model.space_dict.device.type != dev.type:
        raise ValueError(f"the model lives on {model.space_dict.device}, not {dev}")


class _Bound(nn.Module):
    """``fn(model, *args)`` as a module, so that ``functional_call`` can run a
    function of the model with other weights (bf16 copies, the momentum
    towers); its parameter names are the model's under ``model.``."""

    def __init__(self, model: nn.Module, fn):
        super().__init__()
        self.model = model
        self.fn = fn

    def forward(self, *args, **kwargs):
        return self.fn(self.model, *args, **kwargs)


def _prefixed(params: dict) -> dict:
    return {"model." + n: p for n, p in params.items()}


def _optimize(optimizer: torch.optim.Optimizer, loss_fn, names: Sequence[str], after=None,
              count=None):
    """The step shared by every factory: zero the gradients, run ``loss_fn``
    (the total first, then the parts ``names``), backward, update, then
    ``after(out, *args, **kwargs)`` when given (retrieval: the enqueue).

    Inside :func:`~madtp_tpu_torch.parallel.data.global_batch` the
    gradients and the returned losses become the global batch's before the
    update (:func:`~madtp_tpu_torch.parallel.data.reduce_step`), weighted by
    ``count(*args, **kwargs)``: the rows, tokens or questions the loss is a
    mean over."""
    def step(*args, **kwargs):
        optimizer.zero_grad(set_to_none=True)
        out = loss_fn(*args, **kwargs)
        out[0].backward()
        metrics = [v.detach() for v in out[:len(names)]]
        if data.spans():
            metrics = data.reduce_step(
                (p for g in optimizer.param_groups for p in g["params"]), metrics,
                count(*args, **kwargs))
        optimizer.step()
        if after is not None:
            after(out, *args, **kwargs)
        return dict(zip(names, metrics))
    step.loss_fn = loss_fn
    return step


def _dropout_generator(use_dropout: bool, generator: Optional[torch.Generator]):
    """The generator a step's masks come from: ``generator``, or one seeded
    0 when none is given (the JAX step's ``PRNGKey(0)`` default); None
    without ``use_dropout``."""
    if not use_dropout:
        return None
    return generator if generator is not None else torch.Generator().manual_seed(0)


def make_nlvr_train_step(model: NLVRModel, optimizer: torch.optim.Optimizer, *,
                         prune_active: bool = True, use_dropout: bool = False,
                         capacities_v: Optional[Sequence[int]] = None,
                         capacities_t: Optional[Sequence[int]] = None,
                         amp: bool = False, device="cuda"):
    """``step(images, ids, mask, targets, temperature, generator=None)`` runs
    one forward, backward and optimizer update of ``model`` in place and
    returns ``{"loss", "loss_ori", "loss_fdt"}`` as device scalars; nothing
    in the step waits on the card.  ``capacities_v``/``capacities_t`` train
    in gather mode (``--fast_train``).  ``use_dropout`` turns on the
    reference recipe (``madtp_tpu/train/loops.py:61-103``): the ViT's
    drop-path at ``cfg.vit.drop_path_rate`` and the MED's dropout at the
    config's rates, drawn from ``generator`` (a CPU generator keeps the step
    free of waits); without it the step ignores ``generator``.  ``device``
    is where the model must live: ``"cuda"`` (the default) raises without a
    card, ``"cpu"`` runs the plain path.  ``step.loss_fn`` takes the same
    arguments and returns ``(loss, loss_ori, loss_fdt)`` without the
    update."""
    _check_device(model, device)
    params = dict(model.named_parameters())
    kw = dict(prune_active=prune_active, capacities_v=capacities_v,
              capacities_t=capacities_t)

    def loss_fn(images, ids, mask, targets, temperature, generator=None):
        p, x = _amp_cast(amp, params, images)
        g = _dropout_generator(use_dropout, generator)
        loss_ori, loss_fdt, _ = functional_call(
            model, p, (x, ids, mask),
            dict(kw, temperature=temperature, targets=targets, generator=g))
        return loss_ori + FDT_WEIGHT * loss_fdt, loss_ori, loss_fdt

    # both losses are means over the pairs
    return _optimize(optimizer, loss_fn, ("loss", "loss_ori", "loss_fdt"),
                     count=lambda images, ids, mask, targets, *_, **__: targets.shape[0])


def make_caption_train_step(model: CaptionModel, optimizer: torch.optim.Optimizer, *,
                            prune_active: bool = True, use_dropout: bool = False,
                            capacities_v: Optional[Sequence[int]] = None,
                            amp: bool = False, device="cuda"):
    """``step(images, ids, mask, labels, temperature, generator=None)``
    (``make_caption_train_step``, ``madtp_tpu/train/loops.py:106-141``): the
    caption model's training pass (:meth:`CaptionModel.forward`, the image
    tower gather mode with ``capacities_v``), one backward and update in
    place.  The decoder runs unpruned and gives no text MAG features, so
    ``loss_fdt`` is ``loss_lm`` again, the reference's fallback.
    ``use_dropout``: the ViT's drop-path from ``generator`` (the decoder
    takes no dropout, as in the JAX step), as :func:`make_nlvr_train_step`.
    Returns ``{"loss", "loss_lm", "loss_fdt"}`` as device scalars;
    ``device`` as :func:`make_nlvr_train_step`."""
    _check_device(model, device)
    params = dict(model.named_parameters())
    kw = dict(prune_active=prune_active, capacities=capacities_v)

    def loss_fn(images, ids, mask, labels, temperature, generator=None):
        p, x = _amp_cast(amp, params, images)
        g = _dropout_generator(use_dropout, generator)
        loss_lm, _, _ = functional_call(
            model, p, (x, ids, mask),
            dict(kw, temperature=temperature, labels=labels, generator=g))
        loss_fdt = loss_lm
        return loss_lm + FDT_WEIGHT * loss_fdt, loss_lm, loss_fdt

    # the LM loss is a mean over the labelled tokens (``lm_loss``)
    return _optimize(optimizer, loss_fn, ("loss", "loss_lm", "loss_fdt"),
                     count=lambda images, ids, mask, labels, *_, **__:
                     (labels[:, 1:] != -100).sum())


def vqa_loss(model: VQAModel, images, q_ids, q_mask, a_ids, a_mask, weights, *,
             temperature, prune_active: bool = True,
             capacities_v: Optional[Sequence[int]] = None,
             capacities_t: Optional[Sequence[int]] = None):
    """The VQA training loss (``make_vqa_train_step``'s ``loss_fn``,
    ``madtp_tpu/train/loops.py:153-186``): :meth:`VQAModel.encode`, each
    question's state repeated for its ``K`` answers (``a_ids`` [B, K, La],
    BOS at slot 0, padded with zero-weight rows), the decoder over the
    answers with targets -100 at padding, the per-answer summed LM losses
    weighted by ``weights`` [B, K] and divided by B.  ``loss_fdt`` aligns the
    image's and the question's MAG features when pruning, else it is
    ``loss_vqa`` again.  Returns ``(loss_vqa, loss_fdt)``."""
    B, K = a_ids.shape[:2]
    out, sd_img_ft, _ = model.encode(images, q_ids, q_mask, temperature=temperature,
                                     prune_active=prune_active, capacities_v=capacities_v,
                                     capacities_t=capacities_t)
    tiled = TokenState(*(None if a is None else a.repeat_interleave(K, dim=0)
                         for a in out.state))
    ids, msk = a_ids.reshape(B * K, -1), a_mask.reshape(B * K, -1)
    targets = torch.where(ids == 0, -100, ids)
    decoder = model.text_decoder
    per = lm_loss(decoder.lm_head(decoder(ids, msk, tiled)), targets, reduction="none")
    loss_vqa = (weights.reshape(-1) * per).sum() / B
    loss_fdt = loss_vqa
    if prune_active and sd_img_ft is not None and out.sd_ft is not None:
        loss_fdt = fdt_alignment_loss(sd_img_ft, out.sd_ft, model.cfg.sd_dim)
    return loss_vqa, loss_fdt


def make_vqa_train_step(model: VQAModel, optimizer: torch.optim.Optimizer, *,
                        prune_active: bool = True,
                        capacities_v: Optional[Sequence[int]] = None,
                        capacities_t: Optional[Sequence[int]] = None,
                        amp: bool = False, device="cuda"):
    """``step(images, q_ids, q_mask, a_ids, a_mask, weights, temperature)``
    (``make_vqa_train_step``, ``madtp_tpu/train/loops.py:144-198``): the loss
    of :func:`vqa_loss`, one backward and update in place.  ``q_ids`` carry
    the encoder token at slot 0; ``capacities_v``/``capacities_t`` train in
    gather mode.  Returns ``{"loss", "loss_vqa", "loss_fdt"}`` as device
    scalars; ``device`` as :func:`make_nlvr_train_step`."""
    _check_device(model, device)
    params = dict(model.named_parameters())
    bound = _Bound(model, vqa_loss)
    kw = dict(prune_active=prune_active, capacities_v=capacities_v,
              capacities_t=capacities_t)

    def loss_fn(images, q_ids, q_mask, a_ids, a_mask, weights, temperature):
        p, x = _amp_cast(amp, params, images)
        loss_vqa, loss_fdt = functional_call(
            bound, _prefixed(p), (x, q_ids, q_mask, a_ids, a_mask, weights),
            dict(kw, temperature=temperature))
        return loss_vqa + FDT_WEIGHT * loss_fdt, loss_vqa, loss_fdt

    # the weighted answer loss is divided by the questions, the FDT loss a
    # mean over them
    return _optimize(optimizer, loss_fn, ("loss", "loss_vqa", "loss_fdt"),
                     count=lambda images, q_ids, *rest: q_ids.shape[0])


class RetrievalTrainState(NamedTuple):
    """What BLIP retrieval training carries from step to step, on the model's
    device: the online model (trained by the optimizer), ``params_m`` the
    momentum copies of the ``MOMENTUM_KEYS`` towers' parameters by the
    model's names (never trained, updated by EMA), the feature queue, and
    ``temp`` the 0-d ITC temperature, clamped to [0.001, 0.5] by each step
    and carried, not trained (the JAX step differentiates the params
    only)."""

    model: RetrievalModel
    params_m: Dict[str, torch.Tensor]
    queue: FeatureQueue
    temp: torch.Tensor


def _is_momentum(name: str) -> bool:
    return name.split(".", 1)[0] in MOMENTUM_KEYS


def init_retrieval_train_state(model: RetrievalModel, *, queue_size: int = 57600,
                               temp: float = 0.07, seed: int = 0,
                               params_m: Optional[Dict[str, torch.Tensor]] = None
                               ) -> RetrievalTrainState:
    """The state a retrieval run starts from: the momentum towers copies of
    the online ones (the reference ``copy_params``), or copies of
    ``params_m`` (by the model's parameter names, as
    :func:`~madtp_tpu_torch.ckpt.convert.load_retrieval_momentum` reads a
    checkpoint's), a queue from :func:`~madtp_tpu_torch.train.momentum.
    init_queue` at the projections' width, ``temp`` (0.07, the reference
    buffer's start)."""
    dev = model.space_dict.device
    online = {n: p for n, p in model.named_parameters() if _is_momentum(n)}
    if params_m is not None and set(params_m) != set(online):
        raise KeyError(f"momentum towers: {sorted(set(params_m) ^ set(online))[:3]} do not "
                       "match the model's")
    src = online if params_m is None else params_m
    params_m = {n: src[n].detach().to(dev, online[n].dtype, copy=True) for n in online}
    embed_dim = model.vision_proj.weight.shape[0]
    return RetrievalTrainState(model, params_m, init_queue(embed_dim, queue_size, seed, dev),
                               torch.tensor(temp, dtype=torch.float32, device=dev))


def _towers(model: RetrievalModel, images, ids, mask, *, temperature, prune_active,
            capacities_v, capacities_t):
    """Both towers (``towers`` in ``make_retrieval_train_step``): image and
    text features and their encoder outputs."""
    img_feat, vout = model.image_features(images, temperature=temperature,
                                          prune_active=prune_active, capacities=capacities_v)
    txt_feat, tout = model.text_features(ids, mask, temperature=temperature,
                                         prune_active=prune_active, capacities=capacities_t)
    return img_feat, vout, txt_feat, tout


def _itm_logits(model: RetrievalModel, ids, mask, memory: TokenState, *, temperature,
                prune_active, capacities_t):
    """The ITM head over the multimodal encoder's CLS: [rows, 2]."""
    out = model.text_encoder(ids, mask, encoder_state=memory, space_dict=model.space_dict,
                             temperature=temperature, prune_active=prune_active,
                             capacities=capacities_t)
    return linear(out.state.x[:, 0, :], model.itm_head.weight, model.itm_head.bias)


def make_retrieval_train_step(state: RetrievalTrainState, optimizer: torch.optim.Optimizer, *,
                              alpha: float = 0.4, momentum: float = 0.995, enc_token_id: int,
                              prune_active: bool = True, negative_all_rank: bool = False,
                              capacities_v: Optional[Sequence[int]] = None,
                              capacities_t: Optional[Sequence[int]] = None,
                              amp: bool = False, device="cuda"):
    """The ITC + ITM compression step (``make_retrieval_train_step``,
    ``madtp_tpu/train/loops.py:201-359``), over ``state`` in place:
    ``step(images, ids, mask, idx, temperature, alpha=None, *, noise=None,
    generator=None)``.  ``ids`` are the captions with CLS at slot 0 (the ITM
    writes ``enc_token_id`` there), ``idx`` [B] the image ids; ``alpha``
    (default the factory's) is taken per batch, like the temperature.  In
    order:

    1. ``temp`` clamped to [0.001, 0.5];
    2. the EMA of the momentum towers toward the current online weights;
    3. the online towers (with gradients) and the momentum towers (no
       gradient: the momentum weights, the online codebook), soft ITC
       targets over the momentum features and the queue, the ITC loss;
    4. the FDT losses of both towers' MAG features (else ``loss_ita``);
    5. two hard negatives per pair (:func:`~madtp_tpu_torch.train.losses.
       sample_hard_negatives`: ``noise`` a pair of Gumbel tensors over the
       global batch, [Bg, Bg], image-per-text then text-per-image, or drawn
       from ``generator``), the ITM over ``[pos, text with its negative
       image, image with its negative text]``, the memory without the
       image's key bias;
    6. ``loss_ita + loss_itm + 0.1 loss_fdt + 0.1 loss_fdt_m``, backward,
       the optimizer's update;
    7. the fp32 momentum features and ``idx`` into the queue.

    Under several processes, inside :func:`~madtp_tpu_torch.parallel.data.
    global_batch`, the step is the JAX step (``data_shards`` the ranks) on
    the global batch of ``Bg`` rows, each rank a contiguous block of ``B``
    (equal on every rank): the ITC runs this rank's rows against every
    rank's momentum features and ids and the queue; the negatives come from
    every rank's rows with ``negative_all_rank`` (the negative image's
    encoder states with their gradient, the reference's
    ``all_gather_with_grad``; the negative text's ids and mask without),
    else from the rank's own rows; each rank takes its rows of the global
    noise (with ``negative_all_rank`` every column, else its own block's);
    the ITM runs the rank's ``3 B`` rows (DTP's counts maxed over the
    ranks); the queue takes every rank's features and ids, so it stays the
    same on every rank; the gradients and losses are the global batch's
    (``B`` the count).  With one process both values of
    ``negative_all_rank`` mine the whole batch.  Returns ``{"loss",
    "loss_ita", "loss_itm", "loss_fdt", "loss_fdt_m"}`` as device scalars.
    ``device`` as :func:`make_nlvr_train_step`.  ``step.loss_fn`` takes the
    same arguments and returns the five losses and the global batch's
    momentum features and ids without the update and the enqueue; unlike
    the other factories' it changes the state: it advances the EMA (steps
    1-2) and writes the clamped ``temp``."""
    model = state.model
    _check_device(model, device)
    params = dict(model.named_parameters())
    names_m = list(state.params_m)
    online_m = [params[n] for n in names_m]
    towers, itm = _Bound(model, _towers), _Bound(model, _itm_logits)
    kw = dict(prune_active=prune_active, capacities_v=capacities_v, capacities_t=capacities_t)
    default_alpha = alpha

    def loss_fn(images, ids, mask, idx, temperature, alpha=None, *, noise=None, generator=None):
        a = default_alpha if alpha is None else alpha
        temp = state.temp.clamp(0.001, 0.5)
        momentum_update(online_m, state.params_m.values(), momentum)
        p, x = _amp_cast(amp, params, images)
        B = ids.shape[0]
        off, total = data.batch_rows(B)
        img_feat, vout, txt_feat, tout = functional_call(
            towers, _prefixed(p), (x, ids, mask), dict(kw, temperature=temperature))
        with torch.no_grad():
            pm = _amp_cast(amp, state.params_m)[0]
            m_img, m_vout, m_txt, m_tout = functional_call(
                towers, _prefixed({**p, **pm}), (x, ids, mask),
                dict(kw, temperature=temperature))
            q = state.queue
            idx_w, m_img_w, m_txt_w = (data.world_rows(t) for t in (idx, m_img, m_txt))
            sim_targets = L.id_match_targets(idx, torch.cat([idx_w, q.idx]))
            img_m_all = torch.cat([m_img_w.T.float(), q.image], dim=1)
            txt_m_all = torch.cat([m_txt_w.T.float(), q.text], dim=1)
            t_i2t = L.itc_soft_targets(m_img, txt_m_all, sim_targets, temp, a)
            t_t2i = L.itc_soft_targets(m_txt, img_m_all, sim_targets, temp, a)
        loss_ita = 0.5 * (L.itc_loss(img_feat, txt_m_all, t_i2t, temp)
                          + L.itc_loss(txt_feat, img_m_all, t_t2i, temp))

        loss_fdt = loss_fdt_m = loss_ita
        if prune_active and vout.sd_ft is not None and tout.sd_ft is not None:
            sd_dim = model.cfg.sd_dim
            loss_fdt = fdt_alignment_loss(vout.sd_ft, tout.sd_ft, sd_dim)
            loss_fdt_m = fdt_alignment_loss(m_vout.sd_ft, m_tout.sd_ft, sd_dim)

        enc_ids = ids.clone()
        enc_ids[:, 0] = enc_token_id
        vs = vout.state
        rows = slice(off, off + B)
        if negative_all_rank:  # candidates: every rank's rows
            cols = slice(0, total)
            cand_img, cand_txt, cand_idx = (data.world_rows(img_feat), data.world_rows(txt_feat),
                                            idx_w)
            cand_x = data.world_rows(vs.x, grad=True)
            cand_alive, cand_ids, cand_mask = (data.world_rows(t)
                                               for t in (vs.alive, enc_ids, mask))
        else:  # candidates: this rank's rows
            cols = rows
            cand_img, cand_txt, cand_idx = img_feat, txt_feat, idx
            cand_x, cand_alive, cand_ids, cand_mask = vs.x, vs.alive, enc_ids, mask
        noise_i, noise_t = (
            L.rank_noise(None if noise is None else noise[k], rows, cols, total,
                         generator=generator, device=img_feat.device) for k in (0, 1))
        neg_img = L.sample_hard_negatives(txt_feat, cand_img, idx, cand_idx, temp, noise=noise_i)
        neg_txt = L.sample_hard_negatives(img_feat, cand_txt, idx, cand_idx, temp, noise=noise_t)
        ids_all = torch.cat([enc_ids, enc_ids, cand_ids[neg_txt]])
        mask_all = torch.cat([mask, mask, cand_mask[neg_txt]])
        memory = TokenState(torch.cat([vs.x, cand_x[neg_img], vs.x]),
                            torch.cat([vs.alive, cand_alive[neg_img], vs.alive]), None)
        logits = functional_call(itm, _prefixed(p), (ids_all, mask_all, memory),
                                 dict(temperature=temperature, prune_active=prune_active,
                                      capacities_t=capacities_t))
        loss_itm = L.itm_loss(logits, B)
        loss = loss_ita + loss_itm + FDT_WEIGHT * loss_fdt + FDT_WEIGHT * loss_fdt_m
        state.temp.copy_(temp)
        return loss, loss_ita, loss_itm, loss_fdt, loss_fdt_m, m_img_w, m_txt_w, idx_w

    def after(out, *args, **kwargs):
        enqueue(state.queue, *out[5:8])

    # every loss is a mean over the pairs (the ITM over their 3 B rows)
    return _optimize(optimizer, loss_fn,
                     ("loss", "loss_ita", "loss_itm", "loss_fdt", "loss_fdt_m"), after,
                     count=lambda images, ids, *rest, **kw: ids.shape[0])


class ClipTrainState(NamedTuple):
    """What CLIP training carries from step to step, on the model's device:
    the online model (trained by the optimizer, its codebook ``space_dict``
    and ``logit_scale`` included), ``params_m`` the momentum copies of the
    ``CLIP_MOMENTUM_KEYS`` parameters by the model's names (never trained,
    updated by EMA), and the feature queue."""

    model: CLIPModel
    params_m: Dict[str, torch.Tensor]
    queue: FeatureQueue


def init_clip_train_state(model: CLIPModel, *, queue_size: int = 57600,
                          seed: int = 0) -> ClipTrainState:
    """The state a CLIP run starts from: momentum copies of the online
    weights and a queue from :func:`~madtp_tpu_torch.train.momentum.
    init_queue` at ``embed_dim`` (``compress_retrieval_clip.py:378-384``)."""
    if model.space_dict is None:
        raise ValueError("CLIP compression training needs the codebook: this model has no "
                         "space_dict")
    dev = model.space_dict.device
    params_m = {n: p.detach().clone() for n, p in model.named_parameters()
                if n.split(".", 1)[0] in CLIP_MOMENTUM_KEYS}
    return ClipTrainState(model, params_m,
                          init_queue(model.cfg.embed_dim, queue_size, seed, dev))


def _clip_towers(model: CLIPModel, images, text, *, temperature, prune_active, capacities_v):
    """Both towers (``towers`` in ``make_clip_train_step``): L2-normalised
    image and text features in the model's dtype and their MAG features."""
    v = model.encode_image(images, temperature=temperature, prune_active=prune_active,
                           capacities=capacities_v)
    t = model.encode_text(text, temperature=temperature, prune_active=prune_active)
    img = v.features / torch.linalg.vector_norm(v.features, dim=-1, keepdim=True)
    txt = t.features / torch.linalg.vector_norm(t.features, dim=-1, keepdim=True)
    return img, txt, v.sd_ft, t.sd_ft


def make_clip_train_step(state: ClipTrainState, optimizer: torch.optim.Optimizer, *,
                         alpha: float = 0.4, momentum: float = 0.995,
                         prune_active: bool = True,
                         capacities_v: Optional[Sequence[int]] = None,
                         amp: bool = False, device="cuda"):
    """The CLIP compression step (``make_clip_train_step``,
    ``madtp_tpu/train/loops.py:371-481``), over ``state`` in place:
    ``step(images, text, idx, temperature, alpha=None)``, ``text`` the
    token ids [B, context_length], ``idx`` [B] the image ids; ``alpha``
    (default the factory's) is taken per batch.  In order:

    1. the EMA of the momentum copies toward the current online weights;
    2. ``logit_scale`` read in fp32 from the master before the amp cast,
       clamped to [0, 4.6052] (no gradient outside) and exponentiated;
    3. the online towers with gradients (vision in mask mode, or gather
       mode with ``capacities_v``; text in mask mode);
    4. the momentum towers without gradients, with the reference's quirk:
       the *online* ``transformer`` and ``ln_final`` under the momentum
       token and positional embeddings and ``text_projection`` (the
       momentum ``transformer`` and ``ln_final`` copies are updated but
       never read), and the online codebook;
    5. soft targets ``alpha * softmax(s * m_img @ [m_txt^T, queue.text]) +
       (1 - alpha) * id_match_targets`` and back, the ITC loss of the
       online features against the same concatenations, ``s`` the scale;
    6. the FDT losses of both towers' MAG features, the momentum one
       without gradient (both ``loss_ita`` when a tower gives none);
    7. ``loss_ita + 0.1 loss_fdt + 0.1 loss_fdt_m``, backward, the
       optimizer's update of every parameter;
    8. the *online* features (fp32) and ``idx`` into the queue.

    ``amp`` runs both towers in bf16 (online, momentum and codebook cast);
    ``logit_scale``, the masters, the optimizer state and the queue stay
    fp32.  Under several processes, inside :func:`~madtp_tpu_torch.parallel.
    data.global_batch`, it is the JAX step on the global batch, each rank a
    contiguous block of ``B`` rows (equal on every rank): this rank's rows
    against every rank's momentum features and ids and the queue, the queue
    fed every rank's online features and ids, the gradients and losses the
    global batch's (``B`` the count), as :func:`make_retrieval_train_step`
    without negatives.  Returns ``{"loss", "loss_ita", "loss_fdt",
    "loss_fdt_m"}`` as device scalars.  ``device`` as
    :func:`make_nlvr_train_step`.  ``step.loss_fn`` takes the same arguments
    and returns the four losses and the global batch's online features and
    ids without the update and the enqueue; it advances the EMA."""
    model = state.model
    _check_device(model, device)
    params = dict(model.named_parameters())
    names_m = list(state.params_m)
    online_m = [params[n] for n in names_m]
    towers = _Bound(model, _clip_towers)
    kw = dict(prune_active=prune_active, capacities_v=capacities_v)
    default_alpha = alpha

    def loss_fn(images, text, idx, temperature, alpha=None):
        a = default_alpha if alpha is None else alpha
        momentum_update(online_m, state.params_m.values(), momentum)
        scale = params["logit_scale"].float().clamp(0.0, LOGIT_SCALE_MAX).exp()
        p, x = _amp_cast(amp, params, images)
        img, txt, sd_img, sd_txt = functional_call(
            towers, _prefixed(p), (x, text), dict(kw, temperature=temperature))
        data.batch_rows(text.shape[0])  # equal counts on every rank, or raise
        with torch.no_grad():
            pm = {n: t for n, t in _amp_cast(amp, state.params_m)[0].items()
                  if n.split(".", 1)[0] not in ("transformer", "ln_final")}
            m_img, m_txt, sd_img_m, sd_txt_m = functional_call(
                towers, _prefixed({**p, **pm}), (x, text), dict(kw, temperature=temperature))
            q = state.queue
            idx_w, m_img_w, m_txt_w = (data.world_rows(t) for t in (idx, m_img, m_txt))
            sim_targets = L.id_match_targets(idx, torch.cat([idx_w, q.idx]))
            img_m_all = torch.cat([m_img_w.T.float(), q.image], dim=1)
            txt_m_all = torch.cat([m_txt_w.T.float(), q.text], dim=1)
            t_i2t = L.itc_soft_targets(m_img, txt_m_all, sim_targets, None, a, logit_scale=scale)
            t_t2i = L.itc_soft_targets(m_txt, img_m_all, sim_targets, None, a, logit_scale=scale)
        loss_ita = 0.5 * (L.itc_loss(img, txt_m_all, t_i2t, None, logit_scale=scale)
                          + L.itc_loss(txt, img_m_all, t_t2i, None, logit_scale=scale))
        loss_fdt = loss_fdt_m = loss_ita
        if prune_active and sd_img is not None and sd_txt is not None:
            sd_dim = model.cfg.sd_dim
            loss_fdt = fdt_alignment_loss(sd_img, sd_txt, sd_dim)
            loss_fdt_m = fdt_alignment_loss(sd_img_m, sd_txt_m, sd_dim)
        loss = loss_ita + FDT_WEIGHT * loss_fdt + FDT_WEIGHT * loss_fdt_m
        return (loss, loss_ita, loss_fdt, loss_fdt_m, data.world_rows(img.detach()),
                data.world_rows(txt.detach()), idx_w)

    def after(out, *args, **kwargs):
        enqueue(state.queue, *out[4:7])

    # every loss is a mean over the pairs
    return _optimize(optimizer, loss_fn, ("loss", "loss_ita", "loss_fdt", "loss_fdt_m"), after,
                     count=lambda images, text, *rest, **kw: text.shape[0])
