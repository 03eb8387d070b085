"""The compression train steps
(counterpart of ``madtp_tpu/train/loops.py:42-359``): NLVR, caption, VQA and
BLIP retrieval.

Each factory returns ``step(...)``, which runs one forward, backward and
optimizer update of the model in place and returns its losses as device
scalars; nothing in a step waits on the card.  The total loss is the task
loss plus ``0.1 * loss_fdt`` (retrieval: plus ``0.1 * loss_fdt_m`` too).
Dropout and drop-path stay off, as in the JAX package's drivers.  ``amp``
computes in bf16 against the fp32 masters (:func:`_amp_cast`).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence

import torch
from torch import nn
from torch.func import functional_call

from madtp_tpu_torch.core.device import resolve_device
from madtp_tpu_torch.models.blip import (CaptionModel, NLVRModel, RetrievalModel, VQAModel,
                                         fdt_alignment_loss)
from madtp_tpu_torch.models.med import lm_loss
from madtp_tpu_torch.ops.layers import linear
from madtp_tpu_torch.prune.dtp import TokenState
from madtp_tpu_torch.train import losses as L
from madtp_tpu_torch.train.momentum import FeatureQueue, enqueue, init_queue, momentum_update

FDT_WEIGHT = 0.1
MOMENTUM_KEYS = ("visual_encoder", "vision_proj", "text_encoder", "text_proj")


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


def _optimize(optimizer: torch.optim.Optimizer, loss_fn, names: Sequence[str], after=None):
    """The step shared by every factory: zero the gradients, run ``loss_fn``
    (the total first, then the parts ``names``), backward, update, then
    ``after(out, *args, **kwargs)`` when given (retrieval: the enqueue)."""
    def step(*args, **kwargs):
        optimizer.zero_grad(set_to_none=True)
        out = loss_fn(*args, **kwargs)
        out[0].backward()
        optimizer.step()
        if after is not None:
            after(out, *args, **kwargs)
        return {n: v.detach() for n, v in zip(names, out)}
    step.loss_fn = loss_fn
    return step


def make_nlvr_train_step(model: NLVRModel, optimizer: torch.optim.Optimizer, *,
                         prune_active: bool = True,
                         capacities_v: Optional[Sequence[int]] = None,
                         capacities_t: Optional[Sequence[int]] = None,
                         amp: bool = False, device="cuda"):
    """``step(images, ids, mask, targets, temperature)`` runs one forward,
    backward and optimizer update of ``model`` in place and returns
    ``{"loss", "loss_ori", "loss_fdt"}`` as device scalars; nothing in the
    step waits on the card.  ``capacities_v``/``capacities_t`` train in
    gather mode (``--fast_train``).  ``device`` is where the model must
    live: ``"cuda"`` (the default) raises without a card, ``"cpu"`` runs
    the plain path.  ``step.loss_fn`` takes the same arguments and returns
    ``(loss, loss_ori, loss_fdt)`` without the update."""
    _check_device(model, device)
    params = dict(model.named_parameters())
    kw = dict(prune_active=prune_active, capacities_v=capacities_v,
              capacities_t=capacities_t)

    def loss_fn(images, ids, mask, targets, temperature):
        p, x = _amp_cast(amp, params, images)
        loss_ori, loss_fdt, _ = functional_call(
            model, p, (x, ids, mask), dict(kw, temperature=temperature, targets=targets))
        return loss_ori + FDT_WEIGHT * loss_fdt, loss_ori, loss_fdt

    return _optimize(optimizer, loss_fn, ("loss", "loss_ori", "loss_fdt"))


def make_caption_train_step(model: CaptionModel, optimizer: torch.optim.Optimizer, *,
                            prune_active: bool = True,
                            capacities_v: Optional[Sequence[int]] = None,
                            amp: bool = False, device="cuda"):
    """``step(images, ids, mask, labels, temperature)`` (``make_caption_train_step``,
    ``madtp_tpu/train/loops.py:106-141``): the caption model's training pass
    (:meth:`CaptionModel.forward`, the image tower gather mode with
    ``capacities_v``), one backward and update in place.  The decoder runs
    unpruned and gives no text MAG features, so ``loss_fdt`` is ``loss_lm``
    again, the reference's fallback.  Returns ``{"loss", "loss_lm",
    "loss_fdt"}`` as device scalars; ``device`` as
    :func:`make_nlvr_train_step`."""
    _check_device(model, device)
    params = dict(model.named_parameters())
    kw = dict(prune_active=prune_active, capacities=capacities_v)

    def loss_fn(images, ids, mask, labels, temperature):
        p, x = _amp_cast(amp, params, images)
        loss_lm, _, _ = functional_call(
            model, p, (x, ids, mask), dict(kw, temperature=temperature, labels=labels))
        loss_fdt = loss_lm
        return loss_lm + FDT_WEIGHT * loss_fdt, loss_lm, loss_fdt

    return _optimize(optimizer, loss_fn, ("loss", "loss_lm", "loss_fdt"))


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

    return _optimize(optimizer, loss_fn, ("loss", "loss_vqa", "loss_fdt"))


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
                               temp: float = 0.07, seed: int = 0) -> RetrievalTrainState:
    """The state a retrieval run starts from: the momentum towers copies of
    the online ones, a queue from :func:`~madtp_tpu_torch.train.momentum.
    init_queue` at the projections' width, ``temp`` 0.07 (the reference
    ``copy_params`` and buffers)."""
    dev = model.space_dict.device
    params_m = {n: p.detach().clone() for n, p in model.named_parameters() if _is_momentum(n)}
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
                              prune_active: bool = True,
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
       sample_hard_negatives`: ``noise`` a pair of [B, B] Gumbel tensors,
       image-per-text then text-per-image, or drawn from ``generator``),
       the ITM over ``[pos, text with its negative image, image with its
       negative text]``, the memory without the image's key bias;
    6. ``loss_ita + loss_itm + 0.1 loss_fdt + 0.1 loss_fdt_m``, backward,
       the optimizer's update;
    7. the fp32 momentum features and ``idx`` into the queue.

    One process mines its negatives over the whole batch, as the JAX step
    does with ``negative_all_rank`` or one data shard.  Returns ``{"loss",
    "loss_ita", "loss_itm", "loss_fdt", "loss_fdt_m"}`` as device scalars;
    nothing waits on the card.  ``device`` as :func:`make_nlvr_train_step`.
    ``step.loss_fn`` takes the same arguments and returns the five losses
    and the momentum features without the update and the enqueue; unlike
    the other factories' it changes the state: it advances the EMA
    (steps 1-2) and writes the clamped ``temp``."""
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
        img_feat, vout, txt_feat, tout = functional_call(
            towers, _prefixed(p), (x, ids, mask), dict(kw, temperature=temperature))
        with torch.no_grad():
            pm = _amp_cast(amp, state.params_m)[0]
            m_img, m_vout, m_txt, m_tout = functional_call(
                towers, _prefixed({**p, **pm}), (x, ids, mask),
                dict(kw, temperature=temperature))
            q = state.queue
            sim_targets = L.id_match_targets(idx, torch.cat([idx, q.idx]))
            img_m_all = torch.cat([m_img.T.float(), q.image], dim=1)
            txt_m_all = torch.cat([m_txt.T.float(), q.text], dim=1)
            t_i2t = L.itc_soft_targets(m_img, txt_m_all, sim_targets, temp, a)
            t_t2i = L.itc_soft_targets(m_txt, img_m_all, sim_targets, temp, a)
        loss_ita = 0.5 * (L.itc_loss(img_feat, txt_m_all, t_i2t, temp)
                          + L.itc_loss(txt_feat, img_m_all, t_t2i, temp))

        loss_fdt = loss_fdt_m = loss_ita
        if prune_active and vout.sd_ft is not None and tout.sd_ft is not None:
            sd_dim = model.cfg.sd_dim
            loss_fdt = fdt_alignment_loss(vout.sd_ft, tout.sd_ft, sd_dim)
            loss_fdt_m = fdt_alignment_loss(m_vout.sd_ft, m_tout.sd_ft, sd_dim)

        noise_i, noise_t = (None, None) if noise is None else noise
        neg_img = L.sample_hard_negatives(txt_feat, img_feat, idx, idx, temp, noise=noise_i,
                                          generator=generator)
        neg_txt = L.sample_hard_negatives(img_feat, txt_feat, idx, idx, temp, noise=noise_t,
                                          generator=generator)
        enc_ids = ids.clone()
        enc_ids[:, 0] = enc_token_id
        ids_all = torch.cat([enc_ids, enc_ids, enc_ids[neg_txt]])
        mask_all = torch.cat([mask, mask, mask[neg_txt]])
        vs = vout.state
        memory = TokenState(torch.cat([vs.x, vs.x[neg_img], vs.x]),
                            torch.cat([vs.alive, vs.alive[neg_img], vs.alive]), None)
        logits = functional_call(itm, _prefixed(p), (ids_all, mask_all, memory),
                                 dict(temperature=temperature, prune_active=prune_active,
                                      capacities_t=capacities_t))
        loss_itm = L.itm_loss(logits, B)
        loss = loss_ita + loss_itm + FDT_WEIGHT * loss_fdt + FDT_WEIGHT * loss_fdt_m
        state.temp.copy_(temp)
        return loss, loss_ita, loss_itm, loss_fdt, loss_fdt_m, m_img, m_txt

    def after(out, images, ids, mask, idx, *args, **kwargs):
        enqueue(state.queue, out[5], out[6], idx)

    return _optimize(optimizer, loss_fn,
                     ("loss", "loss_ita", "loss_itm", "loss_fdt", "loss_fdt_m"), after)
