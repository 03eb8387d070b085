"""BLIP VQAv2 evaluation by answer ranking, ``inference: 'rank'``
(counterpart of ``madtp_tpu/tasks/vqa.py:25-93`` and of the eval half of
``madtp_tpu/cli/compress_vqa.py:114-215``), single process; and
``inference: 'generate'``, :func:`generate_answers`.

* :func:`candidate_losses` and :func:`rank_answers`: one BOS decoder step
  gives the first-token distribution, restricted to the answer list's first
  tokens, and each question's top ``k`` answers; one decoder pass over the
  k candidates (the question memory shared, the BOS prefix reused) gives
  each candidate's label-smoothed loss; the lowest wins.
* :func:`probe_capacities` is ``--fast_eval``'s calibration (and
  ``--fast_train``'s), and :func:`evaluate` the whole eval with the
  analytic GFLOPs.
* Compression training (the train half of ``madtp_tpu/cli/compress_vqa.py:
  296-460``): :func:`train_batch` pads each question's answers to
  ``MAX_A`` with zero weights, :func:`train_epoch` runs one epoch of a step
  from :func:`madtp_tpu_torch.train.loops.make_vqa_train_step`.

Batches are ``(images [b, 3, H, W], q_ids [b, N], q_mask [b, N],
question_ids)`` numpy arrays, ``q_ids`` with the encoder token at slot 0 and
padded to the batch's longest question (the tokenizer's
``padding="longest"``).  The answer list comes tokenized: ``answer_ids``
[nA, La] with BOS at slot 0, as ``tokenize_answers`` makes it
(``madtp_tpu/cli/compress_vqa.py:33-37``), and its mask.
"""

from __future__ import annotations

import itertools
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from madtp_tpu_torch.models.blip import VQAModel
from madtp_tpu_torch.models.med import MedDecoder
from madtp_tpu_torch.prune.calibrate import fast_capacity_schedule
from madtp_tpu_torch.prune.dtp import TokenState
from madtp_tpu_torch.prune.flops import vqa_gflops
from madtp_tpu_torch.tasks.caption import beam_generate
from madtp_tpu_torch.train.epoch import run_epoch
from madtp_tpu_torch.utils.graph import CapturedStep

LABEL_SMOOTHING = 0.1  # reference models/med.py:1045
MAX_A = 10  # answers per training question: VQAv2 has 10 annotators
Q_MAX_LENGTH = 35  # the questions' token limit (reference models/blip_vqa.py)


def _ids(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=torch.long).to(device)


def candidate_losses(decoder: MedDecoder, q_state: TokenState, answer_ids: torch.Tensor,
                     answer_mask: torch.Tensor, *, k: int = 128, pad_token_id: int = 0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each question's top ``k`` answers by first-token probability and
    their summed label-smoothed losses (``rank_answers`` up to its argmax):
    ``q_state`` the question encoder's output (the decoder's memory,
    [B, S, D]); ``answer_ids`` and ``answer_mask`` [nA, La] long tensors on
    the model's device.  Returns ``(loss [B, k] fp32, topk_ids [B, k])``.

    The top k is a stable descending sort: every answer that shares a first
    token has the same first-token probability, and ``jax.lax.top_k`` puts
    the lower index first among equal values, which ``torch.topk`` does not
    promise.  Nothing here waits on the card."""
    eps = LABEL_SMOOTHING
    B = q_state.x.shape[0]
    La = answer_ids.shape[1]
    start = answer_ids[:1, :1].expand(B, 1)  # BOS
    hidden, bos_k, bos_v = decoder.bos_step(start, q_state)
    logp0 = torch.log_softmax(decoder.lm_head(hidden)[:, 0].float(), dim=-1)  # [B, V]
    prob_first = logp0.exp()[:, answer_ids[:, 1]]  # [B, nA]
    topk_ids = torch.sort(prob_first, dim=1, descending=True, stable=True).indices[:, :k]
    cand_ids, cand_mask = answer_ids[topk_ids], answer_mask[topk_ids]  # [B, k, La]

    # the loss term of position 0 from the BOS step's logits: the label is
    # the candidate's first token
    first = cand_ids[:, :, 1]
    term0 = (1.0 - eps) * -logp0.gather(1, first) + eps * -logp0.mean(dim=-1, keepdim=True)
    term0 = torch.where(first == pad_token_id, torch.zeros_like(term0), term0)

    hidden = decoder.rank_forward(cand_ids, cand_mask, q_state, prefix_kv=(bos_k, bos_v))
    # positions 1..La-2 predict tokens 2..La-1; position La-1 has no label
    logp2 = torch.log_softmax(decoder.lm_head(hidden[:, :La - 2]).float(), dim=-1)
    labels = cand_ids.reshape(B * k, La)[:, 2:]
    valid = labels != pad_token_id
    nll = -logp2.gather(-1, torch.where(valid, labels, torch.zeros_like(labels))[..., None])[..., 0]
    loss2 = torch.where(valid, (1.0 - eps) * nll + eps * -logp2.mean(dim=-1),
                        torch.zeros_like(nll))
    return term0 + loss2.sum(dim=1).view(B, k), topk_ids


def rank_answers(decoder: MedDecoder, q_state: TokenState, answer_ids: torch.Tensor,
                 answer_mask: torch.Tensor, *, k: int = 128, pad_token_id: int = 0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each question's answer (``rank_answers``): the candidate of
    :func:`candidate_losses` with the lowest loss, the first of equals as
    ``jnp.argmax`` takes it.  Returns ``(best [B] indices into the answer
    list, topk_ids [B, k])``."""
    loss, topk_ids = candidate_losses(decoder, q_state, answer_ids, answer_mask, k=k,
                                      pad_token_id=pad_token_id)
    best = torch.argmax(-loss, dim=1)
    return topk_ids.gather(1, best[:, None])[:, 0], topk_ids


def generate_answers(model: VQAModel, images: torch.Tensor, q_ids: torch.Tensor,
                     q_mask: torch.Tensor, *, temperature: float, bos_token_id: int,
                     eos_token_id: int, pad_token_id: int = 0, num_beams: int = 3,
                     max_length: int = 10, min_length: int = 1, graph: bool = True
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``inference: 'generate'`` (``gen_step``, ``madtp_tpu/cli/
    compress_vqa.py:128-146``): :meth:`VQAModel.encode` in mask mode, pruned
    when ``temperature > 0``, then :func:`~madtp_tpu_torch.tasks.caption.
    beam_generate` over the question state from a BOS prompt, as one captured
    step (``graph=False``: eagerly).  Inputs are tensors on the model's
    device.  Returns ``(sequences [B, max_length], v_kept, q_kept)`` without
    waiting for them."""
    prune = temperature > 0

    @torch.inference_mode()
    def step(images, q_ids, q_mask, t):
        out, _, v_kept = model.encode(images, q_ids, q_mask, temperature=t, prune_active=prune)
        bos = torch.full((q_ids.shape[0], 1), bos_token_id, dtype=torch.long,
                         device=q_ids.device)
        seqs = beam_generate(model.text_decoder, out.state, bos, num_beams=num_beams,
                             max_length=max_length, min_length=min_length,
                             eos_token_id=eos_token_id, pad_token_id=pad_token_id)
        return seqs, v_kept, out.kept_counts

    if graph:
        step = CapturedStep(step, "vqa_generate", model, static=(
            prune, bos_token_id, eos_token_id, pad_token_id, num_beams, max_length, min_length))
    return step(images, q_ids, q_mask, temperature)


def make_rank_step(model: VQAModel, prune_active: bool,
                   capacities_v: Optional[Sequence[int]] = None,
                   capacities_t: Optional[Sequence[int]] = None, *, k: int,
                   pad_token_id: int = 0, graph: bool = True):
    """``eval_step`` of ``compress_vqa``: ``step(images, q_ids, q_mask,
    answer_ids, answer_mask, temperature) -> (best, v_kept, q_kept)``, the
    towers (gather mode with capacities) and :func:`rank_answers` at ``k``,
    captured with the answer list as an input (``graph=False``: eager)."""
    @torch.inference_mode()
    def step(images, q_ids, q_mask, a_ids, a_mask, t):
        out, _, v_kept = model.encode(images, q_ids, q_mask, temperature=t,
                                      prune_active=prune_active, capacities_v=capacities_v,
                                      capacities_t=capacities_t)
        best, _ = rank_answers(model.text_decoder, out.state, a_ids, a_mask, k=k,
                               pad_token_id=pad_token_id)
        return best, v_kept, out.kept_counts

    if not graph:
        return step
    return CapturedStep(step, "vqa_rank", model, static=(
        prune_active, capacities_v, capacities_t, k, pad_token_id))


def _pad_to(a: np.ndarray, n: int) -> np.ndarray:
    a = np.asarray(a)
    return np.pad(a, ((0, 0), (0, max(0, n - a.shape[1]))))


@torch.inference_mode()
def probe_capacities(model: VQAModel, batches: Iterable, temperature: float,
                     cap_mode: str = "ceil", max_length: int = 35):
    """``--fast_eval``'s calibration (``madtp_tpu/cli/compress_vqa.py:
    148-178``): the mask-mode towers on the first 4 batches, the questions
    padded to ``max_length`` (one probe shape, as ``compress_vqa`` pads them),
    at ``temperature``, then :func:`fast_capacity_schedule` over both towers'
    kept counts.  Returns ``(capacities_v, capacities_t)``."""
    dev = model.space_dict.device
    vks, tks = [], []
    for images, q_ids, q_mask, _ in itertools.islice(batches, 4):
        out, _, vk = model.encode(torch.from_numpy(np.asarray(images)).to(dev),
                                  _ids(_pad_to(q_ids, max_length), dev),
                                  _ids(_pad_to(q_mask, max_length), dev),
                                  temperature=temperature, prune_active=True)
        vks.append(vk.cpu().numpy())
        tks.append(out.kept_counts.cpu().numpy())
    return fast_capacity_schedule(np.stack(vks), np.stack(tks), cap_mode)


def evaluate(model: VQAModel, batches: Iterable, answer_ids, answer_mask, *,
             temperature: float, k_test: int = 128,
             capacities_v: Optional[Sequence[int]] = None,
             capacities_t: Optional[Sequence[int]] = None, pad_token_id: int = 0,
             graph: bool = True) -> Tuple[List[Tuple[int, int]], float]:
    """The VQA eval of ``compress_vqa`` (single process): prune when
    ``temperature > 0`` (gather mode with capacities), rank each batch's
    questions against the answer list at ``k_test`` (capped at the list's
    length), and average ``vqa_gflops`` over the batches with
    ``n_answers=k_test``.  Batch ``i+1`` is dispatched before batch ``i`` is
    read back.  Returns ``(results, Cur_Gflops)``, ``results`` the
    ``(question_id, answer index)`` pairs in order.  It runs where the model
    lives.  Each batch (encode and ranking) runs as a captured step, the
    answer list one of its inputs (``graph=False``: eagerly)."""
    cfg = model.cfg
    dev = model.space_dict.device
    a_ids, a_mask = _ids(answer_ids, dev), _ids(answer_mask, dev)
    k = min(k_test, a_ids.shape[0])
    prune = temperature > 0
    results: List[Tuple[int, int]] = []
    g_sum, n = 0.0, 0

    step = make_rank_step(model, prune, capacities_v, capacities_t, k=k,
                          pad_token_id=pad_token_id, graph=graph)

    def consume(pend):
        nonlocal g_sum, n
        (best, v_kept, q_kept), qids, text_w = pend
        results.extend((int(q), int(b)) for q, b in zip(qids, best.cpu().numpy()))
        g_sum += vqa_gflops(cfg.vit, cfg.med, v_kept.cpu().numpy(), q_kept.cpu().numpy(),
                            text_w, n_answers=k_test)
        n += 1

    pending = None
    for images, q_ids, q_mask, qids in batches:
        out = step(torch.from_numpy(np.asarray(images)).to(dev), _ids(q_ids, dev),
                   _ids(q_mask, dev), a_ids, a_mask, temperature)
        if pending is not None:
            consume(pending)
        pending = (out, qids, np.shape(q_ids)[1])
    if pending is not None:
        consume(pending)
    return results, g_sum / max(n, 1)


def tokenize_answers(tokenizer, answers: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
    """Answers padded to the longest, BOS in slot 0 (``tokenize_answers``,
    ``madtp_tpu/cli/compress_vqa.py:33-37``): int64 ``(ids, mask)``."""
    out = tokenizer(list(answers), padding="longest")
    ids = np.array(out["input_ids"], np.int64)
    ids[:, 0] = tokenizer.bos_token_id
    return ids, np.array(out["attention_mask"], np.int64)


def train_batch(tokenizer, questions: Sequence[str], answers: Sequence[str], weights,
                counts: Sequence[int]):
    """A training batch (``compress_vqa.py:425-446``) from ``vqa_collate``'s
    ragged answers: ``answers`` and ``weights`` flat, ``counts`` per
    question.  Questions padded to the longest (at most 35 tokens), the
    encoder token in slot 0; each question's first ``MAX_A`` answers in
    ``[B, MAX_A, La]`` with BOS in slot 0, the rest of the rows padding
    with weight 0.  Returns int64 ``q_ids, q_mask, a_ids, a_mask`` and fp32
    ``weights`` [B, MAX_A].  A question with more answers than ``MAX_A``
    drops the extra ones (the JAX driver would then
    misalign the next question's; VQAv2 never has more than 10)."""
    q = tokenizer(list(questions), padding="longest", max_length=Q_MAX_LENGTH)
    q_ids = np.array(q["input_ids"], np.int64)
    q_ids[:, 0] = tokenizer.enc_token_id
    a_ids, a_mask = tokenize_answers(tokenizer, answers)
    weights = np.asarray(weights, np.float32)
    B, La = len(counts), a_ids.shape[1]
    ids = np.zeros((B, MAX_A, La), np.int64)
    msk = np.zeros((B, MAX_A, La), np.int64)
    w = np.zeros((B, MAX_A), np.float32)
    pos = 0
    for b, cnt in enumerate(counts):
        k = min(cnt, MAX_A)
        ids[b, :k] = a_ids[pos:pos + k]
        msk[b, :k] = a_mask[pos:pos + k]
        w[b, :k] = weights[pos:pos + k]
        pos += cnt
    return q_ids, np.array(q["attention_mask"], np.int64), ids, msk, w


def train_epoch(model: VQAModel, train_step, loader_fn: Callable[[], Iterable], tokenizer,
                temperature: float, *, print_fn=print, print_freq: int = 50,
                lr: float = 0.0, stop=None) -> dict:
    """One compression-training epoch (single process) of ``train_step``
    (:func:`~madtp_tpu_torch.train.loops.make_vqa_train_step`'s step) over
    ``loader_fn()``'s ``(images, questions, answers, weights, counts)``
    batches (``vqa_collate``'s), each made by :func:`train_batch`.  Returns
    the stats of :func:`~madtp_tpu_torch.train.epoch.run_epoch`: the means of
    ``temperature``, ``lr``, ``loss``, ``loss_vqa`` and ``loss_fdt``, and
    ``batches_done``."""
    dev = model.space_dict.device

    def run_step(_, batch):
        images, questions, answers, weights, counts = batch
        arrays = train_batch(tokenizer, questions, answers, weights, counts)
        return train_step(torch.from_numpy(np.asarray(images)).to(dev),
                          *(torch.from_numpy(a).to(dev) for a in arrays), temperature)

    return run_epoch(loader_fn(), run_step, temperature, lr=lr, print_fn=print_fn,
                     print_freq=print_freq, stop=stop)
