"""BLIP image-text retrieval evaluation (ITC shortlist, then ITM rerank) and
compression training
(counterpart of ``madtp_tpu/tasks/retrieval.py:80-139`` and ``:242-389``, and
of the eval half of ``madtp_tpu/cli/compress_retrieval.py:130-229``),
single process.

* :func:`encode_corpus` embeds every image batch as given (DTP couples the
  images of a batch through its batch-max keep count, so the batches decide
  the result) and the texts in batches of ``text_batch``; the image states
  stay on the device in the model's dtype for the rerank.
* :func:`rerank_scores` takes the fp32 similarity matrix on the host, each
  row's top ``k_test`` candidates, and runs one ITM forward per row with the
  row's candidates as its batch, in both directions.  Each forward is its own
  DTP batch, as in the reference's one-row-per-step loop (the JAX package
  ``vmap`` s the rows, which keeps them apart the same way); stacking rows
  into one forward would couple them.  Unscored entries stay at -100.
* :func:`probe_capacities` is ``--fast_eval``'s calibration (and
  ``--fast_train``'s); :func:`evaluate` runs the whole eval and returns
  ``itm_eval``'s recalls.
* :func:`train_epoch` runs one compression-training epoch
  (``madtp_tpu/cli/compress_retrieval.py:405-450``) of a step from
  :func:`madtp_tpu_torch.train.loops.make_retrieval_train_step`.
"""

from __future__ import annotations

import itertools
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from madtp_tpu_torch.eval.metrics import itm_eval
from madtp_tpu_torch.models.blip import RetrievalModel
from madtp_tpu_torch.prune.calibrate import fast_capacity_schedule
from madtp_tpu_torch.prune.dtp import TokenState
from madtp_tpu_torch.train.epoch import run_epoch
from madtp_tpu_torch.utils.cache import BoundedCache
from madtp_tpu_torch.utils.graph import CapturedStep

MAX_LENGTH = 35  # the training captions' padded length (compress_retrieval.py:425)


def _ids(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=torch.long).to(device)


def corpus_steps(model: RetrievalModel, prune_active: bool,
                 capacities_v: Optional[Sequence[int]] = None,
                 capacities_t: Optional[Sequence[int]] = None, *, graph: bool = True):
    """The corpus encode's two steps (``_corpus_steps``): ``img_step(images,
    temperature) -> (feat, x, alive)`` and ``txt_step(ids, mask,
    temperature) -> feat``, captured (``graph=False``: eager)."""
    @torch.inference_mode()
    def img_step(images, t):
        feat, out = model.image_features(images, temperature=t, prune_active=prune_active,
                                         capacities=capacities_v)
        return feat, out.state.x, out.state.alive

    @torch.inference_mode()
    def txt_step(ids, mask, t):
        return model.text_features(ids, mask, temperature=t, prune_active=prune_active,
                                   capacities=capacities_t)[0]

    if not graph:
        return img_step, txt_step
    return (CapturedStep(img_step, "retrieval_image", model,
                         static=(prune_active, capacities_v)),
            CapturedStep(txt_step, "retrieval_text", model,
                         static=(prune_active, capacities_t)))


@torch.inference_mode()
def encode_corpus(model: RetrievalModel, image_batches: Iterable[np.ndarray],
                  text_ids: np.ndarray, text_mask: np.ndarray, *, temperature=0.0,
                  prune_active: bool = False, capacities_v: Optional[Sequence[int]] = None,
                  capacities_t: Optional[Sequence[int]] = None, text_batch: int = 256,
                  graph: bool = True) -> Tuple[np.ndarray, TokenState, np.ndarray]:
    """Stage 1: embed every image batch (``[b, 3, H, W]`` numpy) and the
    texts (``[n_texts, N]`` ids with CLS at slot 0, and their mask), each
    batch a captured step (``graph=False``: eagerly).

    Returns ``(img_feats [ni, E], img_states, txt_feats [nt, E])``: the
    features as fp32 numpy arrays, ``img_states`` a :class:`TokenState`
    ``[ni, S, D]`` on the model's device in its dtype."""
    dev = model.space_dict.device
    img_step, txt_step = corpus_steps(model, prune_active, capacities_v, capacities_t,
                                      graph=graph)
    img_feats, xs, alives, txt_feats = [], [], [], []
    for images in image_batches:
        feat, x, alive = img_step(torch.from_numpy(np.asarray(images)).to(dev), temperature)
        img_feats.append(feat)
        xs.append(x)
        alives.append(alive)
    ids, mask = _ids(text_ids, dev), _ids(text_mask, dev)
    for i in range(0, ids.shape[0], text_batch):
        txt_feats.append(txt_step(ids[i:i + text_batch], mask[i:i + text_batch], temperature))
    states = TokenState(torch.cat(xs), torch.cat(alives), None)
    return (torch.cat(img_feats).float().cpu().numpy(), states,
            torch.cat(txt_feats).float().cpu().numpy())


@torch.inference_mode()
def rerank_scores(model: RetrievalModel, img_feats: np.ndarray, img_states: TokenState,
                  txt_feats: np.ndarray, text_ids: np.ndarray, text_mask: np.ndarray, *,
                  k_test: int = 128, temperature=0.0, prune_active: bool = False,
                  capacities_t: Optional[Sequence[int]] = None, graph: bool = True
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Stage 2: ``sims = img_feats @ txt_feats.T`` in fp32 on the host, then
    for each image its top ``k_test`` texts and for each text its top
    ``k_test`` images, scored ``ITM + sim``.  ``text_ids`` carry the
    encoder token at slot 0.  For image-to-text rows the one image state is
    broadcast to the k candidates, whose key and value projections are
    computed per candidate, as the JAX package does.

    The corpus stays on the device at fixed addresses for the call.  Each
    direction's ITM forward of one row is one captured step, its inputs the
    row's index and the temperature: it gathers the row's candidates from
    the resident corpus and writes its scores into row ``r`` of a
    ``[rows, k]`` device tensor, read back once per direction.  Its graph
    lives only for this call (``graph=False``: eagerly).

    Returns ``(score_i2t [ni, nt], score_t2i [nt, ni])`` fp32, -100 where not
    scored."""
    sims = np.asarray(img_feats, np.float32) @ np.asarray(txt_feats, np.float32).T
    dev = model.space_dict.device
    ids_all, mask_all = _ids(text_ids, dev), _ids(text_mask, dev)
    sx_all = img_states.x.to(dev, model.space_dict.dtype)
    sa_all = img_states.alive.to(dev)

    def itm_rows(topk: np.ndarray, i2t: bool) -> np.ndarray:
        cands = _ids(topk, dev)
        n, k = topk.shape
        scores = torch.empty((n, k), dtype=torch.float32, device=dev)

        def row(r, t):  # r: the row's index, a [1] device tensor
            c = cands.index_select(0, r).view(k)
            if i2t:
                ids, mask = ids_all.index_select(0, c), mask_all.index_select(0, c)
                state = TokenState(sx_all.index_select(0, r).expand(k, -1, -1),
                                   sa_all.index_select(0, r).expand(k, -1), None)
            else:
                ids, mask = ids_all.index_select(0, r).expand(k, -1), \
                    mask_all.index_select(0, r).expand(k, -1)
                state = TokenState(sx_all.index_select(0, c), sa_all.index_select(0, c), None)
            s = model.itm_score(ids, mask, state, temperature=t, prune_active=prune_active,
                                capacities=capacities_t)
            scores.index_copy_(0, r, s.float()[None])

        if graph:
            row = CapturedStep(row, "retrieval_itm_row", model,
                               static=(i2t, prune_active, capacities_t),
                               cache=BoundedCache(maxsize=1))
        rows = torch.arange(n, device=dev)
        for r in range(n):
            row(rows[r:r + 1], temperature)
        return scores.cpu().numpy()

    def direction(s: np.ndarray, i2t: bool) -> np.ndarray:
        topk = np.argsort(-s, axis=1)[:, :k_test]
        rows = np.arange(s.shape[0])[:, None]
        out = np.full(s.shape, -100.0, np.float32)
        out[rows, topk] = itm_rows(topk, i2t) + s[rows, topk]
        return out

    return direction(sims, True), direction(sims.T, False)


@torch.inference_mode()
def probe_capacities(model: RetrievalModel, image_batches: Iterable[np.ndarray],
                     text_ids: np.ndarray, text_mask: np.ndarray, temperature: float,
                     cap_mode: str = "ceil"):
    """``--fast_eval``'s calibration (``madtp_tpu/cli/compress_retrieval.py:
    135-164``): the mask-mode image tower on the first 4 image batches and
    the text tower on the first 32 texts in batches of 8, at
    ``temperature``, then :func:`fast_capacity_schedule` over their kept
    counts.  Returns ``(capacities_v, capacities_t)``."""
    dev = model.space_dict.device
    vks, tks = [], []
    for images in itertools.islice(image_batches, 4):
        _, out = model.image_features(torch.from_numpy(np.asarray(images)).to(dev),
                                      temperature=temperature, prune_active=True)
        vks.append(out.kept_counts.cpu().numpy())
    ids, mask = _ids(text_ids, dev), _ids(text_mask, dev)
    for i in range(0, min(ids.shape[0], 32), 8):
        _, out = model.text_features(ids[i:i + 8], mask[i:i + 8], temperature=temperature,
                                     prune_active=True)
        tks.append(out.kept_counts.cpu().numpy())
    return fast_capacity_schedule(np.stack(vks), np.stack(tks), cap_mode)


def evaluate(model: RetrievalModel, image_batches: Iterable[np.ndarray],
             text_ids: np.ndarray, text_mask: np.ndarray, txt2img: Sequence[int],
             img2txt: Sequence[Sequence[int]], temperature: float, *, enc_token_id: int,
             k_test: int = 256, capacities_v: Optional[Sequence[int]] = None,
             capacities_t: Optional[Sequence[int]] = None, text_batch: int = 256,
             graph: bool = True) -> Dict[str, float]:
    """The retrieval eval of ``compress_retrieval`` (single process): prune
    when ``temperature > 0`` (gather mode with capacities), encode the
    corpus, rerank with the encoder token in slot 0 of the ITM's text
    (``madtp_tpu/cli/compress_retrieval.py:211-213``) and ``k_test`` capped
    at the number of texts, and return ``itm_eval``'s recalls.  It runs
    where the model lives, which its constructor chose, through captured
    steps (``graph=False``: eagerly)."""
    prune = temperature > 0
    img_feats, img_states, txt_feats = encode_corpus(
        model, image_batches, text_ids, text_mask, temperature=temperature,
        prune_active=prune, capacities_v=capacities_v, capacities_t=capacities_t,
        text_batch=text_batch, graph=graph)
    enc_ids = np.array(text_ids)
    enc_ids[:, 0] = enc_token_id
    s_i2t, s_t2i = rerank_scores(
        model, img_feats, img_states, txt_feats, enc_ids, text_mask,
        k_test=min(k_test, len(enc_ids)), temperature=temperature, prune_active=prune,
        capacities_t=capacities_t, graph=graph)
    return itm_eval(s_i2t, s_t2i, txt2img, img2txt)


def train_epoch(model: RetrievalModel, train_step, loader_fn: Callable[[], Iterable], tokenizer,
                temperature: float, *, epoch: int, epoch_len: int, alpha: float = 0.4,
                generator: Optional[torch.Generator] = None, max_length: int = MAX_LENGTH,
                print_fn=print, print_freq: int = 50, lr: float = 0.0, stop=None) -> dict:
    """One compression-training epoch (single process) of ``train_step``
    (:func:`~madtp_tpu_torch.train.loops.make_retrieval_train_step`'s step,
    over ``model``'s train state) on ``loader_fn()``'s ``(images, captions,
    image_ids)`` batches, the captions padded to ``max_length``.  Epoch 0
    ramps the soft-target weight, ``alpha * min(1, done / epoch_len)`` at its
    ``done``-th batch; ``generator`` (one per run, on the model's device)
    draws every step's hard negatives.  Returns the stats of
    :func:`~madtp_tpu_torch.train.epoch.run_epoch`: the means of
    ``temperature``, ``lr``, ``alpha``, ``loss``, ``loss_ita``,
    ``loss_itm``, ``loss_fdt`` and ``loss_fdt_m``, and ``batches_done``."""
    dev = model.space_dict.device

    def run_step(done, batch):
        images, captions, img_idx = batch
        tok = tokenizer(list(captions), padding="max_length", max_length=max_length)
        a = alpha if epoch > 0 else alpha * min(1.0, done / max(1, epoch_len))
        metrics = train_step(torch.from_numpy(np.asarray(images)).to(dev),
                             _ids(tok["input_ids"], dev), _ids(tok["attention_mask"], dev),
                             _ids(img_idx, dev), temperature, a, generator=generator)
        return dict(metrics, alpha=a)

    return run_epoch(loader_fn(), run_step, temperature, lr=lr, print_fn=print_fn,
                     print_freq=print_freq, stop=stop)
