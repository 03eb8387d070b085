"""CLIP image-text retrieval evaluation: dual-tower ranking, no ITM rerank
(counterpart of the eval of ``madtp_tpu/cli/compress_retrieval_clip.py:
187-324``).

* :func:`probe_capacities` is ``--fast_eval``'s calibration of the vision
  tower's gather capacities;
* :func:`encode_towers` embeds every image batch as given and the texts in
  batches of ``batch_size`` (DTP couples the rows of a batch through its
  batch-max keep count, so the batches decide the result), with no host
  sync until the features come back; :func:`encode_towers_sharded` splits
  both towers' batches over the processes and gathers them back;
* :func:`evaluate` ranks ``sims = img @ txt.T`` with ``itm_eval`` and
  reports :func:`~madtp_tpu_torch.prune.flops.clip_gflops` from the last
  batch of each tower.  The text tower runs in mask mode in both modes.

Compression training (``madtp_tpu/cli/compress_retrieval_clip.py:336-540``):
:func:`train_epoch` runs one epoch of
:func:`~madtp_tpu_torch.train.loops.make_clip_train_step`'s step on batches
of captions it tokenizes, :func:`train_capacities` is ``--fast_train``'s
per-epoch calibration and :func:`eval_epoch` the per-epoch eval with the
best-checkpoint gate.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from madtp_tpu_torch.data.tokenizer_clip import clip_tokenize
from madtp_tpu_torch.eval.metrics import itm_eval
from madtp_tpu_torch.models.clip import CLIPModel
from madtp_tpu_torch.parallel import data, dist
from madtp_tpu_torch.prune.calibrate import fast_capacity_schedule
from madtp_tpu_torch.prune.flops import clip_gflops
from madtp_tpu_torch.train.epoch import run_epoch
from madtp_tpu_torch.utils.graph import CapturedStep

BATCH_SIZE_TEST = 32  # configs/retrieval_*_clip.yaml batch_size_test
PROBE_IMAGES, PROBE_BATCH = 64, 16  # the --fast_eval probe's images and batch
BEST_SLACK = 5.0  # GFLOPs above the target a best checkpoint may be (compress_retrieval_clip.py:518)


def _device(model: CLIPModel) -> torch.device:
    return model.positional_embedding.device


def _unit(feat: torch.Tensor) -> torch.Tensor:
    return feat / torch.linalg.vector_norm(feat, dim=-1, keepdim=True)


@torch.inference_mode()
def probe_capacities(model: CLIPModel, image_batches: Iterable[np.ndarray], temperature: float,
                     cap_mode: str = "ceil") -> Tuple[int, ...]:
    """``--fast_eval``'s probe (``compress_retrieval_clip.py:187-209``): the
    mask-mode vision tower at ``temperature`` on the first ``PROBE_IMAGES``
    images (fewer if the corpus is smaller) in batches of ``PROBE_BATCH``,
    then the vision schedule of :func:`fast_capacity_schedule` over their
    kept counts."""
    dev = _device(model)
    taken, n = [], 0
    for images in image_batches:
        taken.append(np.asarray(images))
        n += len(taken[-1])
        if n >= PROBE_IMAGES:
            break
    probe = np.concatenate(taken)[:PROBE_IMAGES]
    kept = [model.encode_image(torch.from_numpy(probe[i:i + PROBE_BATCH]).to(dev),
                               temperature=temperature, prune_active=True).kept_counts
            for i in range(0, len(probe), PROBE_BATCH)]
    return fast_capacity_schedule(torch.stack(kept).cpu().numpy(), None, cap_mode)[0]


def tower_steps(model: CLIPModel, prune_active: bool,
                capacities_v: Optional[Sequence[int]] = None, *, graph: bool = True,
                row_independent: bool = False, normalize: bool = True):
    """The two towers' steps (``tower_steps`` of ``compress_retrieval_clip``):
    ``img_step(images, temperature)`` and ``txt_step(ids, temperature)``,
    each ``-> (features, kept counts)``, the features L2-normalised unless
    ``normalize=False`` (the serving units return them as the towers give
    them); ``row_independent``: per-row DTP, kept counts ``[L, B]``.
    Captured (``graph=False``: eager)."""
    def finish(out):
        return (_unit(out.features) if normalize else out.features), out.kept_counts

    @torch.inference_mode()
    def img_step(images, t):
        return finish(model.encode_image(images, temperature=t, prune_active=prune_active,
                                         capacities=capacities_v,
                                         row_independent=row_independent))

    @torch.inference_mode()
    def txt_step(ids, t):
        return finish(model.encode_text(ids.long(), temperature=t, prune_active=prune_active,
                                        row_independent=row_independent))

    if not graph:
        return img_step, txt_step
    return (CapturedStep(img_step, "clip_image", model,
                         static=(prune_active, capacities_v, row_independent, normalize)),
            CapturedStep(txt_step, "clip_text", model,
                         static=(prune_active, row_independent, normalize)))


@torch.inference_mode()
def encode_towers(model: CLIPModel, image_batches: Iterable[np.ndarray], text: np.ndarray, *,
                  temperature=0.0, prune_active: bool = False,
                  capacities_v: Optional[Sequence[int]] = None,
                  batch_size: int = BATCH_SIZE_TEST, graph: bool = True
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Both towers over the corpus (``encode_towers`` without its
    multi-process branch): image batches as given (``[b, 3, H, W]`` floats
    or the uint8 ``[b, H, W, 3]`` feed), the token ids ``text``
    ``[n_texts, context_length]`` in batches of ``batch_size``.

    Returns ``(img_feats [ni, E], txt_feats [nt, E], v_kept [Lv], t_kept
    [Lt])`` as numpy: L2-normalised features (normalised in the model's
    dtype, returned as fp32) and the kept counts of the last batch of each
    tower.  Each batch of each tower is a captured step (``graph=False``:
    eagerly)."""
    dev = _device(model)
    img_step, txt_step = tower_steps(model, prune_active, capacities_v, graph=graph)
    img, txt = [], []
    v_kept = t_kept = None
    for images in image_batches:
        feat, v_kept = img_step(torch.from_numpy(np.asarray(images)).to(dev), temperature)
        img.append(feat)
    ids = torch.as_tensor(np.asarray(text), dtype=torch.long).to(dev)
    for i in range(0, ids.shape[0], batch_size):
        feat, t_kept = txt_step(ids[i:i + batch_size], temperature)
        txt.append(feat)
    return (torch.cat(img).float().cpu().numpy(), torch.cat(txt).float().cpu().numpy(),
            v_kept.cpu().numpy(), t_kept.cpu().numpy())


def encode_towers_sharded(model: CLIPModel, image_blocks: Callable[[int, int], Iterable],
                          n_images: int, text: np.ndarray, *, batch_size: int = BATCH_SIZE_TEST,
                          **kw) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """:func:`encode_towers` over several processes
    (``madtp_tpu/cli/compress_retrieval_clip.py:252-310``): when each tower
    has at least one batch a rank, rank ``r`` of ``P`` encodes the
    contiguous blocks ``[r * nb // P, (r + 1) * nb // P)`` of the image
    batches (``image_blocks(lo, hi)`` yields just those) and of the text
    batches, and the features are gathered back in corpus order.  Every
    batch keeps its members, so the result is that of one process, bit for
    bit; the kept counts are the last rank's, which holds each tower's last
    batch.  Otherwise, and with one process, every rank encodes it all."""
    P, r = dist.process_count(), dist.process_index()
    nb_i, nb_t = -(-n_images // batch_size), -(-len(text) // batch_size)
    if P <= 1 or nb_i < P or nb_t < P:
        return encode_towers(model, image_blocks(0, nb_i), text, batch_size=batch_size, **kw)
    lo_t, hi_t = r * nb_t // P * batch_size, (r + 1) * nb_t // P * batch_size
    img, txt, v_kept, t_kept = encode_towers(
        model, image_blocks(r * nb_i // P, (r + 1) * nb_i // P), text[lo_t:hi_t],
        batch_size=batch_size, **kw)
    dev = _device(model)
    img, txt = (dist.all_gather_rows(torch.from_numpy(a).to(dev)).cpu().numpy()
                for a in (img, txt))
    return img, txt, dist.host_allgather(v_kept)[-1], dist.host_allgather(t_kept)[-1]


def evaluate(model: CLIPModel, image_batches: Iterable[np.ndarray], text: np.ndarray,
             txt2img: Sequence[int], img2txt: Sequence[Sequence[int]], temperature: float, *,
             capacities_v: Optional[Sequence[int]] = None,
             batch_size: int = BATCH_SIZE_TEST, graph: bool = True
             ) -> Tuple[Dict[str, float], float]:
    """The CLIP retrieval eval (``compress_retrieval_clip.py:313-324``):
    prune when ``temperature > 0`` (the vision tower in gather mode with
    ``capacities_v``), encode both towers, ``sims = img @ txt.T`` in fp32,
    ``itm_eval(sims, sims.T, ...)``.  Returns ``(stats, Cur_Gflops)``, the
    GFLOPs from the last batch's kept counts (the dense ones when not
    pruning).  It runs where the model lives, through captured steps
    (``graph=False``: eagerly)."""
    img, txt, v_kept, t_kept = encode_towers(
        model, image_batches, text, temperature=temperature, prune_active=temperature > 0,
        capacities_v=capacities_v, batch_size=batch_size, graph=graph)
    sims = img @ txt.T
    return itm_eval(sims, sims.T, txt2img, img2txt), clip_gflops(model.cfg, v_kept, t_kept)



def train_epoch(model: CLIPModel, train_step, loader_fn: Callable[[], Iterable], tokenizer,
                temperature: float, *, epoch: int, epoch_len: int, alpha: float = 0.4,
                print_fn=print, print_freq: int = 50, lr: float = 0.0, stop=None,
                done0: int = 0) -> dict:
    """One compression-training epoch (``compress_retrieval_clip.py:
    463-492``) of ``train_step`` (:func:`~madtp_tpu_torch.train.loops.
    make_clip_train_step`'s step, over ``model``'s train state) on
    ``loader_fn()``'s ``(images, captions, image_ids)`` batches, the
    captions through :func:`~madtp_tpu_torch.data.tokenizer_clip.
    clip_tokenize` at the model's context length; under several processes
    each step spans the ranks (:func:`~madtp_tpu_torch.parallel.data.
    global_batch`), each rank's batches its shard's.  Epoch 0 ramps the
    soft-target weight, ``alpha * min(1, done / epoch_len)`` at its
    ``done``-th batch of the epoch's schedule (a resumed epoch counts from
    ``done0``, the batches it skips; ``epoch_len`` the batches of a
    shard).  Returns the stats of
    :func:`~madtp_tpu_torch.train.epoch.run_epoch`: the means of
    ``temperature``, ``lr``, ``alpha``, ``loss``, ``loss_ita``,
    ``loss_fdt`` and ``loss_fdt_m``, and ``batches_done``."""
    dev = _device(model)
    context = model.cfg.context_length

    def run_step(done, batch):
        images, captions, img_idx = batch
        text = clip_tokenize(tokenizer, list(captions), context)
        a = alpha if epoch > 0 else alpha * min(1.0, (done0 + done) / max(1, epoch_len))
        metrics = train_step(torch.from_numpy(np.asarray(images)).to(dev),
                             torch.from_numpy(text.astype(np.int64)).to(dev),
                             torch.as_tensor(np.asarray(img_idx), dtype=torch.long).to(dev),
                             temperature, a)
        return dict(metrics, alpha=a)

    with data.global_batch():
        return run_epoch(loader_fn(), run_step, temperature, lr=lr, print_fn=print_fn,
                         print_freq=print_freq, stop=stop)


@torch.inference_mode()
def train_capacities(model: CLIPModel, batches: Iterable, temperature: float,
                     cap_mode: str = "ceil") -> Tuple[int, ...]:
    """``--fast_train``'s per-epoch calibration (``fast_train_step``,
    ``compress_retrieval_clip.py:393-421``): the mask-mode vision tower at
    this epoch's temperature on each cached probe batch ``(images, captions,
    image_ids)`` as it is, then the vision schedule of
    :func:`fast_capacity_schedule` over their kept counts.  The text tower
    stays in mask mode, so it has no schedule."""
    dev = _device(model)
    kept = [model.encode_image(torch.from_numpy(np.asarray(images)).to(dev),
                               temperature=temperature, prune_active=True).kept_counts
            for images, _, _ in batches]
    return fast_capacity_schedule(torch.stack(kept).cpu().numpy(), None, cap_mode)[0]


def eval_epoch(model: CLIPModel, image_batches: Iterable[np.ndarray], text: np.ndarray,
               txt2img: Sequence[int], img2txt: Sequence[Sequence[int]], temperature: float, *,
               best: float, target_gflops: float, batch_size: int = BATCH_SIZE_TEST,
               graph: bool = True) -> Tuple[Dict[str, float], float, bool]:
    """A training epoch's eval (``compress_retrieval_clip.py:499-531``):
    :func:`evaluate` at the epoch's temperature, so it prunes when that
    temperature is > 0 whatever the checkpoint the run started from, in
    mask mode (a training run calibrates no eval capacities).  Returns
    ``(stats, Cur_Gflops, improved)``: ``improved`` is the best-checkpoint
    gate, ``r_mean > best`` and at most :data:`BEST_SLACK` GFLOPs above
    the target."""
    stats, cur_g = evaluate(model, image_batches, text, txt2img, img2txt, temperature,
                            batch_size=batch_size, graph=graph)
    return stats, cur_g, stats["r_mean"] > best and cur_g - target_gflops < BEST_SLACK
