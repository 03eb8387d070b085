"""CLIP image-text retrieval evaluation: dual-tower ranking, no ITM rerank
(counterpart of the eval of ``madtp_tpu/cli/compress_retrieval_clip.py:
187-324``), single process.

* :func:`probe_capacities` is ``--fast_eval``'s calibration of the vision
  tower's gather capacities;
* :func:`encode_towers` embeds every image batch as given and the texts in
  batches of ``batch_size`` (DTP couples the rows of a batch through its
  batch-max keep count, so the batches decide the result), with no host
  sync until the features come back;
* :func:`evaluate` ranks ``sims = img @ txt.T`` with ``itm_eval`` and
  reports :func:`~madtp_tpu_torch.prune.flops.clip_gflops` from the last
  batch of each tower.  The text tower runs in mask mode in both modes.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from madtp_tpu_torch.eval.metrics import itm_eval
from madtp_tpu_torch.models.clip import CLIPModel
from madtp_tpu_torch.prune.calibrate import fast_capacity_schedule
from madtp_tpu_torch.prune.flops import clip_gflops
from madtp_tpu_torch.utils.graph import CapturedStep

BATCH_SIZE_TEST = 32  # configs/retrieval_*_clip.yaml batch_size_test
PROBE_IMAGES, PROBE_BATCH = 64, 16  # the --fast_eval probe's images and batch


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
                capacities_v: Optional[Sequence[int]] = None, *, graph: bool = True):
    """The two towers' steps (``tower_steps`` of ``compress_retrieval_clip``):
    ``img_step(images, temperature)`` and ``txt_step(ids, temperature)``,
    each ``-> (L2-normalised features, kept counts)``, captured
    (``graph=False``: eager)."""
    @torch.inference_mode()
    def img_step(images, t):
        out = model.encode_image(images, temperature=t, prune_active=prune_active,
                                 capacities=capacities_v)
        return _unit(out.features), out.kept_counts

    @torch.inference_mode()
    def txt_step(ids, t):
        out = model.encode_text(ids, temperature=t, prune_active=prune_active)
        return _unit(out.features), out.kept_counts

    if not graph:
        return img_step, txt_step
    return (CapturedStep(img_step, "clip_image", model,
                         static=(prune_active, capacities_v)),
            CapturedStep(txt_step, "clip_text", model, static=(prune_active,)))


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

