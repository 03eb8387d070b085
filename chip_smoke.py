"""Smoke run of the PyTorch/CUDA port (``madtp_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. build kernels K1 (``madtp_tpu_torch/csrc/attention_scores.cu``), K2
   (``csrc/attention_scores_bwd.cu``), K4 (``csrc/cross_attention.cu``) and
   K5 (``csrc/ffn.cu``), and the designs each replaced (``csrc/previous/``,
   yardsticks timed beside them as ``previous_ms``), with nvcc, one process
   each, together;
2. K1 against its plain PyTorch version on the card at the NLVR shapes and
   the fp32 train step's, fp32 and bf16, two launches bit-identical, with
   times, the replaced design's, the card's bound, and the time of
   ``F.scaled_dot_product_attention`` for the ``out`` part alone (a
   yardstick that computes less than K1; the port never calls it);
3. K2 against its plain version (autograd through K1's) at the train step's
   shapes, fp32 and bf16, two launches bit-identical, with times, the
   replaced design's, the bound (fp32 also at the 3xTF32 rate its products
   run at), and SDPA forward + backward for the ``out`` part alone
   (partial again);
3b. K4 against its plain version on synthetic inputs at the ITM rerank's,
   the NLVR twin cross's, the VQA-640 memory's and ragged shapes (bf16
   splitting the keys into chunks), with and without bias, fp32 and bf16,
   a row with no alive key, two launches bit-identical, with times, the
   replaced design's, the bound, and SDPA with the same additive mask (the
   same function);
3c. K5 against its plain version at the CLIP vision (M = 32 x 584, 1024 /
   4096), CLIP text (M = 32 x 96, 768 / 3072), BLIP (M = 64 x 584, 768 /
   3072), a ragged, the BOS step's and a half-tile shape in bf16, the fp32
   train step's (M = 32 x 592, 768 / 3072), a ragged and the BOS shape in
   fp32, GELU and QuickGELU, two launches bit-identical, with times, the
   replaced design's, the bound, and the library call (two ``F.linear`` and
   the activation: the same function); the host time to enqueue one FFN;
3d. K1 in K3's range, N = 1,537 to 4,096, fp32 and bf16, with and without
   bias, two launches bit-identical, each counted as one of K3's, each timed
   beside the replaced design; plain, bound and SDPA (``out`` only) at the
   VQA-640 gather path's first layer;
4. the full-width NLVR model (ViT-B/16@384 + 12-layer twin MED, seeded random
   weights, 2 pairs, fp32) on the card against the same model on the CPU, in
   mask and gather mode: equal kept counts, logits within 1e-4, K1 launched in
   every layer;
5. the eval main path in bf16 at 32 pairs: temperature bisection toward half
   the dense GFLOPs in mask mode (K4 and K5 held on the mask-mode step's
   inputs at its end), ``probe_capacities`` on the eval's first 2 batches,
   and the gather-mode eval through ``tasks.nlvr.evaluate`` on 64 batches
   whose sentences are padded to each batch's longest (synthetic NLVR2
   lengths, ``nlvr_text_lengths``); samples/s of the gather step and of the
   dense forward;
6. one fp32 train step of the full-width model, 1 pair, on the card against
   the CPU, mask and gather mode: equal kept counts, losses within 1e-4,
   named gradients within 1e-3 of their largest value, K2 launched once per
   K1 launch;
7. the training main path at 16 pairs: controller epochs (temperature update,
   cosine LR, a mask-mode fp32 train epoch, an eval for the GFLOPs), then a
   ``--fast_train`` epoch (probe, capacities, gather-mode train) in fp32 and
   with ``amp``; a gather step under the sync guard; the checkpoint round
   trip; step times, profiles of the gather amp and the mask fp32 step;
   K1, K4 and K5 held on the path's own inputs (fp32 and bf16);
8. the full-width BLIP retrieval model (ViT-B/16@384 + 12-layer MED with
   single-stream cross-attention, the width of ``configs/retrieval_coco.yaml``,
   seeded random weights, fp32) on the card against the CPU: 4 images, 8
   texts, ``k_test`` 4, mask and gather mode, at the first temperature near
   phase 9's whose DTP decisions on the CPU stand clear of fp32 rounding
   (so it runs after phase 9): equal kept counts and
   candidate sets, features within 1e-5, rerank scores within 1e-4, 12 K4
   launches per ITM forward;
9. the retrieval main path in bf16 at p=0.5: temperature bisection toward half
   the dense ``retrieval_gflops`` in mask mode, the ``--fast_eval`` capacities,
   ``tasks.retrieval.evaluate`` in gather mode on 256 synthetic images (8
   batches of 32) and 256 texts at ``k_test`` 256, the dense eval, and one
   ITM forward at ``k_test`` 256: images/s, texts/s, ITM candidates/s, eval
   wall time, a profile of the ITM forward;
10. the CLIP ViT-L/14@336 retrieval eval main path in bf16 at p=0.5
   (``tools/bench_clip.py``'s configuration, seeded random weights): the
   temperature bisected toward half the dense ``clip_gflops`` in mask mode,
   the ``--fast_eval`` capacities, ``tasks.clip_retrieval.evaluate`` in
   gather mode on 1,024 synthetic uint8 images (32 batches of 32) and 5,120
   token-id texts, and the dense eval; images/s, texts/s, eval wall time, a
   profile of one image batch;
11. the full-width CLIP model on the card against the CPU, fp32, 2 images
   and 4 texts, mask and gather mode, at the first temperature near the main
   path's whose DTP decisions stand clear of fp32 rounding (as phase 8):
   equal kept counts in both towers, features within 1e-5, equal rankings;
12. the full-width BLIP VQA model (ViT-B/16 and the BERT-base MED as question
   encoder and answer decoder) on the card against the CPU, fp32, at 480 px
   and at 640 px (the 480-px weights loaded with the position grid resized):
   2 questions, 64 answers with shared first tokens, ``k_test`` 8, mask and
   gather mode, each of the four runs at its own first temperature near
   phase 13's whose DTP decisions stand clear of fp32 rounding (as phase 8;
   so it runs after phase 13): equal kept counts, question states within
   1e-5, equal top-k lists and best answers, candidate losses within 1e-4,
   and at 640 px K1 at N > 1536 in every mask-mode ViT layer;
13. the VQA-480 eval main path (``configs/vqa.yaml``'s width, 3,128 answers,
   ``k_test`` 128) in bf16 at p=0.5: the temperature bisected toward half
   the two pruned towers' dense GFLOPs in mask mode, ``probe_capacities``,
   ``tasks.vqa.evaluate`` in gather mode on 256 synthetic questions (16
   batches of 16, padded to each batch's longest as ``vqa_question_words``
   draws VQAv2's lengths) and the dense eval; questions/s, wall times, exact
   launch counts, a profile of one batch, the LM head's time;
14. the VQA-640 path (1,601 tokens, the 480-px weights through
   ``load_vqa_state_dict``), bf16: ``evaluate`` on 64 questions in mask and
   gather mode at phase 13's temperature; every K1 launch at N > 1536 is one
   of K3's (the TPU's query-tiled kernel), and K1 is held on those inputs;
15. VQA ``inference: 'generate'`` on phase 13's model, bf16:
   ``tasks.vqa.generate_answers`` (mask-mode towers, then the 3-beam decode
   from [DEC] over the question state) on 2 batches of 16 questions;
   answers/s, exact launch counts, K4 (one query per row) and K5 held on
   its own inputs;
16. the BLIP COCO caption eval main path (``configs/caption_coco.yaml``:
   ViT-B/16@384, batch 32, 3 beams, ``max_length`` 20, ``min_length`` 5,
   prompt ``"a picture of "``) in bf16 at p=0.5 on the uint8 feed: the
   temperature bisected toward half of ``ORI_GFLOPS_CAPTION`` in mask mode,
   ``probe_capacities``, ``tasks.caption.evaluate`` in gather mode on 256
   synthetic images (8 batches of 32) and the dense eval; captions/s, exact
   launches per batch (12 K1, 228 K4, 240 K5: 19 decoder steps of 12
   layers), CIDEr-D of the pruned captions against the dense ones
   (agreement, not accuracy), the decoder step's device and host dispatch
   times, one batch under the sync guard, timed and profiled; K1, K4 (one
   query per row, 96 rows) and K5 (96 decoder rows) held on its own inputs.
   The decode's vocabulary is a synthetic 30,522-entry BERT-layout
   ``vocab.txt`` written into ``build/``;
17. the full-width caption model on the card against the CPU, fp32, 2
   images, gather mode, at the first temperature near phase 16's whose DTP
   decisions stand clear of fp32 rounding (as phase 8): equal kept counts,
   memory states within 1e-5, the decoder's logits along the CPU's
   sequences within 1e-4, and equal sequences wherever every beam decision
   stands >= 64 fp32 steps and >= 4x the card's logit drift from its edge
   (the steps where one does not are named);
   each card-against-CPU phase that searches ``PARITY_FACTORS`` logs the
   factor it settles at and the card's drift there on one
   ``[parity-settled]`` line;
18-20. compression training (PR 10) of the caption (``configs/caption_coco.yaml``:
   batch 32, 384 px, the pre-search first), VQA (``configs/vqa.yaml``: batch
   16, 480 px, 10 answers a question with soft weights) and retrieval
   (``configs/retrieval_coco.yaml``: batch 32, queue 57,600, alpha 0.4
   ramped over epoch 0, momentum 0.995) models at full width, fp32 masters,
   synthetic data, as the JAX drivers run it (``train_main``): two
   controller epochs of two batches in mask mode fp32, then a
   ``--fast_train`` epoch in fp32 and one with ``amp``; then a gather step
   under the sync guard, step times and samples/s of mask fp32, gather fp32
   and amp, dense fp32 and amp, peak memory, the gather amp step's host
   dispatch, the ``.pth`` written and read back by ``load_*_state_dict``,
   and K1, K2 (the VQA ViT's N = 920 slots in fp32, and the amp epoch's),
   K4 (the retrieval ITM's 96 rows with gradients) and fp32 K5 held on the
   path's own inputs;
21-23. each of those models card against CPU, one fp32 train forward and
   backward from the same weights (caption 2 images, VQA 1 question with 10
   answers, retrieval 3 pairs from the same state with one Gumbel draw made
   on the CPU), mask and gather mode at lossless capacities, at the first
   temperature from the main path's whose DTP decisions stand clear of
   fp32 rounding (as phase 8): equal keep counts in every DTP decision,
   losses within 1e-4, named gradients within 1e-3 of their largest value,
   exact K1, K2, K4 and fp32 K5 launches a step; for retrieval after the
   step, the momentum weights and the queue within 1e-5, equal ids,
   pointer and ``temp``.  Each runs right after its main path (18, 21, 19,
   22, 20, 23);
24. CLIP compression training (``configs/retrieval_coco_clip.yaml``:
   ViT-L/14@336, batch 16, queue 57,600, alpha 0.4 ramped over epoch 0,
   momentum 0.995, weight decay 0.2, lr 1e-5) through ``train_main`` as
   phases 18-20, on synthetic float images and captions tokenized by the
   port's CLIP BPE tokenizer, each epoch's GFLOPs and best gate from
   ``tasks.clip_retrieval.eval_epoch`` on 64 uint8 images and 128 texts;
   K1, K2 (H = 16, fp32 and the amp epoch's) and fp32 K5 (QuickGELU,
   D = 1,024) held on the path's own inputs; no K4;
25. that model card against CPU, one fp32 train step from the same state
   (online and momentum weights 1e-3 apart, the queue), 2 pairs, mask and
   gather mode, as phases 21-23: 48 K1, 24 K2, 72 fp32 K5 a step; after
   it the momentum weights and the queue within 1e-5, equal ids and
   pointer.

The NLVR phases (4-7) also hold K4 to 24 launches per forward: the twin
cross-attention's two streams in each of the 12 MED layers.  Every fp32
FFN on the card runs K5 too: the parity phases (4, 6, 8, 11, 12, 17) and the
training path's fp32 steps count those launches apart (``fp32_launches``)
and hold fp32 K5 against its plain version on their own inputs.  Each
main path (5, 7, 9, 10, 13, 14, 15, 16; phases 9, 10, 13 and 16 their dense evals too)
also holds K4 and K5 against their plain versions on the inputs that path
gave it, one case per distinct shape (K4 where the path has
cross-attention), each timed beside the replaced design; phases 5, 9, 10
and 13 hold K1 on their gather evals' own inputs (phase 10 the CLIP vision
tower's at H = 16) and phase 14 on its N > 1536 inputs, phase 7 K2 on the
inputs of its mask-mode fp32 epochs and of its amp epoch, each case timed
beside the replaced design; the paths of phases 5-10 time their step with the
FFNs on K5 and on two linears (the path before K5), in turns, phase 7 its
mask-mode fp32 step too.

The eval main paths (5, 9, 10, 13-16) run their steps as CUDA graphs, the
tasks' default (``madtp_tpu_torch/utils/graph.py``): each eval runs first
eagerly (``graph=False``), where the recorders above take the kernels'
inputs (a recorder counts Python calls, which under a graph are only the
warm-up and the capture, and the tensors a capture sees live in the graph's
memory pool) and the launch counts are checked exactly; then as graphs, the
main path, whose results must equal the eager run's and whose launch counts
(each replay adds the launches its capture recorded; a new signature's
first call is its warm-up, whose outputs it returns) must be the eager
run's, with one capture per step and input signature (counted by
``CapturedStep.captures``).  The retrieval and CLIP main paths call
``evaluate`` and record the score matrices and features it computes
(``Returns``).  ``graph_check`` then holds each path's step as a graph
against the eager step, bit for bit at the main path's temperature and at
1.25 times it with no new capture, and logs one ``[graph]`` line: eager
and graph wall, the host's enqueue per replay, the device's busy time and
activities per replay, the K1, K4 and K5 kernels the profiled replay ran
(which must equal the launches its graph recorded; the kernels line's
``launches_in_profiled_replays``), pruned/dense under graphs.
Each main path zeroes the launch counts just before it runs and reads them
just after.
Kernel times are device times (``kernel_ms``: the launches queue behind a
spin kernel, so the host's enqueue time is not counted); step times are
wall times.  Every phase logs its wall time (``[time]``).

Prints the card's name and power limit, a JSON line of kernel measurements,
and as its last line ``{"ok": true, "device": {...}}``.  Without a CUDA
device it exits non-zero before printing any result.

``python3 chip_smoke.py probe`` runs ``probe_fp32`` alone: the fp32
training path's kernels through their wrappers, on whichever
``madtp_tpu_torch`` is first on ``sys.path``, so that one call can measure a
parent tree's package (``PYTHONPATH=<its checkout>``) beside this one.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import ctypes
import importlib
import itertools
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

PAD_BIAS = -10000.0
CLS_ID, SEP_ID, ENC_ID = 101, 102, 30523  # BERT's [CLS], [SEP]; BLIP's added [ENC]
DEC_ID = 30522  # BLIP's added [DEC], the answers' BOS
MEM_RATE = 3.35e12  # H100 SXM HBM3, bytes/s
PEAK = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense tensor-core bf16; fp32 CUDA cores
TF32X3 = 495e12 / 3  # fp32 as 3xTF32 on the tensor cores: three TF32 products for each


def log(*args):
    print(*args, flush=True)


def k1_case(B, N, *, with_bias, dtype, device, H=12, Dh=64, seed=0):
    """K1 inputs at one shape: q, k, v as [B, N, H, Dh] views of one packed
    [B, N, 3*H*Dh] tensor (the qkv linear's layout), about a quarter of slots
    1.. dead plus a dead tail like a mask-mode buffer's, and with
    ``with_bias`` PAD_BIAS on about a fifth of the keys.  Drawn on the
    device from a seeded generator (numpy's draws took a minute of host time
    at the larger shapes)."""
    g = torch.Generator(device=device).manual_seed(seed)
    packed = torch.randn(B, N, 3 * H * Dh, generator=g, device=device).to(dtype)
    q, k, v = (packed[..., i * H * Dh:(i + 1) * H * Dh].unflatten(-1, (H, Dh))
               for i in range(3))
    alive = torch.rand(B, N, generator=g, device=device) > 0.25
    alive[:, 0] = True
    alive[:, N - max(1, N // 50):] = False
    bias = None
    if with_bias:
        bias = (torch.rand(B, N, generator=g, device=device) < 0.2).float() * PAD_BIAS
    return q, k, v, alive, bias


def k2_case(B, N, *, with_bias, dtype, device, H=12, seed=0):
    """K2 inputs: a K1 case, K1's out and row statistics on it, and random
    N(0, 1) cotangents of all three outputs."""
    from madtp_tpu_torch.kernels.attention_scores import attention_scores_cuda

    q, k, v, alive, bias = k1_case(B, N, with_bias=with_bias, dtype=dtype, device=device,
                                   H=H, seed=seed)
    bias_in = torch.zeros(alive.shape, device=device) if bias is None else bias
    scale = q.shape[-1] ** -0.5
    with torch.no_grad():
        out, _, _, stats = attention_scores_cuda(q, k, v, alive, bias_in, scale,
                                                 return_stats=True)
    g = torch.Generator(device=device).manual_seed(seed + 1)
    d_out = torch.randn(out.shape, generator=g, device=device).to(dtype)
    d_cls, d_col = (torch.randn(B, N - 1, generator=g, device=device) for _ in range(2))
    return dict(q=q, k=k, v=v, alive=alive, bias=bias, bias_in=bias_in, scale=scale,
                out=out, stats=stats, d_out=d_out, d_cls=d_cls, d_col=d_col)


def head_max_near_ties(c, rel=1e-5):
    """[B, N, N] bool: the (alive query i >= 1, key j >= 1) whose two largest
    head probabilities agree within ``rel``.  The gradient of the head max
    is discontinuous there: two versions whose P differ in the last bits may
    send it to different heads."""
    q, k, alive = c["q"].float(), c["k"].float(), c["alive"]
    logits = torch.einsum("bihd,bjhd->bhij", q, k) * c["scale"]
    logits = (logits + c["bias_in"][:, None, None, :]).masked_fill(
        ~alive[:, None, None, :], float("-inf"))
    top = torch.nan_to_num(torch.softmax(logits, dim=-1)).topk(2, dim=1).values
    del logits
    near = (top[:, 0] - top[:, 1] <= rel * top[:, 0]) & (top[:, 0] > 0)
    near &= alive[:, :, None]
    near[:, 0, :] = False
    near[:, :, 0] = False
    return near


def compare_k2(c, got, want, tol, label):
    """K2's (dq, dk, dv, dbias) against the plain version's, leaving out the
    query rows (dq) and key rows (dk, dbias) of head-max near ties.  Returns
    the max abs errors and the number of near ties."""
    near = head_max_near_ties(c)
    rows, cols = ~near.any(dim=2), ~near.any(dim=1)
    errs = {}
    for name, g, w, keep in zip(("dq", "dk", "dv", "dbias"), got, want,
                                (rows, cols, None, cols)):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"K2 {name} {label}: {g.shape} {g.dtype} vs {w.shape} {w.dtype}")
        if keep is not None:
            g, w = g[keep], w[keep]
        errs[name] = check_close(f"K2 {name} {label}", g, w, *tol[name])
    return errs, int(near.sum())


def k1_work(q, alive):
    """(flops, bytes) the function needs: 4 Dh flops per (head, query, alive
    key) for q k^T and P v; each input read once, each output written once."""
    B, N, H, Dh = q.shape
    alive_keys = int(alive.sum())
    flops = 4.0 * H * Dh * N * alive_keys
    el = q.element_size()
    nbytes = (3 * B * N * H * Dh * el + B * N + B * N * 4  # q, k, v, alive, bias
              + B * N * H * Dh * el + 2 * B * N * 4)  # out, col_mass, cls_attn
    return flops, nbytes


def k2_work(q, alive):
    """(flops, bytes) of the backward itself: one q k^T recompute and the four
    gradient products, 10 Dh flops per (head, query, alive key); q, k, v,
    alive, bias, dout, dcls, dcol read once, dq, dk, dv, dbias written once."""
    B, N, H, Dh = q.shape
    flops = 10.0 * H * Dh * N * int(alive.sum())
    el = q.element_size()
    nbytes = (4 * B * N * H * Dh * el + B * N + B * N * 4 + 2 * B * (N - 1) * 4
              + 3 * B * N * H * Dh * el + B * N * 4)
    return flops, nbytes


def k4_case(B, Nq, S, *, with_bias, dtype, device, H=12, Dh=64, seed=0, packed_q=False):
    """K4 inputs at one shape: q a [B, Nq, H, Dh] view of the query linear's
    output (with ``packed_q``, of a packed [B, Nq, 3*H*Dh] tensor: strided),
    k and v views of two separate [B, S, H*Dh] tensors (the key and value
    linears' outputs), a quarter of the keys dead (slot 0 alive, so every row
    has a live key), and with ``with_bias`` PAD_BIAS on about a fifth; drawn
    on the device, as ``k1_case``."""
    g = torch.Generator(device=device).manual_seed(seed)

    def heads(*shape):
        t = torch.randn(shape, generator=g, device=device).to(dtype)
        return t[..., :H * Dh].unflatten(-1, (H, Dh))

    q = heads(B, Nq, (3 if packed_q else 1) * H * Dh)
    k, v = heads(B, S, H * Dh), heads(B, S, H * Dh)
    alive = torch.rand(B, S, generator=g, device=device) > 0.25
    alive[:, 0] = True
    bias = None
    if with_bias:
        bias = (torch.rand(B, S, generator=g, device=device) < 0.2).float() * PAD_BIAS
    return q, k, v, alive, bias


def k4_work(q, k, alive, bias):
    """(flops, bytes) of the cross-attention: 4 Dh flops per (head, query,
    alive key) for q k^T and P v; q, k, v, alive, bias read once, out
    written once."""
    B, Nq, H, Dh = q.shape
    S = k.shape[1]
    flops = 4.0 * H * Dh * Nq * int(alive.sum())
    el = q.element_size()
    nbytes = (2 * B * Nq * H * Dh + 2 * B * S * H * Dh) * el + B * S
    return flops, nbytes + (0 if bias is None else B * S * 4)


def sdpa_mask(alive, bias, dtype):
    """The additive [B, 1, 1, S] mask that makes scaled_dot_product_attention
    compute the kernels' masking: the bias (None: none), -inf at dead keys."""
    mask = torch.zeros(alive.shape, device=alive.device).masked_fill(~alive, float("-inf"))
    if bias is not None:
        mask = mask + bias
    return mask[:, None, None, :].to(dtype)


class _Capture:
    """While active, replaces ``module.attr`` with a recorder that keeps the
    inputs of the first call of each distinct ``key`` (detached, completed
    to ``len(defaults)`` arguments) and counts the calls of each; every call
    goes on to the original unchanged, so the launch counts are those of the
    path itself.  ``paused()`` puts the original back for a while."""

    module = attr = None
    defaults = ()  # (name, default) of each argument, in order

    def key(self, *args):
        raise NotImplementedError

    def __enter__(self):
        self._mod = importlib.import_module(self.module)
        self._orig = getattr(self._mod, self.attr)
        self.cases, self.calls = {}, collections.Counter()

        def record(*args, **kw):
            full = list(args) + [kw.get(n, d) for n, d in self.defaults[len(args):]]
            key = self.key(*full)
            self.calls[key] += 1
            if key not in self.cases:
                self.cases[key] = tuple(t.detach() if torch.is_tensor(t) else t for t in full)
            return self._orig(*args, **kw)

        self._record = record
        setattr(self._mod, self.attr, record)
        return self

    def __exit__(self, *exc):
        setattr(self._mod, self.attr, self._orig)

    @contextlib.contextmanager
    def paused(self):
        setattr(self._mod, self.attr, self._orig)
        try:
            yield
        finally:
            setattr(self._mod, self.attr, self._record)


class K4Capture(_Capture):
    """The MED's cross-attention calls, by (B, Nq, S, dtype, bias or none)."""

    module, attr = "madtp_tpu_torch.models.med", "cross_attention"
    defaults = (("q", None), ("k", None), ("v", None), ("key_alive", None), ("key_bias", None))

    def key(self, q, k, v, key_alive, key_bias):
        return (q.shape[0], q.shape[1], k.shape[1], q.dtype, key_bias is not None)


class K5Capture(_Capture):
    """K5's calls (from ``ops.layers.mlp`` and ``FusedMLP``), by (M, D, F,
    act, dtype)."""

    module, attr = "madtp_tpu_torch.ops.layers", "ffn_cuda"
    defaults = (("x", None), ("w1", None), ("b1", None), ("w2", None), ("b2", None),
                ("act", "gelu"))

    def key(self, x, w1, b1, w2, b2, act):
        return (x.shape[0], x.shape[1], w1.shape[0], act, x.dtype)


class K1Capture(_Capture):
    """The scoring attention's calls, by (B, N, H, dtype, bias or none)."""

    module, attr = "madtp_tpu_torch.ops.attention", "attention_scores"
    defaults = (("q", None), ("k", None), ("v", None), ("key_alive", None),
                ("key_bias", None), ("scale", None))

    def key(self, q, k, v, key_alive, key_bias, scale):
        return (q.shape[0], q.shape[1], q.shape[2], q.dtype, key_bias is not None)


class K2Capture(_Capture):
    """The backward's K2 calls (from ``ScoringAttention``), by (B, N, H,
    dtype)."""

    module, attr = "madtp_tpu_torch.ops.attention", "attention_scores_bwd_cuda"
    defaults = tuple((n, None) for n in ("q", "k", "v", "key_alive", "key_bias", "scale", "out",
                                         "stats", "d_out", "d_cls", "d_col"))

    def key(self, q, *rest):
        return (q.shape[0], q.shape[1], q.shape[2], q.dtype)


class PlainFFN:
    """While active, the models' FFNs run their plain version (two linears)
    on the card too: the path before K5, for an A/B inside one run."""

    MODULES = ("madtp_tpu_torch.models.vit", "madtp_tpu_torch.models.med",
               "madtp_tpu_torch.models.clip")

    def __enter__(self):
        from madtp_tpu_torch.ops.layers import mlp_plain

        def plain(x, fc1, fc2, act="gelu"):
            return mlp_plain(x, fc1.weight, fc1.bias, fc2.weight, fc2.bias, act)

        self._saved = [(m, m.mlp) for m in map(importlib.import_module, self.MODULES)]
        for m, _ in self._saved:
            m.mlp = plain
        return self

    def __exit__(self, *exc):
        for m, f in self._saved:
            m.mlp = f


class Returns:
    """While active, records what ``module.attr`` returns to its callers (an
    entry point's inner call, such as ``evaluate``'s ``rerank_scores``),
    passing every call through unchanged."""

    def __init__(self, module, attr):
        self.module, self.attr, self.values = module, attr, []

    def __enter__(self):
        self._mod = importlib.import_module(self.module)
        self._orig = getattr(self._mod, self.attr)

        def record(*args, **kw):
            out = self._orig(*args, **kw)
            self.values.append(out)
            return out

        setattr(self._mod, self.attr, record)
        return self

    def __exit__(self, *exc):
        setattr(self._mod, self.attr, self._orig)


def ffn_ab(label, fn, iters):
    """``fn``'s CUDA-event time with the FFNs on K5 and on two linears (the
    path before K5), in turns plain, K5, K5, plain.  Returns the two means."""
    times = {"k5": [], "plain": []}
    for which in ("plain", "k5", "k5", "plain"):
        if which == "plain":
            with PlainFFN():
                times[which].append(time_ms(fn, iters))
        else:
            times[which].append(time_ms(fn, iters))
    k5, plain = (sum(times[w]) / 2 for w in ("k5", "plain"))
    log(f"[ffn-ab] {label}: FFNs on K5 {k5:.2f} ms ({times['k5'][0]:.2f}, {times['k5'][1]:.2f}), "
        f"on two linears (before K5) {plain:.2f} ms ({times['plain'][0]:.2f}, "
        f"{times['plain'][1]:.2f}): {plain / k5:.3f}x")
    return k5, plain


def pick_record(records, calls, where=None):
    """The record of the most-called case whose ``shape`` holds every item
    of ``where`` (all cases when it is None)."""
    keys = [k for k in records
            if all(records[k]["shape"][f] == v for f, v in (where or {}).items())]
    if not keys:
        raise AssertionError(f"no case of shape {where} among {[r['shape'] for r in records.values()]}")
    return records[max(keys, key=calls.__getitem__)]


def check_k4_cases(label, capture, iters=20, where=None):
    """K4 against its plain version on the inputs a main path gave it (one
    case per distinct shape, dtype and bias, as ``capture`` recorded them):
    in their own dtype within ``TOLERANCES``, bf16 cases also cast to fp32
    within the fp32 tolerance, two launches bit-identical; with the times of
    K4, the replaced design (``previous_k4``), the plain version and SDPA
    (the same function), and the bound.
    Returns the record of the most-called case (of those matching ``where``,
    as ``pick_record``) for the kernels line."""
    import torch.nn.functional as F

    from madtp_tpu_torch.kernels.cross_attention import TOLERANCES, cross_attention_cuda
    from madtp_tpu_torch.ops.attention import cross_attention_plain

    records = {}
    with torch.inference_mode():
        for key, (q, k, v, alive, bias) in capture.cases.items():
            B, Nq, S, dtype, _ = key
            alive = alive.contiguous()
            bias = None if bias is None else bias.float().contiguous()
            scale = q.shape[-1] ** -0.5
            name = (f"{label} B={B} Nq={Nq} S={S} bias={bias is not None} "
                    f"({capture.calls[key]} calls)")
            errs = []
            for dt in dict.fromkeys((dtype, torch.float32)):
                qd, kd, vd = (t.to(dt) for t in (q, k, v))
                got = cross_attention_cuda(qd, kd, vd, alive, bias, scale)
                want = cross_attention_plain(qd, kd, vd, alive, bias, scale)
                errs.append(check_close(f"K4 {name} {str(dt)[6:]}", got, want, *TOLERANCES[dt]))
                if not torch.equal(got, cross_attention_cuda(qd, kd, vd, alive, bias, scale)):
                    raise AssertionError(f"K4 {name} {str(dt)[6:]}: two launches differ")
                del qd, kd, vd, got, want
            ms = kernel_ms(lambda: cross_attention_cuda(q, k, v, alive, bias, scale), iters)
            previous_ms = kernel_ms(lambda: previous_k4(q, k, v, alive, bias, scale), iters)
            plain_ms = kernel_ms(lambda: cross_attention_plain(q, k, v, alive, bias, scale), 5)
            mask = sdpa_mask(alive, bias, dtype)
            qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
            sdpa_ms = kernel_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask, scale=scale), iters)
            bound_ms, bound_by = bound(*k4_work(q, k, alive, bias), dtype)
            log(f"[k4-main] {name} {str(dtype)[6:]}: max|err| {errs[0]:.2e}"
                + (f" (as fp32 {errs[1]:.2e})" if len(errs) > 1 else "")
                + f", bit-identical relaunch | K4 {ms:.4f} ms, previous {previous_ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), sdpa (same "
                f"function) {sdpa_ms:.4f} ms")
            records[key] = dict(max_abs_err=errs[0], ms=ms, previous_ms=previous_ms,
                                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                                library_ms=sdpa_ms,
                                shape=dict(B=B, Nq=Nq, S=S, dtype=str(dtype)[6:]))
            del mask, qh, kh, vh
    capture.cases.clear()
    torch.cuda.empty_cache()
    if not records:
        raise AssertionError(f"{label}: the path made no cross-attention call")
    return pick_record(records, capture.calls, where)


def bound(flops, nbytes, dtype):
    """The least time the card could take, ms, and what bounds it."""
    t_ops, t_bytes = flops / PEAK[dtype] * 1e3, nbytes / MEM_RATE * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def bounds(flops, nbytes, dtype, tf32x3=False):
    """``bound``'s least time and what bounds it; with ``tf32x3`` (a kernel
    that multiplies fp32 as 3xTF32) also the least time at that rate
    (``bound_3xtf32_ms``): such a kernel may beat the fp32 bound, which
    counts the CUDA cores."""
    bound_ms, bound_by = bound(flops, nbytes, dtype)
    rec = dict(bound_ms=bound_ms, bound_by=bound_by)
    if tf32x3 and dtype == torch.float32:
        rec["bound_3xtf32_ms"] = max(flops / TF32X3, nbytes / MEM_RATE) * 1e3
    return rec


def time_ms(fn, iters):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def median_step_ms(fn, iters):
    """Median CUDA-event time of ``iters`` back-to-back calls of ``fn`` after
    one warm-up, ms: each call's time from the event recorded before it to
    the one after."""
    fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(iters + 1)]
    events[0].record()
    for e in events[1:]:
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median([a.elapsed_time(b) for a, b in zip(events, events[1:])])


SPIN_HZ = 2.0e9  # cycles a second of torch.cuda._sleep's spin: the H100's top SM clock


def kernel_ms(fn, iters):
    """Device time per call of ``fn`` (kernels and their yardsticks), ms:
    the launches queue up behind a spin kernel that lasts longer than their
    enqueue, so the host's time to enqueue them, which binds small kernels
    and is measured apart (``enqueue_ms``), is not counted."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    spin_s = min(0.5, 1.5 * iters * (time.perf_counter() - t0) + 1e-3)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(spin_s * SPIN_HZ))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def enqueue_ms(fn, iters):
    """Host time per call for ``fn`` to enqueue its kernels, the card left
    to drain only after the last call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize()
    return ms


def host_ms(fn, iters, stat=None):
    """Host time for ``fn`` to return (to dispatch its kernels), with the card
    drained before each call: near the step's CUDA-event time when the step
    is bound by the host.  The mean of ``iters`` calls, or ``stat`` of
    them (``statistics.median``)."""
    fn()
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return (stat or statistics.fmean)(times) * 1e3


def lead_spins(n=32):
    """Opens a profile: ``n`` spin kernels (``spin_kernel``, which the
    profiles leave out) and a synchronize.  A trace can miss the first
    device activities after it starts (2-10 of them on some hosts, once the
    first K1 of the VQA-640 graph's replay); the spins take those places."""
    for _ in range(n):
        torch.cuda._sleep(100_000)
    torch.cuda.synchronize()


def profile_step(label, fn, step_ms, top=10):
    """Device time by kernel for one call of ``fn`` under torch.profiler, and
    the device's busy share of ``step_ms``, the call's time without the
    profiler (whose own cost would lengthen a wall time taken under it).
    Returns the device's busy time, ms, and the number of device
    activities (kernels and copies; in a CUDA graph's replay, its nodes)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        lead_spins()
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)  # ranges, not kernels
               and "spin_kernel" not in e.key]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"[profile] {label}: device busy {busy_ms:.2f} ms of the {step_ms:.2f} ms step "
        f"({busy_ms / step_ms:.1%}); {sum(e.count for e in kernels)} launches of "
        f"{len(kernels)} kernels; " + kernel_totals(kernels, busy_ms))
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        ms = e.self_device_time_total / 1e3
        log(f"[profile]   {ms:8.3f} ms {ms / max(busy_ms, 1e-9):6.1%} x{e.count:<5d} {e.key[:90]}")
    return busy_ms, sum(e.count for e in kernels), wrapper_launches(kernels)


# The kernel each wrapper launch runs once, by its name in a profile: K1's pass
# A (``k1_fwd``, ``k1_fwd_simt``), K4's main kernel (``k4_mma``, ``k4_simt``;
# ``k4_combine`` only when the keys split), and K5's two GEMMs (``k5_wgmma``
# or ``k5_ffma``, twice a launch).
WRAPPER_KERNELS = {"K1": (("::k1_fwd",), 1), "K4": (("::k4_mma", "::k4_simt"), 1),
                   "K5": (("::k5_wgmma", "::k5_ffma"), 2)}


def wrapper_launches(kernels):
    """K1's, K4's and K5's wrapper launches among profiler averages, counted
    from the kernels the card ran."""
    out = {}
    for name, (tags, per_launch) in WRAPPER_KERNELS.items():
        n = sum(e.count for e in kernels if any(tag in e.key for tag in tags))
        if n % per_launch:
            raise AssertionError(f"{name}: {n} kernels is not {per_launch} a launch")
        out[name] = n // per_launch
    return out


def graph_launches(graph):
    """K1's, K4's and K5's wrapper launches that a CUDA graph holds, counted
    from its kernel nodes by their names (the driver API: ``cuGraphGetNodes``
    on ``graph.raw_cuda_graph()``).  A replay runs every node, so this count
    is exact where a profile of the replay can lose device records."""
    import ctypes

    class KernelNodeParams(ctypes.Structure):  # CUDA_KERNEL_NODE_PARAMS_v2
        _fields_ = ([("func", ctypes.c_void_p)]
                    + [(f, ctypes.c_uint) for f in ("gx", "gy", "gz", "bx", "by", "bz", "smem")]
                    + [(f, ctypes.c_void_p) for f in ("params", "extra", "kern", "ctx")])

    cu = ctypes.CDLL("libcuda.so.1")

    def call(fn, *args):
        rc = fn(*args)
        if rc:
            raise RuntimeError(f"{fn.__name__} returned CUresult {rc}")

    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    call(cu.cuGraphGetNodes, handle, None, ctypes.byref(n))
    nodes = (ctypes.c_void_p * n.value)()
    call(cu.cuGraphGetNodes, handle, nodes, ctypes.byref(n))
    names = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        call(cu.cuGraphNodeGetType, ctypes.c_void_p(node), ctypes.byref(kind))
        if kind.value != 0:  # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        params, name = KernelNodeParams(), ctypes.c_char_p()
        call(cu.cuGraphKernelNodeGetParams_v2, ctypes.c_void_p(node), ctypes.byref(params))
        if params.func:
            call(cu.cuFuncGetName, ctypes.byref(name), ctypes.c_void_p(params.func))
        else:
            call(cu.cuKernelGetName, ctypes.byref(name), ctypes.c_void_p(params.kern))
        names.append(name.value.decode())  # mangled: the tags without their "::"
    out = {}
    for key, (tags, per_launch) in WRAPPER_KERNELS.items():
        k = sum(any(tag.lstrip(":") in nm for tag in tags) for nm in names)
        if k % per_launch:
            raise AssertionError(f"{key}: the graph holds {k} kernels, not {per_launch} a launch")
        out[key] = k // per_launch
    return out


def kernel_totals(kernels, busy_ms):
    """Device time of K1's, K2's, K4's and K5's passes among profiler averages."""
    out = []
    for name, tag in (("K1", "::k1_"), ("K2", "::k2_"), ("K4", "::k4_"), ("K5", "::k5_")):
        ms = sum(e.self_device_time_total for e in kernels if tag in e.key) / 1e3
        out.append(f"{name} {ms:.2f} ms ({ms / max(busy_ms, 1e-9):.1%})")
    return ", ".join(out)


def outputs_equal(a, b):
    """Bit-equality of two runs' outputs: tensors, numpy arrays, numbers,
    strings and None, nested in tuples, lists and dicts."""
    if torch.is_tensor(a):
        return torch.is_tensor(b) and a.shape == b.shape and a.dtype == b.dtype and \
            torch.equal(a, b)
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.shape == b.shape and a.dtype == b.dtype and \
            np.array_equal(a, b)
    if isinstance(a, (tuple, list)):
        return isinstance(b, (tuple, list)) and len(a) == len(b) and \
            all(outputs_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and \
            all(outputs_equal(a[k], b[k]) for k in a)
    return a == b


REPLAYS = {"K1": {}, "K4": {}, "K5": {}}  # wrapper launches in one profiled replay, by path
PROFILE_TRIES = 3  # profiles of a graph's replay before a short count fails


def graph_check(label, graph_fn, eager_fn, temps, owner, iters=5, dense_fn=None):
    """One step or batch of a path as a CUDA graph (``graph_fn(t)``, the
    task's captured step) against the same run eagerly (``eager_fn(t)``,
    ``graph=False``): bit-equal outputs (kept counts and overflow among
    them) at every temperature of ``temps``, the first the captured one,
    with no capture after the first call (the owner's cache keeps its
    graphs); the eager and graph wall times (CUDA events), the host's time
    to return from one replay with the card drained first (its enqueue:
    the input copies, the replay, the output clones) and within it the
    graph's launch alone (``CUDAGraph.replay``) and the check of the
    weights' addresses, the device's busy time and the device activities
    of one replay (the profiler), and with ``dense_fn`` (the dense run's
    graph) pruned/dense under graphs.  The K1, K4 and K5 kernels its
    graph holds (its kernel nodes, ``graph_launches``) and the profiled
    replay ran must be the launches it recorded at capture, which every
    replay adds to the wrappers' counts (``REPLAYS`` keeps the profiled ones
    for the kernels line).  A trace can lose device records on some hosts
    (two K5 kernels of the CLIP text graph's replay, once): a profile that
    saw fewer launches than the graph holds is taken again, up to
    ``PROFILE_TRIES`` times; one that saw more fails at once.  Logs one ``[graph]`` line and returns the numbers."""
    from madtp_tpu_torch.kernels.attention_scores import attention_scores_cuda
    from madtp_tpu_torch.kernels.cross_attention import cross_attention_cuda
    from madtp_tpu_torch.kernels.ffn import ffn_cuda
    from madtp_tpu_torch.utils.graph import graph_count, model_cache

    graph_fn(temps[0])
    torch.cuda.synchronize()
    size = graph_count(model_cache(owner))
    for t in temps:
        if not outputs_equal(graph_fn(t), eager_fn(t)):
            raise AssertionError(f"{label}: the graph's outputs differ from the eager run's "
                                 f"at T={t}")
    if graph_count(model_cache(owner)) != size:
        raise AssertionError(f"{label}: a temperature was captured anew ({size} -> "
                             f"{graph_count(model_cache(owner))} graphs)")
    t0 = temps[0]
    eager_ms = time_ms(lambda: eager_fn(t0), iters)
    graph_ms = time_ms(lambda: graph_fn(t0), iters)
    enqueue = host_ms(lambda: graph_fn(t0), iters)
    entry = list(model_cache(owner).values())[-1].last  # the last one replayed: graph_fn's
    launch = host_ms(entry.graph.replay, iters)
    check = host_ms(lambda: model_cache(owner), iters)
    recorded = dict(entry.launches)
    want = {name: recorded.get((wrapper, "launches"), 0)
            for name, wrapper in (("K1", attention_scores_cuda), ("K4", cross_attention_cuda),
                                  ("K5", ffn_cuda))}
    held = graph_launches(entry.graph)
    if held != want:
        raise AssertionError(f"{label}: the graph holds {held} launches, it recorded {want}")
    for attempt in range(1, PROFILE_TRIES + 1):
        busy, nodes, ran = profile_step(f"{label} graph", lambda: graph_fn(t0), graph_ms, top=4)
        if ran == want:
            break
        if any(ran[k] > want[k] for k in want) or attempt == PROFILE_TRIES:
            raise AssertionError(f"{label}: the profiled replay ran {ran} launches, its graph "
                                 f"holds and recorded {want} (profile {attempt} of "
                                 f"{PROFILE_TRIES})")
        log(f"[graph] {label}: profile {attempt} saw {ran} of the graph's {want} launches "
            f"({nodes} device activities): the trace lost records; profiling again")
    for name in want:
        REPLAYS[name][label] = ran[name]
    rec = dict(eager_ms=eager_ms, graph_ms=graph_ms, enqueue_ms=enqueue, launch_ms=launch,
               check_ms=check, busy_ms=busy, nodes=nodes, graphs=size)
    dense = ""
    if dense_fn is not None:
        rec["dense_graph_ms"] = time_ms(lambda: dense_fn(0.0), iters)
        rec["pruned_over_dense"] = rec["dense_graph_ms"] / graph_ms
        dense = (f"; dense graph {rec['dense_graph_ms']:.3f} ms, pruned/dense under graphs "
                 f"{rec['pruned_over_dense']:.3f}x")
    log(f"[graph] {label}: eager {eager_ms:.3f} ms, graph {graph_ms:.3f} ms "
        f"({eager_ms / graph_ms:.2f}x); host enqueue per replay {enqueue:.3f} ms (the graph's "
        f"launch {launch:.3f} ms, the weights' address check {check:.3f} ms); device busy "
        f"{busy:.3f} ms, {nodes} device activities per replay, K1 {ran['K1']}, K4 {ran['K4']}, "
        f"K5 {ran['K5']} launches as recorded{dense}; bit-equal to eager at "
        f"T={', '.join(f'{t:.4f}' for t in temps)} with {size} graphs before and after")
    return rec


def profile_backward(label, step, batch):
    """Device time of the backward pass alone of one train step's loss, and
    K1's (remat only) and K2's part of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    loss = step.loss_fn(*batch)[0]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        loss.backward()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"[profile] {label} backward alone: device {busy_ms:.2f} ms; "
        + kernel_totals(kernels, busy_ms))


PREVIOUS_NOTE = ("previous_ms is the replaced design (madtp_tpu_torch/csrc/previous/{}) on the "
                 "same inputs and card")
PREVIOUS = {"K1": "previous/attention_scores.cu", "K2": "previous/attention_scores_bwd.cu",
            "K4": "previous/cross_attention.cu", "K5": "previous/ffn.cu"}


def _previous_fn(key, symbol, argtypes):
    from madtp_tpu_torch.kernels.build import build

    fn = getattr(build(PREVIOUS[key]).lib, symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def previous_k1(q, k, v, alive, bias, scale):
    """The K1 design that ``csrc/attention_scores.cu`` replaced
    (``csrc/previous/attention_scores.cu``: fp32 FFMA tiles) on the same
    inputs: the yardstick of ``previous_ms``.  Its launches count nowhere.
    Returns ``(out, cls_attn, col_mass, stats)`` as K1's wrapper does."""
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn = _previous_fn("K1", "k1_attention_scores",
                      [i32, p, p, p, i64, i64, p, p, p, p, p, p, p, p,
                       i32, i32, i32, i32, ctypes.c_float, p])
    B, N, H, Dh = q.shape
    out = torch.empty((B, N, H, Dh), dtype=q.dtype, device=q.device)
    col, cls = (torch.empty((B, N), device=q.device) for _ in range(2))
    stats = torch.empty((3, B, H, N), device=q.device)
    err = fn(0 if q.dtype == torch.float32 else 1, q.data_ptr(), k.data_ptr(), v.data_ptr(),
             q.stride(0), q.stride(1), alive.data_ptr(), bias.data_ptr(), out.data_ptr(),
             col.data_ptr(), cls.data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(),
             stats[2].data_ptr(), B, N, H, Dh, float(scale),
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"previous K1 launch failed with cudaError_t {err}")
    return out.view(B, N, H * Dh), cls[:, 1:], col[:, 1:], stats


def previous_k2(q, k, v, alive, bias, scale, out, stats, d_out, d_cls, d_col):
    """The K2 design that ``csrc/attention_scores_bwd.cu`` replaced
    (``csrc/previous/attention_scores_bwd.cu``: fp32 FFMA tiles) on the same
    inputs, K2's argument order: the yardstick of ``previous_ms``."""
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn = _previous_fn("K2", "k2_attention_scores_bwd",
                      [i32, p, p, p, i64, i64] + [p] * 19 + [i32, i32, i32, i32,
                                                            ctypes.c_float, p])
    B, N, H, Dh = q.shape
    dev = q.device
    ismax = torch.empty((B, N, N), dtype=torch.int16, device=dev)
    clsrow, drow, dbias_h = (torch.empty((B, H, N), device=dev) for _ in range(3))
    ssum, csum, dbias = (torch.empty((B, N), device=dev) for _ in range(3))
    dq, dk, dv = (torch.empty((B, N, H, Dh), dtype=q.dtype, device=dev) for _ in range(3))
    err = fn(0 if q.dtype == torch.float32 else 1, q.data_ptr(), k.data_ptr(), v.data_ptr(),
             q.stride(0), q.stride(1), alive.data_ptr(), bias.data_ptr(),
             stats[0].data_ptr(), stats[1].data_ptr(), stats[2].data_ptr(), out.data_ptr(),
             d_out.data_ptr(), d_cls.data_ptr(), d_col.data_ptr(), ismax.data_ptr(),
             clsrow.data_ptr(), ssum.data_ptr(), csum.data_ptr(), drow.data_ptr(),
             dbias_h.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dbias.data_ptr(),
             B, N, H, Dh, float(scale), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"previous K2 launch failed with cudaError_t {err}")
    return dq, dk, dv, dbias


def previous_k4(q, k, v, alive, bias, scale):
    """The K4 design that ``csrc/cross_attention.cu`` replaced
    (``csrc/previous/cross_attention.cu``), on the same inputs: the yardstick
    of ``previous_ms``.  Its launches count nowhere."""
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn = _previous_fn("K4", "k4_cross_attention", [i32, p, p, p, i64, i64, i64, i64, p, p, p,
                                                   i32, i32, i32, i32, i32, ctypes.c_float, p])
    B, Nq, H, Dh = q.shape
    out = torch.empty((B, Nq, H, Dh), dtype=q.dtype, device=q.device)
    err = fn(0 if q.dtype == torch.float32 else 1, q.data_ptr(), k.data_ptr(), v.data_ptr(),
             q.stride(0), q.stride(1), k.stride(0), k.stride(1), alive.data_ptr(),
             None if bias is None else bias.data_ptr(), out.data_ptr(), B, Nq, k.shape[1], H,
             Dh, float(scale), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"previous K4 launch failed with cudaError_t {err}")
    return out.view(B, Nq, H * Dh)


def previous_k5(x, w1, b1, w2, b2, act):
    """The K5 design that ``csrc/ffn.cu`` replaced (``csrc/previous/ffn.cu``:
    bf16 on mma.sync, ``k5_ffn``; fp32 on the first FFMA SGEMM, ``k5_ffn_fp32``),
    on the same inputs: the yardstick of ``previous_ms``."""
    from madtp_tpu_torch.kernels.ffn import ACTS

    p, i32 = ctypes.c_void_p, ctypes.c_int
    symbol = "k5_ffn_fp32" if x.dtype == torch.float32 else "k5_ffn"
    fn = _previous_fn("K5", symbol, [p, p, p, p, p, p, p, i32, i32, i32, i32, p])
    M, D = x.shape
    F = w1.shape[0]
    hidden = torch.empty((M, F), dtype=x.dtype, device=x.device)
    y = torch.empty((M, D), dtype=x.dtype, device=x.device)
    err = fn(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
             hidden.data_ptr(), y.data_ptr(), M, D, F, ACTS[act],
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"previous K5 launch failed with cudaError_t {err}")
    return y


def check_close(name, got, want, rtol, atol):
    got, want = got.float(), want.float()
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if not torch.isfinite(got).all() or bad.any():
        raise AssertionError(
            f"{name}: {int(bad.sum())} values outside rtol={rtol} atol={atol}; "
            f"max abs err {float(err.max()):.3e}")
    return float(err.max())


def fp32_k5_held(label, phase, *args):
    """Runs ``phase`` (a card-against-CPU phase in fp32) with K5's calls
    captured, then holds fp32 K5 against its plain version on the inputs the
    card side gave it.  Returns the phase's result, its fp32 K5 launches and
    the record of its most-called K5 case."""
    from madtp_tpu_torch.kernels.ffn import ffn_cuda

    before = ffn_cuda.fp32_launches
    with K5Capture() as capture:
        out = phase(*args)
    launches = ffn_cuda.fp32_launches - before
    if launches == 0:
        raise AssertionError(f"{label}: the card side launched no fp32 K5")
    return out, launches, check_k5_cases(label, capture, where=dict(dtype="float32"))


def phase_build():
    from madtp_tpu_torch.kernels import attention_scores as k1
    from madtp_tpu_torch.kernels import attention_scores_bwd as k2
    from madtp_tpu_torch.kernels import cross_attention as k4
    from madtp_tpu_torch.kernels import ffn as k5
    from madtp_tpu_torch.kernels.build import build_all

    t0 = time.perf_counter()
    built = build_all([k1.SOURCE, k2.SOURCE, k4.SOURCE, k5.SOURCE, *PREVIOUS.values()])
    log(f"[build] {time.perf_counter() - t0:.2f} s wall for {len(built)} kernel source(s)")
    for name, b in built.items():
        log(f"[build] {name}: nvcc {b.seconds:.2f} s -> {b.path.name}")
        for line in b.log.splitlines():
            if any(w in line for w in ("Compiling entry", "registers", "bytes stack", "spill")):
                log(f"[build]   {line.strip()}")


def hold_k1(name, q, k, v, alive, bias, scale, iters=10, full=True):
    """K1 against its plain version on one case: ``out``, ``cls_attn`` and
    ``col_mass`` within ``TOLERANCES`` in the case's dtype, and a second
    launch bit-identical.  Times K1 and the design it replaced
    (``previous_k1``) on the same inputs, and with ``full`` also the plain
    version and SDPA (``out`` only, so computing less than K1).  Returns the
    record for the kernels line."""
    import torch.nn.functional as F

    from madtp_tpu_torch.kernels.attention_scores import TOLERANCES, attention_scores_cuda
    from madtp_tpu_torch.ops.attention import attention_scores_plain

    dtype = q.dtype
    alive = alive.contiguous()
    bias_in = torch.zeros(alive.shape, device=q.device) if bias is None \
        else bias.float().contiguous()
    with torch.inference_mode():
        got = attention_scores_cuda(q, k, v, alive, bias_in, scale)
        want = attention_scores_plain(q, k, v, alive, bias, scale)
        errs = {n: check_close(f"K1 {n} {name}", g, w, *TOLERANCES[dtype][n])
                for n, g, w in zip(("out", "cls_attn", "col_mass"), got, want)}
        del want
        again = attention_scores_cuda(q, k, v, alive, bias_in, scale)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"K1 {name}: two launches on the same inputs differ")
        del got, again
        ms = kernel_ms(lambda: attention_scores_cuda(q, k, v, alive, bias_in, scale), iters)
        previous_ms = kernel_ms(lambda: previous_k1(q, k, v, alive, bias_in, scale),
                                max(2, iters // 2))
        B, N, H, _ = q.shape
        rec = dict(max_abs_err=max(errs.values()), ms=ms, previous_ms=previous_ms,
                   shape=dict(B=B, N=N, H=H, dtype=str(dtype)[6:]))
        line = (f"{name}: max|err| out {errs['out']:.2e} col {errs['col_mass']:.2e} cls "
                f"{errs['cls_attn']:.2e}, bit-identical relaunch | K1 {ms:.4f} ms, previous "
                f"{previous_ms:.4f} ms")
        if full:
            rec["plain_ms"] = kernel_ms(
                lambda: attention_scores_plain(q, k, v, alive, bias, scale), 3)
            mask = sdpa_mask(alive, bias_in, dtype)
            qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
            rec["library_ms"] = kernel_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask, scale=scale), iters)
            del mask, qh, kh, vh
            rec.update(bounds(*k1_work(q, alive), dtype))
            line += (f", plain {rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
                     f"({rec['bound_by']}), sdpa(out only, computes less than K1) "
                     f"{rec['library_ms']:.4f} ms")
    log(line)
    return rec


K2_ARGS = ("q", "k", "v", "alive", "bias_in", "scale", "out", "stats", "d_out", "d_cls",
           "d_col")


def hold_k2(name, c, iters=5, full=True):
    """K2 against its plain version on one case (``k2_case``'s dict), by
    ``compare_k2``'s rule, and a second launch bit-identical.  Times K2 and
    the design it replaced (``previous_k2``), and with ``full`` also the
    plain version and SDPA forward + backward (``out`` only).  Returns the
    record for the kernels line."""
    import torch.nn.functional as F

    from madtp_tpu_torch.kernels import attention_scores_bwd as k2
    from madtp_tpu_torch.ops.attention import attention_scores_bwd_plain

    dtype = c["q"].dtype
    args = [c[n] for n in K2_ARGS]
    plain_args = [c[n] for n in ("q", "k", "v", "alive", "bias", "scale", "d_out", "d_cls",
                                 "d_col")]
    got = k2.attention_scores_bwd_cuda(*args)
    want = attention_scores_bwd_plain(*plain_args)
    errs, near = compare_k2(c, got, want, k2.TOLERANCES[dtype], name)
    again = k2.attention_scores_bwd_cuda(*args)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"K2 {name}: two launches on the same inputs differ")
    del got, want, again
    ms = kernel_ms(lambda: k2.attention_scores_bwd_cuda(*args), iters)
    previous_ms = kernel_ms(lambda: previous_k2(*args), max(2, iters // 2))
    B, N, H, _ = c["q"].shape
    rec = dict(max_abs_err=max(errs.values()), ms=ms, previous_ms=previous_ms,
               shape=dict(B=B, N=N, H=H, dtype=str(dtype)[6:]))
    line = (f"{name}: max|err| dq {errs['dq']:.2e} dk {errs['dk']:.2e} dv {errs['dv']:.2e} "
            f"dbias {errs['dbias']:.2e} ({near} head-max near ties left out), bit-identical "
            f"relaunch | K2 {ms:.4f} ms, previous {previous_ms:.4f} ms")
    if full:
        rec["plain_ms"] = kernel_ms(lambda: attention_scores_bwd_plain(*plain_args), 2)
        mask = sdpa_mask(c["alive"], c["bias_in"], dtype)
        qh, kh, vh = (c[n].transpose(1, 2).detach().requires_grad_() for n in "qkv")
        do = c["d_out"].view(c["q"].shape).transpose(1, 2)

        def sdpa():
            o = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask, scale=c["scale"])
            torch.autograd.grad(o, (qh, kh, vh), do)

        with torch.enable_grad():
            rec["library_ms"] = kernel_ms(sdpa, iters)
        del mask, qh, kh, vh, do
        rec.update(bounds(*k2_work(c["q"], c["alive"]), dtype, tf32x3=True))
        line += (f", plain {rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
                 f"({rec['bound_by']})" + (f", 3xTF32 bound {rec['bound_3xtf32_ms']:.4f} ms"
                                          if "bound_3xtf32_ms" in rec else "")
                 + f", sdpa fwd+bwd (out only, computes less than K2) {rec['library_ms']:.4f} ms")
    log(line)
    return rec


def slower_cases(label, records):
    """Logs the cases of a path where a kernel was not faster than the design
    it replaced; returns their number."""
    slow = [r for r in records if r["ms"] >= r["previous_ms"]]
    log(f"[previous] {label}: faster than the replaced design in {len(records) - len(slow)} "
        f"of {len(records)} cases" + "".join(f"; not at {r['shape']} ({r['ms']:.4f} against "
                                              f"{r['previous_ms']:.4f} ms)" for r in slow))
    return len(slow)


def phase_k1(device):
    """2. K1 vs plain at the main paths' shapes, fp32 and bf16 (``hold_k1``):
    the NLVR gather path's first layer (64 images, 584 slots), the mask-mode
    buffer (592), a later layer (320), the mask-mode train step's ViT (32
    images, 592: the fp32 step runs K1 in fp32) and the text side (35, with
    PAD_BIAS keys).  Returns the bf16 record at B=64, N=584 and the fp32
    record at B=32, N=592."""
    cases = [(64, 584, False), (64, 592, False), (64, 320, False), (32, 592, False),
             (32, 35, True)]
    record = record32 = None
    for dtype in (torch.float32, torch.bfloat16):
        for B, N, with_bias in cases:
            q, k, v, alive, bias = k1_case(B, N, with_bias=with_bias, dtype=dtype,
                                           device=device)
            rec = hold_k1(f"[k1] {str(dtype)[6:]} B={B} N={N} bias={with_bias}", q, k, v, alive,
                          bias, q.shape[-1] ** -0.5)
            if (dtype, B, N) == (torch.bfloat16, 64, 584):
                record = rec
            if (dtype, B, N) == (torch.float32, 32, 592):
                record32 = rec
            del q, k, v, alive, bias
            torch.cuda.empty_cache()
    return record, record32


def phase_k2(device):
    """3. K2 vs plain at the train step's shapes (``hold_k2``): the
    mask-mode ViT buffer (N = 592), the gather path's first layer (584) and
    a later one (320) at 32 images, the text side at 16 captions with
    PAD_BIAS keys (40 mask, 26 gather), fp32 and bf16.  Returns the fp32
    record at N = 592 (the mask-mode fp32 train step, ``compress_nlvr``'s
    default) and the bf16 record at N = 584 (the amp gather step's first
    ViT layer)."""
    cases = [(32, 592, False), (32, 584, False), (32, 320, False), (16, 40, True),
             (16, 26, True)]
    record = record16 = None
    for dtype in (torch.float32, torch.bfloat16):
        for B, N, with_bias in cases:
            c = k2_case(B, N, with_bias=with_bias, dtype=dtype, device=device)
            rec = hold_k2(f"[k2] B={B} N={N} {str(dtype)[6:]} bias={with_bias}", c)
            if (dtype, N) == (torch.float32, 592):
                record = rec
            if (dtype, N) == (torch.bfloat16, 584):
                record16 = rec
            del c
            torch.cuda.empty_cache()
    return record, record16


def phase_k4(device):
    """K4 vs plain on synthetic inputs at the ITM rerank's shapes (256
    candidates, 35 text queries, 592 image slots in mask mode and 320 in
    gather mode), the NLVR twin cross's (32 pairs, 32 text slots, 320 image
    slots), the VQA-640 mask memory's (16 questions, 40 query slots, 1,616
    image slots) and ragged ones (Nq 1, 7, 22 and 70, S not a multiple of
    the 64-key tile), with and without bias, fp32 and bf16; in bf16 the
    VQA-640 case and B=4, Nq=22, S=600 split the keys (``split_chunks``); a
    batch row with no alive key gives zeros; two launches bit-identical.  The shapes the main paths
    really give K4 are checked on their own inputs (``check_k4_cases``)."""
    import torch.nn.functional as F

    from madtp_tpu_torch.kernels.cross_attention import (TOLERANCES, cross_attention_cuda,
                                                         split_chunks)
    from madtp_tpu_torch.ops.attention import cross_attention_plain

    cases = [(256, 35, 592), (256, 35, 320), (32, 32, 320), (16, 40, 1616), (8, 1, 100),
             (8, 7, 130), (4, 70, 200), (4, 22, 600)]
    for dtype in (torch.float32, torch.bfloat16):
        for B, Nq, S in cases:
            for with_bias in (False, True):
                q, k, v, alive, bias = k4_case(B, Nq, S, with_bias=with_bias, dtype=dtype,
                                               device=device, packed_q=Nq == 7)
                alive[-1] = with_bias  # no alive key in the last row: zeros out
                scale = q.shape[-1] ** -0.5
                got = cross_attention_cuda(q, k, v, alive, bias, scale)
                want = cross_attention_plain(q, k, v, alive, bias, scale)
                torch.cuda.synchronize()
                chunks = split_chunks(B, q.shape[2], Nq, S)[0] if dtype == torch.bfloat16 else 1
                label = (f"B={B} Nq={Nq} S={S} bias={with_bias} {str(dtype)[6:]} "
                         f"({chunks} key chunk{'s' if chunks > 1 else ''})")
                err = check_close(f"K4 {label}", got, want, *TOLERANCES[dtype])
                if not with_bias and got[-1].abs().max() != 0:
                    raise AssertionError(f"K4 {label}: a row with no alive key is not zero")
                if not torch.equal(got, cross_attention_cuda(q, k, v, alive, bias, scale)):
                    raise AssertionError(f"K4 {label}: two launches on the same inputs differ")
                ms = kernel_ms(lambda: cross_attention_cuda(q, k, v, alive, bias, scale), 20)
                previous_ms = kernel_ms(lambda: previous_k4(q, k, v, alive, bias, scale), 20)
                plain_ms = kernel_ms(lambda: cross_attention_plain(q, k, v, alive, bias, scale), 5)
                mask = sdpa_mask(alive, bias, dtype)
                qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
                sdpa_ms = kernel_ms(lambda: F.scaled_dot_product_attention(
                    qh, kh, vh, attn_mask=mask, scale=scale), 20)
                bound_ms, bound_by = bound(*k4_work(q, k, alive, bias), dtype)
                log(f"[k4] {label}: max|err| {err:.2e}, bit-identical relaunch | K4 {ms:.4f} ms, "
                    f"previous {previous_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                    f"{bound_ms:.4f} ms ({bound_by}), sdpa (same function) {sdpa_ms:.4f} ms")
                del q, k, v, got, want, mask
                torch.cuda.empty_cache()


def k5_case(M, D, F, device, seed=0, dtype=torch.bfloat16):
    """K5 inputs: x N(0, 1), W1 and W2 N(0, 1/fan_in), biases N(0, 0.01),
    all in ``dtype`` on the card."""
    g = torch.Generator(device=device).manual_seed(seed)

    def r(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=device) * scale).to(dtype)

    return r(M, D), r(F, D, scale=D ** -0.5), r(F, scale=0.1), r(D, F, scale=F ** -0.5), \
        r(D, scale=0.1)


def k5_work(M, D, F, el=2):
    """(flops, bytes): 2 M D F for each product; x, W1, b1, W2, b2 read once
    and y written once, ``el`` bytes each (the hidden is the kernel's own
    traffic)."""
    return 4.0 * M * D * F, el * (2 * M * D + 2 * D * F + D + F)


def ffn_library(x, w1, b1, w2, b2, act):
    """The same function as K5 in PyTorch calls: two ``F.linear`` and the
    activation (QuickGELU as the reference ``clip/model.py`` writes it)."""
    import torch.nn.functional as F

    h = F.linear(x, w1, b1)
    h = F.gelu(h) if act == "gelu" else h * torch.sigmoid(1.702 * h)
    return F.linear(h, w2, b2)


def hold_k5(name, x, w1, b1, w2, b2, act, iters):
    """K5 against its plain version on one set of inputs, within
    ``TOLERANCES`` of their dtype, a relaunch bit-identical; times of K5,
    the plain version, the library call, the replaced design
    (``previous_k5``) and the bound.  Returns the record."""
    from madtp_tpu_torch.kernels.ffn import TOLERANCES, ffn_cuda
    from madtp_tpu_torch.ops.layers import mlp_plain

    args = (x, w1, b1, w2, b2, act)
    with torch.inference_mode():
        got, want = ffn_cuda(*args), mlp_plain(*args)
        err = check_close(f"K5 {name}", got, want, *TOLERANCES[x.dtype])
        if not torch.equal(got, ffn_cuda(*args)):
            raise AssertionError(f"K5 {name}: two launches on the same inputs differ")
        del got, want
        ms = kernel_ms(lambda: ffn_cuda(*args), iters)
        plain_ms = kernel_ms(lambda: mlp_plain(*args), max(3, iters // 4))
        library_ms = kernel_ms(lambda: ffn_library(*args), iters)
        previous_ms = kernel_ms(lambda: previous_k5(*args), iters)
    M, D = x.shape
    F = w1.shape[0]
    bound_ms, bound_by = bound(*k5_work(M, D, F, x.element_size()), x.dtype)
    log(f"[k5] {name} {str(x.dtype)[6:]}: max|err| {err:.2e}, bit-identical relaunch | K5 "
        f"{ms:.4f} ms ({4.0 * M * D * F / ms / 1e9:.1f} TFLOP/s), previous {previous_ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), library (same "
        f"function) {library_ms:.4f} ms")
    return dict(max_abs_err=err, ms=ms, previous_ms=previous_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                shape=dict(M=M, D=D, F=F, act=act, dtype=str(x.dtype)[6:]))


def phase_k5(device, iters=20):
    """K5 vs plain on synthetic inputs, bf16 at the CLIP vision tower's
    gather shape (32 images x 584 slots, 1024 / 4096), the text tower's
    mask-mode shape (32 x 96, 768 / 3072), BLIP's (64 x 584, 768 / 3072), a
    ragged M, the BOS step's M = 16 and a width that is a multiple of 128
    but not of the 256-wide tile; fp32 at the mask-mode train step's ViT
    rows (32 x 592, 768 / 3072), a ragged M and M = 16; both activations.
    Returns the CLIP vision QuickGELU record and the fp32 train-step GELU
    record."""
    from madtp_tpu_torch.kernels.ffn import ffn_cuda
    from madtp_tpu_torch.ops.layers import mlp_plain

    cases = [("clip vision", 32 * 584, 1024, 4096, torch.bfloat16),
             ("clip text", 32 * 96, 768, 3072, torch.bfloat16),
             ("blip", 64 * 584, 768, 3072, torch.bfloat16),
             ("ragged", 1000, 768, 3072, torch.bfloat16),
             ("bos", 16, 768, 3072, torch.bfloat16),
             ("half tile", 1000, 384, 1152, torch.bfloat16),
             ("train fp32", 32 * 592, 768, 3072, torch.float32),
             ("ragged", 1000, 768, 3072, torch.float32),
             ("bos", 16, 768, 3072, torch.float32)]
    args = k5_case(256, 768, 3072, device)
    with torch.inference_mode():
        host = {name: enqueue_ms(lambda: fn(*args, "gelu"), 200)
                for name, fn in (("K5", ffn_cuda), ("previous", previous_k5),
                                 ("plain", mlp_plain))}
    log(f"[k5] host time to enqueue one FFN (M=256, 768/3072, bf16): K5's wrapper "
        f"{host['K5']:.4f} ms, the replaced design {host['previous']:.4f} ms, the plain "
        f"version {host['plain']:.4f} ms")
    record = record32 = None
    for label, M, D, F, dtype in cases:
        args = k5_case(M, D, F, device, dtype=dtype)
        for act in ("quick_gelu", "gelu"):
            rec = hold_k5(f"{label} M={M} D={D} F={F} {act}", *args, act, iters)
            if label == "clip vision" and act == "quick_gelu":
                record = rec
            if label == "train fp32" and act == "gelu":
                record32 = rec
        del args
        torch.cuda.empty_cache()
    return record, record32


def check_k5_cases(label, capture, iters=5, where=None):
    """K5 against its plain version on the inputs a main path gave it (one
    case per distinct (M, D, F, act, dtype), as ``capture`` recorded them),
    and the FFNs' device time over the path's calls of each dtype on K5, on
    the replaced design, on the plain version and on the library call.
    Returns the record of the most-called case (of those matching ``where``,
    as ``pick_record``)."""
    records = {c: hold_k5(f"{label} M={c[0]} D={c[1]} F={c[2]} {c[3]} "
                          f"({capture.calls[c]} calls)", *case, iters)
               for c, case in capture.cases.items()}
    capture.cases.clear()
    torch.cuda.empty_cache()
    if not records:
        raise AssertionError(f"{label}: the path made no K5 call")
    for dtype in dict.fromkeys(c[4] for c in records):
        mine = {c: r for c, r in records.items() if c[4] == dtype}
        total = {k: sum(capture.calls[c] * r[k] for c, r in mine.items())
                 for k in ("ms", "previous_ms", "plain_ms", "library_ms", "bound_ms")}
        log(f"[k5-path] {label} {str(dtype)[6:]}: the FFNs' device time over "
            f"{sum(capture.calls[c] for c in mine)} calls: K5 {total['ms']:.2f} ms, previous "
            f"{total['previous_ms']:.2f} ms, plain {total['plain_ms']:.2f} ms, library "
            f"{total['library_ms']:.2f} ms, bound {total['bound_ms']:.2f} ms")
    return pick_record(records, capture.calls, where)


def check_k1_cases(label, capture, iters=10, min_n=0):
    """K1 against its plain version on the inputs a main path gave it (one
    case per distinct (B, N, H, dtype, bias), those with N >= ``min_n``),
    each timed beside the design it replaced; the most-called case also with
    its plain version, SDPA (out only) and the bound.  Returns that case's
    record, with the number of cases where K1 was not faster than the
    replaced design (``slower_than_previous``)."""
    calls = collections.Counter({key: n for key, n in capture.calls.items() if key[1] >= min_n})
    if not calls:
        raise AssertionError(f"{label}: the path made no scoring-attention call")
    top = calls.most_common(1)[0][0]
    records = []
    for key, (q, k, v, alive, bias, scale) in capture.cases.items():
        if key[1] < min_n:
            continue
        B, N, H, dtype, _ = key
        scale = q.shape[-1] ** -0.5 if scale is None else scale
        rec = hold_k1(f"[k1-main] {label} B={B} N={N} H={H} {str(dtype)[6:]} "
                      f"({capture.calls[key]} calls)", q, k, v, alive, bias, scale,
                      iters=iters, full=key == top)
        records.append(rec)
        if key == top:
            record = rec
    capture.cases.clear()
    torch.cuda.empty_cache()
    record["slower_than_previous"] = slower_cases(f"K1 {label}", records)
    return record


def check_k2_cases(label, capture, iters=3):
    """K2 against its plain version on the inputs a training path gave it
    (one case per distinct (B, N, H, dtype), by ``compare_k2``'s rule),
    each timed beside the design it replaced; the heaviest case (largest
    B N H) also with the plain version, SDPA and the bound.  Returns that
    case's record, with ``slower_than_previous`` as ``check_k1_cases``."""
    if not capture.cases:
        raise AssertionError(f"{label}: the path made no K2 call")
    top = max(capture.cases, key=lambda key: key[0] * key[1] * key[2])
    records = []
    for key, args in capture.cases.items():
        c = dict(zip(K2_ARGS, args))
        c["bias"] = c["bias_in"]
        c["alive"] = c["alive"].contiguous()
        rec = hold_k2(f"[k2-main] {label} B={key[0]} N={key[1]} H={key[2]} "
                      f"{str(key[3])[6:]} ({capture.calls[key]} calls)", c, iters=iters,
                      full=key == top)
        records.append(rec)
        if key == top:
            record = rec
        del c
    capture.cases.clear()
    torch.cuda.empty_cache()
    record["slower_than_previous"] = slower_cases(f"K2 {label}", records)
    return record


def phase_k1_large(device, main=(16, 1608)):
    """3d. K1 in K3's range (N > 1536, where the TPU runs
    ``fused_attention_scores_tiled``) against its plain version, fp32 and
    bf16, with and without bias, the alive masks of ``k1_case`` (a quarter
    dead at random, a dead tail: ragged across the 64-wide tiles): one slot
    past 1,536, the VQA-640 gather path's first layer (1,608) and mask-mode
    buffer (1,616), a ragged 2,305 and K3's ceiling 4,096, at 16 images where
    the plain version's [B, H, N, N] tensors allow.  Two launches
    bit-identical (``hold_k1``), every launch counted in ``large_n_launches``,
    each case timed beside the replaced design.  Returns the bf16 record at
    ``main`` (B, N) with K1's, the replaced design's, the plain version's
    and SDPA's (``out`` only) times and the bound, for the K3 entry of the
    kernels line."""
    from madtp_tpu_torch.kernels.attention_scores import attention_scores_cuda

    cases = [(16, 1537, True), (16, 1608, False), (16, 1616, False), (8, 2305, True),
             (2, 4096, False)]
    record = None
    for dtype in (torch.float32, torch.bfloat16):
        for B, N, with_bias in cases:
            q, k, v, alive, bias = k1_case(B, N, with_bias=with_bias, dtype=dtype, device=device)
            launches = attention_scores_cuda.launches
            large = attention_scores_cuda.large_n_launches
            main_case = dtype == torch.bfloat16 and (B, N) == main
            rec = hold_k1(f"[k1-large] B={B} N={N} bias={with_bias} {str(dtype)[6:]}", q, k, v,
                          alive, bias, q.shape[-1] ** -0.5, iters=10 if main_case else 3,
                          full=main_case)
            counted = attention_scores_cuda.large_n_launches - large
            if counted < 2 or counted != attention_scores_cuda.launches - launches:
                raise AssertionError(f"K1 B={B} N={N}: {counted} of "
                                     f"{attention_scores_cuda.launches - launches} launches "
                                     "counted in K3's range")
            if main_case:
                record = rec
            del q, k, v, alive, bias
            torch.cuda.empty_cache()
    return record


def full_config():
    from madtp_tpu_torch.core.config import BlipConfig, MedConfig, ViTConfig

    vit = ViTConfig()  # ViT-B/16 @ 384
    med = MedConfig(twin_cross=True, encoder_width=vit.embed_dim, sd_dim=vit.embed_dim)
    return BlipConfig(vit=vit, med=med, sd_dim=vit.embed_dim)


def synthetic_inputs(cfg, pairs, text_len, seed):
    rng = np.random.RandomState(seed)
    s = cfg.vit.image_size
    images = torch.from_numpy(rng.randn(2 * pairs, 3, s, s).astype(np.float32))
    ids = torch.from_numpy(rng.randint(1, cfg.med.vocab_size, size=(pairs, text_len)))
    mask = torch.ones((pairs, text_len), dtype=torch.int64)
    mask[-1, text_len - 5:] = 0  # one padded caption: PAD_BIAS keys
    return images, ids, mask


def phase_model_parity(device, cfg, temperature=1.0):
    """The full-width model on the card (K1, K4, fp32 K5) and the CPU
    (plain), fp32."""
    from madtp_tpu_torch.kernels.attention_scores import attention_scores_cuda
    from madtp_tpu_torch.kernels.cross_attention import cross_attention_cuda
    from madtp_tpu_torch.kernels.ffn import ffn_cuda
    from madtp_tpu_torch.models.blip import init_nlvr_model
    from madtp_tpu_torch.tasks.nlvr import fast_capacity_schedule

    cpu_model = init_nlvr_model(cfg, seed=0, device="cpu")
    gpu_model = copy.deepcopy(cpu_model).to(device)
    images, ids, mask = synthetic_inputs(cfg, pairs=2, text_len=26, seed=1)
    per_forward = cfg.vit.depth + cfg.med.num_hidden_layers
    caps = None
    for mode in ("mask", "gather"):
        kw = dict(temperature=temperature, prune_active=True)
        if mode == "gather":
            kw.update(capacities_v=caps[0], capacities_t=caps[1])
        with torch.inference_mode():
            t0 = time.perf_counter()
            ref = cpu_model(images, ids, mask, **kw)
            cpu_s = time.perf_counter() - t0
            before, k4_before = attention_scores_cuda.launches, cross_attention_cuda.launches
            k5_before = ffn_cuda.fp32_launches
            out = gpu_model(images.to(device), ids.to(device), mask.to(device), **kw)
            torch.cuda.synchronize()
            launches = attention_scores_cuda.launches - before
            k4 = cross_attention_cuda.launches - k4_before
            k5 = ffn_cuda.fp32_launches - k5_before
        vk, tk = out.v_kept.cpu(), out.t_kept.cpu()
        if not (torch.equal(vk, ref.v_kept) and torch.equal(tk, ref.t_kept)):
            raise AssertionError(f"{mode}: kept counts differ: card {vk.tolist()} "
                                 f"{tk.tolist()} vs cpu {ref.v_kept.tolist()} {ref.t_kept.tolist()}")
        err = float((out.logits.cpu() - ref.logits).abs().max())
        if not err <= 1e-4:
            raise AssertionError(f"{mode}: logits differ by {err:.3e} (limit 1e-4)")
        if launches < per_forward:
            raise AssertionError(f"{mode}: K1 launched {launches} times, want >= {per_forward}")
        if k4 != 2 * cfg.med.num_hidden_layers:
            raise AssertionError(f"{mode}: K4 launched {k4} times, want "
                                 f"{2 * cfg.med.num_hidden_layers} (two streams per layer)")
        if k5 != per_forward:
            raise AssertionError(f"{mode}: fp32 K5 launched {k5} times, want {per_forward}")
        log(f"[parity] {mode}: kept vision {vk.tolist()} text {tk.tolist()} equal on card "
            f"and cpu; max|logit diff| {err:.3e}; K1 launches {launches}, K4 {k4}, fp32 K5 "
            f"{k5}; cpu {cpu_s:.1f} s")
        if mode == "mask":
            caps = fast_capacity_schedule(ref.v_kept.numpy(), ref.t_kept.numpy(), "ceil")
            log(f"[parity] gather capacities vision {list(caps[0])} text {list(caps[1])}")


NLVR2_DEV_PAIRS, VQAV2_TEST_DEV = 6982, 107394  # the eval splits' sizes


def nlvr_text_lengths(rng, n):
    """Synthetic NLVR2 sentence lengths in wordpieces with [CLS] and [SEP]:
    about 19 (NLVR2's sentences average 14.8 words, Suhr et al. 2019, at
    about 1.15 wordpieces a word), spread 6.5, in [6, 64]."""
    return np.clip(np.rint(rng.normal(19.0, 6.5, size=n)), 6, 64).astype(np.int64)


def vqa_question_words(rng, n):
    """Synthetic VQAv2 question lengths in wordpieces without [ENC] and
    [SEP]: 3 + Poisson(4), mean 7 (VQAv2's questions average 6.2 words,
    Antol et al. 2015), at most 30."""
    return np.minimum(3 + rng.poisson(4.0, size=n), 30)


def shapes_in_eval(rng, draw, n_items, batch):
    """The distinct padded lengths (``padding="longest"``, one graph each)
    of an eval of ``n_items`` in batches of ``batch`` under ``draw``."""
    return len({int(draw(rng, min(batch, n_items - i)).max())
                for i in range(0, n_items, batch)})


def phase_main_path(device, cfg, pairs=32, text_len=26, p_target=0.5, bisect_steps=8,
                    eval_batches=64, iters=10):
    """NLVR2 eval at p=0.5, bf16: bisection (the captured mask-mode step,
    one graph replayed at every temperature; K4 and K5 held on the eager
    mask-mode step's inputs at T*), ``probe_capacities`` on the eval's
    first two batches, then the gather eval of 64 batches of 32 pairs whose
    sentences are padded to each batch's longest (``nlvr_text_lengths``; a
    graph per length, as JAX compiles one): eagerly (``graph=False``; K1,
    K4 and K5 held on its own inputs, exact launch counts) and as CUDA
    graphs (the main path: equal results and launch counts, a capture per
    length); the step as a graph against the eager step.  Returns the graph
    eval's K1, K4 and K5 launch counts and the K1 record of the gather
    eval."""
    from madtp_tpu_torch.kernels.attention_scores import attention_scores_cuda
    from madtp_tpu_torch.kernels.cross_attention import cross_attention_cuda
    from madtp_tpu_torch.kernels.ffn import ffn_cuda
    from madtp_tpu_torch.models.blip import init_nlvr_model
    from madtp_tpu_torch.prune.flops import nlvr_gflops
    from madtp_tpu_torch.tasks.nlvr import (_device_batch, evaluate, make_eval_step,
                                            probe_capacities)
    from madtp_tpu_torch.utils.graph import CapturedStep

    log(f"[main] {card_line()}")
    model = init_nlvr_model(cfg, seed=0, device=device, dtype=torch.bfloat16)
    images, ids, mask = synthetic_inputs(cfg, pairs, text_len, seed=2)
    mask.fill_(1)
    images = images.to(device, torch.bfloat16)
    ids, mask = ids.to(device), mask.to(device)
    ori = nlvr_gflops(cfg.vit, cfg.med, [cfg.vit.num_patches] * cfg.vit.depth,
                      [text_len - 1] * cfg.med.num_hidden_layers, text_len)
    target = ori * (1.0 - p_target)
    step_mask = make_eval_step(model, prune_active=True)

    rng = np.random.default_rng(3)
    s = cfg.vit.image_size
    pixels = [rng.standard_normal((2 * pairs, 3, s, s), dtype=np.float32) for _ in range(3)]
    texts = []
    for _ in range(eval_batches):  # padded to each batch's longest sentence
        lengths = nlvr_text_lengths(rng, pairs)
        live = np.arange(lengths.max())[None, :] < lengths[:, None]
        texts.append((np.where(live, rng.integers(1, cfg.med.vocab_size, size=live.shape), 0),
                      live.astype(np.int64), rng.integers(0, 2, size=pairs)))
    widths = [t[0].shape[1] for t in texts]

    def loader():  # the same batches on every call
        for j, (_, _, targets) in enumerate(texts):
            im = pixels[j % len(pixels)]
            yield im[:pairs], im[pairs:], [f"{j} sentence {i}" for i in range(pairs)], targets

    def tokenize(sentences):
        return texts[int(sentences[0].split()[0])][:2]

    lo, hi = 0.05, 60.0
    for _ in range(bisect_steps):  # one graph, replayed at each temperature
        t = math.sqrt(lo * hi)
        out = step_mask(images, ids, mask, t)
        vk, tk = out.v_kept.cpu().numpy(), out.t_kept.cpu().numpy()
        g = nlvr_gflops(cfg.vit, cfg.med, vk, tk, text_len)
        log(f"[main] bisect T={t:.4f}: {g:.2f} GFLOPs (target {target:.2f})")
        if g > target:
            lo = t
        else:
            hi = t
    t_star, g_star = t, g
    with K4Capture() as mask_k4, K5Capture() as mask_k5:  # the mask-mode step's own inputs
        make_eval_step(model, True, graph=False)(images, ids, mask, t_star)
    check_k4_cases("nlvr mask-mode step at T*", mask_k4)
    check_k5_cases("nlvr mask-mode step at T*", mask_k5)
    caps_v, caps_t = probe_capacities(model, list(itertools.islice(loader(), 2)), tokenize,
                                      ENC_ID, t_star)
    kw = dict(prune_active=True, enc_token_id=ENC_ID, capacities_v=caps_v, capacities_t=caps_t,
              print_fn=lambda m: log(f"[main] {m}"), print_freq=8)

    def counts():
        torch.cuda.synchronize()
        return (attention_scores_cuda.launches, cross_attention_cuda.launches,
                ffn_cuda.launches)

    attention_scores_cuda.launches = cross_attention_cuda.launches = ffn_cuda.launches = 0
    with K4Capture() as capture, K5Capture() as k5_capture, \
            K1Capture() as k1_capture:  # the eager eval's own inputs
        t0 = time.perf_counter()
        eager_stats = evaluate(model, loader, tokenize, t_star, graph=False, **kw)
        eager_s = time.perf_counter() - t0
    eager = counts()
    per_forward = cfg.vit.depth + cfg.med.num_hidden_layers
    if eager[0] < per_forward * eval_batches:
        raise AssertionError(f"eager eval launched K1 {eager[0]} times, want >= "
                             f"{per_forward * eval_batches}")
    if eager[1:] != (2 * cfg.med.num_hidden_layers * eval_batches, per_forward * eval_batches):
        raise AssertionError(f"eager eval launched K4, K5 {eager[1:]} times, want 24 and "
                             f"{per_forward} per forward")

    attention_scores_cuda.launches = cross_attention_cuda.launches = ffn_cuda.launches = 0
    captures, capture_s = CapturedStep.captures, CapturedStep.capture_seconds
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats, cur_gflops = evaluate(model, loader, tokenize, t_star, **kw)  # the main path
    graph_s = time.perf_counter() - t0
    launches, k4, k5 = counts()
    captures = CapturedStep.captures - captures
    capture_s = CapturedStep.capture_seconds - capture_s
    t0 = time.perf_counter()
    for image0, image1, sentences, _ in loader():  # the eval's feed alone
        _device_batch(image0, image1, sentences, tokenize, ENC_ID, device)
    torch.cuda.synchronize()
    feed_s = time.perf_counter() - t0
    # a new length's first batch is its capture's warm-up; the others replay
    if (launches, k4, k5) != eager:
        raise AssertionError(f"graph eval launched K1, K4, K5 {(launches, k4, k5)} times, want "
                             f"the eager eval's {eager}")
    if captures != len(set(widths)):
        raise AssertionError(f"graph eval captured {captures} graphs for {len(set(widths))} "
                             "text lengths")
    if (stats, cur_gflops) != eager_stats:
        raise AssertionError(f"graph eval {stats, cur_gflops} differs from eager {eager_stats}")
    if not (math.isfinite(cur_gflops) and 0 < cur_gflops < ori):
        raise AssertionError(f"gather eval GFLOPs {cur_gflops} not in (0, {ori})")
    check_k4_cases("nlvr eval", capture)
    check_k5_cases("nlvr eval", k5_capture)
    record1 = check_k1_cases("nlvr gather eval", k1_capture)

    step_gather = make_eval_step(model, True, caps_v, caps_t)
    eager_gather = make_eval_step(model, True, caps_v, caps_t, graph=False)
    step_dense = make_eval_step(model, False)
    eager_dense = make_eval_step(model, False, graph=False)
    torch.cuda.set_sync_debug_mode("error")  # the eager forward must not wait on the card
    try:
        out = eager_gather(images, ids, mask, t_star)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if out.logits.shape != (pairs, 2) or not torch.isfinite(out.logits.float()).all():
        raise AssertionError("gather logits are not finite [pairs, 2]")
    rec = graph_check("nlvr gather step", lambda t: step_gather(images, ids, mask, t),
                      lambda t: eager_gather(images, ids, mask, t), (t_star, 1.25 * t_star),
                      model, iters, dense_fn=lambda t: step_dense(images, ids, mask, t))
    dense_ms = time_ms(lambda: eager_dense(images, ids, mask, 0.0), iters)
    full = shapes_in_eval(np.random.default_rng(4), nlvr_text_lengths, NLVR2_DEV_PAIRS, pairs)
    log(f"[main] T*={t_star:.4f} GFLOPs {g_star:.2f} pruned / {ori:.2f} dense at "
        f"{text_len} tokens; eval GFLOPs {cur_gflops:.2f}; acc {stats['acc']}; overflow "
        f"{stats['overflow']}")
    log(f"[main] capacities (probe of the eval's first 2 batches) vision {list(caps_v)} text "
        f"{list(caps_t)}")
    log(f"[main] gather eval of {eval_batches} batches of {pairs} pairs, text padded to "
        f"{min(widths)}-{max(widths)} tokens: eager {eager_s:.3f} s, graphs {graph_s:.3f} s "
        f"({eager_s / graph_s:.3f}x) with {captures} captures ({len(set(widths))} lengths, "
        f"{capture_s:.3f} s of host time in their warm-ups and captures); the feed alone "
        f"(concatenating and uploading the fp32 images, the ids) {feed_s:.3f} s; "
        f"equal accuracy, overflow and GFLOPs; a whole NLVR2 dev eval ({NLVR2_DEV_PAIRS} "
        f"pairs, {-(-NLVR2_DEV_PAIRS // pairs)} batches) would capture {full} graphs")
    log(f"[main] gather step: graph {rec['graph_ms']:.2f} ms = "
        f"{pairs / rec['graph_ms'] * 1e3:.1f} samples/s, eager {rec['eager_ms']:.2f} ms = "
        f"{pairs / rec['eager_ms'] * 1e3:.1f} samples/s; dense bf16 graph "
        f"{rec['dense_graph_ms']:.2f} ms, eager {dense_ms:.2f} ms; pruned/dense under graphs "
        f"{rec['pruned_over_dense']:.3f}x, eager {dense_ms / rec['eager_ms']:.3f}x")
    log(f"[main] gather step host dispatch time: eager "
        f"{host_ms(lambda: eager_gather(images, ids, mask, t_star), iters):.2f} ms, graph "
        f"replay {rec['enqueue_ms']:.3f} ms")
    log(f"[main] launches on the main path (graphs): K1 {launches}, K4 {k4}, K5 {k5}; "
        f"eager eval K1 {eager[0]}, K4 {eager[1]}, K5 {eager[2]}")
    ffn_ab("nlvr eval gather step (eager)", lambda: eager_gather(images, ids, mask, t_star),
           iters)
    profile_step("gather step (eager)", lambda: eager_gather(images, ids, mask, t_star),
                 rec["eager_ms"])
    profile_step("dense step (eager)", lambda: eager_dense(images, ids, mask, 0.0), dense_ms)
    return launches, k4, k5, record1


GRAD_PARAMS = ("visual_encoder.patch_embed.proj.weight", "visual_encoder.blocks.0.attn.qkv.weight",
               "visual_encoder.blocks.11.attn.qkv.weight", "space_dict",
               "text_encoder.encoder.layer.0.attention.self.query.weight", "cls_head.0.weight")
GRAD_TOL = 1e-3  # of the largest |gradient| of the tensor: fp32 on both, sums in
# another order, and a head-max tie may send col_mass's gradient to another head


def phase_train_parity(device, cfg, temperature=1.0):
    """One fp32 train forward and backward of the full-width model, 1 pair,
    on the card (K1 forward, K2 backward, K4, fp32 K5) and on the CPU
    (plain), in mask mode and in gather mode at lossless capacities."""
    from madtp_tpu_torch.kernels.attention_scores import attention_scores_cuda
    from madtp_tpu_torch.kernels.attention_scores_bwd import attention_scores_bwd_cuda
    from madtp_tpu_torch.kernels.cross_attention import cross_attention_cuda
    from madtp_tpu_torch.kernels.ffn import ffn_cuda
    from madtp_tpu_torch.models.blip import init_nlvr_model
    from madtp_tpu_torch.tasks.nlvr import fast_capacity_schedule

    cpu_model = init_nlvr_model(cfg, seed=0, device="cpu")
    gpu_model = copy.deepcopy(cpu_model).to(device)
    images, ids, mask = synthetic_inputs(cfg, pairs=1, text_len=26, seed=4)
    targets = torch.tensor([1])
    per_forward = cfg.vit.depth + cfg.med.num_hidden_layers
    with torch.inference_mode():
        ref = cpu_model(images, ids, mask, temperature=temperature, prune_active=True)
    caps = fast_capacity_schedule(ref.v_kept.numpy(), ref.t_kept.numpy(), "ceil")
    for mode, (cv, ct) in (("mask", (None, None)), ("gather", caps)):
        kw = dict(temperature=temperature, prune_active=True, capacities_v=cv,
                  capacities_t=ct)
        res = {}
        for where, model, dev in (("cpu", cpu_model, torch.device("cpu")),
                                  ("card", gpu_model, device)):
            x = [t.to(dev) for t in (images, ids, mask)]
            with torch.inference_mode():
                out = model(*x, **kw)
            k1_before = attention_scores_cuda.launches
            k2_before = attention_scores_bwd_cuda.launches
            k4_before = cross_attention_cuda.launches
            k5_before = ffn_cuda.fp32_launches
            model.zero_grad(set_to_none=True)
            lo, lf, _ = model(*x, targets=targets.to(dev), **kw)
            (lo + 0.1 * lf).backward()
            named = dict(model.named_parameters())
            res[where] = dict(kept=(out.v_kept.cpu(), out.t_kept.cpu()),
                              losses=(float(lo.detach()), float(lf.detach())),
                              grads={n: named[n].grad.cpu() for n in GRAD_PARAMS},
                              k1=attention_scores_cuda.launches - k1_before,
                              k2=attention_scores_bwd_cuda.launches - k2_before,
                              k4=cross_attention_cuda.launches - k4_before,
                              k5=ffn_cuda.fp32_launches - k5_before)
        cpu, card = res["cpu"], res["card"]
        if not all(torch.equal(a, b) for a, b in zip(cpu["kept"], card["kept"])):
            raise AssertionError(f"train {mode}: kept counts differ: card {card['kept']} "
                                 f"cpu {cpu['kept']}")
        loss_err = max(abs(a - b) for a, b in zip(cpu["losses"], card["losses"]))
        if not loss_err <= 1e-4:
            raise AssertionError(f"train {mode}: losses differ by {loss_err:.3e} (limit 1e-4)")
        rel = {}
        for n in GRAD_PARAMS:
            g, want = card["grads"][n], cpu["grads"][n]
            scale = float(want.abs().max())
            rel[n] = float((g - want).abs().max()) / scale if scale > 0 else float("inf")
            if not (torch.isfinite(g).all() and rel[n] <= GRAD_TOL):
                raise AssertionError(f"train {mode}: grad of {n} differs by {rel[n]:.3e} of "
                                     f"its max {scale:.3e} (limit {GRAD_TOL})")
        if card["k1"] != per_forward or card["k2"] != card["k1"]:
            raise AssertionError(f"train {mode}: K1 {card['k1']} and K2 {card['k2']} launches, "
                                 f"want {per_forward} each")
        if card["k4"] != 2 * cfg.med.num_hidden_layers:
            raise AssertionError(f"train {mode}: K4 {card['k4']} launches, want 24 per step")
        if card["k5"] != per_forward:  # the backward recomputes the plain version
            raise AssertionError(f"train {mode}: fp32 K5 {card['k5']} launches, want "
                                 f"{per_forward} per step")
        log(f"[train-parity] {mode}: kept vision {card['kept'][0].tolist()} text "
            f"{card['kept'][1].tolist()} equal; losses card {card['losses']} cpu "
            f"{cpu['losses']} (max diff {loss_err:.2e}); K1 {card['k1']} K2 {card['k2']} "
            f"K4 {card['k4']} fp32 K5 {card['k5']} launches per step")
        log("[train-parity]   grad max|diff| / max|grad|: " + ", ".join(
            f"{n.replace('visual_encoder.', 'v.').replace('text_encoder.encoder.', 't.')} "
            f"{r:.2e}" for n, r in rel.items()))


def phase_train_main(device, cfg, pairs=16, text_len=26, epochs=3, batches=2, iters=5,
                     p_target=0.5, enc_token_id=2):
    """Compression training as ``madtp_tpu/cli/compress_nlvr.py:335-384``
    runs it, on synthetic data: controller epochs in mask mode fp32, then a
    ``--fast_train`` epoch in fp32 and with ``amp``.  K2 is held on the
    inputs of the mask-mode fp32 epochs and of the amp epoch, K1, K4 and K5
    on every input of the run, and the mask fp32 step is profiled by kernel.
    Returns the K1, K2, K4 and bf16 K5 launch counts of that run (the amp
    epoch's FFNs), the fp32 K5 launches (every other FFN of the run), K5's
    fp32 record at the path's most-called fp32 shape, K2's records of the
    two captures, K1's record at its most-called shape and K4's at its
    most-called fp32 shape."""
    import tempfile

    from madtp_tpu_torch.ckpt.convert import load_nlvr_state_dict, save_nlvr_checkpoint
    from madtp_tpu_torch.kernels.attention_scores import attention_scores_cuda
    from madtp_tpu_torch.kernels.attention_scores_bwd import attention_scores_bwd_cuda
    from madtp_tpu_torch.kernels.cross_attention import cross_attention_cuda
    from madtp_tpu_torch.kernels.ffn import ffn_cuda
    from madtp_tpu_torch.models.blip import init_nlvr_model
    from madtp_tpu_torch.prune.flops import nlvr_gflops
    from madtp_tpu_torch.tasks.nlvr import (cached_probe_batches, evaluate, probe_capacities,
                                            train_epoch)
    from madtp_tpu_torch.train.controller import TemperatureController
    from madtp_tpu_torch.train.loops import make_nlvr_train_step
    from madtp_tpu_torch.train.optim import cosine_lr, make_adamw, set_lr

    log(f"[train] {card_line()}")
    model = init_nlvr_model(cfg, seed=0, device=device)  # fp32 masters
    opt = make_adamw(model.parameters(), lr=3e-6, weight_decay=0.05)  # configs/nlvr.yaml
    rng = np.random.default_rng(5)
    s = cfg.vit.image_size

    def loader_fn(n):
        def loader():
            for _ in range(n):
                im = rng.standard_normal((2 * pairs, 3, s, s), dtype=np.float32)
                yield (im[:pairs], im[pairs:], [f"sentence {i}" for i in range(pairs)],
                       rng.integers(0, 2, size=pairs))
        return loader

    def tokenize(sentences):
        mask = np.ones((len(sentences), text_len), np.int64)
        mask[-1, text_len - 5:] = 0  # one padded caption: PAD_BIAS keys
        return rng.integers(1, cfg.med.vocab_size, size=(len(sentences), text_len)), mask

    ori = nlvr_gflops(cfg.vit, cfg.med, [cfg.vit.num_patches] * cfg.vit.depth,
                      [text_len - 1] * cfg.med.num_hidden_layers, text_len)
    controller = TemperatureController(target_gflops=ori * (1.0 - p_target))
    quiet = dict(print_fn=lambda m: log(f"[train]   {m}"), print_freq=0)

    attention_scores_cuda.launches = attention_scores_bwd_cuda.launches = 0
    cross_attention_cuda.launches = ffn_cuda.launches = ffn_cuda.fp32_launches = 0
    with K4Capture() as capture, K5Capture() as k5_capture, \
            K1Capture() as k1_capture:  # the path's own inputs
        step_mask = make_nlvr_train_step(model, opt)  # mask mode, fp32: compress_nlvr's default
        cur_g = ori
        with K2Capture() as k2_fp32:  # the mask-mode fp32 epochs' own backward inputs
            for epoch in range(epochs):
                if epoch > 0:
                    controller.update(cur_g)
                temperature = controller.temperature
                lr = cosine_lr(epoch, epochs, 3e-6, 0.0)
                set_lr(opt, lr)
                stats = train_epoch(model, step_mask, loader_fn(batches), tokenize, enc_token_id,
                                    temperature, lr=lr, **quiet)
                # the training path stays eager: its recorders take every call's inputs
                _, cur_g = evaluate(model, loader_fn(1), tokenize, temperature, prune_active=True,
                                    enc_token_id=enc_token_id, graph=False, **quiet)
                log(f"[train] epoch {epoch}: T={temperature:.2f} lr={lr:.3e} loss {stats['loss']} "
                    f"(ori {stats['loss_ori']}, fdt {stats['loss_fdt']}); eval GFLOPs {cur_g:.2f} "
                    f"(target {controller.target_gflops:.2f}, dense {ori:.2f})")
                losses = ("loss", "loss_ori", "loss_fdt")
                if not (all(math.isfinite(float(stats[k])) for k in losses)
                        and stats["batches_done"] == batches and 0 < cur_g <= ori):
                    raise AssertionError(f"epoch {epoch}: stats {stats}, GFLOPs {cur_g}")
        probe = cached_probe_batches([None], loader_fn(2), n=2)
        caps_v, caps_t = probe_capacities(model, probe, tokenize, enc_token_id, temperature, "ceil")
        log(f"[train] fast_train capacities vision {list(caps_v)} text {list(caps_t)}")
        steps = {}
        for amp in (False, True):
            name = "gather " + ("amp" if amp else "fp32")
            steps[name] = make_nlvr_train_step(model, opt, capacities_v=caps_v,
                                               capacities_t=caps_t, amp=amp)
            with K2Capture() if amp else contextlib.nullcontext() as k2_capture:
                stats = train_epoch(model, steps[name], loader_fn(batches), tokenize,
                                    enc_token_id, temperature, lr=lr, **quiet)
            k2_amp = k2_capture if amp else None
            log(f"[train] fast_train epoch, {name}: loss {stats['loss']} (ori {stats['loss_ori']}, "
                f"fdt {stats['loss_fdt']})")
            if not math.isfinite(float(stats["loss"])):
                raise AssertionError(f"{name}: loss {stats['loss']}")
    torch.cuda.synchronize()
    k5_fp32 = ffn_cuda.fp32_launches
    launches = (attention_scores_cuda.launches, attention_scores_bwd_cuda.launches,
                cross_attention_cuda.launches, ffn_cuda.launches - k5_fp32)
    log(f"[train] launches on the training main path: K1 {launches[0]}, K2 {launches[1]}, "
        f"K4 {launches[2]}, K5 {launches[3]} in bf16 and {k5_fp32} in fp32")
    if min(launches) == 0 or launches[2] != launches[0]:
        raise AssertionError(f"training main path launched K1/K2/K4/K5 {launches} times "
                             "(K4 should match K1: 24 of each per forward)")
    per_forward = cfg.vit.depth + cfg.med.num_hidden_layers
    if launches[3] != per_forward * batches:
        raise AssertionError(f"training main path launched bf16 K5 {launches[3]} times, want "
                             f"{per_forward * batches}: every FFN of the amp epoch")
    if k5_fp32 == 0 or k5_fp32 % per_forward:
        raise AssertionError(f"training main path launched fp32 K5 {k5_fp32} times, want a "
                             f"positive multiple of {per_forward}: every FFN of the fp32 "
                             "forwards")
    record4_32 = check_k4_cases("nlvr train", capture, where=dict(dtype="float32"))
    record32 = check_k5_cases("nlvr train", k5_capture, where=dict(dtype="float32"))
    record1 = check_k1_cases("nlvr train", k1_capture, iters=5)
    record2_fp32 = check_k2_cases("nlvr train mask fp32", k2_fp32)
    record2_amp = check_k2_cases("nlvr train gather amp", k2_amp)

    # one fixed batch on the card for the guard, the timings and the profile
    im0, im1, _, tg = next(iter(loader_fn(1)()))
    ids, mask = tokenize([""] * pairs)
    ids[:, 0] = enc_token_id
    batch = tuple(torch.from_numpy(a).to(device) for a in (np.concatenate([im0, im1]), ids,
                                                           mask, tg)) + (temperature,)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # the train step must not wait on the card
    try:
        m = steps["gather fp32"](*batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if not torch.isfinite(m["loss"]):
        raise AssertionError("gather train step under the sync guard: loss not finite")
    log("[train] gather fp32 train step ran under set_sync_debug_mode('error')")

    steps["mask fp32"] = step_mask
    steps["dense fp32"] = make_nlvr_train_step(model, opt, prune_active=False)
    steps["dense amp"] = make_nlvr_train_step(model, opt, prune_active=False, amp=True)
    times = {}
    for name in ("mask fp32", "gather fp32", "gather amp", "dense fp32", "dense amp"):
        step = steps[name]
        step(*batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times[name] = time_ms(lambda: step(*batch), iters)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"[train] {name} step {times[name]:.2f} ms = {pairs / times[name] * 1e3:.1f} "
            f"pairs/s; peak memory {peak:.2f} GiB")
    for name in ("mask fp32", "gather amp"):
        profile_backward(name, steps[name], batch)
    host = host_ms(lambda: steps["gather amp"](*batch), iters)
    log(f"[train] gather amp step host dispatch time {host:.2f} ms")
    ffn_ab("train gather amp step", lambda: steps["gather amp"](*batch), iters)
    ffn_ab("train mask fp32 step", lambda: steps["mask fp32"](*batch), iters)
    profile_step("gather amp train step", lambda: steps["gather amp"](*batch),
                 times["gather amp"], top=12)
    profile_step("mask fp32 train step", lambda: steps["mask fp32"](*batch),
                 times["mask fp32"], top=16)

    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/checkpoint_best.pth"
        save_nlvr_checkpoint(model, path, epoch=epochs - 1, temperature=temperature)
        ck = torch.load(path)
        again = load_nlvr_state_dict(ck["model"], cfg, device=device)
    with torch.inference_mode():
        a = model(*batch[:3], temperature=temperature, prune_active=True)
        b = again(*batch[:3], temperature=temperature, prune_active=True)
    if not (torch.equal(a.logits, b.logits) and ck["temperature"] == temperature):
        raise AssertionError("the reloaded checkpoint gives other logits or temperature")
    log(f"[train] checkpoint round trip: identical logits, temperature {ck['temperature']:.2f}")
    return launches, k5_fp32, record32, record2_fp32, record2_amp, record1, record4_32


def retrieval_config():
    """BLIP retrieval at the width of ``configs/retrieval_coco.yaml``: ViT-B/16
    @ 384 and the 12-layer BERT-base MED with single-stream cross-attention."""
    from madtp_tpu_torch.core.config import BlipConfig, MedConfig, ViTConfig

    vit = ViTConfig()
    med = MedConfig(encoder_width=vit.embed_dim, sd_dim=vit.embed_dim)
    return BlipConfig(vit=vit, med=med, sd_dim=vit.embed_dim)


def retrieval_corpus(cfg, n_images, texts_per_image, seed, text_len=35):
    """A synthetic corpus: ``n_images`` images and ``texts_per_image`` texts
    for each (COCO has 5), token ids with CLS at slot 0 and SEP at the end of
    a random length in [10, text_len], padded to the longest (the
    tokenizer's ``padding="longest"``, at most 35 tokens).  Returns
    ``(images, ids, mask, txt2img, img2txt)``."""
    rng = np.random.default_rng(seed)
    s = cfg.vit.image_size
    images = rng.standard_normal((n_images, 3, s, s), dtype=np.float32)
    n_texts = n_images * texts_per_image
    lengths = rng.integers(10, text_len + 1, size=n_texts)
    lengths[0] = text_len
    ids = rng.integers(1000, 30000, size=(n_texts, text_len))
    mask = (np.arange(text_len)[None, :] < lengths[:, None]).astype(np.int64)
    ids[:, 0] = CLS_ID
    ids[np.arange(n_texts), lengths - 1] = SEP_ID
    ids = np.where(mask > 0, ids, 0)
    txt2img = [t // texts_per_image for t in range(n_texts)]
    img2txt = [list(range(i * texts_per_image, (i + 1) * texts_per_image))
               for i in range(n_images)]
    return images, ids, mask, txt2img, img2txt


FP32_ULP = 2.0 ** -23  # relative rounding step of fp32
GAP_MIN = 64 * FP32_ULP  # least relative DTP margin the parity phase runs at
DRIFT_FACTOR = 4  # the margin must also hold this many times the card's drift
# the card-against-CPU phases run near their main path's temperature T*: at
# the first of these multiples of it whose DTP decisions clear the margin
PARITY_FACTORS = (1.0, 1.25, 0.8, 1.6, 0.6, 2.0, 2.5, 3.2, 4.0, 5.0, 6.4)


class DTPRecorder:
    """While active, records every DTP keep decision as CPU tensors: the
    scores, each row's threshold, the alive mask, the ranking, the batch keep
    count and whether the step applies."""

    def __enter__(self):
        from madtp_tpu_torch.prune import dtp

        self.records = []
        self._dtp, self._orig = dtp, dtp._keep_rule

        def record(score, signals, palive, temperature, *rest):
            order, topk_num, alive_cnt, apply = self._orig(score, signals, palive, temperature,
                                                           *rest)
            t = torch.as_tensor(temperature, dtype=torch.float32, device=score.device)
            thr = dtp.dtp_threshold(signals.token_attn, score, palive, t)
            self.records.append((score.detach().float().cpu(), thr.detach().float().cpu(),
                                 palive.cpu(),
                                 order.cpu(), int(topk_num), bool(apply)))
            return order, topk_num, alive_cnt, apply

        dtp._keep_rule = record
        return self

    def __exit__(self, *exc):
        self._dtp._keep_rule = self._orig


def dtp_margins(records):
    """The smallest relative margins of recorded DTP decisions: the distance
    of a score from its row's threshold, over the rows that hold the batch's
    largest keep count (the rows that set it), and, in every row that drops
    tokens, the gap between the last kept and the first dropped score.  A
    rounding error smaller than both changes no decision."""
    thr_gap = rank_gap = math.inf
    for score, thr, palive, order, k, apply in records:
        counts = (palive & (score > thr[:, None])).sum(dim=1)
        deciding = palive & (counts == counts.max())[:, None]
        if deciding.any():
            rel = (score - thr[:, None]).abs() / thr.abs()[:, None]
            thr_gap = min(thr_gap, float(rel[deciding].min()))
        drops = palive.sum(dim=1) > k
        if apply and k >= 1 and drops.any():
            ranked = torch.gather(score, 1, order)[drops]
            gap = (ranked[:, k - 1] - ranked[:, k]) / ranked[:, k - 1].abs()
            rank_gap = min(rank_gap, float(gap.min()))
    return thr_gap, rank_gap


def dtp_drift(want, got):
    """The largest change of (score - threshold) between two runs' recorded
    decisions, relative to the larger of the score and the threshold (the
    scale of both roundings), bounded by |change of score| + |change of
    threshold|.  Each row's alive scores are compared in sorted order:
    gather mode places kept tokens by rank, so two near-equal scores may
    trade slots between runs without changing any decision."""
    if len(want) != len(got):
        raise AssertionError(f"{len(got)} DTP decisions against {len(want)}")
    drift = 0.0
    for (s0, t0, a0, *_), (s1, t1, a1, *_) in zip(want, got):
        n_alive = a0.sum(dim=1, keepdim=True)
        if s0.shape != s1.shape or not torch.equal(n_alive, a1.sum(dim=1, keepdim=True)):
            raise AssertionError("a DTP decision ran on another number of alive tokens")
        r0, r1 = (s.masked_fill(~a, -math.inf).sort(dim=1, descending=True).values
                  for s, a in ((s0, a0), (s1, a1)))
        alive = torch.arange(s0.shape[1])[None, :] < n_alive
        if alive.any():
            d = (((r1 - r0).abs() + (t1 - t0).abs()[:, None])
                 / torch.maximum(r0.abs(), t0.abs()[:, None]))
            drift = max(drift, float(d[alive].max()))
    return drift


def card_drift(label, margin, pairs, factor):
    """The card's largest drift (``dtp_drift``) over ``(CPU run, card
    run)`` pairs, and whether it stays ``DRIFT_FACTOR`` times below the
    CPU's ``margin``.  Where it does not, the temperature is not clear of
    rounding and the parity phase tries the next one; where it does, one
    ``[parity-settled]`` line names the phase's settled temperature by its
    ``factor`` of the main path's (one of ``PARITY_FACTORS``) and the
    drift, so that two runs compare line by line."""
    drift = max(dtp_drift(want["dtp"], got["dtp"]) for want, got in pairs)
    clear = drift * DRIFT_FACTOR <= margin
    log(f"{label}: the card's DTP scores drift {drift:.3e} from the CPU's, "
        f"{margin / drift if drift else math.inf:.1f}x below the margin (want >= {DRIFT_FACTOR}x)"
        + ("" if clear else ": the next temperature"))
    if clear:
        log(f"[parity-settled] {label}: factor {factor:g} of the main path's T, the card's "
            f"drift {drift:.3e}, margin {margin:.3e}")
    return drift, clear


def phase_retrieval_parity(device, cfg, t_main, k_test=4):
    """The full-width retrieval model on the card (K1, K4) and the CPU
    (plain), fp32, seeded weights: 4 images, 8 texts, ``k_test`` 4, in mask
    and gather mode.  Equal kept counts and candidate sets, features within
    1e-5, rerank scores within 1e-4, 12 K4 launches per ITM forward.

    Equal kept counts hold only where no DTP decision sits within rounding
    of its edge.  Random weights can put one there: at T=1 the threshold is
    exactly one token's own score in several layers (the codebook's softmax
    over tokens is one-hot), and card and CPU kept 257 and 256 tokens.  So
    the phase measures, on the CPU runs, the smallest margin of every
    decision (``dtp_margins``) at the first temperature ``t_main`` times one
    of ``PARITY_FACTORS`` (``t_main`` the main path's T*) where it reaches
    ``GAP_MIN`` (64 fp32 rounding steps) and the largest drift of the
    card's (score - threshold) from the CPU's stays ``DRIFT_FACTOR`` times
    below it (``card_drift``), and compares card and CPU there."""
    from madtp_tpu_torch.kernels.cross_attention import cross_attention_cuda
    from madtp_tpu_torch.models.blip import init_retrieval_model
    from madtp_tpu_torch.tasks.retrieval import encode_corpus, probe_capacities, rerank_scores

    cpu_model = init_retrieval_model(cfg, seed=0, device="cpu")
    gpu_model = copy.deepcopy(cpu_model).to(device)
    images, ids, mask, _, _ = retrieval_corpus(cfg, 4, 2, seed=6)
    enc_ids = ids.copy()
    enc_ids[:, 0] = ENC_ID

    def run(model, dev, temperature, cv, ct):
        kw = dict(temperature=temperature, prune_active=True)
        t0 = time.perf_counter()
        with DTPRecorder() as rec:
            with torch.inference_mode():
                _, iout = model.image_features(torch.from_numpy(images).to(dev),
                                               capacities=cv, **kw)
                _, tout = model.text_features(torch.from_numpy(ids).to(dev),
                                              torch.from_numpy(mask).to(dev), capacities=ct, **kw)
            # eagerly: the recorder reads every decision back, which no graph may do
            feats = encode_corpus(model, [images], ids, mask, capacities_v=cv, capacities_t=ct,
                                  graph=False, **kw)
            before = cross_attention_cuda.launches
            scores = rerank_scores(model, *feats, enc_ids, mask, k_test=k_test,
                                   capacities_t=ct, graph=False, **kw)
            k4 = cross_attention_cuda.launches - before
        return dict(kept=(iout.kept_counts.cpu(), tout.kept_counts.cpu()),
                    feats=(feats[0], feats[2]), scores=scores, k4=k4, dtp=rec.records,
                    seconds=time.perf_counter() - t0)

    for temperature in (t_main * f for f in PARITY_FACTORS):
        caps = probe_capacities(cpu_model, [images], ids, mask, temperature, "ceil")
        modes = {"mask": (None, None), "gather": caps}
        cpu_runs = {mode: run(cpu_model, torch.device("cpu"), temperature, *c)
                    for mode, c in modes.items()}
        thr_gap, rank_gap = (min(g) for g in zip(*(dtp_margins(r["dtp"])
                                                   for r in cpu_runs.values())))
        margin = min(thr_gap, rank_gap)
        cpu_s = sum(r["seconds"] for r in cpu_runs.values())
        log(f"[r-parity] T={temperature:.4f}: smallest DTP margins on the CPU: threshold "
            f"{thr_gap:.3e}, rank {rank_gap:.3e} ({margin / FP32_ULP:.0f} fp32 steps, want "
            f">= {GAP_MIN / FP32_ULP:.0f}); cpu {cpu_s:.1f} s")
        if margin < GAP_MIN:
            continue
        card_runs = {mode: run(gpu_model, device, temperature, *c) for mode, c in modes.items()}
        for mode, card in card_runs.items():
            if not all(torch.equal(a, b) for a, b in zip(cpu_runs[mode]["kept"], card["kept"])):
                raise AssertionError(f"retrieval {mode}: kept counts differ: card {card['kept']} "
                                     f"cpu {cpu_runs[mode]['kept']}")
        drift, clear = card_drift(f"[r-parity] T={temperature:.4f}", margin,
                                  [(cpu_runs[m], card_runs[m]) for m in modes],
                                  temperature / t_main)
        if clear:
            break
    else:
        raise AssertionError("no temperature near the main path's keeps every DTP decision "
                             f"{GAP_MIN / FP32_ULP:.0f} fp32 steps and {DRIFT_FACTOR}x the card's "
                             "drift from its edge")
    log(f"[r-parity] T={temperature:.4f}: gather capacities vision {list(caps[0])} text "
        f"{list(caps[1])}")
    for mode, card in card_runs.items():
        cpu = cpu_runs[mode]
        feat_err = max(float(np.abs(a - b).max()) for a, b in zip(card["feats"], cpu["feats"]))
        if not feat_err <= 1e-5:
            raise AssertionError(f"retrieval {mode}: features differ by {feat_err:.3e}")
        score_err = 0.0
        for g, w in zip(card["scores"], cpu["scores"]):
            if not np.array_equal(g == -100.0, w == -100.0):
                raise AssertionError(f"retrieval {mode}: candidate sets differ")
            score_err = max(score_err, float(np.abs(g - w).max()))
        if not score_err <= 1e-4:
            raise AssertionError(f"retrieval {mode}: rerank scores differ by {score_err:.3e}")
        n_forwards = sum(sc.shape[0] for sc in card["scores"])
        if card["k4"] != cfg.med.num_hidden_layers * n_forwards:
            raise AssertionError(f"retrieval {mode}: K4 launched {card['k4']} times in "
                                 f"{n_forwards} ITM forwards, want 12 per forward")
        log(f"[r-parity] {mode}: kept vision {card['kept'][0].tolist()} text "
            f"{card['kept'][1].tolist()} equal on card and cpu; candidate sets equal; max|diff| "
            f"features {feat_err:.2e}, scores {score_err:.2e}; DTP drift {drift:.2e} "
            f"({margin / drift if drift else math.inf:.0f}x below the margin); K4 {card['k4']} launches "
            f"in {n_forwards} ITM forwards; cpu {cpu['seconds']:.1f} s")


def phase_retrieval_main(device, cfg, p_target=0.5, bisect_steps=8, n_images=256,
                         texts_per_image=1, batch=32, k_test=256, iters=5):
    """BLIP retrieval eval at p=0.5, bf16: the temperature bisected toward
    half the dense ``retrieval_gflops`` in mask mode, the ``--fast_eval``
    capacities, then the gather-mode ``evaluate`` on a synthetic corpus (8
    batches of 32 images, 1 text each: COCO has 5, cut to keep the script
    inside its time limit) at ``k_test`` 256, so that every
    rerank row in both directions scores 256 candidates, and the dense eval
    (temperature 0); K4 against its plain version on the inputs each eval
    gave it, K1 on the gather eval's.  Each eval runs through ``evaluate``
    (its score matrices recorded as ``rerank_scores`` returns them): eagerly
    (``graph=False``: the recorders take the kernels' inputs there, its
    launch counts exact) and then as CUDA graphs, the main path (equal
    recalls, score matrices and launch counts, 4 captures); ``graph_check``
    holds the image, text
    and ITM steps' graphs (one ITM forward at ``k_test`` 256) against their
    eager runs.  Returns the temperature, the K1, K4 and K5 launch
    counts of the graph gather eval, the K4 record of its ITM shape and its
    K1 record."""
    from madtp_tpu_torch.kernels.attention_scores import attention_scores_cuda
    from madtp_tpu_torch.kernels.cross_attention import cross_attention_cuda
    from madtp_tpu_torch.kernels.ffn import ffn_cuda
    from madtp_tpu_torch.models.blip import init_retrieval_model
    from madtp_tpu_torch.prune.dtp import TokenState
    from madtp_tpu_torch.prune.flops import retrieval_gflops
    from madtp_tpu_torch.tasks.retrieval import corpus_steps, evaluate, probe_capacities
    from madtp_tpu_torch.utils.graph import CapturedStep

    log(f"[retrieval] {card_line()}")
    model = init_retrieval_model(cfg, seed=0, device=device, dtype=torch.bfloat16)
    images, ids, mask, txt2img, img2txt = retrieval_corpus(cfg, n_images, texts_per_image,
                                                           seed=7)
    batches = [images[i:i + batch] for i in range(0, n_images, batch)]
    text_len = ids.shape[1]
    L = cfg.med.num_hidden_layers
    ori = retrieval_gflops(cfg.vit, cfg.med, [cfg.vit.num_patches] * cfg.vit.depth,
                           [text_len - 1] * L, text_len)
    target = ori * (1.0 - p_target)
    im0 = torch.from_numpy(batches[0]).to(device)
    ids_d, mask_d = torch.from_numpy(ids).to(device), torch.from_numpy(mask).to(device)

    lo, hi = 0.05, 60.0
    with torch.inference_mode():
        for _ in range(bisect_steps):
            t = math.sqrt(lo * hi)
            _, iout = model.image_features(im0, temperature=t, prune_active=True)
            _, tout = model.text_features(ids_d[:batch], mask_d[:batch], temperature=t,
                                          prune_active=True)
            g = retrieval_gflops(cfg.vit, cfg.med, iout.kept_counts.cpu().numpy(),
                                 tout.kept_counts.cpu().numpy(), text_len)
            log(f"[retrieval] bisect T={t:.4f}: {g:.2f} GFLOPs (target {target:.2f})")
            if g > target:
                lo = t
            else:
                hi = t
    t_star, g_star = t, g
    caps_v, caps_t = probe_capacities(model, batches, ids, mask, t_star, "ceil")
    log(f"[retrieval] T*={t_star:.4f}: {g_star:.2f} GFLOPs pruned / {ori:.2f} dense; "
        f"capacities vision {list(caps_v)} text {list(caps_t)}")

    def run_eval(temperature, cv, ct, graph):
        """``evaluate`` (the entry point), its score matrices recorded for the
        comparison of the graph run with the eager one."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with Returns("madtp_tpu_torch.tasks.retrieval", "rerank_scores") as scores:
            stats = evaluate(model, iter(batches), ids, mask, txt2img, img2txt, temperature,
                             enc_token_id=ENC_ID, k_test=k_test, capacities_v=cv,
                             capacities_t=ct, graph=graph)
        return stats, scores.values, time.perf_counter() - t0

    def counts():
        torch.cuda.synchronize()
        return attention_scores_cuda.launches, cross_attention_cuda.launches, ffn_cuda.launches

    n_texts = len(ids)
    n_tb = -(-n_texts // 256)
    n_itm = n_images + n_texts  # one ITM forward per rerank row, both directions
    attention_scores_cuda.launches = cross_attention_cuda.launches = ffn_cuda.launches = 0
    with K4Capture() as gather_capture, K5Capture() as gather_k5, \
            K1Capture() as gather_k1:  # the eager eval's own inputs
        eager_stats, eager_scores, eager_s = run_eval(t_star, caps_v, caps_t, False)
    eager = counts()
    want_k1 = cfg.vit.depth * len(batches) + L * (n_tb + n_itm)
    if eager != (want_k1, L * n_itm, want_k1):
        raise AssertionError(f"eager retrieval eval launched K1, K4, K5 {eager} times, want "
                             f"{(want_k1, L * n_itm, want_k1)}: every self-attention and FFN of "
                             f"the towers and the ITM forwards, {L} cross-attentions a forward")
    attention_scores_cuda.launches = cross_attention_cuda.launches = ffn_cuda.launches = 0
    captures = CapturedStep.captures
    stats, scores, eval_s = run_eval(t_star, caps_v, caps_t, True)  # the main path
    k1, k4, k5 = counts()
    captures = CapturedStep.captures - captures
    # one capture each of the image step, the text step and each direction's
    # row step, whose first calls are their warm-ups
    if (k1, k4, k5) != eager or captures != 4:
        raise AssertionError(f"graph retrieval eval launched K1, K4, K5 {(k1, k4, k5)} times "
                             f"with {captures} captures, want the eager eval's {eager} with 4")
    if len(scores) != 1 or not outputs_equal(scores, eager_scores) or stats != eager_stats:
        raise AssertionError("the graph retrieval eval's score matrices or recalls differ from "
                             "the eager eval's")
    if not all(math.isfinite(v) and 0.0 <= v <= 100.0 for v in stats.values()):
        raise AssertionError(f"retrieval stats out of range: {stats}")
    log(f"[retrieval] gather eval: {n_images} images, {n_texts} texts, k_test {k_test}: "
        f"graphs {eval_s:.2f} s wall ({captures} captures), eager {eager_s:.2f} s; r_mean "
        f"{stats['r_mean']:.3f} (random weights), recalls equal, score matrices bit-equal; "
        f"launches (graphs) K1 {k1}, K4 {k4} ({k4 // n_itm} per ITM forward), K5 {k5}")
    with K4Capture() as dense_capture, K5Capture() as dense_k5, K1Capture() as dense_k1:
        dense_eager = run_eval(0.0, None, None, False)
    dense_k1.cases.clear()
    dense_stats, dense_scores, dense_s = run_eval(0.0, None, None, True)
    dense_eager_s = dense_eager[2]
    if not outputs_equal(dense_scores, dense_eager[1]) or dense_stats != dense_eager[0]:
        raise AssertionError("graph dense retrieval eval differs from the eager one")
    log(f"[retrieval] dense eval: graphs {dense_s:.2f} s wall, eager {dense_eager_s:.2f} s; "
        f"r_mean {dense_stats['r_mean']:.3f}; pruned/dense eval wall under graphs "
        f"{dense_s / eval_s:.3f}x, eager {dense_eager_s / eager_s:.3f}x")
    record = check_k4_cases("retrieval gather eval", gather_capture)
    check_k4_cases("retrieval dense eval", dense_capture)
    check_k5_cases("retrieval gather eval", gather_k5)
    check_k5_cases("retrieval dense eval", dense_k5)
    record1 = check_k1_cases("retrieval gather eval", gather_k1, iters=5)

    temps = (t_star, 1.25 * t_star)
    steps = {graph: corpus_steps(model, True, caps_v, caps_t, graph=graph)
             for graph in (True, False)}
    dense_steps = corpus_steps(model, False)
    rec_img = graph_check(f"retrieval image batch of {batch}",
                          lambda t: steps[True][0](im0, t), lambda t: steps[False][0](im0, t),
                          temps, model, iters, dense_fn=lambda t: dense_steps[0](im0, t))
    txt_args = (ids_d[:256], mask_d[:256])
    rec_txt = graph_check("retrieval text batch of 256",
                          lambda t: steps[True][1](*txt_args, t),
                          lambda t: steps[False][1](*txt_args, t), temps, model, iters,
                          dense_fn=lambda t: dense_steps[1](*txt_args, t))


    # one ITM forward at k_test 256, the work of one rerank row: text 0 against
    # 256 image states (t2i's shape)
    k = k_test

    def itm_inputs(temperature, cv):
        with torch.inference_mode():
            _, out = model.image_features(im0, temperature=temperature,
                                          prune_active=temperature > 0, capacities=cv)
        idx = torch.arange(k, device=device) % out.state.x.shape[0]
        eids = ids_d[:1].clone()
        eids[:, 0] = ENC_ID
        return eids.expand(k, -1), mask_d[:1].expand(k, -1), out.state.x[idx], \
            out.state.alive[idx]

    def itm_step(prune, ct, graph):
        @torch.inference_mode()
        def fn(e_ids, e_mask, x, alive, t):
            return model.itm_score(e_ids, e_mask, TokenState(x, alive, None), temperature=t,
                                   prune_active=prune, capacities=ct)
        return CapturedStep(fn, "itm_forward", model, static=(prune, ct)) if graph else fn

    args = itm_inputs(t_star, caps_v)
    dense_args = itm_inputs(0.0, None)
    itm_g, itm_e = itm_step(True, caps_t, True), itm_step(True, caps_t, False)
    dense_itm = itm_step(False, None, True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # the eager ITM forward must not wait on the card
    try:
        score = itm_e(*args, t_star)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if score.shape != (k,) or not torch.isfinite(score.float()).all():
        raise AssertionError("ITM scores at k_test 256 are not finite [256]")
    rec_itm = graph_check(f"retrieval ITM forward, k={k}", lambda t: itm_g(*args, t),
                          lambda t: itm_e(*args, t), temps, model, iters,
                          dense_fn=lambda t: dense_itm(*dense_args, t))
    ffn_ab(f"retrieval gather ITM forward, k={k} (eager)", lambda: itm_e(*args, t_star), iters)
    profile_step(f"gather ITM forward, k={k} (eager)", lambda: itm_e(*args, t_star),
                 rec_itm["eager_ms"])
    for name, rec, n in (("image encode", rec_img, batch), ("text encode", rec_txt, 256),
                         ("ITM candidates", rec_itm, k)):
        log(f"[retrieval] {name}: graphs {n / rec['graph_ms'] * 1e3:.1f}/s pruned, "
            f"{n / rec['dense_graph_ms'] * 1e3:.1f}/s dense ({rec['pruned_over_dense']:.3f}x); "
            f"eager pruned {n / rec['eager_ms'] * 1e3:.1f}/s")
    return t_star, k1, k4, k5, record, record1


def clip_config():
    """CLIP ViT-L/14@336, the model of ``configs/retrieval_*_clip.yaml``, as
    ``tools/bench_clip.py:38-41`` configures it: vision 24 x 1024 (16 heads,
    patch 14, 577 tokens), text 12 x 768 (12 heads, context 77), embed 768,
    codebook 100 x 768."""
    from madtp_tpu_torch.core.config import CLIPConfig

    return CLIPConfig(embed_dim=768, image_resolution=336, vision_layers=24, vision_width=1024,
                      vision_patch_size=14, transformer_width=768, transformer_heads=12,
                      transformer_layers=12, sd_dim=768)


CLIP_EOT = 49407  # the CLIP BPE vocabulary's end-of-text id, its highest


def clip_corpus(cfg, n_images, texts_per_image, seed):
    """A synthetic CLIP corpus: uint8 [H, W, 3] images (the ``--uint8_feed``
    layout) and ``texts_per_image`` texts each, token ids as
    ``tools/bench_clip.py:45-49`` makes them (random ids, EOT ending a length
    in [8, 20), zeros after).  Returns ``(images, text, txt2img, img2txt)``."""
    rng = np.random.default_rng(seed)
    s = cfg.image_resolution
    images = rng.integers(0, 256, size=(n_images, s, s, 3), dtype=np.uint8)
    n_texts = n_images * texts_per_image
    lengths = rng.integers(8, 20, size=n_texts)
    ids = rng.integers(1, 40000, size=(n_texts, cfg.context_length))
    text = np.where(np.arange(cfg.context_length)[None, :] < lengths[:, None], ids, 0)
    text[np.arange(n_texts), lengths - 1] = CLIP_EOT
    txt2img = [t // texts_per_image for t in range(n_texts)]
    img2txt = [list(range(i * texts_per_image, (i + 1) * texts_per_image))
               for i in range(n_images)]
    return images, text, txt2img, img2txt


def phase_clip_main(device, cfg, p_target=0.5, bisect_steps=10, n_images=1024,
                    texts_per_image=5, batch=32, iters=5):
    """CLIP retrieval eval at p=0.5, bf16: the temperature bisected toward
    half the dense ``clip_gflops`` in mask mode (``tools/bench_clip.py:
    80-91``; first image batch and first 32 texts), the ``--fast_eval``
    capacities, ``evaluate`` in gather mode on a synthetic corpus cut from
    COCO's 5,000 images and 25,000 texts to 1,024 and 5,120 (1:5), and the
    dense eval.  K5 and K1 (at H=16) held against their plain versions on
    the inputs the evals gave them.  Each eval runs through ``evaluate``
    (the towers' features recorded as ``encode_towers`` returns them):
    eagerly (``graph=False``: the recorders take the kernels' inputs there,
    its launch counts exact) and then as CUDA graphs, the main path (equal
    recalls, GFLOPs, features and launch counts, 2 captures); ``graph_check``
    holds both towers'
    steps against their eager runs.  Returns the temperature, the K1 and K5
    launch counts of the graph gather eval and the K5 and K1 records."""
    from madtp_tpu_torch.kernels.attention_scores import attention_scores_cuda
    from madtp_tpu_torch.kernels.ffn import ffn_cuda
    from madtp_tpu_torch.models.clip import init_clip_model
    from madtp_tpu_torch.prune.flops import clip_gflops
    from madtp_tpu_torch.tasks.clip_retrieval import evaluate, probe_capacities, tower_steps
    from madtp_tpu_torch.utils.graph import CapturedStep

    log(f"[clip] {card_line()}")
    model = init_clip_model(cfg, seed=0, device=device, dtype=torch.bfloat16)
    images, text, txt2img, img2txt = clip_corpus(cfg, n_images, texts_per_image, seed=9)
    batches = [images[i:i + batch] for i in range(0, n_images, batch)]
    Lv, Lt = cfg.vision_layers, cfg.transformer_layers
    ori = clip_gflops(cfg, [cfg.vision_num_patches] * Lv, [cfg.context_length - 1] * Lt)
    target = ori * (1.0 - p_target)
    im0 = torch.from_numpy(batches[0]).to(device)
    tx = torch.from_numpy(text).to(device)

    lo, hi = 0.05, 60.0
    with torch.inference_mode():
        for _ in range(bisect_steps):
            t = math.sqrt(lo * hi)
            vk = model.encode_image(im0, temperature=t, prune_active=True).kept_counts
            tk = model.encode_text(tx[:batch], temperature=t, prune_active=True).kept_counts
            g = clip_gflops(cfg, vk.cpu().numpy(), tk.cpu().numpy())
            log(f"[clip] bisect T={t:.4f}: {g:.2f} GFLOPs (target {target:.2f}); kept vision "
                f"{vk.tolist()[::4]}... text {tk.tolist()[::3]}...")
            if g > target:
                lo = t
            else:
                hi = t
    t_star, g_star = t, g
    caps_v = probe_capacities(model, batches, t_star, "ceil")
    log(f"[clip] T*={t_star:.4f}: {g_star:.2f} GFLOPs pruned / {ori:.2f} dense; "
        f"capacities vision {list(caps_v)}")

    def run_eval(temperature, cv, graph):
        """``evaluate`` (the entry point), the towers' features recorded for
        the comparison of the graph run with the eager one."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with Returns("madtp_tpu_torch.tasks.clip_retrieval", "encode_towers") as towers:
            stats, cur_g = evaluate(model, iter(batches), text, txt2img, img2txt, temperature,
                                    capacities_v=cv, batch_size=batch, graph=graph)
        return stats, cur_g, time.perf_counter() - t0, towers.values

    def counts():
        torch.cuda.synchronize()
        return attention_scores_cuda.launches, ffn_cuda.launches

    n_texts = len(text)
    n_tb = -(-n_texts // batch)
    attention_scores_cuda.launches = ffn_cuda.launches = 0
    with K5Capture() as k5_capture, K1Capture() as k1_capture:  # the eager eval's own inputs
        eager_stats, eager_g, eager_s, eager_out = run_eval(t_star, caps_v, False)
    eager = counts()
    if eager != (Lv * len(batches), Lv * len(batches) + Lt * n_tb):
        raise AssertionError(f"eager clip eval launched K1, K5 {eager} times, want "
                             f"{(Lv * len(batches), Lv * len(batches) + Lt * n_tb)}: every "
                             "vision layer (the causal text attention stays plain), every FFN")
    attention_scores_cuda.launches = ffn_cuda.launches = 0
    captures = CapturedStep.captures
    stats, cur_g, eval_s, out = run_eval(t_star, caps_v, True)  # the main path
    k1, k5 = counts()
    captures = CapturedStep.captures - captures
    # one capture of each tower's step (the text batches share a shape), whose
    # first calls are their warm-ups
    if (k1, k5) != eager or captures != 2:
        raise AssertionError(f"graph clip eval launched K1, K5 {(k1, k5)} times with "
                             f"{captures} captures, want the eager eval's {eager} with 2")
    if len(out) != 1 or not outputs_equal(out, eager_out) or \
            (stats, cur_g) != (eager_stats, eager_g):
        raise AssertionError("the graph clip eval's features or recalls differ from the eager "
                             "eval's")
    if not all(math.isfinite(v) and 0.0 <= v <= 100.0 for v in stats.values()):
        raise AssertionError(f"clip stats out of range: {stats}")
    if not (math.isfinite(cur_g) and 0 < cur_g < ori):
        raise AssertionError(f"clip eval GFLOPs {cur_g} not in (0, {ori})")
    log(f"[clip] gather eval: {n_images} images, {n_texts} texts: graphs {eval_s:.2f} s wall = "
        f"{n_images / eval_s:.1f} images/s with their texts ({captures} captures), eager "
        f"{eager_s:.2f} s; r_mean {stats['r_mean']:.3f} (random weights), recalls equal, "
        f"features bit-equal; Cur_Gflops {cur_g:.2f}; launches (graphs) K1 {k1}, K5 {k5}")
    with K5Capture() as dense_k5, K1Capture() as dense_k1:
        dense_eager = run_eval(0.0, None, False)
    dense_stats, dense_g, dense_s, dense_out = run_eval(0.0, None, True)
    if dense_k1.calls or abs(dense_g - ori) > 1e-6 * ori or \
            not outputs_equal(dense_out, dense_eager[3]) or dense_stats != dense_eager[0]:
        raise AssertionError(f"dense eval: {sum(dense_k1.calls.values())} scoring attentions, "
                             f"GFLOPs {dense_g} (want none, {ori}), equal to eager: "
                             f"{outputs_equal(dense_out, dense_eager[3])}")
    log(f"[clip] dense eval: graphs {dense_s:.2f} s wall, eager {dense_eager[2]:.2f} s; r_mean "
        f"{dense_stats['r_mean']:.3f}; pruned/dense eval wall under graphs "
        f"{dense_s / eval_s:.3f}x, eager {dense_eager[2] / eager_s:.3f}x")
    record5 = check_k5_cases("clip gather eval", k5_capture)
    check_k5_cases("clip dense eval", dense_k5)
    record1 = check_k1_cases("clip vision gather eval", k1_capture)

    temps = (t_star, 1.25 * t_star)
    steps = {graph: tower_steps(model, True, caps_v, graph=graph) for graph in (True, False)}
    dense_steps = tower_steps(model, False)
    rec_img = graph_check(f"clip image batch of {batch}", lambda t: steps[True][0](im0, t),
                          lambda t: steps[False][0](im0, t), temps, model, iters,
                          dense_fn=lambda t: dense_steps[0](im0, t))
    tx0 = tx[:batch]
    rec_txt = graph_check(f"clip text batch of {batch}", lambda t: steps[True][1](tx0, t),
                          lambda t: steps[False][1](tx0, t), temps, model, iters,
                          dense_fn=lambda t: dense_steps[1](tx0, t))
    ffn_ab(f"clip gather image batch of {batch} (eager)", lambda: steps[False][0](im0, t_star),
           iters)
    for name, rec in (("vision", rec_img), ("text", rec_txt)):
        log(f"[clip] {name}: graphs {batch / rec['graph_ms'] * 1e3:.1f}/s pruned, "
            f"{batch / rec['dense_graph_ms'] * 1e3:.1f}/s dense ({rec['pruned_over_dense']:.3f}x);"
            f" eager pruned {batch / rec['eager_ms'] * 1e3:.1f}/s")
    return t_star, k1, k5, record5, record1


def phase_clip_parity(device, cfg, t_main, n_images=2, texts_per_image=2):
    """The full-width CLIP model on the card (K1 in the vision tower) and
    the CPU (plain), fp32, seeded weights: 2 images and 4 texts, mask and
    gather mode.  Equal kept counts in both towers, unit features within
    1e-5, equal rankings of ``sims`` in both directions, one K1 launch per
    vision layer.  The temperature is the first of a few around the main
    path's ``t_main`` at which the vision tower prunes on the CPU and every
    DTP decision stands ``GAP_MIN`` from its edge, with the card's drift
    ``DRIFT_FACTOR`` times below that margin (as phase 8)."""
    from madtp_tpu_torch.kernels.attention_scores import attention_scores_cuda
    from madtp_tpu_torch.models.clip import init_clip_model
    from madtp_tpu_torch.tasks.clip_retrieval import encode_towers, probe_capacities

    cpu_model = init_clip_model(cfg, seed=0, device="cpu")
    gpu_model = copy.deepcopy(cpu_model).to(device)
    images, text, _, _ = clip_corpus(cfg, n_images, texts_per_image, seed=8)

    def run(model, temperature, cv):
        t0 = time.perf_counter()
        before = attention_scores_cuda.launches
        with DTPRecorder() as rec:  # eagerly: the recorder reads every decision back
            img, txt, vk, tk = encode_towers(model, [images], text, temperature=temperature,
                                             prune_active=True, capacities_v=cv,
                                             batch_size=len(text), graph=False)
        return dict(kept=(vk, tk), feats=(img, txt), sims=img @ txt.T, dtp=rec.records,
                    k1=attention_scores_cuda.launches - before,
                    seconds=time.perf_counter() - t0)

    for temperature in (t_main * f for f in PARITY_FACTORS):
        caps = probe_capacities(cpu_model, [images], temperature)
        modes = {"mask": None, "gather": caps}
        cpu_runs = {mode: run(cpu_model, temperature, cv) for mode, cv in modes.items()}
        thr_gap, rank_gap = (min(g) for g in zip(*(dtp_margins(r["dtp"])
                                                   for r in cpu_runs.values())))
        margin = min(thr_gap, rank_gap)
        vk = cpu_runs["mask"]["kept"][0]
        log(f"[clip-parity] T={temperature:.4f}: smallest DTP margins on the CPU: threshold "
            f"{thr_gap:.3e}, rank {rank_gap:.3e} ({margin / FP32_ULP:.0f} fp32 steps, want "
            f">= {GAP_MIN / FP32_ULP:.0f}); vision keeps {int(vk[-1])} of "
            f"{cfg.vision_num_patches}; cpu {sum(r['seconds'] for r in cpu_runs.values()):.1f} s")
        if margin < GAP_MIN or vk[-1] >= cfg.vision_num_patches:
            continue
        card_runs = {mode: run(gpu_model, temperature, cv) for mode, cv in modes.items()}
        for mode, card in card_runs.items():
            if not all(np.array_equal(a, b) for a, b in zip(cpu_runs[mode]["kept"], card["kept"])):
                raise AssertionError(f"clip {mode}: kept counts differ: card {card['kept']} "
                                     f"cpu {cpu_runs[mode]['kept']}")
        drift, clear = card_drift(f"[clip-parity] T={temperature:.4f}", margin,
                                  [(cpu_runs[m], card_runs[m]) for m in modes],
                                  temperature / t_main)
        if clear:
            break
    else:
        raise AssertionError("no temperature near the main path's prunes with every DTP "
                             f"decision {GAP_MIN / FP32_ULP:.0f} fp32 steps and {DRIFT_FACTOR}x "
                             "the card's drift from its edge")
    log(f"[clip-parity] T={temperature:.4f}: gather capacities vision {list(caps)}")
    for mode, card in card_runs.items():
        cpu = cpu_runs[mode]
        feat_err = max(float(np.abs(a - b).max()) for a, b in zip(card["feats"], cpu["feats"]))
        if not feat_err <= 1e-5:
            raise AssertionError(f"clip {mode}: features differ by {feat_err:.3e} (limit 1e-5)")
        for s_card, s_cpu in ((card["sims"], cpu["sims"]), (card["sims"].T, cpu["sims"].T)):
            if not np.array_equal(np.argsort(-s_card, axis=1, kind="stable"),
                                  np.argsort(-s_cpu, axis=1, kind="stable")):
                raise AssertionError(f"clip {mode}: the rankings of sims differ")
        if card["k1"] != cfg.vision_layers:
            raise AssertionError(f"clip {mode}: K1 launched {card['k1']} times, want "
                                 f"{cfg.vision_layers} (one image batch)")
        log(f"[clip-parity] {mode}: kept vision {card['kept'][0].tolist()} text "
            f"{card['kept'][1].tolist()} equal on card and cpu; rankings equal; max|diff| "
            f"features {feat_err:.2e}; DTP drift {drift:.2e} "
            f"({margin / drift if drift else math.inf:.0f}x below the margin); K1 {card['k1']}; "
            f"cpu {cpu['seconds']:.1f} s")


def vqa_questions(rng, n, lo=8, hi=20, words=None):
    """Synthetic question ids: [ENC], ``words`` (default ``lo``-``hi``)
    random wordpieces and [SEP], padded to the longest (the tokenizer's
    ``padding="longest"``, [ENC] in slot 0 as ``compress_vqa`` sets it).
    Returns ``(ids, mask)``."""
    lengths = (rng.integers(lo, hi + 1, size=n) if words is None else words) + 2
    ids = np.where(np.arange(lengths.max())[None, :] < lengths[:, None],
                   rng.integers(1000, 30000, size=(n, lengths.max())), 0)
    ids[:, 0] = ENC_ID
    ids[np.arange(n), lengths - 1] = SEP_ID
    return ids, (ids > 0).astype(np.int64)


def vqa_answers(rng, n, pool, la=8):
    """A synthetic tokenized answer list [n, ``la``]: [DEC] (the BOS), 1-5
    random wordpieces, the first drawn from a pool of ``pool`` ids so that
    answers share first tokens, [SEP], padding 0 (``tokenize_answers``'s
    layout).  Returns ``(ids, mask)``."""
    lengths = rng.integers(1, 6, size=n)
    ids = rng.integers(1000, 30000, size=(n, la))
    ids[:, 1] = rng.choice(rng.integers(1000, 30000, size=pool), size=n)
    ids = np.where(np.arange(la)[None, :] <= lengths[:, None], ids, 0)
    ids[:, 0] = DEC_ID
    ids[np.arange(n), lengths + 1] = SEP_ID
    return ids, (ids > 0).astype(np.int64)


def vqa_batches(rng, image_size, n_batches, batch):
    """``n_batches`` synthetic eval batches ``(images, q_ids, q_mask,
    question_ids)`` in ``tasks.vqa``'s layout, the questions as long as
    ``vqa_question_words`` draws them."""
    out = []
    for i in range(n_batches):
        ids, mask = vqa_questions(rng, batch, words=vqa_question_words(rng, batch))
        images = rng.standard_normal((batch, 3, image_size, image_size), dtype=np.float32)
        out.append((images, ids, mask, np.arange(i * batch, (i + 1) * batch)))
    return out


def zero_launch_counts():
    from madtp_tpu_torch.kernels.attention_scores import attention_scores_cuda
    from madtp_tpu_torch.kernels.attention_scores_bwd import attention_scores_bwd_cuda
    from madtp_tpu_torch.kernels.cross_attention import cross_attention_cuda
    from madtp_tpu_torch.kernels.ffn import ffn_cuda

    attention_scores_cuda.launches = attention_scores_cuda.large_n_launches = 0
    attention_scores_bwd_cuda.launches = cross_attention_cuda.launches = ffn_cuda.launches = 0
    ffn_cuda.fp32_launches = 0


def launch_counts():
    """(K1, K3's range of K1, K4, K5) launches since the last zeroing."""
    from madtp_tpu_torch.kernels.attention_scores import attention_scores_cuda
    from madtp_tpu_torch.kernels.cross_attention import cross_attention_cuda
    from madtp_tpu_torch.kernels.ffn import ffn_cuda

    torch.cuda.synchronize()
    return (attention_scores_cuda.launches, attention_scores_cuda.large_n_launches,
            cross_attention_cuda.launches, ffn_cuda.launches)


def phase_vqa_parity(device, t_main, k_test=8, n_answers=64):
    """12. The full-width VQA model (``vqa_config``: ViT-B/16 and the
    BERT-base MED as question encoder and answer decoder, seeded random
    weights, fp32) on the card (K1, K4) against the CPU (plain), at 480 px
    and at 640 px (the 480-px weights through ``load_vqa_state_dict``, the
    position grid resized 30 x 30 -> 40 x 40): 2 questions, 64 synthetic
    answers over 16 first tokens (ties in the first-token ranking),
    ``k_test`` 8, mask and gather mode.  Equal kept counts in both towers,
    question states within 1e-5, equal top-k lists in order, candidate
    losses within 1e-4, equal best answers; at 640 every mask-mode ViT layer
    launches K1 at N > 1536.  Each of the four runs (size, mode) has its
    own temperature: the first ``t_main`` (the main path's T*) times one of
    ``PARITY_FACTORS`` at which the ViT prunes and every DTP decision of
    both towers in that run stands ``GAP_MIN`` from its edge on the CPU,
    with the card's drift ``DRIFT_FACTOR`` times below that margin (as
    phase 8).  Gather mode takes its capacities from the CPU's mask-mode run
    at its temperature.  Each run logs the share of the ViT's tokens it
    keeps at its last layer."""
    from madtp_tpu_torch.ckpt.convert import load_vqa_state_dict
    from madtp_tpu_torch.core.config import vqa_config
    from madtp_tpu_torch.kernels.attention_scores import attention_scores_cuda
    from madtp_tpu_torch.models.blip import init_vqa_model
    from madtp_tpu_torch.prune.calibrate import fast_capacity_schedule
    from madtp_tpu_torch.tasks.vqa import candidate_losses

    cpu480 = init_vqa_model(vqa_config(480), seed=0, device="cpu")
    cpu = {480: cpu480, 640: load_vqa_state_dict(cpu480.state_dict(), vqa_config(640),
                                                 device="cpu")}
    card = {res: copy.deepcopy(m).to(device) for res, m in cpu.items()}
    rng = np.random.default_rng(12)
    q_ids, q_mask = vqa_questions(rng, 2)
    a_ids, a_mask = vqa_answers(rng, n_answers, pool=16)
    images = {res: rng.standard_normal((2, 3, res, res), dtype=np.float32) for res in cpu}

    def run(model, res, temperature, caps):
        dev = model.space_dict.device
        x = [torch.from_numpy(a).to(dev) for a in (images[res], q_ids, q_mask)]
        answers = [torch.from_numpy(a).to(dev) for a in (a_ids, a_mask)]
        large = attention_scores_cuda.large_n_launches
        t0 = time.perf_counter()
        with DTPRecorder() as rec, torch.inference_mode():
            out, _, vk = model.encode(*x, temperature=temperature, prune_active=True,
                                      capacities_v=caps[0], capacities_t=caps[1])
            loss, topk = candidate_losses(model.text_decoder, out.state, *answers, k=k_test)
            best = topk.gather(1, torch.argmax(-loss, dim=1)[:, None])[:, 0]
        return dict(kept=(vk.cpu(), out.kept_counts.cpu()), x=out.state.x.cpu(),
                    alive=out.state.alive.cpu(), loss=loss.cpu(), topk=topk.cpu(),
                    best=best.cpu(), dtp=rec.records,
                    large=attention_scores_cuda.large_n_launches - large,
                    seconds=time.perf_counter() - t0)

    mask_runs = {}  # (size, T) -> the CPU's mask-mode run, which both modes' searches read

    def cpu_mask(res, temperature):
        if (res, temperature) not in mask_runs:
            mask_runs[res, temperature] = run(cpu[res], res, temperature, (None, None))
        return mask_runs[res, temperature]

    def search(res, mode):
        """The CPU's and the card's runs of (``res``, ``mode``) at its
        temperature, the CPU's margin and the card's drift."""
        label, n = f"vqa {res} px {mode}", cpu[res].cfg.vit.num_patches
        for temperature in (t_main * f for f in PARITY_FACTORS):
            want, caps = cpu_mask(res, temperature), (None, None)
            if mode == "gather":
                caps = fast_capacity_schedule(want["kept"][0].numpy(), want["kept"][1].numpy(),
                                              "ceil")
                want = run(cpu[res], res, temperature, caps)
            thr_gap, rank_gap = dtp_margins(want["dtp"])
            margin = min(thr_gap, rank_gap)
            kept = int(want["kept"][0][-1])
            log(f"[vqa-parity] {label} T={temperature:.4f}: smallest DTP margins on the CPU "
                f"(both towers): threshold {thr_gap:.3e}, rank {rank_gap:.3e} "
                f"({margin / FP32_ULP:.0f} fp32 steps, want >= {GAP_MIN / FP32_ULP:.0f}); the "
                f"ViT keeps {kept} of {n} at its last layer; cpu {want['seconds']:.1f} s")
            if margin < GAP_MIN or kept >= n:
                continue
            got = run(card[res], res, temperature, caps)
            if not all(torch.equal(a, b) for a, b in zip(want["kept"], got["kept"])):
                raise AssertionError(f"{label}: kept counts differ: card {got['kept']} cpu "
                                     f"{want['kept']}")
            drift, clear = card_drift(f"[vqa-parity] {label} T={temperature:.4f}", margin,
                                      [(want, got)], temperature / t_main)
            if clear:
                return temperature, want, got, margin, drift
        raise AssertionError(f"{label}: no temperature near the main path's prunes with every "
                             f"DTP decision {GAP_MIN / FP32_ULP:.0f} fp32 steps and "
                             f"{DRIFT_FACTOR}x the card's drift from its edge")

    for res, mode in itertools.product(cpu, ("mask", "gather")):
        temperature, want, got, margin, drift = search(res, mode)
        label = f"vqa {res} px {mode}"
        share = int(want["kept"][0][-1]) / cpu[res].cfg.vit.num_patches
        if not torch.equal(want["alive"], got["alive"]):
            raise AssertionError(f"{label}: the question states' alive slots differ")
        state_err = float((got["x"] - want["x"])[want["alive"]].abs().max())
        if not state_err <= 1e-5:
            raise AssertionError(f"{label}: question states differ by {state_err:.3e}")
        if not torch.equal(want["topk"], got["topk"]):
            raise AssertionError(f"{label}: top-k lists differ: card {got['topk'].tolist()} "
                                 f"cpu {want['topk'].tolist()}")
        loss_err = float((got["loss"] - want["loss"]).abs().max())
        if not loss_err <= 1e-4:
            raise AssertionError(f"{label}: candidate losses differ by {loss_err:.3e}")
        if not torch.equal(want["best"], got["best"]):
            raise AssertionError(f"{label}: best answers differ: card {got['best'].tolist()} "
                                 f"cpu {want['best'].tolist()}")
        # 640 px: every mask-mode ViT layer holds 1,616 slots, gather layer 0 1,608
        if res == 480:
            large_ok = got["large"] == 0
        elif mode == "mask":
            large_ok = got["large"] == cpu[res].cfg.vit.depth
        else:
            large_ok = got["large"] >= 1
        if not large_ok:
            raise AssertionError(f"{label}: K1 launched {got['large']} times at N > 1536")
        gaps = want["loss"].sort(dim=1).values
        log(f"[vqa-parity] {label} T={temperature:.4f} ({temperature / t_main:.2f} T*): kept "
            f"vision {got['kept'][0].tolist()} ({share:.1%} at the last layer) text "
            f"{got['kept'][1].tolist()} equal on card and cpu; top-k and best answers "
            f"{got['best'].tolist()} equal; max|diff| states {state_err:.2e}, losses "
            f"{loss_err:.2e} (best-to-second loss gap "
            f"{float((gaps[:, 1] - gaps[:, 0]).min()):.3e}); "
            f"DTP drift {drift:.2e} ({margin / drift if drift else math.inf:.0f}x below the "
            f"margin); K1 launches at N > 1536: {got['large']}; cpu {want['seconds']:.1f} s")


def phase_vqa_main(device, cfg, p_target=0.5, bisect_steps=8, n_batches=16, batch=16,
                   n_answers=3128, k_test=128, iters=3):
    """13. BLIP VQA-480 eval (``configs/vqa.yaml``'s width: ViT-B/16@480, the
    BERT-base MED as question encoder and answer decoder, 3,128 answers,
    ``k_test`` 128, batch 16) in bf16 at p=0.5, seeded random weights: the
    temperature bisected in mask mode toward half the dense GFLOPs of the two
    pruned towers (``vqa_gflops`` with ``n_answers=0``: the answer decoder
    is not pruned), ``probe_capacities``, ``tasks.vqa.evaluate`` in gather
    mode on 256 synthetic questions (16 batches of 16), and the dense eval;
    questions/s, eval wall times, the launches of each kernel (exact: per
    batch 24 scoring attentions, 24 cross-attentions, 48 FFNs), K1, K4 and
    K5 held against their plain versions on the gather eval's own inputs,
    K4 and K5 on the dense eval's (which runs no scoring attention), a
    profile of one gather batch, its host dispatch time, and the LM head's
    time at the candidate pass's shape.  Each eval runs eagerly
    (``graph=False``: the recorders take the kernels' inputs there, its
    launch counts exact) and then as CUDA graphs, the main path (a graph per
    question length, the questions drawn as ``vqa_question_words`` does;
    equal answers and launch counts); ``graph_check`` holds the rank step's graph
    against its eager run.  Returns the temperature, the model, the launch
    counts (K1, K4, K5) of the graph gather eval, the gather eval's K1, K4
    and K5 records and the dense eval's K4 and K5 records."""
    from madtp_tpu_torch.models.blip import init_vqa_model
    from madtp_tpu_torch.prune.flops import vqa_gflops
    from madtp_tpu_torch.tasks.vqa import evaluate, make_rank_step, probe_capacities
    from madtp_tpu_torch.utils.graph import CapturedStep

    log(f"[vqa] {card_line()}")
    model = init_vqa_model(cfg, seed=0, device=device, dtype=torch.bfloat16)
    rng = np.random.default_rng(13)
    batches = vqa_batches(rng, cfg.vit.image_size, n_batches, batch)
    a_ids, a_mask = vqa_answers(rng, n_answers, pool=1000)
    Lv, L = cfg.vit.depth, cfg.med.num_hidden_layers
    im0, q0, m0 = (torch.from_numpy(a).to(device) for a in batches[0][:3])
    n_q0 = q0.shape[1]

    def gflops(vk, tk, n):
        return vqa_gflops(cfg.vit, cfg.med, vk, tk, n_q0, n_answers=n)

    dense_kept = ([cfg.vit.num_patches] * Lv, [n_q0 - 1] * L)
    target = gflops(*dense_kept, 0) * (1.0 - p_target)
    lo, hi = 0.05, 60.0
    with torch.inference_mode():
        for _ in range(bisect_steps):
            t = math.sqrt(lo * hi)
            out, _, vk = model.encode(im0, q0, m0, temperature=t, prune_active=True)
            vk, tk = vk.cpu().numpy(), out.kept_counts.cpu().numpy()
            g = gflops(vk, tk, 0)
            log(f"[vqa] bisect T={t:.4f}: towers {g:.2f} GFLOPs (target {target:.2f}); with "
                f"{k_test} decoder passes {gflops(vk, tk, k_test):.2f}")
            if g > target:
                lo = t
            else:
                hi = t
    t_star = t
    caps_v, caps_t = probe_capacities(model, iter(batches), t_star, "ceil")
    log(f"[vqa] T*={t_star:.4f}: towers {g:.2f} / {gflops(*dense_kept, 0):.2f} GFLOPs dense; "
        f"with {k_test} decoder passes {gflops(vk, tk, k_test):.2f} / "
        f"{gflops(*dense_kept, k_test):.2f}; capacities vision {list(caps_v)} text {list(caps_t)}")

    def run_eval(temperature, cv, ct, graph):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results, cur_g = evaluate(model, iter(batches), a_ids, a_mask, temperature=temperature,
                                  k_test=k_test, capacities_v=cv, capacities_t=ct, graph=graph)
        return results, cur_g, time.perf_counter() - t0

    n_q = n_batches * batch
    per_batch = (Lv + L, 0, 2 * L, Lv + 3 * L)
    # a graph per question length (batches are padded to their longest)
    n_shapes = len({b[1].shape for b in batches})
    widths = sorted({b[1].shape[1] for b in batches})
    zero_launch_counts()
    with K1Capture() as k1_capture, K4Capture() as k4_capture, K5Capture() as k5_capture:
        eager_results, eager_g, eager_s = run_eval(t_star, caps_v, caps_t, False)
    eager = launch_counts()
    if eager != tuple(n_batches * n for n in per_batch):
        raise AssertionError(f"eager vqa eval launched K1, K1 at N > 1536, K4, K5 {eager} "
                             f"times, want {n_batches} x {per_batch}")
    zero_launch_counts()
    captures, capture_s = CapturedStep.captures, CapturedStep.capture_seconds
    results, cur_g, eval_s = run_eval(t_star, caps_v, caps_t, True)  # the main path
    k1, large, k4, k5 = launch_counts()
    captures = CapturedStep.captures - captures
    capture_s = CapturedStep.capture_seconds - capture_s
    # a new length's first batch is its capture's warm-up; the others replay
    if (k1, large, k4, k5) != eager or captures != n_shapes:
        raise AssertionError(f"graph vqa eval launched K1 ({large} at N > 1536), K4, K5 "
                             f"{(k1, k4, k5)} times with {captures} captures, want the eager "
                             f"eval's {eager} with {n_shapes}")
    if (results, cur_g) != (eager_results, eager_g):
        raise AssertionError("graph vqa eval differs from the eager one")
    if len(results) != n_q or not all(0 <= a < n_answers for _, a in results):
        raise AssertionError(f"vqa eval: {len(results)} results, want {n_q} in range")
    if not (math.isfinite(cur_g) and 0 < cur_g < gflops(*dense_kept, k_test)):
        raise AssertionError(f"vqa eval GFLOPs {cur_g}")
    full = shapes_in_eval(np.random.default_rng(15), vqa_question_words, VQAV2_TEST_DEV, batch)
    log(f"[vqa] gather eval: {n_q} questions, {n_answers} answers, k_test {k_test}: graphs "
        f"{eval_s:.2f} s wall = {n_q / eval_s:.2f} questions/s ({captures} captures for "
        f"{n_shapes} question lengths, {widths[0]}-{widths[-1]} tokens, {capture_s:.3f} s of "
        f"host time in their warm-ups and captures), eager {eager_s:.2f} "
        f"s = {n_q / eager_s:.2f} questions/s ({eager_s / eval_s:.3f}x); a whole VQAv2 "
        f"test-dev eval ({VQAV2_TEST_DEV} questions, {-(-VQAV2_TEST_DEV // batch)} batches) "
        f"would capture {full} graphs; equal answers; Cur_Gflops "
        f"{cur_g:.2f}; {len(set(a for _, a in results))} distinct answers; launches (graphs) "
        f"K1 {k1}, K4 {k4}, K5 {k5}")
    zero_launch_counts()
    with K4Capture() as dense_k4, K5Capture() as dense_k5:
        dense_eager = run_eval(0.0, None, None, False)
    d_launches = launch_counts()
    dense_results, dense_g, dense_s = run_eval(0.0, None, None, True)
    if (dense_results, dense_g) != dense_eager[:2]:
        raise AssertionError("graph dense vqa eval differs from the eager one")
    log(f"[vqa] dense eval: graphs {dense_s:.2f} s wall = {n_q / dense_s:.2f} questions/s, "
        f"eager {dense_eager[2]:.2f} s; Cur_Gflops {dense_g:.2f}; eager launches K1 "
        f"{d_launches[0]}, K4 {d_launches[2]}, K5 {d_launches[3]}; pruned/dense wall under "
        f"graphs {dense_s / eval_s:.3f}x, eager {dense_eager[2] / eager_s:.3f}x; answers equal "
        f"to the pruned eval's: {sum(a == b for a, b in zip(results, dense_results))} of {n_q}")
    record1 = check_k1_cases("vqa gather eval", k1_capture, iters=5)
    record4 = check_k4_cases("vqa gather eval", k4_capture)
    # the records of the candidate pass's FFNs, which carry most of the path's FFN work
    cand = dict(M=batch * min(k_test, n_answers) * (a_ids.shape[1] - 1))
    record5 = check_k5_cases("vqa gather eval", k5_capture, where=cand)
    # the dense ViT holds every token, so its K4 cases are those at the widest image memory
    widest = dict(S=max(key[2] for key in dense_k4.cases))
    dense4 = check_k4_cases("vqa dense eval", dense_k4, where=widest)
    dense5 = check_k5_cases("vqa dense eval", dense_k5, where=cand)

    a_dev = [torch.from_numpy(a).to(device) for a in (a_ids, a_mask)]
    kw = dict(k=k_test)
    step = make_rank_step(model, True, caps_v, caps_t, **kw)
    eager_step = make_rank_step(model, True, caps_v, caps_t, graph=False, **kw)
    dense_step = make_rank_step(model, False, **kw)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # the eager batch must not wait on the card
    try:
        eager_step(im0, q0, m0, *a_dev, t_star)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    rec = graph_check(f"vqa batch of {batch}", lambda t: step(im0, q0, m0, *a_dev, t),
                      lambda t: eager_step(im0, q0, m0, *a_dev, t), (t_star, 1.25 * t_star),
                      model, iters, dense_fn=lambda t: dense_step(im0, q0, m0, *a_dev, t))
    log(f"[vqa] one batch of {batch}: graph {rec['graph_ms']:.2f} ms = "
        f"{batch / rec['graph_ms'] * 1e3:.2f} questions/s, eager {rec['eager_ms']:.2f} ms, "
        f"host dispatch eager {host_ms(lambda: eager_step(im0, q0, m0, *a_dev, t_star), iters):.2f}"
        f" ms, graph replay {rec['enqueue_ms']:.3f} ms")
    profile_step(f"vqa gather batch of {batch} (eager)",
                 lambda: eager_step(im0, q0, m0, *a_dev, t_star), rec["eager_ms"], top=12)
    hidden = torch.randn(batch * k_test, 6, cfg.med.hidden_size, device=device,
                         dtype=torch.bfloat16)
    with torch.inference_mode():
        lm_ms = time_ms(lambda: model.text_decoder.lm_head(hidden), iters)
    log(f"[vqa] LM head at the candidate pass's shape ({batch * k_test} x 6 rows, vocab "
        f"{cfg.med.vocab_size}, fp32 logits): {lm_ms:.2f} ms")
    return t_star, model, (k1, k4, k5), (record1, record4, record5), (dense4, dense5)


def phase_vqa_640(device, model480, temperature, n_batches=4, batch=16, n_answers=3128,
                  k_test=128):
    """14. BLIP VQA at 640 px (1,601 tokens), bf16: the VQA-480 weights
    through ``load_vqa_state_dict`` at 640 px, then ``tasks.vqa.evaluate``
    on 64 synthetic questions (4 batches of 16) at phase 13's temperature in
    mask mode (every ViT layer at 1,616 slots) and in gather mode (the probe's
    capacities; 1,608 slots at layer 0).  Every K1 launch with N > 1536 is a
    launch of K3's counterpart.  Held against their plain versions on this
    path's own inputs: K1 at N > 1536, and K4 and K5 in both modes (K4 over
    the mask-mode image memory of 1,616 slots, K5 over its 16 x 1,616
    rows).  Returns the K1 launches, K3's (N > 1536), the K4 and K5
    launches, and the records of K1 at N > 1536, of K4 at the widest image
    memory and of K5 at the widest ViT rows.  Each eval runs eagerly (``graph=False``: the recorders
    take the kernels' inputs there, its launch counts exact) and then as
    CUDA graphs, the main path (equal results and launch counts: a new
    length's first batch is its capture's warm-up); ``graph_check`` holds
    the gather step and a dense eval as graphs gives pruned/dense."""
    from madtp_tpu_torch.ckpt.convert import load_vqa_state_dict
    from madtp_tpu_torch.core.config import vqa_config
    from madtp_tpu_torch.kernels.attention_scores import LARGE_N
    from madtp_tpu_torch.tasks.vqa import evaluate, make_rank_step, probe_capacities

    log(f"[vqa640] {card_line()}")
    cfg = vqa_config(640)
    sd = {k: v.float().cpu() for k, v in model480.state_dict().items()}
    model = load_vqa_state_dict(sd, cfg, device=device).to(torch.bfloat16)
    rng = np.random.default_rng(14)
    batches = vqa_batches(rng, cfg.vit.image_size, n_batches, batch)
    a_ids, a_mask = vqa_answers(rng, n_answers, pool=1000)
    n_q = n_batches * batch
    caps_v, caps_t = probe_capacities(model, iter(batches), temperature, "ceil")
    log(f"[vqa640] T={temperature:.4f}: capacities vision {list(caps_v)} text {list(caps_t)}")
    def run_eval(cv, ct, graph, temperature=temperature):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results, cur_g = evaluate(model, iter(batches), a_ids, a_mask, temperature=temperature,
                                  k_test=k_test, capacities_v=cv, capacities_t=ct, graph=graph)
        return results, cur_g, time.perf_counter() - t0

    modes = (("mask", None, None), ("gather", caps_v, caps_t))
    n_shapes = len({b[1].shape for b in batches})
    eager, eager_counts = {}, {}
    with K1Capture() as capture, K4Capture() as k4_capture, K5Capture() as k5_capture:
        for mode, cv, ct in modes:  # eagerly, for the kernels' own inputs
            zero_launch_counts()
            eager[mode] = run_eval(cv, ct, False)
            eager_counts[mode] = launch_counts()
            large = eager_counts[mode][1]
            want_large = cfg.vit.depth * n_batches if mode == "mask" else n_batches
            if large < want_large or (mode == "mask" and large != want_large):
                raise AssertionError(f"vqa640 {mode}: K1 launched {large} times at N > 1536, "
                                     f"want {want_large}")
    zero_launch_counts()
    runs = {}
    for mode, cv, ct in modes:  # the main path: as graphs
        before = launch_counts()
        results, cur_g, runs[mode] = run_eval(cv, ct, True)
        k1, large, k4, k5 = (a - b for a, b in zip(launch_counts(), before))
        if len(results) != n_q or (results, cur_g) != eager[mode][:2]:
            raise AssertionError(f"vqa640 {mode}: {len(results)} results, want {n_q}, equal to "
                                 "the eager eval's")
        if (k1, large, k4, k5) != eager_counts[mode]:
            raise AssertionError(f"vqa640 {mode}: graphs launched {(k1, large, k4, k5)}, want "
                                 f"the eager eval's {eager_counts[mode]}")
        log(f"[vqa640] {mode} eval: {n_q} questions: graphs {runs[mode]:.2f} s wall = "
            f"{n_q / runs[mode]:.2f} questions/s, eager {eager[mode][2]:.2f} s = "
            f"{n_q / eager[mode][2]:.2f}; equal answers; Cur_Gflops {cur_g:.2f}; launches "
            f"(graphs) K1 {k1} ({large} at N > 1536: K3's), K4 {k4}, K5 {k5}")
    totals = launch_counts()
    dense = run_eval(None, None, True, temperature=0.0)
    log(f"[vqa640] dense eval (graphs): {dense[2]:.2f} s wall = {n_q / dense[2]:.2f} "
        f"questions/s; pruned/dense wall under graphs: mask {dense[2] / runs['mask']:.3f}x, "
        f"gather {dense[2] / runs['gather']:.3f}x")
    record = check_k1_cases("vqa640 eval, N > 1536", capture, iters=5, min_n=LARGE_N + 1)
    widest = dict(S=max(key[2] for key in k4_capture.cases))
    record4 = check_k4_cases("vqa640 eval", k4_capture, where=widest)
    rows = dict(M=max(key[0] for key in k5_capture.cases))
    record5 = check_k5_cases("vqa640 eval", k5_capture, where=rows)

    im0, q0, m0 = (torch.from_numpy(a).to(device) for a in batches[0][:3])
    a_dev = [torch.from_numpy(a).to(device) for a in (a_ids, a_mask)]
    step = make_rank_step(model, True, caps_v, caps_t, k=k_test)
    eager_step = make_rank_step(model, True, caps_v, caps_t, k=k_test, graph=False)
    dense_step = make_rank_step(model, False, k=k_test)
    graph_check(f"vqa640 gather batch of {batch}", lambda t: step(im0, q0, m0, *a_dev, t),
                lambda t: eager_step(im0, q0, m0, *a_dev, t), (temperature, 1.25 * temperature),
                model, 3, dense_fn=lambda t: dense_step(im0, q0, m0, *a_dev, t))
    return totals, (record, record4, record5)


CAPTION_WORDS = {1037: "a", 3861: "picture", 1997: "of"}  # their bert-base-uncased ids


def caption_tokenizer():
    """The decode's vocabulary: a synthetic 30,522-entry vocab.txt in the
    bert-base-uncased layout ([PAD] 0, [unused0-98], [UNK] 100, [CLS] 101,
    [SEP] 102, [MASK] 103, the prompt's words at their ids, ``w<id>``
    elsewhere), written into the git-ignored ``build/``; the tokenizer adds
    [DEC] 30522 and [ENC] 30523, the MED's 30,524 tokens."""
    from madtp_tpu_torch.data.tokenizer_bert import BertWordPieceTokenizer
    from madtp_tpu_torch.kernels.build import BUILD_DIR

    tokens = (["[PAD]"] + [f"[unused{i}]" for i in range(99)]
              + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"]
              + [CAPTION_WORDS.get(i, f"w{i}") for i in range(104, 30522)])
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = BUILD_DIR / "caption_vocab.txt"
    path.write_text("\n".join(tokens) + "\n")
    tok = BertWordPieceTokenizer(str(path))
    if (len(tok.vocab), tok.bos_token_id, tok.enc_token_id, tok.sep_token_id) != \
            (30524, DEC_ID, ENC_ID, SEP_ID):
        raise AssertionError("the synthetic vocabulary is not in the BERT layout")
    return tok


class BeamRecorder:
    """While active, records the margins of every beam-search decision
    (``tasks.caption._top``'s calls) as CPU floats: at each beam step the
    gap between the 2 nb-th and the (2 nb + 1)-th candidate score (which
    candidates are drawn), the gap between the nb-th and the (nb + 1)-th
    candidate that is not EOS among those (the EOS / live split: which beams
    live on), and the gap at the nb-th place of the finished hypotheses'
    pool; and the final pick's gap between the best and the second sequence.
    Each gap is the smallest over the rows, absolute and relative to the
    larger score; gaps between two ``NEG`` entries (empty hypothesis slots)
    are left out."""

    def __init__(self, nb, vocab_size, eos):
        self.nb, self.V, self.eos = nb, vocab_size, eos

    def _gap(self, a, b):
        real = b > self.neg / 2
        if not real.any():
            return math.inf, math.inf
        d = (a - b)[real]
        rel = d / torch.maximum(a.abs(), b.abs())[real]
        return float(d.min()), float(rel.min())

    def __enter__(self):
        from madtp_tpu_torch.tasks import caption

        self.steps, self.final, self.neg = [], None, caption.NEG
        self._mod, self._orig = caption, caption._top
        nb = self.nb

        def record(x, k):
            vals, idx = self._orig(x, k)
            s = torch.sort(x.float(), dim=1, descending=True).values.cpu()
            if k == 2 * nb:
                live = [r[t != self.eos] for r, t in zip(vals.float().cpu(),
                                                         (idx % self.V).cpu())]
                split = [(r[nb - 1], r[nb]) for r in live if len(r) > nb]
                self.steps.append(dict(
                    candidates=self._gap(s[:, k - 1], s[:, k]),
                    live=(self._gap(torch.stack([a for a, _ in split]),
                                    torch.stack([b for _, b in split]))
                          if split else (math.inf, math.inf))))
            elif k == nb:
                self.steps[-1]["finished"] = self._gap(s[:, k - 1], s[:, k])
            else:
                self.final = self._gap(s[:, 0], s[:, 1])
            return vals, idx

        caption._top = record
        return self

    def __exit__(self, *exc):
        self._mod._top = self._orig


def sharpen_decoder(decoder, seed, emb_std=0.1):
    """Redraws the decoder's linear weights N(0, 1/fan_in) and its
    embeddings N(0, ``emb_std``^2) from a CPU generator seeded with ``seed``
    (biases and LayerNorms kept).  With the init's N(0, 0.02) the logits
    (the tied embeddings times a normalized state) spread over about half a
    unit and the memory enters through products of N(0, 0.02) weights, so
    the captions barely depend on the image and the beam decisions sit near
    their edges.  Here the logits spread over about ``emb_std`` sqrt(768),
    2.8."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in decoder.modules():
            if isinstance(m, torch.nn.Linear):
                m.weight.copy_(torch.randn(m.weight.shape, generator=g) * m.weight.shape[1] ** -0.5)
            elif isinstance(m, torch.nn.Embedding):
                m.weight.copy_(torch.randn(m.weight.shape, generator=g) * emb_std)


def caption_batches(rng, image_size, n_batches, batch):
    """``n_batches`` synthetic caption eval batches ``(uint8 images [batch,
    H, W, 3], image_ids)``, the uint8 feed."""
    return [(rng.integers(0, 256, size=(batch, image_size, image_size, 3), dtype=np.uint8),
             np.arange(i * batch, (i + 1) * batch)) for i in range(n_batches)]


def phase_caption_main(device, cfg, tokenizer, p_target=0.5, bisect_steps=8, n_batches=8,
                       batch=32, iters=3):
    """16. BLIP COCO caption eval (``configs/caption_coco.yaml``: ViT-B/16@384,
    the BERT-base MED decoder, batch 32, 3 beams, ``max_length`` 20,
    ``min_length`` 5, prompt ``"a picture of "``) in bf16 at p=0.5, seeded
    random weights (the decoder's through ``sharpen_decoder``), the uint8
    feed: the temperature bisected in mask mode
    toward half of ``ORI_GFLOPS_CAPTION`` by ``caption_gflops``,
    ``probe_capacities``, ``tasks.caption.evaluate`` in gather mode on 256
    synthetic images (8 batches of 32), then the dense eval; captions/s and
    wall times, exact launch counts per batch, CIDEr-D of the pruned captions
    against the dense ones as references (agreement, not accuracy), the
    decoder step's device and host dispatch times; K1, K4 and K5 held on the
    pruned eval's own inputs, K4 and K5 on the dense eval's.  Each eval runs
    eagerly (``graph=False``: the recorders take the kernels' inputs there,
    its launch counts exact) and then as CUDA graphs, the main path (equal
    results and launch counts: the first batch is the capture's warm-up);
    ``graph_check`` holds one
    batch (encode and the whole decode, one graph) against its eager run.
    Returns the temperature, the launch counts (K1, K4, K5) of the graph
    eval and the K1, K4 and K5 records of the pruned eval."""
    from madtp_tpu_torch.eval.caption_metrics import coco_caption_scores
    from madtp_tpu_torch.models.blip import init_caption_model
    from madtp_tpu_torch.models.med import init_decode_cache
    from madtp_tpu_torch.prune.flops import ORI_GFLOPS_CAPTION, caption_gflops
    from madtp_tpu_torch.tasks import caption as TC

    log(f"[caption] {card_line()}")
    model = init_caption_model(cfg, seed=0, device=device, dtype=torch.bfloat16)
    sharpen_decoder(model.text_decoder, seed=1)
    rng = np.random.default_rng(15)
    batches = caption_batches(rng, cfg.vit.image_size, n_batches, batch)
    Lv, L = cfg.vit.depth, cfg.med.num_hidden_layers
    nb, T = 3, 20
    im0 = torch.from_numpy(batches[0][0]).to(device)
    prompt = torch.from_numpy(TC.prompt_ids(tokenizer, batch)).to(device)
    Lp = prompt.shape[1]

    def gflops(vk):
        return caption_gflops(cfg.vit, cfg.med, vk, TC.N_TEXT0)

    target = ORI_GFLOPS_CAPTION * (1.0 - p_target)
    dense_g = gflops([cfg.vit.num_patches] * Lv)
    lo, hi = 0.05, 60.0
    with torch.inference_mode():
        for _ in range(bisect_steps):
            t = math.sqrt(lo * hi)
            vk = model.encode_image(im0, temperature=t, prune_active=True)[2].cpu().numpy()
            g = gflops(vk)
            log(f"[caption] bisect T={t:.4f}: {g:.2f} GFLOPs (target {target:.2f})")
            if g > target:
                lo = t
            else:
                hi = t
    t_star = t
    caps = TC.probe_capacities(model, iter(batches), t_star, "ceil")
    log(f"[caption] T*={t_star:.4f}: {g:.2f} GFLOPs on batch 0, {dense_g:.2f} dense "
        f"(ORI_GFLOPS_CAPTION {ORI_GFLOPS_CAPTION}); kept {vk.tolist()}; capacities "
        f"{list(caps)}")

    def run_eval(temperature, capacities, graph):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = TC.evaluate(model, tokenizer, iter(batches), temperature=temperature,
                          capacities=capacities, num_beams=nb, max_length=T, min_length=5,
                          graph=graph)
        return (*out, time.perf_counter() - t0)

    n_img = n_batches * batch
    steps = Lp + (T - Lp - 1)  # decoder steps per batch: the prompt, then all but the last
    per_batch = (Lv, 0, L * steps, Lv + L * steps)
    zero_launch_counts()
    with K1Capture() as k1_capture, K4Capture() as k4_capture, K5Capture() as k5_capture:
        eager = run_eval(t_star, caps, False)
    if launch_counts() != tuple(n_batches * n for n in per_batch):
        raise AssertionError(f"eager caption eval launched K1, K1 at N > 1536, K4, K5 "
                             f"{launch_counts()} times, want {n_batches} x {per_batch}")
    zero_launch_counts()
    results, cur_g, eval_s = run_eval(t_star, caps, True)  # the main path
    k1, large, k4, k5 = launch_counts()
    # one capture (every batch of the same shape), whose first batch is its
    # warm-up, then a replay a batch
    if (k1, large, k4, k5) != tuple(n_batches * n for n in per_batch):
        raise AssertionError(f"caption eval launched K1, K1 at N > 1536, K4, K5 "
                             f"{(k1, large, k4, k5)} times, want {n_batches} x {per_batch}")
    if (results, cur_g) != eager[:2]:
        raise AssertionError("graph caption eval differs from the eager one")
    zero_launch_counts()
    with K4Capture() as dense_k4, K5Capture() as dense_k5:
        dense_eager = run_eval(0.0, None, False)
    d_launches = launch_counts()
    dense, dense_gf, dense_s = run_eval(0.0, None, True)
    if (dense, dense_gf) != dense_eager[:2]:
        raise AssertionError("graph dense caption eval differs from the eager one")
    for name, res in (("pruned", results), ("dense", dense)):
        if [r["image_id"] for r in res] != list(range(n_img)) or not all(
                r["caption"] for r in res):
            raise AssertionError(f"caption {name} eval: {len(res)} results, want {n_img} "
                                 "non-empty captions in order")
    if not (math.isfinite(cur_g) and 0 < cur_g < dense_gf):
        raise AssertionError(f"caption eval GFLOPs {cur_g} against {dense_gf} dense")
    cider = coco_caption_scores(results, {str(r["image_id"]): [r["caption"]] for r in dense})
    same = sum(a["caption"] == b["caption"] for a, b in zip(results, dense))
    log(f"[caption] gather eval: {n_img} images: graphs {eval_s:.2f} s wall = "
        f"{n_img / eval_s:.2f} captions/s (one capture included), eager {eager[2]:.2f} s = "
        f"{n_img / eager[2]:.2f} captions/s; equal captions; Cur_Gflops {cur_g:.2f}; launches "
        f"(graphs) K1 {k1}, K4 {k4}, K5 {k5} (per batch {per_batch[0]}, {per_batch[2]}, "
        f"{per_batch[3]}: {steps} decoder steps)")
    log(f"[caption] dense eval: graphs {dense_s:.2f} s wall = {n_img / dense_s:.2f} captions/s, "
        f"eager {dense_eager[2]:.2f} s = {n_img / dense_eager[2]:.2f}; Cur_Gflops "
        f"{dense_gf:.2f}; eager launches K1 {d_launches[0]}, K4 {d_launches[2]}, K5 "
        f"{d_launches[3]}; pruned/dense wall under graphs {dense_s / eval_s:.3f}x, eager "
        f"{dense_eager[2] / eager[2]:.3f}x")
    log(f"[caption] agreement of the pruned captions with the dense ones (references): "
        f"CIDEr-D {cider['CIDEr']:.4f}, Bleu_4 {cider['Bleu_4']:.4f}; {same} of {n_img} equal; "
        f"e.g. {results[0]['caption']!r} / {dense[0]['caption']!r}")

    record1 = check_k1_cases("caption gather eval", k1_capture, iters=5)
    record4 = check_k4_cases("caption gather eval", k4_capture, where=dict(Nq=1))
    record5 = check_k5_cases("caption gather eval", k5_capture, where=dict(M=batch * nb))
    check_k4_cases("caption dense eval", dense_k4)
    check_k5_cases("caption dense eval", dense_k5, where=dict(M=batch * nb))

    decoder = model.text_decoder
    with torch.inference_mode():
        state, _, _ = model.encode_image(im0, temperature=t_star, prune_active=True,
                                         capacities=caps)
        enc = decoder._memory(TC._expand_state(state, nb), decoder.dtype)
        memory = decoder.memory_kv(enc)
        cache = init_decode_cache(cfg.med, batch * nb, T, decoder.dtype, device)
        tok = prompt[:, -1:].repeat_interleave(nb, dim=0)
        pos = torch.arange(T, device=device)[10]

        def one_step():
            return decoder.step(tok, pos, cache, enc, memory)

        # its ~600 launches overrun the card's launch queue, so kernel_ms's
        # spin cannot hide their enqueue: the device time is the profiler's
        step_ms = time_ms(one_step, 20)
        step_host = host_ms(one_step, 20)
        step_dev = profile_step(f"caption decoder step ({batch * nb} rows)", one_step, step_ms,
                                top=6)[0]
        h = one_step()[0]
        lm_ms = kernel_ms(lambda: decoder.lm_head(h), 20)
    log(f"[caption] decoder step ({batch * nb} rows, {L} layers, memory of {state.x.shape[1]} "
        f"slots): {step_ms:.3f} ms wall, device busy {step_dev:.3f} ms, host dispatch "
        f"{step_host:.3f} ms; LM head (fp32 logits over {cfg.med.vocab_size}) device "
        f"{lm_ms:.3f} ms")

    images0 = batches[0][0]
    kw = dict(num_beams=nb, max_length=T, min_length=5)
    rec = graph_check(f"caption batch of {batch} (encode and decode)",
                      lambda t: TC.generate_captions(model, tokenizer, images0, t,
                                                     capacities=caps, **kw),
                      lambda t: TC.generate_captions(model, tokenizer, images0, t,
                                                     capacities=caps, graph=False, **kw),
                      (t_star, 1.25 * t_star), model, iters,
                      dense_fn=lambda t: TC.generate_captions(model, tokenizer, images0, t,
                                                              **kw))
    out = TC.generate_captions(model, tokenizer, images0, t_star, capacities=caps, **kw)[0]
    if out.shape != (batch, T) or not torch.equal(out[:, :Lp].cpu(), prompt.cpu()):
        raise AssertionError(f"caption batch: sequences {tuple(out.shape)} without the prompt")
    log(f"[caption] gather: one batch of {batch} (encode and decode): graph "
        f"{rec['graph_ms']:.2f} ms = {batch / rec['graph_ms'] * 1e3:.2f} captions/s, eager "
        f"{rec['eager_ms']:.2f} ms = {batch / rec['eager_ms'] * 1e3:.2f} captions/s")
    return t_star, (k1, k4, k5), (record1, record4, record5)


def phase_caption_parity(device, tokenizer, t_main, n_images=2):
    """17. The full-width caption model (``caption_config``, phase 16's
    seeded random weights, fp32, the uint8 feed) on the card (K1, K4, K5)
    against the CPU (plain): 2 images, the eval's decode (3 beams,
    ``max_length`` 20, ``min_length`` 5, the prompt), in gather mode (the
    capacities from the CPU's mask-mode run), at the first temperature near
    phase 16's T* whose DTP decisions stand clear of fp32 rounding (as phase
    12).  Equal kept counts and alive masks, memory states within 1e-5; the
    decoder's logits along the CPU's sequences (``MedDecoder.forward``)
    within 1e-4 on both sides, their log-prob drift the card's logit drift;
    equal sequences where every beam decision (the CPU's ``BeamRecorder``
    gaps) stands >= 64 fp32 steps and >= 4x the drift (times the steps
    summed into a score) from its edge, else the steps that do not are
    named."""
    from madtp_tpu_torch.core.config import caption_config
    from madtp_tpu_torch.models.blip import init_caption_model
    from madtp_tpu_torch.prune.calibrate import fast_capacity_schedule
    from madtp_tpu_torch.tasks import caption as TC

    cfg = caption_config()
    cpu = init_caption_model(cfg, seed=0, device="cpu")
    sharpen_decoder(cpu.text_decoder, seed=1)
    card = copy.deepcopy(cpu).to(device)
    nb, T, V = 3, 20, cfg.med.vocab_size
    images = np.random.default_rng(16).integers(0, 256, size=(n_images, 384, 384, 3),
                                                dtype=np.uint8)
    prompt = torch.from_numpy(TC.prompt_ids(tokenizer, n_images))
    Lp = prompt.shape[1]

    def run(model, temperature, caps):
        dev = model.space_dict.device
        t0 = time.perf_counter()
        with DTPRecorder() as rec, BeamRecorder(nb, V, SEP_ID) as beams, \
                torch.inference_mode():
            state, _, vk = model.encode_image(torch.from_numpy(images).to(dev),
                                              temperature=temperature, prune_active=True,
                                              capacities=caps)
            seqs = TC.beam_generate(model.text_decoder, state, prompt.to(dev), num_beams=nb,
                                    max_length=T, min_length=5, eos_token_id=SEP_ID,
                                    pad_token_id=0)
        return dict(kept=vk.cpu(), x=state.x.cpu(), alive=state.alive.cpu(), state=state,
                    seqs=seqs.cpu(), dtp=rec.records, beams=beams, model=model,
                    seconds=time.perf_counter() - t0)

    def along(run_, seqs):
        """log-probs of the decoder over ``seqs`` (the CPU's), fp32 [n, T, V]."""
        model = run_["model"]
        dev = model.space_dict.device
        with torch.inference_mode():
            h = model.text_decoder(seqs.to(dev), torch.ones_like(seqs).to(dev), run_["state"])
            return model.text_decoder.lm_head(h).cpu()

    def search():
        """The CPU's and the card's gather runs at the first clear
        temperature, and the card's DTP drift."""
        n = cfg.vit.num_patches
        for temperature in (t_main * f for f in PARITY_FACTORS):
            mask = run(cpu, temperature, None)
            caps = fast_capacity_schedule(mask["kept"].numpy(), None, "ceil")[0]
            want = run(cpu, temperature, caps)
            thr_gap, rank_gap = dtp_margins(want["dtp"])
            margin = min(thr_gap, rank_gap)
            kept = int(want["kept"][-1])
            log(f"[caption-parity] T={temperature:.4f}: smallest DTP margins on the CPU: "
                f"threshold {thr_gap:.3e}, rank {rank_gap:.3e} ({margin / FP32_ULP:.0f} fp32 "
                f"steps, want >= {GAP_MIN / FP32_ULP:.0f}); the ViT keeps {kept} of {n}; "
                f"capacities {list(caps)}; cpu {mask['seconds'] + want['seconds']:.1f} s")
            if margin < GAP_MIN or kept >= n:
                continue
            got = run(card, temperature, caps)
            if not torch.equal(want["kept"], got["kept"]):
                raise AssertionError(f"caption parity: kept counts differ: card {got['kept']} "
                                     f"cpu {want['kept']}")
            drift, clear = card_drift(f"[caption-parity] T={temperature:.4f}", margin,
                                      [(want, got)], temperature / t_main)
            if clear:
                return temperature, want, got, drift
        raise AssertionError("caption parity: no temperature near the main path's prunes with "
                             f"every DTP decision {GAP_MIN / FP32_ULP:.0f} fp32 steps and "
                             f"{DRIFT_FACTOR}x the card's drift from its edge")

    temperature, want, got, drift = search()
    label = "caption gather"
    if not torch.equal(want["alive"], got["alive"]):
        raise AssertionError(f"{label}: the memory states' alive slots differ")
    state_err = float((got["x"] - want["x"])[want["alive"]].abs().max())
    if not state_err <= 1e-5:
        raise AssertionError(f"{label}: memory states differ by {state_err:.3e}")
    lw, lg = along(want, want["seqs"]), along(got, want["seqs"])
    logit_err = float((lg - lw).abs().max())
    if not logit_err <= 1e-4:
        raise AssertionError(f"{label}: decoder logits along the CPU's sequences differ by "
                             f"{logit_err:.3e}")
    lp_drift = float((torch.log_softmax(lg, -1) - torch.log_softmax(lw, -1)).abs().max())
    unclear = []
    beams = want["beams"]
    for j, step in enumerate(beams.steps + [dict(final=beams.final)]):
        score_drift = lp_drift * min(j + 1, T - Lp)  # log-probs summed into a score
        for what, (gap, rel) in step.items():
            if rel < GAP_MIN or gap < DRIFT_FACTOR * score_drift:
                unclear.append(f"{'final pick' if what == 'final' else f't={Lp + j}'} "
                               f"{what} gap {gap:.3e} ({rel / FP32_ULP:.0f} fp32 steps)")
    equal = torch.equal(want["seqs"], got["seqs"])
    if not unclear and not equal:
        raise AssertionError(f"{label}: sequences differ with every beam decision clear: "
                             f"card {got['seqs'].tolist()} cpu {want['seqs'].tolist()}")
    smallest = min(min(g for g, _ in s.values()) for s in beams.steps)
    log(f"[caption-parity] {label} T={temperature:.4f} ({temperature / t_main:.2f} T*): kept "
        f"{got['kept'].tolist()} equal on card and cpu; max|diff| memory states "
        f"{state_err:.2e}, logits along the cpu's sequences {logit_err:.2e} (log-prob drift "
        f"{lp_drift:.2e}); DTP drift {drift:.2e}; smallest beam gap on the cpu "
        f"{smallest:.3e}; sequences {'equal' if equal else 'differ'}"
        + (f"; beam decisions within rounding of their edge, so sequences are not demanded "
           f"equal: {'; '.join(unclear[:6])}" + (f" (+{len(unclear) - 6} more)"
                                                 if len(unclear) > 6 else "")
           if unclear else "; every beam decision clear: sequences demanded equal")
        + f"; cpu {want['seconds']:.1f} s")


def phase_vqa_generate(device, model, temperature, tokenizer, n_batches=2, batch=16):
    """15. VQA ``inference: 'generate'`` on phase 13's VQA-480 model (bf16):
    ``tasks.vqa.generate_answers`` (the mask-mode towers at phase 13's
    temperature, then the 3-beam decode from [DEC], ``max_length`` 10,
    ``min_length`` 1, over the question state) on 2 batches of 16 synthetic
    questions; answers/s, exact launch counts, K4 (one query per row over
    the question state) and K5 held on the path's own inputs.  Returns
    the launch counts (K1, K4, K5) of the graph run and the K4 and K5
    records.  Each eval runs eagerly (``graph=False``: the recorders
    take the kernels' inputs there, its launch counts exact) and then as
    CUDA graphs, the main path (equal results and launch counts: a new
    length's first batch is its capture's warm-up); ``graph_check`` holds one batch
    against its eager run."""
    from madtp_tpu_torch.tasks.vqa import generate_answers

    log(f"[vqa-gen] {card_line()}")
    rng = np.random.default_rng(17)
    batches = [tuple(torch.from_numpy(a).to(device) for a in b[:3])
               for b in vqa_batches(rng, model.cfg.vit.image_size, n_batches, batch)]
    Lv, L = model.cfg.vit.depth, model.cfg.med.num_hidden_layers
    steps = 1 + (10 - 1 - 1)
    kw = dict(bos_token_id=DEC_ID, eos_token_id=SEP_ID)

    def run(graph):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = [generate_answers(model, *b, temperature=temperature, graph=graph, **kw)
                for b in batches]
        answers = [tokenizer.decode(r) for seqs, _, _ in outs for r in seqs.cpu().numpy()]
        return outs, answers, time.perf_counter() - t0

    zero_launch_counts()
    with K4Capture() as k4_capture, K5Capture() as k5_capture:
        eager_outs, _, eager_wall = run(False)
    eager = launch_counts()
    per_batch = (Lv + L, 0, L * (1 + steps), Lv + L + L * steps)
    if eager != tuple(n_batches * n for n in per_batch):
        raise AssertionError(f"eager vqa generate launched K1, K1 at N > 1536, K4, K5 {eager} "
                             f"times, want {n_batches} x {per_batch}")
    zero_launch_counts()
    outs, answers, wall = run(True)  # the main path
    k1, large, k4, k5 = launch_counts()
    n_shapes = len({b[1].shape for b in batches})
    if (k1, large, k4, k5) != eager:
        raise AssertionError(f"vqa generate launched K1, K1 at N > 1536, K4, K5 "
                             f"{(k1, large, k4, k5)} times, want the eager run's {eager}")
    if not outputs_equal(outs, eager_outs):
        raise AssertionError("vqa generate: the graphs' sequences differ from the eager run's")
    if len(answers) != n_batches * batch or not all(
            (s[:, 0] == DEC_ID).all() and s.shape[1] == 10 for s, _, _ in outs):
        raise AssertionError("vqa generate: sequences without [DEC] first or of another length")
    log(f"[vqa-gen] T={temperature:.4f}: {len(answers)} questions: graphs {wall:.2f} s = "
        f"{len(answers) / wall:.2f} answers/s ({n_shapes} captures included), eager "
        f"{eager_wall:.2f} s = {len(answers) / eager_wall:.2f} answers/s; equal sequences; "
        f"launches (graphs) K1 {k1}, K4 {k4}, K5 {k5}; {len(set(answers))} distinct answers, "
        f"e.g. {answers[0]!r}")
    record4 = check_k4_cases("vqa generate", k4_capture, where=dict(Nq=1))
    record5 = check_k5_cases("vqa generate", k5_capture, where=dict(M=batch * 3))
    b0 = batches[0]
    graph_check(f"vqa generate batch of {batch}",
                lambda t: generate_answers(model, *b0, temperature=t, **kw),
                lambda t: generate_answers(model, *b0, temperature=t, graph=False, **kw),
                (temperature, 1.25 * temperature), model, 3,
                dense_fn=lambda t: generate_answers(model, *b0, temperature=t, **kw))
    return (k1, k4, k5), (record4, record5)


# ------------------------------------------------------------- compression training


TRAIN_EPOCHS, TRAIN_BATCHES = 2, 2  # controller epochs in mask mode fp32, batches per epoch


def train_words(rng, lo, hi):
    """One synthetic text of ``lo``-``hi`` words of the synthetic vocabulary
    (``caption_tokenizer``'s ``w<id>``, one wordpiece each)."""
    return " ".join(f"w{i}" for i in rng.integers(1000, 30000, size=rng.integers(lo, hi + 1)))


def train_main(label, *, opt, make_step, run_epoch, eval_gflops, probe, target, t0, init_lr,
               timing_batch, n_samples, unit, ffn_per_forward, save_and_load,
               epochs=TRAIN_EPOCHS, batches=TRAIN_BATCHES, iters=5, cross_attention=True):
    """A compression-training main path as the JAX drivers run it, on
    synthetic data: ``epochs`` controller epochs (the temperature updated
    from the last epoch's GFLOPs, cosine LR) in mask mode fp32
    (``make_step()``), then a ``--fast_train`` epoch at ``probe(T)``'s
    capacities in fp32 and one with ``amp``; K1, K2, K4 and K5 captured on
    the train steps' own inputs (K2 apart in the fp32 epochs and in the amp
    epoch).  The controller's evals and the capacity probe are counted
    apart and not captured.  Then, outside the path: the gather fp32 step
    under the sync guard, step times (mask fp32, gather fp32 and amp, dense
    fp32 and amp; the median of ``iters``) with peak memory, the gather amp
    step's host dispatch time (median), the checkpoint round trip, each
    kernel held against its plain version on the captured inputs.  Returns
    the train steps' launch counts (K1, K2, K4, bf16 K5), their fp32 K5
    launches, the evals' and probe's counts (K1, K2, K4, bf16 K5, fp32 K5),
    the final temperature and the records (K1, K2 fp32, K2 amp, K4, K5
    fp32).  A model without ``cross_attention`` (CLIP) must launch no K4
    and has no K4 record."""
    from madtp_tpu_torch.kernels.attention_scores import attention_scores_cuda
    from madtp_tpu_torch.kernels.attention_scores_bwd import attention_scores_bwd_cuda
    from madtp_tpu_torch.kernels.cross_attention import cross_attention_cuda
    from madtp_tpu_torch.kernels.ffn import ffn_cuda
    from madtp_tpu_torch.train.controller import TemperatureController
    from madtp_tpu_torch.train.optim import cosine_lr, set_lr

    log(f"[{label}] {card_line()}")
    controller = TemperatureController(target_gflops=target, temperature=t0)
    quiet = dict(print_fn=lambda m: log(f"[{label}]   {m}"), print_freq=0)

    def losses_of(stats):
        return {k: v for k, v in stats.items() if k.startswith("loss")}

    def counts():
        fp32 = ffn_cuda.fp32_launches
        return (attention_scores_cuda.launches, attention_scores_bwd_cuda.launches,
                cross_attention_cuda.launches, ffn_cuda.launches - fp32, fp32)

    apart_counts = [0] * 5

    def apart(fn, *args):
        """``fn`` (the controller's eval, the capacity probe) with its launches
        counted apart from the train steps' and its kernels' inputs not
        captured."""
        before = counts()
        with k1c.paused(), k4c.paused(), k5c.paused():
            out = fn(*args)
        for i, (a, b) in enumerate(zip(counts(), before)):
            apart_counts[i] += a - b
        return out

    zero_launch_counts()
    with K1Capture() as k1c, K4Capture() as k4c, K5Capture() as k5c:
        steps = {"mask fp32": make_step()}
        cur_g = None
        with K2Capture() as k2_fp32:
            for epoch in range(epochs):
                if epoch > 0:
                    controller.update(cur_g)
                temperature = controller.temperature
                lr = cosine_lr(epoch, epochs, init_lr, 0.0)
                set_lr(opt, lr)
                t_ep = time.perf_counter()
                stats = run_epoch(steps["mask fp32"], temperature, epoch, lr, batches, quiet)
                cur_g = apart(eval_gflops, temperature)
                log(f"[{label}] epoch {epoch}: T={temperature:.4f} lr={lr:.3e} "
                    f"{losses_of(stats)}; GFLOPs {cur_g:.2f} (target {target:.2f}); "
                    f"{time.perf_counter() - t_ep:.1f} s")
                if not (all(math.isfinite(float(v)) for v in losses_of(stats).values())
                        and stats["batches_done"] == batches and 0 < cur_g):
                    raise AssertionError(f"{label} epoch {epoch}: stats {stats}, GFLOPs {cur_g}")
        caps = apart(probe, temperature)
        log(f"[{label}] fast_train capacities {[list(c) for c in caps]}")
        for amp in (False, True):
            name = "gather " + ("amp" if amp else "fp32")
            steps[name] = make_step(caps, amp=amp)
            with K2Capture() if amp else contextlib.nullcontext() as k2c:
                stats = run_epoch(steps[name], temperature, epochs, lr, batches, quiet)
            if amp:
                k2_amp = k2c
            log(f"[{label}] fast_train epoch, {name}: {losses_of(stats)}")
            if not all(math.isfinite(float(v)) for v in losses_of(stats).values()):
                raise AssertionError(f"{label} {name}: {losses_of(stats)}")
    torch.cuda.synchronize()
    *launches, k5_fp32 = (a - b for a, b in zip(counts(), apart_counts))
    log(f"[{label}] launches of the train steps: K1 {launches[0]}, K2 {launches[1]}, "
        f"K4 {launches[2]}, K5 {launches[3]} in bf16 and {k5_fp32} in fp32; of the "
        f"controller's evals and the capacity probe: K1, K2, K4, K5 bf16, K5 fp32 "
        f"{apart_counts}")
    needed = launches if cross_attention else launches[:2] + launches[3:]
    if (min(needed) == 0 or k5_fp32 == 0 or launches[1] > launches[0]
            or (launches[2] > 0) != cross_attention):
        raise AssertionError(f"{label}: K1/K2/K4/K5 launched {launches} times, fp32 K5 {k5_fp32}")
    if launches[3] != ffn_per_forward * batches:
        raise AssertionError(f"{label}: bf16 K5 launched {launches[3]} times, want "
                             f"{ffn_per_forward * batches}: every FFN of the amp epoch")

    args = timing_batch(temperature)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # a train step must not wait on the card
    try:
        m = steps["gather fp32"](*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if not torch.isfinite(m["loss"]):
        raise AssertionError(f"{label}: gather train step under the sync guard: loss not finite")
    log(f"[{label}] gather fp32 train step ran under set_sync_debug_mode('error')")
    steps["dense fp32"] = make_step(prune=False)
    steps["dense amp"] = make_step(prune=False, amp=True)
    times = {}
    for name in ("mask fp32", "gather fp32", "gather amp", "dense fp32", "dense amp"):
        step, args = steps[name], timing_batch(0.0 if name.startswith("dense") else temperature)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times[name] = median_step_ms(lambda: step(*args), iters)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"[{label}] {name} step {times[name]:.2f} ms (median of {iters}) = "
            f"{n_samples / times[name] * 1e3:.2f} {unit}/s; peak memory {peak:.2f} GiB")
    args = timing_batch(temperature)
    host = host_ms(lambda: steps["gather amp"](*args), iters, statistics.median)
    log(f"[{label}] gather amp step host dispatch time {host:.2f} ms (median of {iters}); "
        f"dense/pruned: mask fp32 "
        f"{times['dense fp32'] / times['mask fp32']:.3f}x, gather fp32 "
        f"{times['dense fp32'] / times['gather fp32']:.3f}x, gather amp "
        f"{times['dense amp'] / times['gather amp']:.3f}x")
    del steps, args
    save_and_load(temperature, epochs - 1)
    records = (check_k1_cases(label, k1c, iters=3),
               check_k2_cases(f"{label} mask fp32", k2_fp32),
               check_k2_cases(f"{label} gather amp", k2_amp),
               check_k4_cases(label, k4c, iters=5) if cross_attention else None,
               check_k5_cases(label, k5c, iters=3, where=dict(dtype="float32")))
    return launches, k5_fp32, apart_counts, temperature, records


def round_trip(label, save, load, path_name, temperature, epoch, outputs):
    """``save`` a checkpoint, read it back with ``torch.load`` and ``load``
    (the port's ``load_*_state_dict``), and demand equal ``outputs(model)``
    and temperature."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        model = save(f"{tmp}/{path_name}", epoch=epoch, temperature=temperature)
        ck = torch.load(f"{tmp}/{path_name}")
    again = load(ck["model"])
    with torch.inference_mode():
        same = torch.equal(outputs(model), outputs(again))
    if not (same and ck["temperature"] == temperature and ck["epoch"] == epoch):
        raise AssertionError(f"{label}: the reloaded checkpoint gives other outputs")
    log(f"[{label}] checkpoint round trip: identical outputs, T {ck['temperature']:.4f}")


def phase_train_caption_main(device, cfg, tokenizer, batch=32, n_eval=8):
    """18. Caption compression training as ``madtp_tpu/cli/compress_caption.py:
    280-440`` runs it (``configs/caption_coco.yaml``: batch 32, 384 px, prompt
    ``"a picture of "``, captions to the batch's longest, at most 40 tokens,
    lr 1e-5 cosine, weight decay 0.05), on synthetic float images and
    captions of 7-14 words after the prompt (COCO's average 10.5): the
    pre-search toward half of ``ORI_GFLOPS_CAPTION`` (``tasks.caption.
    presearch``, tol 1.0), then ``train_main``; each epoch's GFLOPs from
    ``tasks.caption.evaluate`` on one batch of ``n_eval`` uint8 images."""
    from madtp_tpu_torch.ckpt.convert import load_caption_state_dict, save_caption_checkpoint
    from madtp_tpu_torch.models.blip import init_caption_model
    from madtp_tpu_torch.prune.flops import ORI_GFLOPS_CAPTION
    from madtp_tpu_torch.tasks import caption as TC
    from madtp_tpu_torch.train.loops import make_caption_train_step
    from madtp_tpu_torch.train.optim import make_adamw

    model = init_caption_model(cfg, seed=0, device=device)
    opt = make_adamw(model.parameters(), lr=1e-5, weight_decay=0.05)
    rng = np.random.default_rng(18)
    s = cfg.vit.image_size

    def draw():
        return (rng.standard_normal((batch, 3, s, s), dtype=np.float32),
                [TC.PROMPT + train_words(rng, 7, 14) for _ in range(batch)], np.arange(batch))

    def run_epoch(step, temperature, epoch, lr, n, quiet):
        return TC.train_epoch(model, step, lambda: (draw() for _ in range(n)), tokenizer,
                              temperature, lr=lr, **quiet)

    eval_batch = caption_batches(rng, s, 1, n_eval)

    def eval_gflops(temperature):
        return TC.evaluate(model, tokenizer, eval_batch, temperature=temperature,
                           graph=False)[1]

    probe_images = draw()[0][:8]

    def probe(temperature):
        return (TC.probe_capacities(model, [(probe_images, None)], temperature, "ceil"),)

    def make_step(caps=(None,), amp=False, prune=True):
        return make_caption_train_step(model, opt, prune_active=prune, capacities_v=caps[0],
                                       amp=amp, device=device.type)

    target = ORI_GFLOPS_CAPTION * 0.5
    t0 = TC.presearch(model, probe_images, target, tol=1.0)
    log(f"[train-caption] pre-searched temperature {t0:.4f} (target {target:.2f} GFLOPs)")
    images, texts, _ = draw()
    fixed = [torch.from_numpy(a).to(device) for a in
             (images, *TC.train_batch(tokenizer, texts, len(tokenizer.encode(TC.PROMPT)) - 1))]

    def save_and_load(temperature, epoch):
        round_trip("train-caption",
                   lambda path, **kw: save_caption_checkpoint(model, path, **kw) or model,
                   lambda sd: load_caption_state_dict(sd, cfg, device=device),
                   "checkpoint_best.pth", temperature, epoch,
                   lambda m: m(*fixed[:3], temperature=temperature, prune_active=True))

    return train_main("train-caption", opt=opt, make_step=make_step, run_epoch=run_epoch,
                      eval_gflops=eval_gflops, probe=probe, target=target, t0=t0,
                      init_lr=1e-5, timing_batch=lambda t: (*fixed, t), n_samples=batch,
                      unit="captions", ffn_per_forward=cfg.vit.depth + cfg.med.num_hidden_layers,
                      save_and_load=save_and_load)


def vqa_train_text(rng, batch, n_answers=10):
    """One VQAv2-like training batch's text as ``vqa_collate`` gives it:
    questions as long as ``vqa_question_words`` draws them, ``n_answers``
    answers of 1-3 words each with soft weights summing to 1 (flat), and the
    counts."""
    questions = [" ".join(f"w{i}" for i in rng.integers(1000, 30000, size=n))
                 for n in vqa_question_words(rng, batch)]
    answers = [train_words(rng, 1, 3) for _ in range(batch * n_answers)]
    weights = rng.dirichlet(np.ones(n_answers), size=batch).astype(np.float32).reshape(-1)
    return questions, answers, weights, [n_answers] * batch


def phase_train_vqa_main(device, cfg, tokenizer, batch=16, n_answers_eval=128):
    """19. VQA compression training as ``madtp_tpu/cli/compress_vqa.py:296-460``
    runs it (``configs/vqa.yaml``: batch 16, 480 px, lr 2e-5 cosine, weight
    decay 0.05, the controller from T=1 toward half of ``ORI_GFLOPS_VQA``), on
    synthetic float images, questions of VQAv2's lengths and 10 answers per
    question with soft weights (``tasks.vqa.train_batch``: [16, 10, La], 160
    decoder rows): ``train_main``; each epoch's GFLOPs from
    ``tasks.vqa.evaluate`` on one batch against ``n_answers_eval`` answers,
    the ``--fast_train`` capacities from ``tasks.vqa.probe_capacities`` on
    it."""
    from madtp_tpu_torch.ckpt.convert import load_vqa_state_dict, save_vqa_checkpoint
    from madtp_tpu_torch.models.blip import init_vqa_model
    from madtp_tpu_torch.prune.flops import ORI_GFLOPS_VQA
    from madtp_tpu_torch.tasks import vqa as TV
    from madtp_tpu_torch.train.loops import make_vqa_train_step
    from madtp_tpu_torch.train.optim import make_adamw

    model = init_vqa_model(cfg, seed=0, device=device)
    opt = make_adamw(model.parameters(), lr=2e-5, weight_decay=0.05)
    rng = np.random.default_rng(19)
    s = cfg.vit.image_size

    def draw():
        return (rng.standard_normal((batch, 3, s, s), dtype=np.float32),
                *vqa_train_text(rng, batch))

    def run_epoch(step, temperature, epoch, lr, n, quiet):
        return TV.train_epoch(model, step, lambda: (draw() for _ in range(n)), tokenizer,
                              temperature, lr=lr, **quiet)

    a_ids, a_mask = vqa_answers(rng, n_answers_eval, pool=32)
    eval_batches = vqa_batches(rng, s, 1, batch)

    def eval_gflops(temperature):
        return TV.evaluate(model, eval_batches, a_ids, a_mask, temperature=temperature,
                           k_test=n_answers_eval, graph=False)[1]

    def probe(temperature):
        return TV.probe_capacities(model, eval_batches, temperature, "ceil")

    def make_step(caps=(None, None), amp=False, prune=True):
        return make_vqa_train_step(model, opt, prune_active=prune, capacities_v=caps[0],
                                   capacities_t=caps[1], amp=amp, device=device.type)

    images, *text = draw()
    fixed = [torch.from_numpy(np.asarray(a)).to(device)
             for a in (images, *TV.train_batch(tokenizer, *text))]

    def save_and_load(temperature, epoch):
        round_trip("train-vqa",
                   lambda path, **kw: save_vqa_checkpoint(model, path, **kw) or model,
                   lambda sd: load_vqa_state_dict(sd, cfg, device=device),
                   f"checkpoint_{epoch:02d}.pth", temperature, epoch,
                   lambda m: m.encode(*fixed[:3], temperature=temperature,
                                      prune_active=True)[0].state.x)

    return train_main("train-vqa", opt=opt, make_step=make_step, run_epoch=run_epoch,
                      eval_gflops=eval_gflops, probe=probe, target=ORI_GFLOPS_VQA * 0.5, t0=1.0,
                      init_lr=2e-5, timing_batch=lambda t: (*fixed, t), n_samples=batch,
                      unit="questions",
                      ffn_per_forward=cfg.vit.depth + 2 * cfg.med.num_hidden_layers,
                      save_and_load=save_and_load)


def phase_train_retrieval_main(device, cfg, tokenizer, batch=32, text_len=35):
    """20. BLIP retrieval compression training as ``madtp_tpu/cli/
    compress_retrieval.py:240-450`` runs it (``configs/retrieval_coco.yaml``:
    batch 32, 384 px, queue 57,600, alpha 0.4 ramped over epoch 0, momentum
    0.995, captions padded to 35, weight decay 0.05; the controller from T=1
    toward half of ``ORI_GFLOPS_RETRIEVAL``; lr 1e-5 cosine, where the
    config's 1e-7 would hardly move the weights), on synthetic float images
    and captions of 7-14 words, two captions an image, one Gumbel generator
    on the card for the run: ``train_main``; each epoch's GFLOPs as the
    driver computes them, from a mask-mode image-tower probe.  The ITM runs
    96 rows (3B) with gradients through K4."""
    from madtp_tpu_torch.ckpt.convert import load_retrieval_state_dict, save_retrieval_checkpoint
    from madtp_tpu_torch.models.blip import init_retrieval_model
    from madtp_tpu_torch.prune.flops import ORI_GFLOPS_RETRIEVAL, retrieval_gflops
    from madtp_tpu_torch.tasks import retrieval as TR
    from madtp_tpu_torch.train.loops import init_retrieval_train_state, make_retrieval_train_step
    from madtp_tpu_torch.train.optim import make_adamw

    model = init_retrieval_model(cfg, seed=0, device=device)
    state = init_retrieval_train_state(model, queue_size=57600)
    opt = make_adamw(model.parameters(), lr=1e-5, weight_decay=0.05)
    rng = np.random.default_rng(20)
    gen = torch.Generator(device=device).manual_seed(20)
    s = cfg.vit.image_size
    pairs = itertools.count()

    def draw():
        idx = np.array([next(pairs) for _ in range(batch)]) // 2  # two captions an image
        return (rng.standard_normal((batch, 3, s, s), dtype=np.float32),
                [train_words(rng, 7, 14) for _ in range(batch)], idx)

    def run_epoch(step, temperature, epoch, lr, n, quiet):
        return TR.train_epoch(model, step, lambda: (draw() for _ in range(n)), tokenizer,
                              temperature, epoch=epoch, epoch_len=n, alpha=0.4, generator=gen,
                              lr=lr, **quiet)

    probe_images, probe_text, _ = draw()
    tok = tokenizer(probe_text, padding="max_length", max_length=text_len)
    probe_ids, probe_mask = tok["input_ids"], tok["attention_mask"]

    @torch.inference_mode()
    def eval_gflops(temperature):
        _, out = model.image_features(torch.from_numpy(probe_images).to(device),
                                      temperature=temperature, prune_active=True)
        v_alive = int(out.state.alive[0].sum()) - 1
        return retrieval_gflops(cfg.vit, cfg.med, [v_alive] * cfg.vit.depth,
                                [text_len - 1] * cfg.med.num_hidden_layers, text_len)

    def probe(temperature):
        return TR.probe_capacities(model, [probe_images], probe_ids, probe_mask, temperature,
                                   "ceil")

    def make_step(caps=(None, None), amp=False, prune=True):
        return make_retrieval_train_step(state, opt, enc_token_id=ENC_ID, prune_active=prune,
                                         capacities_v=caps[0], capacities_t=caps[1], amp=amp,
                                         device=device.type)

    fixed = (torch.from_numpy(probe_images).to(device), torch.from_numpy(probe_ids).to(device),
             torch.from_numpy(probe_mask).to(device), torch.arange(batch, device=device) // 2)

    def save_and_load(temperature, epoch):
        round_trip("train-retrieval",
                   lambda path, **kw: save_retrieval_checkpoint(model, path, **kw) or model,
                   lambda sd: load_retrieval_state_dict(sd, cfg, device=device),
                   "checkpoint_best.pth", temperature, epoch,
                   lambda m: m.image_features(fixed[0], temperature=temperature,
                                              prune_active=True)[0])
        q = state.queue
        log(f"[train-retrieval] queue pointer {int(q.ptr)} on {q.ptr.device}, ids "
            f"{int((q.idx >= 0).sum())} of {q.idx.shape[0]} written, temp {float(state.temp):.4f}")

    return train_main("train-retrieval", opt=opt, make_step=make_step, run_epoch=run_epoch,
                      eval_gflops=eval_gflops, probe=probe, target=ORI_GFLOPS_RETRIEVAL * 0.5,
                      t0=1.0, init_lr=1e-5, timing_batch=lambda t: (*fixed, t, 0.4),
                      n_samples=batch, unit="pairs", ffn_per_forward=5 * cfg.vit.depth,
                      save_and_load=save_and_load)


CAPTION_GRADS = ("visual_encoder.patch_embed.proj.weight",
                 "visual_encoder.blocks.0.attn.qkv.weight",
                 "visual_encoder.blocks.11.attn.qkv.weight", "space_dict",
                 "text_decoder.bert.encoder.layer.0.crossattention.self.key.weight",
                 "text_decoder.cls.predictions.transform.dense.weight",
                 "text_decoder.bert.embeddings.word_embeddings.weight")
VQA_GRADS = CAPTION_GRADS[:4] + (
    "text_encoder.encoder.layer.0.attention.self.query.weight",
    "text_encoder.encoder.layer.11.crossattention.self.value.weight",
    "text_decoder.bert.encoder.layer.0.crossattention.self.key.weight",
    "text_decoder.cls.predictions.transform.dense.weight")
RETRIEVAL_GRADS = CAPTION_GRADS[:4] + (
    "text_encoder.encoder.layer.0.attention.self.query.weight",
    "text_encoder.encoder.layer.11.crossattention.self.key.weight",
    "vision_proj.weight", "text_proj.weight", "itm_head.weight")


def train_launches():
    from madtp_tpu_torch.kernels.attention_scores import attention_scores_cuda
    from madtp_tpu_torch.kernels.attention_scores_bwd import attention_scores_bwd_cuda
    from madtp_tpu_torch.kernels.cross_attention import cross_attention_cuda
    from madtp_tpu_torch.kernels.ffn import ffn_cuda

    return dict(K1=attention_scores_cuda.launches, K2=attention_scores_bwd_cuda.launches,
                K4=cross_attention_cuda.launches, K5=ffn_cuda.fp32_launches)


def loss_and_backward(loss_fn, backward=True):
    """A step's ``loss_fn`` run forward and backward, without the update;
    returns the losses as floats.  ``backward=False``: the forward alone,
    without autograd, for its DTP decisions (returns no losses)."""
    def run(*args, **kw):
        if not backward:
            with torch.no_grad():
                loss_fn(*args, **kw)
            return []
        out = loss_fn(*args, **kw)
        out[0].backward()
        return [float(v.detach()) for v in out]
    return run


def train_run(model, fn, grad_params, *inputs, **kw):
    """One fp32 train forward and backward, ``fn(*inputs, **kw)`` (which
    returns the losses as floats), with every DTP decision recorded.
    Returns the losses, the named gradients on the CPU, the decisions' keep
    counts and records, the card's launches of K1, K2, K4 and fp32 K5, and
    the seconds."""
    t0 = time.perf_counter()
    before = train_launches()
    model.zero_grad(set_to_none=True)
    with DTPRecorder() as rec:
        losses = fn(*inputs, **kw)
    named = dict(model.named_parameters())
    after = train_launches()
    return dict(losses=losses, grads={n: named[n].grad.cpu() for n in grad_params},
                kept=[r[4] for r in rec.records], dtp=rec.records,
                launches={k: after[k] - before[k] for k in after},
                seconds=time.perf_counter() - t0)


def train_parity(label, t_main, modes_at, run, grad_params, want_launches, mask_caps=None):
    """The search and checks of the training card-against-CPU phases: at the
    first of ``t_main`` times ``PARITY_FACTORS`` where every DTP decision of
    the CPU's runs (``run(where, temperature, caps)`` in each mode of
    ``modes_at(temperature)``) stands ``GAP_MIN`` from its edge and the
    card's drift ``DRIFT_FACTOR`` times below that (``card_drift``), equal
    keep counts in every decision, losses within 1e-4, the gradients of
    ``grad_params`` within ``GRAD_TOL`` of their largest value, and the
    card's launches per step exactly ``want_launches``.  A temperature is
    first screened by a forward alone on the CPU in mask mode
    (``run(..., backward=False)`` at ``mask_caps``, mask mode's
    capacities): one whose margin already misses ``GAP_MIN`` costs no
    backward pass and no capacity probe.  Returns the temperature and both
    sides' runs by mode."""
    for temperature in (t_main * f for f in PARITY_FACTORS):
        screen = run("cpu", temperature, mask_caps, backward=False)
        if min(dtp_margins(screen["dtp"])) < GAP_MIN:
            log(f"[{label}] T={temperature:.4f}: a CPU forward's smallest DTP margin "
                f"{min(dtp_margins(screen['dtp'])) / FP32_ULP:.0f} fp32 steps (want >= "
                f"{GAP_MIN / FP32_ULP:.0f}); {screen['seconds']:.1f} s")
            continue
        modes = modes_at(temperature)
        cpu_runs = {mode: run("cpu", temperature, caps) for mode, caps in modes.items()}
        thr_gap, rank_gap = (min(g) for g in zip(*(dtp_margins(r["dtp"])
                                                   for r in cpu_runs.values())))
        margin = min(thr_gap, rank_gap)
        log(f"[{label}] T={temperature:.4f}: smallest DTP margins on the CPU: threshold "
            f"{thr_gap:.3e}, rank {rank_gap:.3e} ({margin / FP32_ULP:.0f} fp32 steps, want "
            f">= {GAP_MIN / FP32_ULP:.0f}); "
            f"cpu {sum(r['seconds'] for r in cpu_runs.values()):.1f} s")
        if margin < GAP_MIN:
            continue
        card_runs = {mode: run("card", temperature, caps) for mode, caps in modes.items()}
        for mode, card in card_runs.items():
            if card["kept"] != cpu_runs[mode]["kept"]:
                raise AssertionError(f"{label} {mode}: keep counts differ: card {card['kept']} "
                                     f"cpu {cpu_runs[mode]['kept']}")
        drift, clear = card_drift(f"[{label}] T={temperature:.4f}", margin,
                                  [(cpu_runs[m], card_runs[m]) for m in modes],
                                  temperature / t_main)
        if clear:
            break
    else:
        raise AssertionError(f"{label}: no temperature near the main path's keeps every DTP "
                             f"decision {GAP_MIN / FP32_ULP:.0f} fp32 steps and {DRIFT_FACTOR}x "
                             "the card's drift from its edge")
    for mode, card in card_runs.items():
        cpu = cpu_runs[mode]
        loss_err = max(abs(a - b) for a, b in zip(cpu["losses"], card["losses"]))
        if not loss_err <= 1e-4:
            raise AssertionError(f"{label} {mode}: losses differ by {loss_err:.3e} (limit 1e-4)")
        rel = {}
        for n in grad_params:
            g, want = card["grads"][n], cpu["grads"][n]
            scale = float(want.abs().max())
            rel[n] = float((g - want).abs().max()) / scale if scale > 0 else math.inf
            if not (torch.isfinite(g).all() and rel[n] <= GRAD_TOL):
                raise AssertionError(f"{label} {mode}: grad of {n} differs by {rel[n]:.3e} of "
                                     f"its max {scale:.3e} (limit {GRAD_TOL})")
        if card["launches"] != want_launches:
            raise AssertionError(f"{label} {mode}: launches {card['launches']} per step, want "
                                 f"{want_launches}")
        log(f"[{label}] {mode}: {len(card['kept'])} DTP decisions' keep counts equal; losses "
            f"card {card['losses']} cpu {cpu['losses']} (max diff {loss_err:.2e}); launches "
            f"per step {card['launches']}; DTP drift {drift:.2e}; cpu {cpu['seconds']:.1f} s, "
            f"card {card['seconds']:.1f} s")
        log(f"[{label}]   grad max|diff| / max|grad|: " + ", ".join(
            f"{n.replace('visual_encoder.', 'v.').replace('text_', 't_')} {r:.2e}"
            for n, r in rel.items()))
    return temperature, cpu_runs, card_runs


def phase_train_caption_parity(device, cfg, tokenizer, t_main, n=2):
    """21. One fp32 caption train forward and backward of the full-width model
    on the card (K1, K2, K4, fp32 K5) and on the CPU (plain), ``n`` images
    and captions, in mask mode and in gather mode at lossless capacities:
    ``train_parity``'s checks, 12 K1, 12 K2, 12 K4 and 24 fp32 K5 a step."""
    from madtp_tpu_torch.models.blip import init_caption_model
    from madtp_tpu_torch.tasks import caption as TC
    from madtp_tpu_torch.train.loops import make_caption_train_step

    models = {"cpu": init_caption_model(cfg, seed=0, device="cpu")}
    models["card"] = copy.deepcopy(models["cpu"]).to(device)
    rng = np.random.default_rng(21)
    s = cfg.vit.image_size
    images = rng.standard_normal((n, 3, s, s), dtype=np.float32)
    batch = [torch.from_numpy(images)] + [torch.from_numpy(a) for a in TC.train_batch(
        tokenizer, [TC.PROMPT + train_words(rng, 7, 14) for _ in range(n)],
        len(tokenizer.encode(TC.PROMPT)) - 1)]

    def modes_at(temperature):
        return {"mask": None, "gather": TC.probe_capacities(models["cpu"], [(images, None)],
                                                            temperature, "ceil")}

    def run(where, temperature, caps, backward=True):
        model, dev = models[where], (device if where == "card" else torch.device("cpu"))
        step = make_caption_train_step(model, torch.optim.SGD(model.parameters(), lr=0.0),
                                       capacities_v=caps, device=dev.type)
        return train_run(model, loss_and_backward(step.loss_fn, backward),
                         CAPTION_GRADS if backward else (), *(t.to(dev) for t in batch),
                         temperature)

    L = cfg.vit.depth
    train_parity("caption-train-parity", t_main, modes_at, run, CAPTION_GRADS,
                 dict(K1=L, K2=L, K4=L, K5=2 * L))


def phase_train_vqa_parity(device, cfg, tokenizer, t_main, n=1):
    """22. One fp32 VQA train forward and backward of the full-width model at
    480 px on the card and on the CPU, ``n`` question with 10 answers and
    soft weights, mask and gather mode at lossless capacities:
    ``train_parity``'s checks, 24 K1, 24 K2 (the ViT's at 901 tokens, 920
    slots in mask mode), 24 K4 and 36 fp32 K5 a step."""
    from madtp_tpu_torch.models.blip import init_vqa_model
    from madtp_tpu_torch.tasks import vqa as TV
    from madtp_tpu_torch.train.loops import make_vqa_train_step

    models = {"cpu": init_vqa_model(cfg, seed=0, device="cpu")}
    models["card"] = copy.deepcopy(models["cpu"]).to(device)
    rng = np.random.default_rng(22)
    s = cfg.vit.image_size
    images = rng.standard_normal((n, 3, s, s), dtype=np.float32)
    arrays = TV.train_batch(tokenizer, *vqa_train_text(rng, n))
    batch = [torch.from_numpy(images)] + [torch.from_numpy(np.asarray(a)) for a in arrays]

    def modes_at(temperature):
        return {"mask": (None, None), "gather": TV.probe_capacities(
            models["cpu"], [(images, arrays[0], arrays[1], None)], temperature, "ceil")}

    def run(where, temperature, caps, backward=True):
        model, dev = models[where], (device if where == "card" else torch.device("cpu"))
        step = make_vqa_train_step(model, torch.optim.SGD(model.parameters(), lr=0.0),
                                   capacities_v=caps[0], capacities_t=caps[1], device=dev.type)
        return train_run(model, loss_and_backward(step.loss_fn, backward),
                         VQA_GRADS if backward else (), *(t.to(dev) for t in batch), temperature)

    L = cfg.vit.depth
    train_parity("vqa-train-parity", t_main, modes_at, run, VQA_GRADS,
                 dict(K1=2 * L, K2=2 * L, K4=2 * L, K5=3 * L), mask_caps=(None, None))


def state_to(state, device):
    """A copy of a retrieval or CLIP train state on ``device``."""
    from madtp_tpu_torch.train.momentum import FeatureQueue

    model, params_m, queue, *rest = state
    return type(state)(copy.deepcopy(model).to(device),
                       {n: t.to(device, copy=True) for n, t in params_m.items()},
                       FeatureQueue(*(t.to(device, copy=True) for t in queue)),
                       *(t.to(device, copy=True) for t in rest))


def phase_train_retrieval_parity(device, cfg, tokenizer, t_main, n=3, text_len=35):
    """23. One fp32 retrieval train step of the full-width model on the card
    and on the CPU from the same state (online and momentum towers, the
    57,600-slot queue, ``temp``), ``n`` pairs, one Gumbel draw made on the
    CPU and passed to both, mask and gather mode at lossless capacities:
    ``train_parity``'s checks (60 K1: the online, momentum and ITM passes;
    36 K2; 12 K4; 60 fp32 K5 a step); then the momentum weights and the
    queue within 1e-5 of their largest value, equal ids and pointer.  The
    momentum towers start 1e-3 (one normal draw a weight) from the online
    ones, so the EMA, the momentum forward and the queue's features run on
    weights of their own."""
    from madtp_tpu_torch.models.blip import init_retrieval_model
    from madtp_tpu_torch.tasks import retrieval as TR
    from madtp_tpu_torch.train.losses import gumbel
    from madtp_tpu_torch.train.loops import init_retrieval_train_state, make_retrieval_train_step

    state0 = init_retrieval_train_state(init_retrieval_model(cfg, seed=0, device="cpu"),
                                        queue_size=57600)
    g = torch.Generator().manual_seed(24)
    for t in state0.params_m.values():  # momentum towers of their own, so the EMA shows
        t.add_(torch.randn(t.shape, generator=g), alpha=1e-3)
    rng = np.random.default_rng(23)
    s = cfg.vit.image_size
    images = rng.standard_normal((n, 3, s, s), dtype=np.float32)
    tok = tokenizer([train_words(rng, 7, 14) for _ in range(n)], padding="max_length",
                    max_length=text_len)
    batch = [torch.from_numpy(a) for a in (images, tok["input_ids"], tok["attention_mask"])]
    batch.append(torch.arange(n))
    g = torch.Generator().manual_seed(23)
    noise = tuple(gumbel((n, n), generator=g) for _ in range(2))
    states = {}

    def modes_at(temperature):
        cv, _ = TR.probe_capacities(state0.model, [images], tok["input_ids"],
                                    tok["attention_mask"], temperature, "ceil")
        return {"mask": (None, None), "gather": (cv, (text_len,) * cfg.med.num_hidden_layers)}

    def run(where, temperature, caps, backward=True):
        dev = device if where == "card" else torch.device("cpu")
        state = state_to(state0, dev)
        step = make_retrieval_train_step(
            state, torch.optim.SGD(state.model.parameters(), lr=0.0), enc_token_id=ENC_ID,
            capacities_v=caps[0], capacities_t=caps[1], device=dev.type)
        fn = (loss_and_backward(step.loss_fn, False) if not backward else
              lambda *a, **k: [float(v) for v in step(*a, **k).values()])
        out = train_run(state.model, fn, RETRIEVAL_GRADS if backward else (),
                        *(t.to(dev) for t in batch), temperature, 0.4,
                        noise=tuple(t.to(dev) for t in noise))
        states[where, caps[0] is None] = state
        return out

    L = cfg.vit.depth
    train_parity("retrieval-train-parity", t_main, modes_at, run, RETRIEVAL_GRADS,
                 dict(K1=5 * L, K2=3 * L, K4=L, K5=5 * L), mask_caps=(None, None))
    for mask_mode in (True, False):
        cpu, card = states["cpu", mask_mode], states["card", mask_mode]
        worst = 0.0
        for name, want in [*cpu.params_m.items(), ("queue.image", cpu.queue.image),
                           ("queue.text", cpu.queue.text)]:
            got = card.params_m[name] if name in card.params_m else \
                getattr(card.queue, name.split(".")[1])
            err, scale = float((got.cpu() - want).abs().max()), float(want.abs().max())
            rel = err / scale if scale > 0 else (0.0 if err == 0 else math.inf)
            worst = max(worst, rel)
            if not rel <= 1e-5:
                raise AssertionError(f"retrieval parity: {name} differs by {rel:.3e} of its max")
        if not (torch.equal(card.queue.idx.cpu(), cpu.queue.idx) and
                int(card.queue.ptr) == int(cpu.queue.ptr) == n and
                float(card.temp) == float(cpu.temp)):
            raise AssertionError("retrieval parity: queue ids, pointer or temp differ")
        log(f"[retrieval-train-parity] {'mask' if mask_mode else 'gather'}: after the step "
            f"momentum weights and queue within {worst:.2e} of their largest value; ids, "
            f"pointer ({int(card.queue.ptr)}) and temp equal")


CLIP_WORDS = ("a an the two three man woman person child dog cat horse bird car bus train "
              "street table kitchen field beach water plate pizza bench sign red blue white "
              "black green small large young old wooden sitting standing walking riding "
              "holding eating playing next to on in of with near behind front at under "
              "top its and while").split()


def clip_captions(rng, n, lo=7, hi=14):
    """``n`` synthetic captions of ``lo``-``hi`` English words (COCO's average
    is 10.5), for the CLIP BPE tokenizer."""
    return [" ".join(rng.choice(CLIP_WORDS, size=rng.integers(lo, hi + 1))) for _ in range(n)]


def phase_train_clip_main(device, cfg, tokenizer, batch=16, n_eval=64):
    """24. CLIP compression training as ``madtp_tpu/cli/compress_retrieval_clip.py:
    336-540`` runs it (``configs/retrieval_coco_clip.yaml``: ViT-L/14@336,
    batch 16, queue 57,600, alpha 0.4 ramped over epoch 0, momentum 0.995,
    weight decay 0.2, lr 1e-5 cosine; the controller from T=1 toward half of
    ``ORI_GFLOPS``), on synthetic float images and captions of 7-14 words
    tokenized by the port's CLIP BPE tokenizer (context 77), two captions an
    image: ``train_main``; each epoch's GFLOPs from ``tasks.clip_retrieval.
    eval_epoch`` (``evaluate`` at the epoch's temperature and the best gate)
    on ``n_eval`` uint8 images and two texts each, the ``--fast_train``
    capacities from ``train_capacities`` on two cached batches.  No K4: CLIP
    has no cross-attention; K2 runs at H = 16 in the vision backward."""
    from madtp_tpu_torch.ckpt.convert import load_clip_state_dict, save_clip_checkpoint
    from madtp_tpu_torch.data.tokenizer_clip import clip_tokenize
    from madtp_tpu_torch.models.clip import init_clip_model
    from madtp_tpu_torch.prune.flops import ORI_GFLOPS
    from madtp_tpu_torch.tasks import clip_retrieval as TC
    from madtp_tpu_torch.train.loops import init_clip_train_state, make_clip_train_step
    from madtp_tpu_torch.train.optim import make_adamw

    model = init_clip_model(cfg, seed=0, device=device)
    state = init_clip_train_state(model, queue_size=57600)
    opt = make_adamw(model.parameters(), lr=1e-5, weight_decay=0.2)
    rng = np.random.default_rng(24)
    s = cfg.image_resolution
    pairs = itertools.count()
    target = ORI_GFLOPS * 0.5

    def draw():
        idx = np.array([next(pairs) for _ in range(batch)]) // 2  # two captions an image
        return (rng.standard_normal((batch, 3, s, s), dtype=np.float32),
                clip_captions(rng, batch), idx)

    def run_epoch(step, temperature, epoch, lr, n, quiet):
        return TC.train_epoch(model, step, lambda: (draw() for _ in range(n)), tokenizer,
                              temperature, epoch=epoch, epoch_len=n, alpha=0.4, lr=lr, **quiet)

    images, text, txt2img, img2txt = clip_corpus(cfg, n_eval, 2, seed=24)
    image_batches = [images[i:i + TC.BATCH_SIZE_TEST] for i in range(0, n_eval,
                                                                        TC.BATCH_SIZE_TEST)]
    best = [0.0]

    def eval_gflops(temperature):
        stats, cur_g, improved = TC.eval_epoch(model, image_batches, text, txt2img, img2txt,
                                               temperature, best=best[0],
                                               target_gflops=target, graph=False)
        if improved:
            best[0] = stats["r_mean"]
        log(f"[train-clip]   eval: r_mean {stats['r_mean']:.3f}, GFLOPs {cur_g:.2f}, "
            f"best gate {'taken' if improved else 'not taken'}")
        return cur_g

    probe_batches = [draw() for _ in range(2)]  # cached_probe_batches' two

    def probe(temperature):
        return (TC.train_capacities(model, probe_batches, temperature, "ceil"),)

    def make_step(caps=(None,), amp=False, prune=True):
        return make_clip_train_step(state, opt, alpha=0.4, prune_active=prune,
                                    capacities_v=caps[0], amp=amp, device=device.type)

    p_images, p_captions, _ = probe_batches[0]
    fixed = (torch.from_numpy(p_images).to(device),
             torch.from_numpy(clip_tokenize(tokenizer, p_captions, cfg.context_length)
                              .astype(np.int64)).to(device),
             torch.arange(batch, device=device) // 2)

    def save_and_load(temperature, epoch):
        round_trip("train-clip",
                   lambda path, **kw: save_clip_checkpoint(model, path, **kw) or model,
                   lambda sd: load_clip_state_dict(sd, cfg, device=device),
                   "checkpoint_best.pth", temperature, epoch,
                   lambda m: m.encode_image(fixed[0], temperature=temperature,
                                            prune_active=True).features)
        q = state.queue
        log(f"[train-clip] queue pointer {int(q.ptr)} on {q.ptr.device}, ids "
            f"{int((q.idx >= 0).sum())} of {q.idx.shape[0]} written; logit_scale "
            f"{float(model.logit_scale.detach()):.6f}")

    return train_main("train-clip", opt=opt, make_step=make_step, run_epoch=run_epoch,
                      eval_gflops=eval_gflops, probe=probe, target=target, t0=1.0,
                      init_lr=1e-5, timing_batch=lambda t: (*fixed, t, 0.4), n_samples=batch,
                      unit="pairs",
                      ffn_per_forward=2 * (cfg.vision_layers + cfg.transformer_layers),
                      save_and_load=save_and_load, cross_attention=False)


CLIP_GRADS = ("visual.conv1.weight", "visual.transformer.resblocks.0.attn.in_proj_weight",
              "visual.transformer.resblocks.23.mlp.c_fc.weight", "visual.proj", "space_dict",
              "logit_scale", "token_embedding.weight",
              "transformer.resblocks.0.attn.in_proj_weight",
              "transformer.resblocks.11.query_model.q_map.0.weight", "text_projection")


def phase_train_clip_parity(device, cfg, tokenizer, t_main, n=2):
    """25. One fp32 CLIP train step of the full-width model on the card and on
    the CPU from the same state (online and momentum weights, the
    57,600-slot queue), ``n`` pairs, mask mode and gather mode at the
    probe's capacities: ``train_parity``'s checks (48 K1: the online and
    momentum vision towers; 24 K2 at H = 16; no K4; 72 fp32 K5 a step; a
    temperature's screen runs the online towers alone);
    then the momentum weights and the queue within 1e-5 of their largest
    value, equal ids and pointer.  The momentum copies start 1e-3 (one
    normal draw a weight) from the online ones, so the EMA, the momentum
    towers (with the online text transformer, the reference's quirk) and
    the queue run on weights of their own."""
    from madtp_tpu_torch.data.tokenizer_clip import clip_tokenize
    from madtp_tpu_torch.models.clip import init_clip_model
    from madtp_tpu_torch.tasks import clip_retrieval as TC
    from madtp_tpu_torch.train.loops import init_clip_train_state, make_clip_train_step

    state0 = init_clip_train_state(init_clip_model(cfg, seed=0, device="cpu"),
                                   queue_size=57600)
    g = torch.Generator().manual_seed(25)
    for t in state0.params_m.values():  # momentum copies of their own, so the EMA shows
        t.add_(torch.randn(t.shape, generator=g), alpha=1e-3)
    rng = np.random.default_rng(25)
    s = cfg.image_resolution
    images = rng.standard_normal((n, 3, s, s), dtype=np.float32)
    text = clip_tokenize(tokenizer, clip_captions(rng, n), cfg.context_length).astype(np.int64)
    batch = [torch.from_numpy(images), torch.from_numpy(text), torch.arange(n)]
    states = {}

    def modes_at(temperature):
        return {"mask": None,
                "gather": TC.train_capacities(state0.model, [(images, None, None)],
                                              temperature, "ceil")}

    @torch.no_grad()
    def online_towers(images, text, idx, temperature, alpha):
        state0.model.encode_image(images, temperature=temperature, prune_active=True)
        state0.model.encode_text(text, temperature=temperature, prune_active=True)
        return []

    def run(where, temperature, caps, backward=True):
        if not backward:  # the screen: the online towers' DTP decisions, on the CPU
            return train_run(state0.model, online_towers, (), *batch, temperature, 0.4)
        dev = device if where == "card" else torch.device("cpu")
        state = state_to(state0, dev)
        step = make_clip_train_step(state, torch.optim.SGD(state.model.parameters(), lr=0.0),
                                    capacities_v=caps, device=dev.type)
        out = train_run(state.model, lambda *a: [float(v) for v in step(*a).values()],
                        CLIP_GRADS, *(t.to(dev) for t in batch), temperature, 0.4)
        states[where, caps is None] = state
        return out

    L, T = cfg.vision_layers, cfg.transformer_layers
    train_parity("clip-train-parity", t_main, modes_at, run, CLIP_GRADS,
                 dict(K1=2 * L, K2=L, K4=0, K5=2 * (L + T)))
    for mask_mode in (True, False):
        cpu, card = states["cpu", mask_mode], states["card", mask_mode]
        worst = 0.0
        for name, want in [*cpu.params_m.items(), ("queue.image", cpu.queue.image),
                           ("queue.text", cpu.queue.text)]:
            got = card.params_m[name] if name in card.params_m else \
                getattr(card.queue, name.split(".")[1])
            err, scale = float((got.cpu() - want).abs().max()), float(want.abs().max())
            rel = err / scale if scale > 0 else (0.0 if err == 0 else math.inf)
            worst = max(worst, rel)
            if not rel <= 1e-5:
                raise AssertionError(f"clip train parity: {name} differs by {rel:.3e} of its max")
        if not (torch.equal(card.queue.idx.cpu(), cpu.queue.idx) and
                int(card.queue.ptr) == int(cpu.queue.ptr) == n):
            raise AssertionError("clip train parity: queue ids or pointer differ")
        log(f"[clip-train-parity] {'mask' if mask_mode else 'gather'}: after the step "
            f"momentum weights and queue within {worst:.2e} of their largest value; ids and "
            f"pointer ({int(card.queue.ptr)}) equal")


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    import madtp_tpu_torch  # noqa: F401  fails here when run outside the repo

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    log(card_line())

    start = time.perf_counter()

    def timed(phase, *args):
        t0 = time.perf_counter()
        out = phase(*args)
        name = phase.__name__ if phase is not fp32_k5_held else args[1].__name__
        log(f"[time] {name}: {time.perf_counter() - t0:.1f} s "
            f"(script at {time.perf_counter() - start:.1f} s)")
        return out

    timed(phase_build)
    record, record1_32 = timed(phase_k1, device)
    record2, record2_16 = timed(phase_k2, device)
    timed(phase_k4, device)
    record5, record5_fp32 = timed(phase_k5, device)
    record3 = timed(phase_k1_large, device)
    cfg = full_config()
    fp32_k5 = {}  # fp32 K5 launches of each fp32 path, counted apart
    _, fp32_k5["nlvr_parity"], _ = timed(fp32_k5_held, "nlvr parity", phase_model_parity,
                                         device, cfg)
    k1_eval, k4_eval, k5_eval, record1_eval = timed(phase_main_path, device, cfg)
    _, fp32_k5["train_parity"], _ = timed(fp32_k5_held, "nlvr train parity", phase_train_parity,
                                          device, cfg)
    (k1_train, k2_train, k4_train, k5_train), fp32_k5["train"], record5_train, record2_fp32, \
        record2_amp, record1_train, record4_train32 = timed(phase_train_main, device, cfg)
    rcfg = retrieval_config()
    t_ret, k1_ret, k4_ret, k5_ret, record4, record1_ret = timed(phase_retrieval_main, device,
                                                                rcfg)
    _, fp32_k5["retrieval_parity"], _ = timed(fp32_k5_held, "retrieval parity",
                                              phase_retrieval_parity, device, rcfg, t_ret)
    ccfg = clip_config()
    t_clip, k1_clip, k5_clip, record5_clip, record1_clip = timed(phase_clip_main, device, ccfg)
    _, fp32_k5["clip_parity"], _ = timed(fp32_k5_held, "clip parity", phase_clip_parity,
                                         device, ccfg, t_clip)
    from madtp_tpu_torch.core.config import vqa_config

    t_vqa, vqa_model, (k1_vqa, k4_vqa, k5_vqa), (record1_vqa, record4_vqa, record5_vqa), \
        (dense4_vqa, dense5_vqa) = timed(phase_vqa_main, device, vqa_config(480))
    _, fp32_k5["vqa_parity"], _ = timed(fp32_k5_held, "vqa parity", phase_vqa_parity, device,
                                        t_vqa)
    (k1_640, k3_640, k4_640, k5_640), (record3_640, record4_640, record5_640) = \
        timed(phase_vqa_640, device, vqa_model, t_vqa)
    tokenizer = caption_tokenizer()
    (k1_gen, k4_gen, k5_gen), (record4_gen, record5_gen) = timed(
        phase_vqa_generate, device, vqa_model, t_vqa, tokenizer)
    del vqa_model
    torch.cuda.empty_cache()
    from madtp_tpu_torch.core.config import caption_config

    t_cap, (k1_cap, k4_cap, k5_cap), (record1_cap, record4_cap, record5_cap) = timed(
        phase_caption_main, device, caption_config(), tokenizer)
    _, fp32_k5["caption_parity"], _ = timed(fp32_k5_held, "caption parity",
                                            phase_caption_parity, device, tokenizer, t_cap)
    torch.cuda.empty_cache()
    from madtp_tpu_torch.data.tokenizer_clip import ClipBPETokenizer

    train = {}  # compression training of caption, VQA, retrieval and CLIP: main path, parity
    for family, cfg_f, tok_f, main_phase, parity_phase in (
            ("caption", caption_config(), tokenizer, phase_train_caption_main,
             phase_train_caption_parity),
            ("vqa", vqa_config(480), tokenizer, phase_train_vqa_main, phase_train_vqa_parity),
            ("retrieval", rcfg, tokenizer, phase_train_retrieval_main,
             phase_train_retrieval_parity),
            ("clip", ccfg, ClipBPETokenizer(), phase_train_clip_main, phase_train_clip_parity)):
        launches_f, fp32_k5[f"train_{family}"], apart_f, t_f, records_f = timed(
            main_phase, device, cfg_f, tok_f)
        fp32_k5[f"train_{family}_eval"] = apart_f[4]
        torch.cuda.empty_cache()
        # the parity search starts at the main path's last temperature (T = 1 had it
        # left pruning)
        _, fp32_k5[f"{family}_train_parity"], _ = timed(
            fp32_k5_held, f"{family} train parity", parity_phase, device, cfg_f, tok_f,
            t_f if t_f > 0 else 1.0)
        torch.cuda.empty_cache()
        train[family] = (launches_f, records_f, apart_f[:4])
    tk = {f"train_{f}": dict(zip(("K1", "K2", "K4", "K5"), train[f][0])) for f in train}
    # the controller's evals and capacity probes of the training paths (no K2, fp32 K5)
    te = {f"train_{f}_eval": dict(zip(("K1", "K2", "K4", "K5"), train[f][2])) for f in train}
    trec = {f: dict(zip(("K1", "K2_fp32", "K2_amp", "K4", "K5_fp32"), train[f][1]))
            for f in train}

    def train_total(k):
        return sum(c[k] for c in (*tk.values(), *te.values()))

    def train_paths(k):
        return {**{p: c[k] for p, c in tk.items()}, **{p: c[k] for p, c in te.items() if c[k]}}

    kernels = [
        dict(name="attention_scores", route="cuda",
             source="madtp_tpu_torch/csrc/attention_scores.cu",
             replaces="madtp_tpu/ops/pallas/fused_attention.py:595",
             launches=k1_eval + k1_train + k1_ret + k1_clip + k1_vqa + k1_640 + k1_gen + k1_cap
             + train_total("K1"),
             launches_by_path={"eval": k1_eval, "train": k1_train, "retrieval": k1_ret,
                               "clip": k1_clip, "vqa": k1_vqa, "vqa640": k1_640,
                               "vqa_generate": k1_gen, "caption": k1_cap,
                               **train_paths("K1")},
             launches_in_profiled_replays=REPLAYS["K1"],
             **record, at_nlvr_gather_eval=record1_eval, at_retrieval_eval=record1_ret,
             at_clip_vision_h16=record1_clip, at_vqa_gather_eval=record1_vqa,
             at_caption_eval=record1_cap, at_train_nlvr=record1_train,
             **{f"at_train_{f}": r["K1"] for f, r in trec.items()},
             fp32_at_train_shape=record1_32,
             library_note="library_ms is scaled_dot_product_attention, out only; vqa640 "
                          "counts the launches in K3's range too (attention_scores_large_n); "
                          "train_<family>_eval counts the training path's controller evals "
                          "and capacity probe, train_<family> its train steps",
             previous_note=PREVIOUS_NOTE.format("attention_scores.cu")),
        dict(name="attention_scores_large_n", route="cuda",
             source="madtp_tpu_torch/csrc/attention_scores.cu",
             replaces="madtp_tpu/ops/pallas/fused_attention.py:522",
             launches=k3_640, launches_by_path={"vqa640": k3_640},
             launches_in_profiled_replays_note="within attention_scores' count: one kernel "
                                               "serves both ranges",
             **record3,
             at_vqa640_eval=record3_640,
             library_note="K1 launched at N > 1536, where the TPU runs its query-tiled kernel; "
                          "library_ms is scaled_dot_product_attention, out only",
             previous_note=PREVIOUS_NOTE.format("attention_scores.cu")),
        dict(name="attention_scores_bwd", route="cuda",
             source="madtp_tpu_torch/csrc/attention_scores_bwd.cu",
             replaces="madtp_tpu/ops/pallas/fused_attention.py:306",
             launches=k2_train + train_total("K2"),
             launches_by_path={"train": k2_train, **train_paths("K2")},
             **record2,
             bf16_at_amp_shape=record2_16, at_train_fp32=record2_fp32, at_train_amp=record2_amp,
             **{f"at_train_{f}_{k[3:]}": r[k] for f, r in trec.items()
                for k in ("K2_fp32", "K2_amp")},
             library_note="library_ms is scaled_dot_product_attention forward + backward, "
                          "out only",
             previous_note=PREVIOUS_NOTE.format("attention_scores_bwd.cu")),
        dict(name="cross_attention", route="cuda",
             source="madtp_tpu_torch/csrc/cross_attention.cu",
             replaces="madtp_tpu/ops/pallas/cross_attention.py:56",
             launches=k4_eval + k4_train + k4_ret + k4_vqa + k4_640 + k4_gen + k4_cap
             + train_total("K4"),
             launches_by_path={"eval": k4_eval, "train": k4_train, "retrieval": k4_ret,
                               "vqa": k4_vqa, "vqa640": k4_640, "vqa_generate": k4_gen,
                               "caption": k4_cap, **train_paths("K4")},
             launches_in_profiled_replays=REPLAYS["K4"],
             **record4, at_vqa_gather_eval=record4_vqa, at_vqa_dense_eval=dense4_vqa,
             at_vqa640_eval=record4_640, at_vqa_generate=record4_gen,
             at_caption_eval=record4_cap, fp32_at_train_nlvr=record4_train32,
             **{f"at_train_{f}": r["K4"] for f, r in trec.items() if r["K4"] is not None},
             library_note="library_ms is scaled_dot_product_attention with the "
                          "same additive mask: the same function",
             previous_note="previous_ms is the replaced design "
                           "(madtp_tpu_torch/csrc/previous/cross_attention.cu) on the same "
                           "inputs and card"),
        dict(name="ffn", route="cuda", source="madtp_tpu_torch/csrc/ffn.cu",
             replaces="madtp_tpu/ops/pallas/fused_ffn.py:79",
             launches=k5_eval + k5_train + k5_ret + k5_clip + k5_vqa + k5_640 + k5_gen + k5_cap
             + train_total("K5"),
             launches_by_path={"eval": k5_eval, "train": k5_train, "retrieval": k5_ret,
                               "clip": k5_clip, "vqa": k5_vqa, "vqa640": k5_640,
                               "vqa_generate": k5_gen, "caption": k5_cap,
                               **train_paths("K5")},
             launches_in_profiled_replays=REPLAYS["K5"],
             **record5, at_clip_gather_eval=record5_clip, at_vqa_gather_eval=record5_vqa,
             at_vqa_dense_eval=dense5_vqa, at_vqa640_eval=record5_640,
             at_vqa_generate=record5_gen, at_caption_eval=record5_cap,
             fp32=record5_fp32, fp32_at_train_main=record5_train,
             **{f"fp32_at_train_{f}": r["K5_fp32"] for f, r in trec.items()},
             fp32_launches=sum(fp32_k5.values()), fp32_launches_by_path=fp32_k5,
             library_note="library_ms is two F.linear and the activation: the same function",
             previous_note="previous_ms is the replaced design (madtp_tpu_torch/csrc/previous/"
                           "ffn.cu: bf16 k5_ffn, fp32 k5_ffn_fp32, the first SGEMM) on the same "
                           "inputs and card; launches counts the bf16 main paths, "
                           "fp32_launches the fp32 paths"),
    ]
    log(card_line())
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def pass_times(label, fn, iters):
    """Device time per call of each kernel that ``fn`` launches (the passes
    of K1, the two GEMMs of K5), from torch.profiler over ``iters`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        lead_spins()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.count and "spin_kernel" not in e.key:
            name = e.key.replace("(anonymous namespace)::", "").split("(")[0]
            log(f"[probe-pass] {label}: {e.self_device_time_total / 1e3 / iters:.4f} ms a call, "
                f"x{e.count // iters} {name[:70]}")


def probe_fp32():
    """``python3 chip_smoke.py probe``: the fp32 training path's kernels on
    whatever ``madtp_tpu_torch`` comes first on the path (a parent tree's,
    for a comparison inside one call), through the wrappers alone: the mask
    fp32 NLVR train step (16 pairs) timed and profiled by kernel, then fp32
    K5 (D = 768, F = 3072, GELU) at the paths' row counts and fp32 K1 at
    their lengths, each with the library call's time and its passes' or
    GEMMs' device times apart."""
    import torch.nn.functional as F

    import madtp_tpu_torch
    from madtp_tpu_torch.kernels.attention_scores import attention_scores_cuda
    from madtp_tpu_torch.kernels.ffn import ffn_cuda
    from madtp_tpu_torch.models.blip import init_nlvr_model
    from madtp_tpu_torch.train.loops import make_nlvr_train_step
    from madtp_tpu_torch.train.optim import make_adamw

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    log(f"[probe] {madtp_tpu_torch.__file__}; {card_line()}")
    phase_build()
    cfg = full_config()
    model = init_nlvr_model(cfg, seed=0, device=device)
    opt = make_adamw(model.parameters(), lr=3e-6, weight_decay=0.05)
    rng = np.random.default_rng(5)
    pairs, text_len, s = 16, 26, cfg.vit.image_size
    ids = rng.integers(1, cfg.med.vocab_size, size=(pairs, text_len))
    ids[:, 0] = 2
    mask = np.ones((pairs, text_len), np.int64)
    mask[-1, text_len - 5:] = 0
    batch = tuple(torch.from_numpy(a).to(device) for a in (
        rng.standard_normal((2 * pairs, 3, s, s), dtype=np.float32), ids, mask,
        rng.integers(0, 2, size=pairs))) + (1.0,)
    step = make_nlvr_train_step(model, opt)  # mask mode, fp32
    ms = time_ms(lambda: step(*batch), 5)
    log(f"[probe] mask fp32 NLVR train step, 16 pairs: {ms:.2f} ms")
    profile_step("mask fp32 train step", lambda: step(*batch), ms, top=16)
    del model, opt, step, batch
    torch.cuda.empty_cache()
    with torch.inference_mode():
        for M in (1, 2, 16, 480, 608, 800, 1000, 18944):
            args = k5_case(M, 768, 3072, device, dtype=torch.float32) + ("gelu",)
            iters = 20 if M < 5000 else 5
            k5_ms = kernel_ms(lambda: ffn_cuda(*args), iters)
            lib_ms = kernel_ms(lambda: ffn_library(*args), iters)
            log(f"[probe] fp32 K5 M={M}: {k5_ms:.4f} ms, library {lib_ms:.4f} ms")
            pass_times(f"fp32 K5 M={M}", lambda: ffn_cuda(*args), 5)
            del args
        for B, N, H, with_bias in ((32, 592, 12, False), (16, 920, 12, False),
                                   (2, 1608, 12, False), (16, 26, 12, True),
                                   (32, 35, 12, True), (2, 584, 16, False)):
            q, k, v, alive, bias = k1_case(B, N, with_bias=with_bias, dtype=torch.float32,
                                           device=device, H=H)
            bias_in = torch.zeros(alive.shape, device=device) if bias is None else bias
            k1_ms = kernel_ms(lambda: attention_scores_cuda(q, k, v, alive, bias_in, 0.125), 10)
            qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
            attn_mask = sdpa_mask(alive, bias_in, torch.float32)
            sdpa_ms = kernel_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=attn_mask, scale=0.125), 10)
            log(f"[probe] fp32 K1 B={B} N={N} H={H}: {k1_ms:.4f} ms, sdpa (out only) "
                f"{sdpa_ms:.4f} ms")
            pass_times(f"fp32 K1 B={B} N={N} H={H}",
                       lambda: attention_scores_cuda(q, k, v, alive, bias_in, 0.125), 5)
            del q, k, v, alive, bias, bias_in, qh, kh, vh, attn_mask
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(probe_fp32() if sys.argv[1:] == ["probe"] else main())
