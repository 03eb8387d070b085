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
   and in fp32 alone at the NLVR train step's shape and one query a row
   (the caption controller's fp32 decode), a row with no alive key, two
   launches bit-identical, with times, the replaced design's, the bound,
   and SDPA with the same additive mask (the same function);
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
   and the gather-mode eval through ``tasks.nlvr.evaluate`` on 32 batches
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
   ``tasks.retrieval.evaluate`` in gather mode on 192 synthetic images (6
   batches of 32) and 192 texts at ``k_test`` 256 (capped at 192), the dense eval, and one
   ITM forward at ``k_test`` 256: images/s, texts/s, ITM candidates/s, eval
   wall time, a profile of the ITM forward;
10. the CLIP ViT-L/14@336 retrieval eval main path in bf16 at p=0.5
   (``tools/bench_clip.py``'s configuration, seeded random weights): the
   temperature bisected toward half the dense ``clip_gflops`` in mask mode,
   the ``--fast_eval`` capacities, ``tasks.clip_retrieval.evaluate`` in
   gather mode on 512 synthetic uint8 images (16 batches of 32) and 2,560
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
   and amp, dense fp32 and amp (the median of 2), peak memory, the gather amp step's host
   dispatch, the ``.pth`` written and read back by ``load_*_state_dict``,
   and K1, K2 (the VQA ViT's N = 920 slots in fp32, and the amp epoch's),
   K4 (the retrieval ITM's 96 rows with gradients) and fp32 K5 held on the
   path's own inputs;
21-23. each of those models card against CPU, one fp32 train forward and
   backward from the same weights (caption 2 images, VQA 1 question with 10
   answers, retrieval 2 pairs from the same state with one Gumbel draw made
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
   (online and momentum weights 1e-3 apart, the queue), 1 pair, mask and
   gather mode, as phases 21-23: 48 K1, 24 K2, 72 fp32 K5 a step; after
   it the momentum weights and the queue within 1e-5, equal ids and
   pointer;
26. the NLVR2, COCO caption and VQAv2 drivers (``madtp_tpu_torch/cli/``)
   through ``main(argv)`` at the widths and image sizes of
   ``configs/nlvr.yaml``, ``configs/caption_coco.yaml`` and
   ``configs/vqa.yaml``, seeded random init, on a fixture this phase
   writes without PIL (``driver_fixture``: PNG images at 640 x 480 and
   500 x 375, ``tools/make_fixture.py``'s annotation layout and a
   BERT-layout vocabulary): ``--epoch 1`` each (NLVR at
   the config's 16 and 32, caption and VQA at 8 and 8; 2 train batches an
   epoch), then ``--evaluate`` on the checkpoint written, which reproduces
   the logged metric; ``log.txt``, ``config.yaml`` and the checkpoint,
   NLVR's first temperature, K1, K2, K4 and K5 launched on every
   driver's path (``driver_<family>`` in the kernels line), K1, K4 and K5
   held on the NLVR driver's own inputs; each driver's wall, step times
   and where its run spends its time;
27. the BLIP and CLIP retrieval drivers through ``main(argv)`` on that
   fixture (8 test images with 5 captions each): ``compress_retrieval`` at
   ``configs/retrieval_coco.yaml``'s width (BLIP base, 384 px, queue
   57,600), random init, ``--epoch 1``, and ``compress_retrieval_clip`` on
   a seeded random ViT-L/14@336 ``.pth``, ``--epoch 1``, each at batch 8
   and then ``--evaluate`` on its best checkpoint, which reproduces the
   best epoch;
   ``compress_retrieval_clip --evaluate`` on a seeded random RN50 ``.pth``;
   the files, the controller's temperatures, K1, K2, K4 and K5 launched on
   the BLIP driver and K1, K2 and K5 on the CLIP driver, K4 held on the
   BLIP driver's ITM inputs and K1 (H = 16) on the CLIP driver's; then
   ``mp_batched_loader`` against the threaded loader in this process and
   ``device_prefetch`` to the card (``phase_retrieval_drivers``);
28. serving (``phase_serving``): phase 5's model, temperature and capacities
   exported through ``cli/export_serving.py``'s functions as two gather-mode
   NLVR artifacts (32 pairs, text 26), batch-coupled and row-independent,
   and the retrieval (3 units), CLIP (2), VQA-480 rank (3,128 answers,
   ``k_test`` 128) and caption (3 beams) models in mask mode at their main
   paths' temperatures, served by one ``ArtifactServer`` whose warm-up
   captures every unit; over HTTP a full NLVR batch on each artifact (equal
   to the direct step bit for bit), 8 client threads of 1-4-pair requests
   on the row-independent one (each reply equal to its rows served alone;
   ``merged`` > 0 there and 0 on the coupled one), one request to each
   other unit (equal to its direct step); no capture after the warm-up;
   latency p50/p99 by request size, requests/s and pairs/s, the host codec's
   time per full request; the requests are the ``serve`` path of the
   kernels line;
29. multi-process runs (``phase_multiprocess``): a one-rank NCCL group in
   this process holds every helper of ``madtp_tpu_torch/parallel/dist.py``
   and the global-batch count max and gradient reduction of
   ``parallel/data.py`` on CUDA tensors; then two ranks under
   ``--dist_backend gloo`` share the card, spawned with
   ``torch.multiprocessing``, each running the BLIP retrieval and CLIP
   drivers' training: each driver's first train step (16 pairs over the two
   ranks, at the first temperature where each rank's half takes the
   one-process step's DTP decisions) against the one-process step on the
   same global batch (losses within 1e-4, named gradients within 1e-3 of
   their largest, the queue after the step within 1e-5), the same
   ``LOG:`` lines on both ranks and files from rank 0 only, the retrieval
   scores bit-equal to one process's; the ranks' K1, K2, K4 and K5
   launches are the ``multiprocess`` path of the kernels line;
30. the stochastic and legacy paths (``phase_stochastic``), at full width:
   the reference training recipe (``use_dropout``: drop-path and dropout
   0.1) in the NLVR train step at ``configs/nlvr.yaml``'s width (16 pairs,
   fp32 mask mode, twice from one generator seed: bit-equal losses,
   gradients and masks), one ``--fast_train --amp`` step and the caption
   train step at ``configs/caption_coco.yaml``'s batch (twice), each mask's
   kept share within 6 binomial standard deviations of ``1 - p``, the fp32
   step at rates 0 bit-equal to the step without dropout; the dropout step
   card against CPU at 1 pair with the CPU's masks replayed (losses 1e-4,
   gradients 1e-3 of each tensor's largest); nucleus captioning
   (``make_nucleus_step``) at the caption config's width, bf16, gather
   mode, as a CUDA graph fed a new Gumbel draw each call (the same draw
   twice: equal sequences), and 2 images card against CPU in fp32 with the
   same noise (equal sequences where every draw's margin stands >= 64 fp32
   steps and >= 4x the card's drift); the legacy ITM and ITC heads and the
   pretrain losses at ``configs/retrieval_coco.yaml``'s width plus a
   caption decoder, card against CPU (1e-4); K1, K2, K4 and K5 held on the
   paths' inputs; the main paths' launches are the ``stochastic`` path of
   the kernels line.
31. tensor parallelism, mesh serving and the native JPEG decode
   (``phase_tp``): K1's planes variant (a tensor-parallel MED's scoring
   attention on a rank's 6 heads), K4 on those heads and K5 on a rank's half
   of BLIP's and CLIP-L's FFNs, fp32 and bf16, against their plain versions
   with times, bounds and library calls; the full-width NLVR eval (fp32, 4
   pairs) on two gloo ranks sharing the card, the model sharded over a 1x2
   mesh, in mask and gather mode against the one-process step (equal kept
   counts, logits 1e-4, at a temperature where the ranks' DTP drift stays
   4x below the margin), and every K1-planes, K4 and K5 case those ranks
   launched held against its plain version on the rank's own inputs, the
   most-called case of each timed; the model as a 1x2 mesh artifact served by
   ``python -m madtp_tpu_torch.cli.serve`` (its second rank started by the
   command), the reply against the direct step; the port's JPEG decoder
   built with g++ (no libjpeg), bit-equal to this machine's Pillow, with
   images/s; the ranks' launches are the ``tp`` path of the kernels line.

Before phase 1 a line says whether libjpeg's header and library are on the
machine (``jpeg_headers``); the port's JPEG decoder (phase 31) needs
neither.

The card-against-CPU searches try first the factor of ``PARITY_FACTORS``
where each settled in earlier runs of these seeds (``parity_factors``),
then the others in order.

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
import os
import pathlib
import statistics
import subprocess
import sys
import time
import types

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
    alive key) for q k^T and P v; q, the alive keys' rows of k and v, alive
    and bias read once, out written once (a dead key's row is never needed)."""
    B, Nq, H, Dh = q.shape
    S = k.shape[1]
    n_alive = int(alive.sum())
    flops = 4.0 * H * Dh * Nq * n_alive
    el = q.element_size()
    nbytes = (2 * B * Nq * H * Dh + 2 * n_alive * H * Dh) * el + B * S
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


class PlanesCapture(_Capture):
    """K1's planes variant's calls (a tensor-parallel MED's scoring
    attention on a rank's heads), by (B, N, H, dtype)."""

    module, attr = "madtp_tpu_torch.ops.attention", "attention_planes_cuda"
    defaults = tuple((n, None) for n in ("q", "k", "v", "key_alive", "key_bias", "scale"))

    def key(self, q, *rest):
        return (q.shape[0], q.shape[1], q.shape[2], q.dtype)


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
            alive_share = float(alive.float().mean())
            log(f"[k4-main] {name} {str(dtype)[6:]}: max|err| {errs[0]:.2e}"
                + (f" (as fp32 {errs[1]:.2e})" if len(errs) > 1 else "")
                + f", bit-identical relaunch | K4 {ms:.4f} ms, previous {previous_ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), sdpa (same "
                f"function) {sdpa_ms:.4f} ms; alive keys {alive_share:.3f}")
            records[key] = dict(max_abs_err=errs[0], ms=ms, previous_ms=previous_ms,
                                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                                library_ms=sdpa_ms, alive_share=alive_share,
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
# A (``k1_fwd``, ``k1_fwd_simt``), K4's main kernel (``k4_mma``, ``k4_ffma``
# or ``k4_ffma_decode``; ``k4_combine`` only when the keys split), and K5's
# two GEMMs (``k5_wgmma`` or ``k5_ffma``, twice a launch).
WRAPPER_KERNELS = {"K1": (("::k1_fwd",), 1), "K4": (("::k4_mma", "::k4_ffma"), 1),
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
    (``csrc/previous/cross_attention.cu``: bf16 ``k4_cross_attention``, the
    first FFMA design; fp32 ``k4_cross_attention_fp32``, ``k4_simt``), on
    the same inputs: the yardstick of ``previous_ms``.  Its launches count
    nowhere."""
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    types = [p, p, p, i64, i64, i64, i64, p, p, p, i32, i32, i32, i32, i32, ctypes.c_float, p]
    B, Nq, H, Dh = q.shape
    out = torch.empty((B, Nq, H, Dh), dtype=q.dtype, device=q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), q.stride(0), q.stride(1), k.stride(0),
            k.stride(1), alive.data_ptr(), None if bias is None else bias.data_ptr(),
            out.data_ptr(), B, Nq, k.shape[1], H, Dh, float(scale),
            torch.cuda.current_stream().cuda_stream)
    if q.dtype == torch.float32:
        err = _previous_fn("K4", "k4_cross_attention_fp32", types)(*args)
    else:
        err = _previous_fn("K4", "k4_cross_attention", [i32] + types)(1, *args)
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
    the 64-key tile), with and without bias, fp32 and bf16, and in fp32
    alone at the NLVR train step's (16 pairs, 40 text slots, 592 image
    slots) and one query a row (96 beams over 577 and 192 image slots, the
    caption controller's fp32 decode); the keys split where
    ``split_chunks``' rule for the dtype says so; a batch row with no alive
    key gives zeros; two launches bit-identical.  The shapes the main paths
    really give K4 are checked on their own inputs (``check_k4_cases``).
    Returns the record of fp32 K4 at one query a row over 577 slots."""
    import torch.nn.functional as F

    from madtp_tpu_torch.kernels.cross_attention import (TOLERANCES, cross_attention_cuda,
                                                         split_chunks)
    from madtp_tpu_torch.ops.attention import cross_attention_plain

    cases = [(256, 35, 592), (256, 35, 320), (32, 32, 320), (16, 40, 1616), (8, 1, 100),
             (8, 7, 130), (4, 70, 200), (4, 22, 600)]
    fp32_cases = [(16, 40, 592), (96, 1, 577), (96, 1, 192)]
    one_query = None
    for dtype in (torch.float32, torch.bfloat16):
        for B, Nq, S in cases + (fp32_cases if dtype == torch.float32 else []):
            for with_bias in (False, True):
                q, k, v, alive, bias = k4_case(B, Nq, S, with_bias=with_bias, dtype=dtype,
                                               device=device, packed_q=Nq == 7)
                alive[-1] = with_bias  # no alive key in the last row: zeros out
                scale = q.shape[-1] ** -0.5
                got = cross_attention_cuda(q, k, v, alive, bias, scale)
                want = cross_attention_plain(q, k, v, alive, bias, scale)
                torch.cuda.synchronize()
                chunks = split_chunks(B, q.shape[2], Nq, S, dtype)[0]
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
                if (B, Nq, S, with_bias, dtype) == (96, 1, 577, False, torch.float32):
                    one_query = dict(max_abs_err=err, ms=ms, previous_ms=previous_ms,
                                     plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                                     library_ms=sdpa_ms,
                                     shape=dict(B=B, Nq=Nq, S=S, dtype="float32",
                                                dead_share=0.25))
                del q, k, v, got, want, mask
                torch.cuda.empty_cache()
    return one_query


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
                    eval_batches=32, iters=10):
    """NLVR2 eval at p=0.5, bf16: bisection (the captured mask-mode step,
    one graph replayed at every temperature; K4 and K5 held on the eager
    mask-mode step's inputs at T*), ``probe_capacities`` on the eval's
    first two batches, then the gather eval of 32 batches of 32 pairs (cut
    for the script's time) whose
    sentences are padded to each batch's longest (``nlvr_text_lengths``; a
    graph per length, as JAX compiles one): eagerly (``graph=False``; K1,
    K4 and K5 held on its own inputs, exact launch counts) and as CUDA
    graphs (the main path: equal results and launch counts, a capture per
    length); the step as a graph against the eager step.  Returns the graph
    eval's K1, K4 and K5 launch counts, the K1 record of the gather eval,
    and ``(model, T*, capacities)`` for the serving phase."""
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
    return launches, k4, k5, record1, (model, t_star, (caps_v, caps_t))


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


def phase_train_main(device, cfg, pairs=16, text_len=26, epochs=2, batches=2, iters=2,
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


def parity_factors(first=1.0):
    """``PARITY_FACTORS`` with ``first`` tried first: the factor where the
    phase settled in earlier runs of these seeds (its ``[parity-settled]``
    line), so that its search does not repeat the CPU runs of the factors
    that missed there; the others follow in their order if ``first``
    misses."""
    return (first,) + tuple(f for f in PARITY_FACTORS if f != first)


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


def phase_retrieval_main(device, cfg, p_target=0.5, bisect_steps=8, n_images=192,
                         texts_per_image=1, batch=32, k_test=256, iters=5):
    """BLIP retrieval eval at p=0.5, bf16: the temperature bisected toward
    half the dense ``retrieval_gflops`` in mask mode, the ``--fast_eval``
    capacities, then the gather-mode ``evaluate`` on a synthetic corpus (6
    batches of 32 images, 1 text each: COCO has 5 texts an image, and the
    corpus's size, both cut to keep the script inside its time limit) at ``k_test`` 256, capped at the corpus, so that every
    rerank row in both directions scores every candidate, and the dense eval
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
    rec_txt = graph_check(f"retrieval text batch of {len(txt_args[0])}",
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
    for name, rec, n in (("image encode", rec_img, batch),
                         ("text encode", rec_txt, len(txt_args[0])),
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


def phase_clip_main(device, cfg, p_target=0.5, bisect_steps=10, n_images=512,
                    texts_per_image=5, batch=32, iters=5):
    """CLIP retrieval eval at p=0.5, bf16: the temperature bisected toward
    half the dense ``clip_gflops`` in mask mode (``tools/bench_clip.py:
    80-91``; first image batch and first 32 texts), the ``--fast_eval``
    capacities, ``evaluate`` in gather mode on a synthetic corpus cut from
    COCO's 5,000 images and 25,000 texts to 512 and 2,560 (1:5), and the
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
    from madtp_tpu_torch.kernels.attention_scores import (attention_planes_cuda,
                                                          attention_scores_cuda)
    from madtp_tpu_torch.kernels.attention_scores_bwd import attention_scores_bwd_cuda
    from madtp_tpu_torch.kernels.cross_attention import cross_attention_cuda
    from madtp_tpu_torch.kernels.ffn import ffn_cuda

    attention_scores_cuda.launches = attention_scores_cuda.large_n_launches = 0
    attention_scores_bwd_cuda.launches = cross_attention_cuda.launches = ffn_cuda.launches = 0
    ffn_cuda.fp32_launches = attention_planes_cuda.launches = 0


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
        for temperature in (t_main * f for f in parity_factors({480: 2.5, 640: 5.0}[res])):
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
        for temperature in (t_main * f for f in parity_factors(1.25)):
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
               epochs=TRAIN_EPOCHS, batches=TRAIN_BATCHES, iters=2, cross_attention=True):
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
    driver computes them (``tasks.retrieval.epoch_gflops``).  The ITM runs
    96 rows (3B) with gradients through K4."""
    from madtp_tpu_torch.ckpt.convert import load_retrieval_state_dict, save_retrieval_checkpoint
    from madtp_tpu_torch.models.blip import init_retrieval_model
    from madtp_tpu_torch.prune.flops import ORI_GFLOPS_RETRIEVAL
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

    def eval_gflops(temperature):
        return TR.epoch_gflops(model, probe_images, temperature, text_len)

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


def train_parity(label, t_main, modes_at, run, grad_params, want_launches, mask_caps=None,
                 first=1.0):
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
    backward pass and no capacity probe.  The factors are tried from
    ``first`` (``parity_factors``).  Returns the temperature and both sides'
    runs by mode."""
    for temperature in (t_main * f for f in parity_factors(first)):
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
                 dict(K1=2 * L, K2=2 * L, K4=2 * L, K5=3 * L), mask_caps=(None, None),
                 first=4.0)


def state_to(state, device):
    """A copy of a retrieval or CLIP train state on ``device``."""
    from madtp_tpu_torch.train.momentum import FeatureQueue

    model, params_m, queue, *rest = state
    return type(state)(copy.deepcopy(model).to(device),
                       {n: t.to(device, copy=True) for n, t in params_m.items()},
                       FeatureQueue(*(t.to(device, copy=True) for t in queue)),
                       *(t.to(device, copy=True) for t in rest))


def phase_train_retrieval_parity(device, cfg, tokenizer, t_main, n=2, text_len=35):
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
                 dict(K1=5 * L, K2=3 * L, K4=L, K5=5 * L), mask_caps=(None, None),
                 first=4.0)
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
                      save_and_load=save_and_load, cross_attention=False,
                      iters=1)  # one timed step a kind: ViT-L's steps are ~1 s each


CLIP_GRADS = ("visual.conv1.weight", "visual.transformer.resblocks.0.attn.in_proj_weight",
              "visual.transformer.resblocks.23.mlp.c_fc.weight", "visual.proj", "space_dict",
              "logit_scale", "token_embedding.weight",
              "transformer.resblocks.0.attn.in_proj_weight",
              "transformer.resblocks.11.query_model.q_map.0.weight", "text_projection")


def phase_train_clip_parity(device, cfg, tokenizer, t_main, n=1):
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
                 dict(K1=2 * L, K2=L, K4=0, K5=2 * (L + T)), first=5.0)
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


FIXTURE_WORDS = ["a", "the", "picture", "of", "cat", "dog", "left", "right", "is", "on", "two",
                 "red", "blue", "object", "sitting", "mat", "park", "running", "small", "big",
                 "yes", "no", "one", "three", "where", "what", "color", "in"]  # make_fixture's
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def write_png(path, img):
    """``img`` (uint8 HWC RGB) as an 8-bit RGB PNG, with ``zlib`` and no
    PIL; the rows are filtered None, Sub and Up in turn."""
    import struct
    import zlib

    H, W, _ = img.shape
    rows, prior = bytearray(), np.zeros(W * 3, np.uint8)
    for y in range(H):
        row = np.ascontiguousarray(img[y]).reshape(-1)
        ftype = y % 3
        if ftype == 1:
            filtered = row - np.concatenate([np.zeros(3, np.uint8), row[:-3]])
        elif ftype == 2:
            filtered = row - prior
        else:
            filtered = row
        rows.append(ftype)
        rows += filtered.astype(np.uint8).tobytes()
        prior = row

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    path.write_bytes(PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0))
                     + chunk(b"IDAT", zlib.compress(bytes(rows), 6)) + chunk(b"IEND", b""))


def driver_fixture(root, sizes=((480, 640), (375, 500)), n_images=8, nlvr_pairs=32,
                   caption_train=16, caption_eval=8, vqa_train=16, vqa_test=8, n_answers=128):
    """The drivers' fixture, written under ``root`` without PIL: ``n_images``
    PNG images (seeded gradients and noise) of the ``sizes`` (H, W) in turn,
    annotations in ``tools/make_fixture.py``'s layout (NLVR2 train, dev and
    test; COCO-Karpathy and Flickr30k train, val and test, for captioning
    and retrieval, each eval image with 5 captions; VQAv2 train, test and
    the answer list) and a 30,522-entry BERT-layout ``vocab.txt`` holding the
    fixture's words.  Eval images are named ``coco_<id>`` (no extension: the
    caption dataset reads the COCO id from the name, and the decoder goes by
    the PNG signature)."""
    import shutil

    shutil.rmtree(root, ignore_errors=True)
    (root / "images").mkdir(parents=True)
    (root / "annotation").mkdir()
    rng = np.random.default_rng(26)
    names = []
    for i in range(n_images):
        H, W = sizes[i % len(sizes)]
        y, x = np.mgrid[0:H, 0:W]
        img = np.stack([(x * (1 + i) + y) % 256, (y * (2 + i)) % 256, (x + 3 * y + 40 * i) % 256],
                       axis=-1) + rng.integers(0, 48, size=(H, W, 3))
        names.append(f"img_{i}.png")
        write_png(root / "images" / names[-1], np.clip(img, 0, 255).astype(np.uint8))
    words = FIXTURE_WORDS

    def dump(name, obj):
        (root / "annotation" / name).write_text(json.dumps(obj))

    nlvr = [{"images": [names[i % n_images], names[(i + 3) % n_images]],
             "sentence": f"the {words[4 + i % 6]} is on the {words[6 + i % 2]}",
             "label": "True" if i % 2 else "False"} for i in range(nlvr_pairs)]
    for split in ("nlvr_train.json", "nlvr_dev.json", "nlvr_test.json"):
        dump(split, nlvr)

    def caption(i):
        return f"a picture of {words[4 + i % 6]} number {i} on the {words[6 + i % 2]}"

    train = [{"image": names[i % n_images], "caption": caption(i), "image_id": f"img{i}"}
             for i in range(caption_train)]
    evals = []
    for i in range(caption_eval):
        shutil.copyfile(root / "images" / names[i % n_images], root / "images" / f"coco_{i:04d}")
        evals.append({"image": f"coco_{i:04d}",
                      "caption": [caption(i)] + [f"{caption(i)} {w}"
                                                 for w in ("indeed", "today", "again", "here")]})
    for name in ("coco_karpathy", "flickr30k"):
        dump(f"{name}_train.json", train)
        for split in ("val", "test"):
            dump(f"{name}_{split}.json", evals)
    answers = [f"{a} {b}" for a in words for b in words if a != b][:n_answers]
    dump("vqa_train.json", [{"image": names[i % n_images], "dataset": "vqa",
                             "question": f"what color is the {words[4 + i % 6]}",
                             "answer": [answers[(i + j // 3) % n_answers] for j in range(10)]}
                            for i in range(vqa_train)])
    dump("vqa_val.json", [])
    dump("vg_qa.json", [])
    dump("vqa_test.json", [{"image": names[i % n_images], "question": "what is this",
                            "question_id": i} for i in range(vqa_test)])
    dump("answer_list.json", answers)
    fixture_tokens = (words + ["number"] + [str(d) for d in range(10)]
                      + [f"##{c}" for c in "abcdefghijklmnopqrstuvwxyz"]
                      + list("abcdefghijklmnopqrstuvwxyz"))
    fixture_tokens = list(dict.fromkeys(fixture_tokens))
    tokens = (["[PAD]"] + [f"[unused{i}]" for i in range(99)]
              + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"] + fixture_tokens
              + [f"w{i}" for i in range(104 + len(fixture_tokens), 30522)])
    (root / "vocab.txt").write_text("\n".join(tokens) + "\n")
    return root


def driver_yaml(config_name, root, path, **override):
    """``configs/<config_name>`` with the fixture's roots, its vocabulary and
    no pretrained weights (and ``override``, the CPU rehearsal's cuts)."""
    import yaml

    with open(f"configs/{config_name}") as f:
        config = yaml.safe_load(f)
    images, ann = str(root / "images"), str(root / "annotation")
    config.update({k: v for k, v in (("image_root", images), ("vqa_root", images))
                   if k in config})
    config.update(ann_root=ann, bert_vocab=str(root / "vocab.txt"), pretrained="", **override)
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    return path


class StepTimes:
    """While active, the ``make_*_train_step`` factory that a driver module
    imported returns steps whose wall time (the card synchronised before and
    after) is recorded in ``times``."""

    def __init__(self, module, factory):
        self.module, self.factory, self.times = module, factory, []

    def __enter__(self):
        self._mod = importlib.import_module(self.module)
        self._orig = getattr(self._mod, self.factory)

        def make(*args, **kw):
            step = self._orig(*args, **kw)

            def timed(*a, **k):
                sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
                sync()
                t0 = time.perf_counter()
                out = step(*a, **k)
                sync()
                self.times.append((time.perf_counter() - t0) * 1e3)
                return out
            return timed

        setattr(self._mod, self.factory, make)
        return self

    def __exit__(self, *exc):
        setattr(self._mod, self.factory, self._orig)


class Stopwatch:
    """While active, each ``(module, attr)`` function adds its wall time
    (the card synchronised at its end) to ``seconds[attr]``, and its
    positional arguments that are numbers or strings to ``args[attr]``
    (others as None): where a driver's run spends its time, and what it
    passed."""

    def __init__(self, *targets):
        self.targets, self.seconds = targets, collections.Counter()
        self.args = collections.defaultdict(list)

    def __enter__(self):
        self._saved = []
        for module, attr in self.targets:
            mod = importlib.import_module(module)
            orig = getattr(mod, attr)

            def timed(*a, _orig=orig, _attr=attr, **k):
                # numbers only: a model or a batch held here would outlive the run
                self.args[_attr].append(tuple(x if isinstance(x, (int, float, str)) else None
                                              for x in a))
                t0 = time.perf_counter()
                try:
                    return _orig(*a, **k)
                finally:
                    if torch.cuda.is_available():
                        torch.cuda.synchronize()
                    self.seconds[_attr] += time.perf_counter() - t0

            self._saved.append((mod, attr, orig))
            setattr(mod, attr, timed)
        return self

    def __exit__(self, *exc):
        for mod, attr, orig in reversed(self._saved):
            setattr(mod, attr, orig)


def read_log(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


DRIVER_EPOCHS = 1  # phase 26's training runs: one, for the script's time


def phase_drivers(device, fixture_sizes=((480, 640), (375, 500)), override=None,
                  captures=True):
    """Phase 26: the three ported drivers through ``main(argv)``, as a user
    runs them, at the width and image size of ``configs/nlvr.yaml``,
    ``configs/caption_coco.yaml`` and ``configs/vqa.yaml`` (BLIP base, 12-layer
    MED; 384, 384 and 480 px), seeded random init, on a PNG fixture written
    here (``driver_fixture``): each ``--epoch 1`` (NLVR at the config's
    batches, 16 train and 32 test, 2 train batches an epoch and 1 a split;
    caption and VQA at ``--batch_size_train 8 --batch_size_test 8``, 2 train
    batches an epoch, 1 eval batch; one epoch, for the script's time: the
    controller's later steps are host arithmetic, held against the JAX
    drivers over 2 epochs on the CPU by ``tests/test_torch_driver_*.py``),
    then ``--evaluate --pretrained`` on the checkpoint the run wrote (VQA:
    its last epoch's, since the VQA driver writes one every epoch), which
    must reproduce the logged metric.  Checks ``log.txt`` (a line per
    epoch), ``config.yaml`` and the checkpoint, the first epoch's
    temperature (NLVR), and K1, K2, K4 and K5 launched on
    each driver's path (train and evaluate runs, counts zeroed just before
    and read just after); K1, K4 and K5 are held against their plain
    versions on the NLVR driver's own inputs.  Returns the launch counts by
    driver, the step times and the NLVR records."""
    import shutil

    from madtp_tpu_torch.kernels.attention_scores import attention_scores_cuda
    from madtp_tpu_torch.kernels.attention_scores_bwd import attention_scores_bwd_cuda
    from madtp_tpu_torch.kernels.cross_attention import cross_attention_cuda
    from madtp_tpu_torch.kernels.ffn import ffn_cuda
    from madtp_tpu_torch.kernels.build import BUILD_DIR

    override = override or {}
    flag = ["--device", device.type]
    t_fix = time.perf_counter()
    root = driver_fixture(BUILD_DIR / "driver_fixture", sizes=fixture_sizes)
    log(f"[drivers] PNG fixture written in {time.perf_counter() - t_fix:.1f} s; "
        f"{card_line() if device.type == 'cuda' else 'cpu'}")
    small = ["--batch_size_train", "8", "--batch_size_test", "8"]
    # (family, config, driver, train step factory, flags, checkpoint to evaluate, p): NLVR
    # and caption at p = 0.1, so that random weights reach the checkpoint gate (within 5
    # GFLOPs of the target)
    plans = (("nlvr", "nlvr.yaml", "compress_nlvr", "make_nlvr_train_step", [],
              "checkpoint_best.pth", 0.1),
             ("caption", "caption_coco.yaml", "compress_caption", "make_caption_train_step",
              small, "checkpoint_best.pth", 0.1),
             ("vqa", "vqa.yaml", "compress_vqa", "make_vqa_train_step", small,
              f"checkpoint_{DRIVER_EPOCHS - 1:02d}.pth", 0.5))
    launches, steps, records = {}, {}, {}
    for family, config_name, module, factory, extra, best_name, p in plans:
        out = BUILD_DIR / "driver_runs" / family
        shutil.rmtree(out, ignore_errors=True)
        out.mkdir(parents=True)
        yaml_path = driver_yaml(config_name, root, out / "fixture.yaml", **override)
        main = importlib.import_module(f"madtp_tpu_torch.cli.{module}").main
        train_argv = ["--config", str(yaml_path), "--output_dir", str(out / "train"),
                      "--epoch", str(DRIVER_EPOCHS), "--pretrained", "", "--p", str(p), *extra,
                      *flag]
        eval_argv = ["--config", str(yaml_path), "--output_dir", str(out / "evaluate"),
                     "--evaluate", "--pretrained", str(out / "train" / best_name), *extra, *flag]
        want = (K1Capture(), K4Capture(), K5Capture()) if family == "nlvr" and captures else ()
        attention_scores_cuda.launches = attention_scores_bwd_cuda.launches = 0
        cross_attention_cuda.launches = ffn_cuda.launches = ffn_cuda.fp32_launches = 0
        walls = {}
        with contextlib.ExitStack() as stack:
            caps = [stack.enter_context(c) for c in want]
            timer = stack.enter_context(StepTimes(f"madtp_tpu_torch.cli.{module}", factory))
            driver, tasks = f"madtp_tpu_torch.cli.{module}", f"madtp_tpu_torch.tasks.{family}"
            watch = stack.enter_context(Stopwatch(
                *((driver, a) for a in ("save_resume", f"save_{family}_checkpoint",
                                        f"init_{family}_model", "read_checkpoint")),
                *((tasks, a) for a in ("train_epoch", "evaluate")
                  + (("presearch",) if family == "caption" else ()))))
            for run, argv in (("train", train_argv), ("evaluate", eval_argv)):
                t0 = time.perf_counter()
                main(argv)
                if device.type == "cuda":
                    torch.cuda.synchronize()
                walls[run] = time.perf_counter() - t0
        launches[family] = dict(K1=attention_scores_cuda.launches,
                                K2=attention_scores_bwd_cuda.launches,
                                K4=cross_attention_cuda.launches, K5=ffn_cuda.launches)
        if device.type == "cuda":
            torch.cuda.empty_cache()
        train_log = read_log(out / "train" / "log.txt")
        for name in ("config.yaml", "log.txt", best_name):
            if not (out / "train" / name).is_file():
                raise AssertionError(f"driver {family}: no {name} in its output")
        if [e["epoch"] for e in train_log] != list(range(DRIVER_EPOCHS)):
            raise AssertionError(f"driver {family}: log.txt has epochs "
                                 f"{[e['epoch'] for e in train_log]}, want "
                                 f"{list(range(DRIVER_EPOCHS))}")
        ck = torch.load(out / "train" / best_name, map_location="cpu")
        best = train_log[int(ck["epoch"])]
        got = read_log(out / "evaluate" / "evaluate.txt")[0]
        if got["Cur_Gflops"] != best["Cur_Gflops"] or (
                family == "nlvr" and got["test_acc"] != best["test_acc"]):
            raise AssertionError(f"driver {family}: --evaluate logged {got}, the best epoch "
                                 f"{best}")
        if family == "vqa":
            with open(out / "evaluate" / "vqa_result.json") as f, \
                    open(out / "train" / f"vqa_result_epoch{DRIVER_EPOCHS - 1}.json") as g:
                if json.load(f) != json.load(g):
                    raise AssertionError("driver vqa: --evaluate answered otherwise than its "
                                         "last epoch")
        # the controller starts NLVR at T 1 (caption at its pre-searched T); its later
        # steps are held against the JAX drivers on the CPU (tests/test_torch_driver_*.py)
        if family == "nlvr" and float(train_log[0]["train_temperature"]) != 1.0:
            raise AssertionError(f"driver nlvr: epoch 0 ran at T "
                                 f"{train_log[0]['train_temperature']}, not 1")
        steps[family] = timer.times
        n = len(timer.times) // DRIVER_EPOCHS
        log(f"[drivers] {family}: train run {walls['train']:.1f} s, evaluate run "
            f"{walls['evaluate']:.1f} s; step times (ms) by epoch "
            f"{[[round(t, 1) for t in timer.times[e * n:(e + 1) * n]] for e in range(DRIVER_EPOCHS)]}"
            f"; launches {launches[family]}; "
            f"best epoch {int(ck['epoch'])} (T {float(ck['temperature']):.4f}): "
            f"{ {k: v for k, v in best.items() if not k.startswith('train_loss_')} }; "
            f"--evaluate {got}")
        log(f"[drivers] {family}: seconds in " + ", ".join(
            f"{k} {v:.1f}" for k, v in watch.seconds.items())
            + f" (train steps {sum(timer.times) / 1e3:.1f}, within train_epoch)")
        if device.type == "cuda":
            need = ("K1", "K2", "K4", "K5")
            if any(launches[family][k] == 0 for k in need):
                raise AssertionError(f"driver {family}: launches {launches[family]}: a kernel "
                                     "of the path was not launched")
        shutil.rmtree(out)  # the runs' checkpoints: ~15 GB for the three drivers
        if want:
            records["K1"] = check_k1_cases("driver nlvr", caps[0], iters=3)
            records["K4"] = check_k4_cases("driver nlvr", caps[1], iters=5,
                                           where=dict(dtype="float32"))
            records["K5"] = check_k5_cases("driver nlvr", caps[2], iters=3)
    shutil.rmtree(root)
    shutil.rmtree(BUILD_DIR / "driver_runs")
    return launches, steps, records


RN50 = dict(embed_dim=1024, image_resolution=224, vision_layers=16, vision_width=64,
            vision_patch_size=32, context_length=77, vocab_size=49408, transformer_width=512,
            transformer_heads=8, transformer_layers=12, sd_dim=768, resnet_layers=(3, 4, 6, 3))
CLIP_DRIVER_P = 0.01  # phase 27's CLIP --p: see phase_retrieval_drivers


def check_loaders(root, device, image_size, batch=8):
    """Phase 27's loader checks, in this process with CUDA up:
    ``mp_batched_loader`` (2 forked workers) against the threaded loader on
    the fixture's retrieval train set (COCO-Karpathy, the train transform at
    ``image_size``, shuffled epoch 1): equal batches in the same order and
    no shared-memory segment left in ``/dev/shm``; then ``device_prefetch``
    of those batches onto ``device``: equal tensors in order, captions
    passed through, every host source pinned (on a card).  Returns the two
    loaders' walls (s)."""
    import glob

    from madtp_tpu_torch.data import loader as L
    from madtp_tpu_torch.data.datasets import CaptionTrainDataset
    from madtp_tpu_torch.data.mp_loader import mp_batched_loader
    from madtp_tpu_torch.data.transforms import PerSampleRng, train_transform

    rng = PerSampleRng(42)
    ds = CaptionTrainDataset(lambda im: train_transform(im, image_size, rng),
                             str(root / "images"), str(root / "annotation"), dataset="coco")
    before = set(glob.glob("/dev/shm/madtp*"))
    walls = []
    for fn in (L.batched_loader, mp_batched_loader):
        t0 = time.perf_counter()
        walls.append((list(fn(ds, batch, shuffle=True, epoch=1, num_workers=2)),
                      time.perf_counter() - t0))
    (want, t_threads), (got, t_procs) = walls
    if len(got) != len(want) or not all(
            np.array_equal(a[0], b[0]) and list(a[1]) == list(b[1])
            and np.array_equal(a[2], b[2]) for a, b in zip(want, got)):
        raise AssertionError("mp_batched_loader: batches differ from the threaded loader's")
    left = set(glob.glob("/dev/shm/madtp*")) - before
    if left:
        raise AssertionError(f"mp_batched_loader left shared-memory segments: {sorted(left)}")
    staged, real = [], L._stage
    L._stage = lambda x: staged.append(real(x)) or staged[-1]
    try:
        out = list(L.device_prefetch(iter(want), size=2, device=device))
    finally:
        L._stage = real
    if device.type == "cuda" and (len(staged) != 2 * len(want)
                                  or not all(t.is_pinned() for t in staged)):
        raise AssertionError(f"device_prefetch: {len(staged)} host sources staged, pinned "
                             f"{[t.is_pinned() for t in staged]}")
    if len(out) != len(want) or not all(
            o[0].device.type == device.type and torch.equal(o[0].cpu(), torch.from_numpy(w[0]))
            and o[1] == w[1] and torch.equal(o[2].cpu(), torch.from_numpy(w[2]))
            for o, w in zip(out, want)):
        raise AssertionError("device_prefetch: batches differ from their sources")
    log(f"[retrieval-drivers] loaders: mp_batched_loader (2 processes) gave the threaded "
        f"loader's {len(want)} batches of {batch} in order, no segment left in /dev/shm; "
        f"threads {t_threads:.2f} s, processes {t_procs:.2f} s; device_prefetch put them on "
        f"{device.type} from {len(staged)} pinned host sources, equal and in order")
    return t_threads, t_procs


def run_driver(label, module, factory, tasks, watch_names, argvs, captures=(), epochs=0):
    """``main(argv)`` of ``madtp_tpu_torch.cli.<module>`` for each (run,
    argv) of ``argvs``, with the launch counts zeroed just before and read
    just after all of them, the train steps' walls (``StepTimes`` on
    ``factory``, logged by epoch of the ``epochs`` trained), the seconds in
    ``watch_names`` of the driver module and ``tasks`` (``Stopwatch``) and
    each run's wall, inside ``captures``.  Returns ``(walls, launches, step
    times, watch)``."""
    from madtp_tpu_torch.kernels.attention_scores import attention_scores_cuda
    from madtp_tpu_torch.kernels.attention_scores_bwd import attention_scores_bwd_cuda
    from madtp_tpu_torch.kernels.cross_attention import cross_attention_cuda
    from madtp_tpu_torch.kernels.ffn import ffn_cuda

    driver = f"madtp_tpu_torch.cli.{module}"
    main = importlib.import_module(driver).main
    walls = {}
    zero_launch_counts()
    with contextlib.ExitStack() as stack:
        for c in captures:
            stack.enter_context(c)
        timer = stack.enter_context(StepTimes(driver, factory))
        watch = stack.enter_context(Stopwatch(
            *((driver, a) for a in watch_names[0]), *((tasks, a) for a in watch_names[1])))
        for run, argv in argvs:
            t0 = time.perf_counter()
            main(argv)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            walls[run] = time.perf_counter() - t0
    launches = dict(K1=attention_scores_cuda.launches, K2=attention_scores_bwd_cuda.launches,
                    K4=cross_attention_cuda.launches, K5=ffn_cuda.launches)
    log(f"[retrieval-drivers] {label}: " + ", ".join(f"{r} run {w:.1f} s" for r, w in walls.items())
        + f"; launches {launches}")
    n = len(timer.times) // max(1, epochs)
    log(f"[retrieval-drivers] {label}: "
        + "".join(f"epoch {e}'s step times (ms) "
                  f"{[round(t, 1) for t in timer.times[e * n:(e + 1) * n]]}, "
                  for e in range(epochs))
        + "seconds in " + ", ".join(f"{k} {v:.1f}" for k, v in watch.seconds.items())
        + f" (train steps {sum(timer.times) / 1e3:.1f}, within train_epoch)")
    return walls, launches, timer.times, watch


def check_run(label, out, want_epochs, eval_name="evaluate.txt"):
    """The files a driver's training run leaves, and its log's epochs."""
    for name in ("config.yaml", "log.txt", "checkpoint_best.pth", "resume_ckpt"):
        if not (out / "train" / name).is_file():
            raise AssertionError(f"driver {label}: no {name} in its output")
    if not (out / "evaluate" / eval_name).is_file():
        raise AssertionError(f"driver {label}: --evaluate wrote no {eval_name}")
    train_log = read_log(out / "train" / "log.txt")
    if [e["epoch"] for e in train_log] != list(range(want_epochs)):
        raise AssertionError(f"driver {label}: log.txt has epochs "
                             f"{[e['epoch'] for e in train_log]}, want {list(range(want_epochs))}")
    return train_log


def check_controller(label, temps, train_log, target):
    """Epoch 0 at T = 1, each later epoch one controller step from the last
    epoch's logged GFLOPs."""
    from madtp_tpu_torch.train.controller import temperature_step

    want = [1.0]
    for e in train_log[:-1]:
        want.append(want[-1] + temperature_step(e["Cur_Gflops"], target))
    if len(temps) != len(want) or not all(math.isclose(a, b, abs_tol=1e-9)
                                          for a, b in zip(temps, want)):
        raise AssertionError(f"driver {label}: epochs ran at T {temps}, the controller gives "
                             f"{want}")


RECALL_KEYS = ("txt_r1", "txt_r5", "txt_r10", "img_r1", "img_r5", "img_r10", "txt_r_mean",
               "img_r_mean", "r_mean")


def phase_retrieval_drivers(device, fixture_sizes=((480, 640), (375, 500)), override=None,
                            clip_cfg=None, clip_override=None, rn_cfg=None, captures=True):
    """Phase 27: the BLIP and CLIP retrieval drivers through ``main(argv)``,
    as a user runs them, on ``driver_fixture``'s PNG fixture (8 test images
    with 5 captions each, 16 train pairs), then the loader checks
    (``check_loaders``).

    * ``compress_retrieval`` at ``configs/retrieval_coco.yaml``'s width (BLIP
      base, 384 px, 12-layer MED, queue 57,600, ``negative_all_rank``),
      random init, ``--batch_size_train 8 --batch_size_test 8 --epoch 1 --p
      0.1`` (2 train batches; ``k_test`` min(256, 40) = 40; one epoch, for
      the script's time: the controller's later steps are host arithmetic,
      held against the JAX drivers over 2 epochs on the CPU by
      ``tests/test_torch_driver_*.py``), then
      ``--evaluate`` on ``checkpoint_best.pth``, which must give the best
      epoch's recalls, and that checkpoint's GFLOPs (``epoch_gflops`` at its
      temperature on the first test batch) the logged ``Cur_Gflops``.  K4 is
      held against its plain version on the driver's own ITM inputs.
    * ``compress_retrieval_clip`` on a seeded random ViT-L/14@336 ``.pth``
      written here (``configs/retrieval_flickr_clip.yaml``'s checkpoint
      widths, codebook 100 x 768, temperature 0), ``--batch_size_train 8
      --batch_size_test 8 --epoch 1 --p 0.01`` (one epoch: the script's
      time), then
      ``--evaluate`` on its best checkpoint, which must give the epoch's
      recalls and GFLOPs.
      p = 0.01: on random weights CLIP prunes 2.5-4.5% at T = 1-2 (386 and
      378 of the reference's 395.7 GFLOPs, phase 24), and the best gate
      takes only an epoch within 5 GFLOPs of the target, so p must stay
      below about 0.037.  K1 is held at H = 16 on the driver's own inputs.
    * the same driver ``--evaluate`` on a seeded random RN50 ``.pth``
      (OpenAI CLIP's RN50: stages (3, 4, 6, 3), width 64, 224 px, embed
      1,024, text 512 wide, 12 layers, 77 tokens): finite recalls and the
      RN ``Cur_Gflops`` (the ResNet's and the dense text tower's).

    Each training run's ``log.txt`` has a line per epoch, ``config.yaml``,
    the checkpoint and the resume checkpoint exist, and its epochs ran at
    the controller's temperatures; K1, K2, K4 and K5 are launched on the
    BLIP driver's train and evaluate runs, K1, K2 and K5 on the CLIP
    driver's (counts zeroed just before and read just after, as phase 26);
    each run's wall, step times per epoch and seconds in init, ``train_epoch``,
    evaluation, checkpoint and resume writes are logged.  The CPU rehearsal
    passes a tiny ``override`` (BLIP yaml), ``clip_cfg``, ``clip_override``
    and ``rn_cfg``.  Returns the launch counts by driver, the K4 and K1
    records, and what phase 29 reuses (``root``: the fixture; ``yaml`` and
    ``scores``: the BLIP run's yaml and the score matrices its train run's
    opening eval dumped, kept under ``dir``)."""
    import shutil
    from unittest import mock

    import yaml

    from madtp_tpu_torch.ckpt.convert import load_retrieval_state_dict, save_clip_checkpoint
    from madtp_tpu_torch.cli.common import build_blip_cfg, read_checkpoint
    from madtp_tpu_torch.core.config import CLIPConfig
    from madtp_tpu_torch.data.datasets import RetrievalEvalDataset
    from madtp_tpu_torch.data.loader import batched_loader
    from madtp_tpu_torch.data.tokenizer_bert import BertWordPieceTokenizer
    from madtp_tpu_torch.data.transforms import eval_transform
    from madtp_tpu_torch.kernels.build import BUILD_DIR
    from madtp_tpu_torch.models.clip import init_clip_model
    from madtp_tpu_torch.prune.flops import clip_gflops
    from madtp_tpu_torch.tasks import retrieval as TR

    override, clip_override = override or {}, clip_override or {}
    clip_cfg = clip_cfg or clip_config()
    rn_cfg = rn_cfg or CLIPConfig(**RN50)
    flag = ["--device", device.type]
    small = ["--batch_size_train", "8", "--batch_size_test", "8"]
    t_fix = time.perf_counter()
    root = driver_fixture(BUILD_DIR / "retrieval_fixture", sizes=fixture_sizes)
    runs = BUILD_DIR / "retrieval_runs"
    shutil.rmtree(runs, ignore_errors=True)
    log(f"[retrieval-drivers] PNG fixture written in {time.perf_counter() - t_fix:.1f} s; "
        f"{card_line() if device.type == 'cuda' else 'cpu'}")
    launches, records = {}, {}

    # ---- BLIP retrieval ----
    out = runs / "retrieval"
    out.mkdir(parents=True)
    yaml_path = driver_yaml("retrieval_coco.yaml", root, out / "fixture.yaml", **override)
    p = 0.1
    target = 153.2 * (1 - p)  # ORI_GFLOPS of compress_retrieval
    k4c = K4Capture() if captures else None
    with mock.patch.dict("os.environ", {"MADTP_DUMP_SCORES": "1"}):  # phase 29's scores
        walls, launches["retrieval"], steps, watch = run_driver(
            "retrieval", "compress_retrieval", "make_retrieval_train_step",
            "madtp_tpu_torch.tasks.retrieval",
            (("init_retrieval_model", "save_retrieval_checkpoint", "save_resume",
              "read_checkpoint", "load_retrieval_state_dict"),
             ("train_epoch", "encode_corpus", "rerank_scores", "epoch_gflops")),
            (("train", ["--config", str(yaml_path), "--output_dir", str(out / "train"),
                        "--epoch", "1", "--pretrained", "", "--p", str(p), *small, *flag]),
             ("evaluate", ["--config", str(yaml_path), "--output_dir", str(out / "evaluate"),
                           "--evaluate", "--pretrained",
                           str(out / "train" / "checkpoint_best.pth"), *small, *flag])),
            captures=(k4c,) if k4c else (), epochs=1)
    train_log = check_run("retrieval", out, 1)
    check_controller("retrieval", [a[4] for a in watch.args["train_epoch"]], train_log, target)
    sd, extras = read_checkpoint(str(out / "train" / "checkpoint_best.pth"))
    best = train_log[int(extras["epoch"])]
    got = read_log(out / "evaluate" / "evaluate.txt")[0]
    with open(yaml_path) as f:
        config = yaml.safe_load(f)
    size = config.get("image_size", 384)
    model = load_retrieval_state_dict(sd, build_blip_cfg(config, size), device=device)
    del sd
    ds = RetrievalEvalDataset(lambda im: eval_transform(im, size), str(root / "images"),
                              str(root / "annotation"), "test", dataset="coco")
    tok = BertWordPieceTokenizer(str(root / "vocab.txt"))(ds.text, padding="longest",
                                                          max_length=35)
    first = next(iter(batched_loader(ds, 8, num_workers=0)))[0]
    g = TR.epoch_gflops(model, first, float(extras["temperature"]),
                        np.asarray(tok["input_ids"]).shape[1])
    del model
    if {k: got[k] for k in RECALL_KEYS} != {k: best[k] for k in RECALL_KEYS} or \
            round(g, 2) != best["Cur_Gflops"] or len(ds.text) != 40:
        raise AssertionError(f"driver retrieval: --evaluate logged {got} and its checkpoint "
                             f"{g:.2f} GFLOPs; the best epoch {best}")
    log(f"[retrieval-drivers] retrieval: best epoch {int(extras['epoch'])} (T "
        f"{float(extras['temperature']):.4f}): {best}; --evaluate {got}, its checkpoint's "
        f"GFLOPs {g:.2f}")
    if device.type == "cuda" and min(launches["retrieval"].values()) == 0:
        raise AssertionError(f"driver retrieval: launches {launches['retrieval']}: a kernel of "
                             "the path was not launched")
    kept = dict(root=root, dir=BUILD_DIR / "mp_inputs")  # phase 29 evaluates on two ranks
    shutil.rmtree(kept["dir"], ignore_errors=True)
    kept["dir"].mkdir(parents=True)
    for key, src in (("yaml", yaml_path), ("scores", out / "train" / "scores.npz")):
        kept[key] = kept["dir"] / src.name
        shutil.move(str(src), str(kept[key]))
    shutil.rmtree(out)
    if k4c:
        records["K4"] = check_k4_cases("driver retrieval", k4c, iters=5,
                                       where=dict(dtype="float32"))
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # ---- CLIP retrieval, ViT-L/14@336 ----
    out = runs / "clip"
    out.mkdir(parents=True)
    t0 = time.perf_counter()
    pth = out / "clip_vit.pth"
    save_clip_checkpoint(init_clip_model(clip_cfg, seed=27, device=device), str(pth), epoch=0,
                         temperature=0.0)
    log(f"[retrieval-drivers] clip: random {clip_cfg.vision_layers}-layer "
        f"{clip_cfg.image_resolution}-px checkpoint written in {time.perf_counter() - t0:.1f} s")
    yaml_path = driver_yaml("retrieval_flickr_clip.yaml", root, out / "fixture.yaml",
                            **clip_override)
    target = 395.7 * (1 - CLIP_DRIVER_P)
    k1c = K1Capture() if captures else None
    walls, launches["retrieval_clip"], steps, watch = run_driver(
        "clip", "compress_retrieval_clip", "make_clip_train_step",
        "madtp_tpu_torch.tasks.clip_retrieval",
        (("save_clip_checkpoint", "save_resume", "read_checkpoint", "load_clip_state_dict"),
         ("train_epoch", "encode_towers")),
        (("train", ["--config", str(yaml_path), "--output_dir", str(out / "train"), "--epoch",
                    "1", "--pretrained", str(pth), "--p", str(CLIP_DRIVER_P), *small, *flag]),
         ("evaluate", ["--config", str(yaml_path), "--output_dir", str(out / "evaluate"),
                       "--evaluate", "--pretrained", str(out / "train" / "checkpoint_best.pth"),
                       *small, *flag])),
        captures=(k1c,) if k1c else (), epochs=1)
    train_log = check_run("clip", out, 1)
    check_controller("clip", [a[4] for a in watch.args["train_epoch"]], train_log, target)
    ck = torch.load(out / "train" / "checkpoint_best.pth", map_location="cpu")
    best = train_log[int(ck["epoch"])]
    got = read_log(out / "evaluate" / "evaluate.txt")[0]
    if {k: got[k] for k in RECALL_KEYS} != {k: best[k] for k in RECALL_KEYS} or \
            round(got["Cur_Gflops"], 2) != best["Cur_Gflops"]:
        raise AssertionError(f"driver clip: --evaluate logged {got}, the best epoch {best}")
    log(f"[retrieval-drivers] clip: best epoch {int(ck['epoch'])} (T "
        f"{float(ck['temperature']):.4f}): {best}; --evaluate {got}")
    del ck
    if device.type == "cuda" and (min(launches["retrieval_clip"][k] for k in ("K1", "K2", "K5"))
                                  == 0 or launches["retrieval_clip"]["K4"]):
        raise AssertionError(f"driver clip: launches {launches['retrieval_clip']}: want K1, "
                             "K2 and K5, and no K4")
    shutil.rmtree(out)
    if k1c:
        records["K1"] = check_k1_cases("driver clip", k1c, iters=3)
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # ---- CLIP retrieval, RN50, --evaluate ----
    out = runs / "clip_rn50"
    out.mkdir(parents=True)
    pth = out / "clip_rn50.pth"
    save_clip_checkpoint(init_clip_model(rn_cfg, seed=27, device=device), str(pth), epoch=0,
                         temperature=0.0)
    yaml_path = driver_yaml("retrieval_flickr_clip.yaml", root, out / "fixture.yaml",
                            **clip_override)
    walls, launches["retrieval_clip_rn50"], _, _ = run_driver(
        "clip RN50", "compress_retrieval_clip", "make_clip_train_step",
        "madtp_tpu_torch.tasks.clip_retrieval", (("load_clip_state_dict",), ("encode_towers",)),
        (("evaluate", ["--config", str(yaml_path), "--output_dir", str(out / "evaluate"),
                       "--evaluate", "--pretrained", str(pth), *small, *flag]),))
    got = read_log(out / "evaluate" / "evaluate.txt")[0]
    want_g = round(clip_gflops(rn_cfg, [], [rn_cfg.context_length - 1]
                               * rn_cfg.transformer_layers), 3)
    if not (all(math.isfinite(got[k]) for k in RECALL_KEYS) and got["Cur_Gflops"] == want_g):
        raise AssertionError(f"driver clip RN50: --evaluate logged {got}, want finite recalls "
                             f"and {want_g} GFLOPs")
    log(f"[retrieval-drivers] clip RN50: --evaluate {got}")
    if device.type == "cuda" and launches["retrieval_clip_rn50"]["K5"] == 0:
        raise AssertionError(f"driver clip RN50: launches {launches['retrieval_clip_rn50']}: "
                             "the text tower's FFNs ran no K5")
    shutil.rmtree(runs)
    check_loaders(root, device, 384 if not override else override.get("image_size", 384))
    return launches, records, kept


SERVE_TOL = 2e-2  # logits of a merged request against the same rows served alone (bf16)


def _serve_args(task, out, t, *flags):
    from madtp_tpu_torch.cli import export_serving

    return export_serving.build_parser().parse_args(
        ["--task", task, "--output_dir", str(out), "--temperature", repr(float(t)), *flags])


def _pctl(values, q):
    return float(np.percentile(np.asarray(values), q)) if values else float("nan")


def phase_serving(device, nlvr_model, t_star, caps, tasks, tokenizer, pairs=32, text_len=26,
                  threads=8, rounds=6, root=None):
    """Serving (``madtp_tpu_torch/serve``, ``cli/export_serving``): the NLVR
    eval main path's model, temperature and capacities exported through the
    CLI's functions as two gather-mode artifacts, batch-coupled and
    ``--row_independent``, and the other four tasks in mask mode at their
    main paths' temperatures (``tasks``: ``{task: (config, temperature)}``),
    all served by one ``ArtifactServer`` on ``127.0.0.1:0``, whose warm-up
    captures every unit's graph.  Over HTTP: a full NLVR batch on each
    artifact, ``threads`` clients sending ``rounds`` sub-batches of 1-4
    pairs each to the row-independent one (each also sent alone first), a
    burst on the coupled one, one request to each unit of the other tasks.
    The launch counts are zeroed just before the requests and read just
    after them (the ``serve`` path).  Then: the full batches equal a direct
    ``make_eval_step`` call bit for bit (the coupled one the main path's
    own step), every reply under load its rows served alone (logits within
    ``SERVE_TOL``, argmax and kept counts equal), ``merged`` > 0 on the
    row-independent artifact and 0 on the coupled one, no capture after
    the warm-up, and each other task's replies equal its direct step.
    Returns the ``serve`` launches of K1, K4 and K5."""
    import shutil
    import threading

    from madtp_tpu_torch.cli import export_serving as ES
    from madtp_tpu_torch.kernels.build import BUILD_DIR
    from madtp_tpu_torch.models import blip
    from madtp_tpu_torch.models.clip import init_clip_model
    from madtp_tpu_torch.serve.server import (ArtifactServer, ServingClient, decode_tensors,
                                              encode_arrays)
    from madtp_tpu_torch.tasks.caption import make_caption_step, prompt_ids
    from madtp_tpu_torch.tasks.clip_retrieval import tower_steps
    from madtp_tpu_torch.tasks.nlvr import make_eval_step
    from madtp_tpu_torch.tasks.retrieval import corpus_steps, itm_step
    from madtp_tpu_torch.tasks.vqa import make_rank_step
    from madtp_tpu_torch.utils.graph import CapturedStep

    log(f"[serve] {card_line()}")
    root = BUILD_DIR / "serving" if root is None else root
    shutil.rmtree(root, ignore_errors=True)
    caps_v, caps_t = caps
    dirs = {}
    t0 = time.perf_counter()
    for name, flags in (("nlvr", ()), ("nlvr_ri", ("--row_independent",))):
        args = _serve_args("nlvr", root / name, t_star, "--batch", str(pairs), "--text_len",
                           str(text_len), *flags)
        ES.export_nlvr(args, {}, device, model=nlvr_model, capacities=(caps_v, caps_t))
        dirs[name] = root / name
    dt = torch.bfloat16
    models, shapes = {}, {}
    (rcfg, t_ret), (ccfg, t_clip) = tasks["retrieval"], tasks["clip"]
    (vcfg, t_vqa), (pcfg, t_cap) = tasks["vqa"], tasks["caption"]
    models["retrieval"] = blip.init_retrieval_model(rcfg, seed=0, device=device, dtype=dt)
    ES.export_retrieval(_serve_args("retrieval", root / "retrieval", t_ret, "--batch", "16",
                                    "--text_len", "35", "--rerank_batch", "16"),
                        {}, device, model=models["retrieval"])
    models["clip"] = init_clip_model(ccfg, seed=0, device=device, dtype=dt)
    ES.export_clip(_serve_args("clip", root / "clip", t_clip, "--batch", "16"), {}, device,
                   model=models["clip"])
    models["vqa"] = blip.init_vqa_model(vcfg, seed=0, device=device, dtype=dt)
    ES.export_vqa(_serve_args("vqa", root / "vqa", t_vqa, "--batch", "8", "--text_len", "20",
                              "--num_answers", "3128", "--answer_len", "8", "--k_test", "128",
                              "--pad_id", str(tokenizer.pad_token_id)),
                  {}, device, model=models["vqa"])
    prompt = prompt_ids(tokenizer, 8)
    models["caption"] = blip.init_caption_model(pcfg, seed=0, device=device, dtype=dt)
    cap_kw = dict(num_beams=3, max_length=20, min_length=5,
                  eos_token_id=tokenizer.sep_token_id, pad_token_id=tokenizer.pad_token_id)
    ES.export_caption(_serve_args(
        "caption", root / "caption", t_cap, "--batch", "8", "--prompt_len",
        str(prompt.shape[1]), "--num_beams", "3", "--max_length", "20", "--min_length", "5",
        "--eos_id", str(cap_kw["eos_token_id"]), "--pad_id", str(cap_kw["pad_token_id"])),
        {}, device, model=models["caption"])
    for unit in ("image_encoder", "text_encoder", "itm_rerank"):
        dirs[f"retrieval_{unit}"] = root / "retrieval" / unit
    for unit in ("image_encoder", "text_encoder"):
        dirs[f"clip_{unit}"] = root / "clip" / unit
    dirs["vqa"], dirs["caption"] = root / "vqa", root / "caption"
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    captures = CapturedStep.captures
    srv = ArtifactServer({k: str(v) for k, v in dirs.items()}, device=device)
    srv.start_background()
    warm_s, warm_captures = time.perf_counter() - t0, CapturedStep.captures - captures
    log(f"[serve] exported {len(dirs)} units in {export_s:.1f} s; the server loaded and warmed "
        f"them up in {warm_s:.1f} s ({warm_captures} captures)")
    client = ServingClient(srv.url, timeout=600)
    try:
        if not client.healthy():
            raise AssertionError("the server is not healthy after its warm-up")
        captures = CapturedStep.captures
        rng = np.random.default_rng(21)
        s = nlvr_model.cfg.vit.image_size
        images = rng.standard_normal((2 * pairs, 3, s, s), dtype=np.float32)
        ids = rng.integers(1, nlvr_model.cfg.med.vocab_size, (pairs, text_len)).astype(np.int32)
        ids[:, 0] = ENC_ID
        mask = np.ones((pairs, text_len), np.int32)
        mask[-1, text_len - 6:] = 0
        t32 = np.float32(t_star)

        zero_launch_counts()  # the serve path: every request below, and nothing else
        serve_t0 = time.perf_counter()
        full = {name: client.predict(images, ids, mask, t32, name=name)
                for name in ("nlvr", "nlvr_ri")}
        # sub-batches of 1-4 pairs drawn from the batch, each sent alone first
        reqs = []
        for k in range(threads * rounds):
            n = 1 + k % 4
            rows = rng.choice(pairs, n, replace=False)
            reqs.append((np.concatenate([images[rows], images[pairs + rows]]), ids[rows],
                         mask[rows], t32))
        alone = [client.predict(*r, name="nlvr_ri") for r in reqs]
        merged0, calls0 = srv.runtimes["nlvr_ri"].stats["merged"], \
            srv.runtimes["nlvr_ri"].stats["calls"]
        replies, latency = [None] * len(reqs), collections.defaultdict(list)

        def worker(w):
            for k in range(w, len(reqs), threads):
                t1 = time.perf_counter()
                replies[k] = client.predict(*reqs[k], name="nlvr_ri")
                latency[len(reqs[k][1])].append((time.perf_counter() - t1) * 1e3)

        pool = [threading.Thread(target=worker, args=(w,)) for w in range(threads)]
        t1 = time.perf_counter()
        for th in pool:
            th.start()
        for th in pool:
            th.join()
        load_s = time.perf_counter() - t1
        coupled_out = [None] * threads

        def coupled_one(k):
            coupled_out[k] = client.predict(*reqs[k], name="nlvr")

        burst = [threading.Thread(target=coupled_one, args=(k,)) for k in range(threads)]
        for th in burst:
            th.start()
        for th in burst:
            th.join()
        # one request to each unit of the other four tasks
        other = {}
        rs = rcfg.vit.image_size
        r_in = {"img": rng.standard_normal((16, 3, rs, rs), dtype=np.float32),
                "ids": rng.integers(1, rcfg.med.vocab_size, (16, 35)).astype(np.int32),
                "mask": np.ones((16, 35), np.int32)}
        tr = np.float32(t_ret)
        other["retrieval_image_encoder"] = client.predict(r_in["img"], tr,
                                                          name="retrieval_image_encoder")
        other["retrieval_text_encoder"] = client.predict(r_in["ids"], r_in["mask"], tr,
                                                         name="retrieval_text_encoder")
        _, sx, sa = other["retrieval_image_encoder"]
        r_in["itm_ids"] = r_in["ids"].copy()
        r_in["itm_ids"][:, 0] = ENC_ID
        other["retrieval_itm_rerank"] = client.predict(r_in["itm_ids"], r_in["mask"], sx, sa,
                                                       tr, name="retrieval_itm_rerank")
        cs = ccfg.image_resolution
        c_img = rng.standard_normal((16, 3, cs, cs), dtype=np.float32)
        c_txt = np.zeros((16, ccfg.context_length), np.int32)
        for b, n in enumerate(rng.integers(6, ccfg.context_length, 16)):
            c_txt[b, :n] = rng.integers(1, CLIP_EOT - 1, n)
            c_txt[b, n - 1] = CLIP_EOT
        other["clip_image_encoder"] = client.predict(c_img, np.float32(t_clip),
                                                     name="clip_image_encoder")
        other["clip_text_encoder"] = client.predict(c_txt, np.float32(t_clip),
                                                    name="clip_text_encoder")
        vs = vcfg.vit.image_size
        v_in = [rng.standard_normal((8, 3, vs, vs), dtype=np.float32),
                rng.integers(1000, 30000, (8, 20)).astype(np.int32), np.ones((8, 20), np.int32)]
        v_in[1][:, 0] = ENC_ID
        a_ids = np.zeros((3128, 8), np.int32)
        a_ids[:, 0] = DEC_ID
        for a in range(3128):
            n = 1 + a % 4
            a_ids[a, 1:1 + n] = rng.integers(1000, 30000, n)
            a_ids[a, 1 + n] = SEP_ID
        v_in += [a_ids, (a_ids > 0).astype(np.int32), np.float32(t_vqa)]
        other["vqa"] = client.predict(*v_in, name="vqa")
        ps = pcfg.vit.image_size
        p_in = [rng.standard_normal((8, 3, ps, ps), dtype=np.float32), prompt.astype(np.int32),
                np.float32(t_cap)]
        other["caption"] = client.predict(*p_in, name="caption")
        serve_s = time.perf_counter() - serve_t0
        k1, _, k4, k5 = launch_counts()
        new_captures = CapturedStep.captures - captures
        stats = {n: dict(rt.stats) for n, rt in srv.runtimes.items()}
    finally:
        srv.shutdown()
        srv.server_close()
    if new_captures:
        raise AssertionError(f"requests captured {new_captures} graphs after the warm-up")
    if not (k1 and k4 and k5):
        raise AssertionError(f"the serve path launched K1, K4, K5 {k1}, {k4}, {k5} times")
    if stats["nlvr_ri"]["merged"] - merged0 <= 0:
        raise AssertionError(f"no request merged on the row-independent artifact: "
                             f"{stats['nlvr_ri']}")
    if stats["nlvr"]["merged"] != 0:
        raise AssertionError(f"the coupled artifact merged requests: {stats['nlvr']}")

    # the direct steps on the same inputs
    # int64 ids and mask, as the main path fed its step: the coupled call replays its graph
    x = torch.from_numpy(images).to(device, dt)
    i_d, m_d = (torch.from_numpy(a).long().to(device) for a in (ids, mask))
    for name, ri in (("nlvr", False), ("nlvr_ri", True)):
        want = make_eval_step(nlvr_model, True, caps_v, caps_t, row_independent=ri)(
            x, i_d, m_d, t_star)
        vk, tk = (want.v_kept.t(), want.t_kept.t()) if ri else (want.v_kept, want.t_kept)
        got = full[name]
        if not (np.array_equal(got[0], want.logits.float().cpu().numpy())
                and np.array_equal(got[1], vk.cpu().numpy())
                and np.array_equal(got[2], tk.cpu().numpy())):
            err = float(np.abs(got[0] - want.logits.float().cpu().numpy()).max())
            raise AssertionError(f"{name}: the full batch over HTTP differs from the direct "
                                 f"step (max |logit diff| {err:.3e})")
    worst = 0.0
    for k, (r, a, g) in enumerate(zip(reqs, alone, replies)):
        worst = max(worst, float(np.abs(g[0] - a[0]).max()))
        if not (np.array_equal(g[0].argmax(-1), a[0].argmax(-1))
                and np.array_equal(g[1], a[1]) and np.array_equal(g[2], a[2])):
            raise AssertionError(f"request {k} ({len(r[1])} pairs): its reply under load "
                                 "differs from the same rows served alone")
    if not worst <= SERVE_TOL:
        raise AssertionError(f"a reply under load is {worst:.3e} from its rows served alone "
                             f"(limit {SERVE_TOL})")
    if any(o is None or o[0].shape != (len(r[1]), 2) for o, r in zip(coupled_out, reqs)):
        raise AssertionError("the coupled burst's replies are missing or misshapen")

    def equal(label, got, want):
        want = [w.float().cpu().numpy() if w.is_floating_point() else w.cpu().numpy()
                for w in want]
        for j, (g, w) in enumerate(zip(got, want)):
            if g.shape != w.shape or not np.array_equal(g, w):
                raise AssertionError(f"{label}: reply {j} differs from the direct step")

    m = models["retrieval"]
    img_step, txt_step = corpus_steps(m, True)
    equal("retrieval image_encoder", other["retrieval_image_encoder"],
          img_step(torch.from_numpy(r_in["img"]).to(device, dt), t_ret))
    equal("retrieval text_encoder", other["retrieval_text_encoder"],
          txt_step(torch.from_numpy(r_in["ids"]).to(device), torch.from_numpy(r_in["mask"]).to(
              device), t_ret))
    equal("retrieval itm_rerank", other["retrieval_itm_rerank"], [itm_step(m, True)(
        torch.from_numpy(r_in["itm_ids"]).to(device), torch.from_numpy(r_in["mask"]).to(device),
        torch.from_numpy(sx).to(device, dt), torch.from_numpy(sa).to(device), t_ret)])
    c_img_step, c_txt_step = tower_steps(models["clip"], True, normalize=False)
    equal("clip image_encoder", other["clip_image_encoder"],
          c_img_step(torch.from_numpy(c_img).to(device, dt), t_clip))
    equal("clip text_encoder", other["clip_text_encoder"],
          c_txt_step(torch.from_numpy(c_txt).to(device), t_clip))
    best, vk, qk, topk = make_rank_step(models["vqa"], True, k=128,
                                        pad_token_id=tokenizer.pad_token_id)(
        torch.from_numpy(v_in[0]).to(device, dt), *(torch.from_numpy(a).to(device)
                                                    for a in v_in[1:5]), t_vqa)
    equal("vqa rank", other["vqa"], [best, topk, vk, qk])
    seqs, pk = make_caption_step(models["caption"], True, **cap_kw)(
        torch.from_numpy(p_in[0]).to(device, dt), torch.from_numpy(p_in[1]).to(device), t_cap)
    equal("caption", other["caption"], [seqs, pk])
    del models

    # the host's codec on one full NLVR request and its reply
    body = encode_arrays([images, ids, mask, t32])
    enc_ms = 1e3 * min(_timed(lambda: encode_arrays([images, ids, mask, t32])) for _ in range(3))
    dec_ms = 1e3 * min(_timed(lambda: decode_tensors(body)) for _ in range(3))
    n_load = sum(len(r[1]) for r in reqs)
    ri_calls = stats["nlvr_ri"]["calls"] - calls0
    log(f"[serve] full batch of {pairs} pairs over HTTP equals the direct step bit for bit "
        f"(coupled: the main path's step; row-independent: a direct row-independent step)")
    log(f"[serve] load: {threads} threads x {rounds} requests of 1-4 pairs ({len(reqs)} "
        f"requests, {n_load} pairs) on the row-independent artifact in {load_s:.3f} s: "
        f"{len(reqs) / load_s:.1f} requests/s, {n_load / load_s:.1f} pairs/s; "
        f"{ri_calls} device calls, merged {stats['nlvr_ri']['merged'] - merged0}; the coupled "
        f"artifact merged {stats['nlvr']['merged']} of a burst of {threads}; max |logit "
        f"diff| against the same rows alone {worst:.3e} (limit {SERVE_TOL}), argmax and kept "
        f"counts equal")
    for n in sorted(latency):
        log(f"[serve] latency under load, {n} pair(s): p50 {_pctl(latency[n], 50):.1f} ms, "
            f"p99 {_pctl(latency[n], 99):.1f} ms ({len(latency[n])} requests)")
    log(f"[serve] host codec per full NLVR request ({len(body) / 1e6:.1f} MB npz): encode "
        f"{enc_ms:.1f} ms, decode {dec_ms:.1f} ms")
    log(f"[serve] retrieval, CLIP, VQA and caption units: one request each, equal to their "
        f"direct steps; every request {serve_s:.1f} s; launches on the serve path: K1 {k1}, "
        f"K4 {k4}, K5 {k5}; no capture after the warm-up")
    log(f"[serve] stats {json.dumps(stats)}")
    return k1, k4, k5


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def nccl_one_rank(device):
    """Phase 29 (a): every helper of ``parallel/dist.py`` and the global-batch
    pieces of ``parallel/data.py`` through a one-rank NCCL group in this
    process, on CUDA tensors, against the values one rank must give."""
    from unittest import mock

    import torch.distributed as tdist

    from madtp_tpu_torch.parallel import data, dist

    tdist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}",
                             world_size=1, rank=0, device_id=device)
    checks = []

    def check(name, ok):
        checks.append(name)
        if not ok:
            raise AssertionError(f"nccl one-rank group: {name} gave a wrong value")

    try:
        check("backend", tdist.get_backend() == "nccl" and dist.process_count() == 1
              and dist.is_main_process() and dist.reference_row_shard(10) == (0, 10))
        a = np.arange(6, dtype=np.float32).reshape(2, 3)
        check("host_allgather", np.array_equal(dist.host_allgather(a), a[None]))
        check("host_allgather bool", np.array_equal(dist.host_allgather(a > 2), (a > 2)[None]))
        check("host_sum", np.array_equal(dist.host_sum(np.array([1.5, 2.0 ** -30])),
                                         np.array([1.5, 2.0 ** -30])))
        s = np.full((3, 4), -100.0, np.float32)
        s[1] = [-250.0, 0.5, 3.0, -100.5]
        check("merge_scores", np.array_equal(dist.merge_scores(s), s))
        x = torch.randn(5, 7, device=device)
        check("all_gather_rows", torch.equal(dist.all_gather_rows(x), x))
        check("all_gather_rows bool", torch.equal(dist.all_gather_rows(x > 0), x > 0))
        xg = x.clone().requires_grad_(True)
        c = dist.concat_all_gather(xg)
        check("concat_all_gather", torch.equal(c, x) and not c.requires_grad)
        w = torch.randn(5, 7, device=device)
        y = dist.all_gather_with_grad(xg)
        (y * w).sum().backward()
        check("all_gather_with_grad", torch.equal(y.detach(), x) and torch.equal(xg.grad, w))
        t = torch.tensor([3, -2], device=device)
        check("all_reduce sum", torch.equal(dist.all_reduce(t.clone(), "sum"), t))
        check("all_reduce max", torch.equal(dist.all_reduce(t.clone(), "max"), t))
        dist.barrier("phase 29")
        with mock.patch.object(data._SCOPE, "active", True):  # a step that spans the group
            counts = (torch.tensor(7, device=device), torch.tensor(9, device=device))
            check("batch_max", [int(v) for v in data.batch_max(*counts)] == [7, 9])
            lin = torch.nn.Linear(7, 3).to(device)
            lin(x).square().mean().backward()
            want = [p.grad.clone() for p in lin.parameters()]
            m = data.reduce_step(lin.parameters(), [torch.tensor(0.25, device=device)],
                                 torch.tensor(12, device=device))
            check("reduce_step", abs(float(m[0]) - 0.25) <= 1e-7 and all(
                torch.allclose(p.grad, g, rtol=1e-6, atol=0) for p, g in
                zip(lin.parameters(), want)))
    finally:
        tdist.destroy_process_group()
    log(f"[multiprocess] one-rank NCCL group on {torch.cuda.get_device_name(device)}: "
        f"{len(checks)} checks held ({', '.join(checks)})")
    return checks


def _mp_rank(rank, plan):
    """One of phase 29's two ranks (spawned): the BLIP retrieval and CLIP
    drivers' ``--epoch 1`` training runs over gloo (the BLIP run's opening
    eval dumps its scores), their first steps' inputs, losses, named
    gradients and queues kept (``held_step``).  Each training run's epoch 0
    runs at the plan's temperature for it.  The launch counts of each run,
    the ``LOG:`` lines, written to ``plan["out"]/rank<r>.pt``."""
    import io
    from unittest import mock

    import torch.distributed as tdist

    from madtp_tpu_torch.cli import compress_retrieval, compress_retrieval_clip
    from madtp_tpu_torch.kernels.attention_scores import attention_scores_cuda
    from madtp_tpu_torch.kernels.attention_scores_bwd import attention_scores_bwd_cuda
    from madtp_tpu_torch.kernels.cross_attention import cross_attention_cuda
    from madtp_tpu_torch.kernels.ffn import ffn_cuda
    from madtp_tpu_torch.parallel import data
    from madtp_tpu_torch.train.controller import TemperatureController

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = plan["device"]
    mp = ["--device", dev, "--num_processes", "2", "--process_id", str(rank), "--coordinator",
          plan["coordinator"], "--dist_backend", "gloo"]
    first = {}
    make_retrieval = compress_retrieval.make_retrieval_train_step
    make_clip = compress_retrieval_clip.make_clip_train_step
    reduce_step, reduce_ms = data.reduce_step, []
    world_rows, batch_rows, gather_ms = data.world_rows, data.batch_rows, []

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()

    def timed(fn, into):
        def run(*a, **k):  # a collective over gloo, the card drained around it
            sync()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            sync()
            into.append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    def held(name, maker, grad_params):
        def factory(state, opt, **kw):
            return held_step(name, maker(state, opt, **kw), state.queue, first, grad_params,
                             state.model, sync, reduce_ms, gather_ms)
        return factory

    def controller(name):
        class Controller(TemperatureController):  # epoch 0 at the plan's temperature
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                self.temperature = plan["temperatures"][name]
        return Controller

    out, walls, launches = {}, {}, {}
    stdout = io.StringIO()
    with mock.patch.object(compress_retrieval, "make_retrieval_train_step",
                           held("retrieval_train", make_retrieval, plan["retrieval_grads"])), \
            mock.patch.object(compress_retrieval_clip, "make_clip_train_step",
                              held("clip_train", make_clip, plan["clip_grads"])), \
            mock.patch.object(data, "reduce_step", timed(reduce_step, reduce_ms)), \
            mock.patch.object(data, "world_rows", timed(world_rows, gather_ms)), \
            mock.patch.object(data, "batch_rows", timed(batch_rows, gather_ms)), \
            mock.patch.object(compress_retrieval, "TemperatureController",
                              controller("retrieval_train")), \
            mock.patch.object(compress_retrieval_clip, "TemperatureController",
                              controller("clip_train")), \
            mock.patch.dict("os.environ", {"MADTP_DUMP_SCORES": "1"}), \
            contextlib.redirect_stdout(stdout):
        for label, main in (("retrieval_train", compress_retrieval.main),
                            ("clip_train", compress_retrieval_clip.main)):
            zero_launch_counts()
            t0 = time.perf_counter()
            main([*plan["argv"][label], "--output_dir", f"{plan['out']}/{label}_r{rank}", *mp])
            sync()
            launches[label] = dict(K1=attention_scores_cuda.launches,
                                   K2=attention_scores_bwd_cuda.launches,
                                   K4=cross_attention_cuda.launches, K5=ffn_cuda.launches)
            walls[label] = time.perf_counter() - t0
    tdist.destroy_process_group()
    out.update(first=first, launches=launches, walls=walls,
               logs=[line for line in stdout.getvalue().splitlines()
                     if line.startswith("LOG:")])
    torch.save(out, f"{plan['out']}/rank{rank}.pt")


def rank_decisions(fwd, x, halves, rows, t):
    """Whether two ranks, each running its half of the global batch ``x``,
    take the one-process forward's DTP decisions at ``t``.  The
    one-process forward ``fwd(x, t, None)`` (no gradient) records every
    decision; each half (``halves[r]``, whose rows of a decision over ``n``
    global rows are ``rows[r][n]``) runs again as ``fwd(halves[r], t, r)``
    with ``parallel.data.batch_max`` handing it the recorded global counts,
    as the ranks' cross-rank max will, at the ranks' batch shapes and so
    their rounding.  Returns the one-process output and None, or a
    description of the first decision a half takes otherwise (its rows'
    above-threshold counts or kept tokens)."""
    from unittest import mock

    from madtp_tpu_torch.parallel import data

    with DTPRecorder() as rec, torch.no_grad():
        ref = fwd(x, t, None)
    dev = x[0].device
    forced = [(torch.tensor(k, device=dev), palive.sum(dim=1).amax().to(dev))
              for _, _, palive, _, k, _ in rec.records]
    for r, half in enumerate(halves):
        given = iter(forced)
        with mock.patch.object(data, "batch_max", lambda *counts: next(given)), \
                DTPRecorder() as mine, torch.no_grad():
            fwd([a.to(dev) for a in half], t, r)
        for d, (want, got) in enumerate(zip(rec.records, mine.records)):
            idx = rows[r][want[0].shape[0]]
            s0, t0, a0, o0 = (w[idx] for w in want[:4])
            k, apply = want[4:]
            s1, t1, a1, o1 = got[:4]
            if not torch.equal((a0 & (s0 > t0[:, None])).sum(1), (a1 & (s1 > t1[:, None])).sum(1)):
                return ref, f"rank {r}'s decision {d}: other counts above the threshold"
            if apply and not torch.equal(o0[:, :k].sort(dim=1).values,
                                         o1[:, :k].sort(dim=1).values):
                return ref, f"rank {r}'s decision {d}: other kept tokens"
    return ref, None


def parity_temperature(label, fwd, x, halves, rows, first):
    """The first factor of ``parity_factors(first)`` (times T = 1, the
    controller's start) at which each rank's half takes the one-process
    decisions (:func:`rank_decisions`): ``(T, the one-process output)``."""
    for factor in parity_factors(first):
        ref, split = rank_decisions(fwd, x, halves, rows, factor)
        if split is None:
            return factor, ref
        log(f"[multiprocess] {label} T {factor:g}: {split}: the next temperature")
    raise AssertionError(f"{label}: at no temperature of PARITY_FACTORS do the ranks' halves "
                         "take the one-process step's DTP decisions")


def replayed_loss(step, state, ranks=2, **kw):
    """``fwd`` for :func:`rank_decisions` from a retrieval or CLIP train step:
    its ``loss_fn`` (alpha 0, as at epoch 0's first batch, and ``kw``) with
    the momentum towers put back after each call.  The one-process call on
    the global batch records the rows ``parallel.data.world_rows`` hands
    out; rank ``r``'s half gets those global rows back from it, in the same
    order, and its place in the global batch from ``batch_rows``, as the
    rank's gathers will give them."""
    from unittest import mock

    from madtp_tpu_torch.parallel import data

    seen = []

    def fwd(batch, t, r):
        saved = [p.clone() for p in state.params_m.values()]
        try:
            if r is None:
                seen.clear()

                def record(x, grad=False):
                    seen.append(x)
                    return x
                with mock.patch.object(data, "world_rows", record):
                    return step.loss_fn(*batch, t, 0.0, **kw)
            given = iter(seen)
            with mock.patch.object(data, "world_rows", lambda x, grad=False: next(given)), \
                    mock.patch.object(data, "batch_rows", lambda n: (r * n, ranks * n)):
                return step.loss_fn(*batch, t, 0.0, **kw)
        finally:
            for p, v in zip(state.params_m.values(), saved):
                p.copy_(v)
    return fwd


def retrieval_first_batches(config, image_size, encode, batch, ranks=2, seed=42):
    """The first train batch of each rank's shard, as the BLIP and CLIP
    retrieval drivers load it under ``ranks`` processes (``--seed`` 42)
    and their ``train_epoch`` hands it to the step: ``(images, text...,
    image ids)`` of each rank, ``encode(captions)`` the text tensors."""
    import types

    from madtp_tpu_torch.cli.common import train_image_transform
    from madtp_tpu_torch.data.datasets import CaptionTrainDataset
    from madtp_tpu_torch.data.loader import batched_loader
    from madtp_tpu_torch.data.transforms import PerSampleRng

    ds = CaptionTrainDataset(train_image_transform(types.SimpleNamespace(uint8_feed=False),
                                                   image_size, PerSampleRng(seed)),
                             config["image_root"], config["ann_root"],
                             dataset=config.get("dataset", "coco"))
    out = []
    for r in range(ranks):
        images, captions, idx = next(iter(batched_loader(
            ds, batch, shuffle=True, epoch=0, drop_last=True, num_shards=ranks, shard_id=r,
            num_workers=0)))
        out.append((torch.from_numpy(np.asarray(images)), *encode(list(captions)),
                    torch.as_tensor(np.asarray(idx), dtype=torch.long)))
    return out


def held_step(name, step_fn, queue, first, grad_params, model, sync, reduce_ms, gather_ms):
    """A rank's train step whose first call records its inputs, losses,
    named gradients, queue after the step (the global batch's columns, ids
    and pointer), wall, all-reduce and gathers' ms into ``first[name]``."""
    def held(*args, **kw):
        if name in first:
            return step_fn(*args, **kw)
        sync()
        reduce_ms.clear()
        gather_ms.clear()
        t0 = time.perf_counter()
        m = step_fn(*args, **kw)
        sync()
        named = dict(model.named_parameters())
        n = int(queue.ptr)
        first[name] = dict(inputs=[a.cpu() for a in args if torch.is_tensor(a)], t=args[-2],
                           step_ms=(time.perf_counter() - t0) * 1e3, reduce_ms=sum(reduce_ms),
                           gather_ms=sum(gather_ms),
                           metrics={k: float(v) for k, v in m.items()},
                           grads={g: named[g].grad.cpu() for g in grad_params},
                           queue=(queue.image[:, :n].cpu(), queue.text[:, :n].cpu(),
                                  queue.idx[:n].cpu(), n))
        return m
    return held


MP_CLIP_DEPTH = (6, 4)  # phase 29's CLIP ViT-L/14@336: vision and text layers (full width)


def mp_clip_grads(cfg):
    """``CLIP_GRADS`` at ``cfg``'s depth: each tower's last block."""
    return tuple(n.replace("visual.transformer.resblocks.23",
                           f"visual.transformer.resblocks.{cfg.vision_layers - 1}")
                 .replace("transformer.resblocks.11.",
                          f"transformer.resblocks.{cfg.transformer_layers - 1}.")
                 for n in CLIP_GRADS)


def one_process_step(label, step, state, x, halves, rows, first, grad_params, sync, **kw):
    """The one-process retrieval or CLIP step on the global batch ``x`` at
    epoch 0's first batch (alpha 0), at the temperature where each rank's
    half takes its DTP decisions (``parity_temperature``): its losses, named
    gradients, queue after it (the global batch's columns, ids and pointer)
    and two walls (the second step from the state the first left)."""
    t, _ = parity_temperature(label, replayed_loss(step, state, **kw), x, halves, rows, first)
    model, q, step_ms = state.model, state.queue, []
    for _ in range(2):
        sync()
        t0 = time.perf_counter()
        metrics = step(*x, t, 0.0, **kw)
        sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if len(step_ms) == 1:
            named = dict(model.named_parameters())
            n = int(q.ptr)
            want = dict(t=t, metrics={k: float(v) for k, v in metrics.items()},
                        grads={g: named[g].grad.cpu() for g in grad_params},
                        queue=(q.image[:, :n].cpu(), q.text[:, :n].cpu(), q.idx[:n].cpu(), n))
    want["step_ms"] = step_ms
    log(f"[multiprocess] {label}: one-process step on the global batch ({x[0].shape[0]} pairs) "
        f"at T {t:g}, where each rank's half takes its DTP decisions: {want['metrics']}; step "
        f"{step_ms[0]:.1f} ms, again {step_ms[1]:.1f} ms")
    return want


def check_first_steps(label, got, want, built):
    """Each rank's first train step of ``label`` against the one-process step
    on the global batch: the batch built here, the temperature, losses
    (1e-4), named gradients (``GRAD_TOL`` of each tensor's largest) and, where
    ``want`` has one, the queue after the step (features 1e-5, ids and
    pointer equal, both ranks' bit-equal).  Returns the gradients' relative
    differences."""
    rel = {}
    for r, g in enumerate(got):
        f = g["first"][label]
        if not all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(f["inputs"], built[r])):
            raise AssertionError(f"{label}: rank {r}'s first train batch is not the one built here")
        if f["t"] != want["t"]:
            raise AssertionError(f"{label}: rank {r} trained at T {f['t']}, not {want['t']}")
        err = max(abs(f["metrics"][k] - v) for k, v in want["metrics"].items())
        if not err <= 1e-4:
            raise AssertionError(f"{label}: rank {r}: losses {f['metrics']} against "
                                 f"{want['metrics']}")
        for n, w in want["grads"].items():
            rel[n] = float((f["grads"][n] - w).abs().max()) / float(w.abs().max())
            if not (torch.isfinite(f["grads"][n]).all() and rel[n] <= GRAD_TOL):
                raise AssertionError(f"{label}: rank {r}: grad of {n} differs by {rel[n]:.3e} "
                                     "of its max")
        if "queue" in want:
            (img, txt, idx, n), (wi, wt, widx, wn) = f["queue"], want["queue"]
            qerr = max(float((img - wi).abs().max()), float((txt - wt).abs().max()))
            if n != wn or not torch.equal(idx, widx) or not qerr <= 1e-5:
                raise AssertionError(f"{label}: rank {r}: queue after the step {qerr:.2e} "
                                     f"from one process's, pointer {n} against {wn}")
            if not all(torch.equal(a, b) for a, b in zip(f["queue"][:3],
                                                         got[0]["first"][label]["queue"][:3])):
                raise AssertionError(f"{label}: the ranks' queues differ")
    return rel


def phase_multiprocess(device, kept, clip_cfg=None, clip_override=None):
    """Phase 29: multi-process runs.  (a) ``nccl_one_rank``.  (b) two ranks
    under ``--dist_backend gloo`` on the one card, spawned here with
    ``torch.multiprocessing``, each running, on the PNG fixtures of phases
    26-27 (``kept``): the BLIP
    retrieval driver training ``--epoch 1`` at
    ``configs/retrieval_coco.yaml``'s widths (ViT-B/16@384,
    ``negative_all_rank``, queue 57,600) from its seeded init, 8 pairs a
    rank; the CLIP driver training ``--epoch 1`` on a seeded ViT-L/14@336
    checkpoint at full width and ``MP_CLIP_DEPTH`` (the full depth trains
    in phases 24-25 and 27), 8 pairs a rank.

    * Each driver's first train step spans both ranks (DTP's counts, the
      gradients, the ITC, the hard negatives and the queue over the global
      batch): its losses (1e-4), named gradients (1e-3 of each tensor's
      largest) and queue after the step (1e-5) against the
      one-process step on the same global batch from the same seeded init
      (BLIP: the same hard-negative noise, the driver's generator seeded
      alike), here, before the ranks start.  Each epoch 0 runs at the first
      of ``PARITY_FACTORS`` (times T = 1, the controller's start) at which
      each rank's half, run here at the rank's batch shape with the global
      counts and rows handed in
      (``rank_decisions``), takes the one-process step's DTP decisions: the
      ranks' smaller GEMMs round otherwise, and the fixture's augmented
      images hold identical patches, whose exact ties no margin clears.
      The ranks' first batches must equal the ones built here.
    * Both ranks print the same ``LOG:`` lines; only rank 0 writes the
      logs, the config and the checkpoints.
    * The BLIP run's opening eval (the seeded init at T = 1, before any
      step) gives each rank the scores of phase 27's one-process train
      run's opening eval, bit for bit: the sharded eval held to one
      process without a run of its own.
    * Each rank's K1, K2, K4 and K5 launches of every run, summed: the
      ``multiprocess`` path of the kernels line; every one of them
      launched, and each training run launched its family's kernels.

    A rank that fails fails the phase (``torch.multiprocessing`` ends the
    other).  The CPU rehearsal passes a tiny ``clip_cfg`` and
    ``clip_override``.  Returns the summed launch counts."""
    import dataclasses
    import shutil

    import torch.multiprocessing as tmp
    import yaml

    from madtp_tpu_torch.ckpt.convert import load_clip_state_dict, save_clip_checkpoint
    from madtp_tpu_torch.cli.common import build_blip_cfg, read_checkpoint
    from madtp_tpu_torch.core.config import infer_clip_config
    from madtp_tpu_torch.data.tokenizer_bert import BertWordPieceTokenizer
    from madtp_tpu_torch.data.tokenizer_clip import ClipBPETokenizer, clip_tokenize
    from madtp_tpu_torch.kernels.build import BUILD_DIR
    from madtp_tpu_torch.models.blip import init_retrieval_model
    from madtp_tpu_torch.models.clip import init_clip_model
    from madtp_tpu_torch.tasks.retrieval import MAX_LENGTH
    from madtp_tpu_torch.train.losses import gumbel
    from madtp_tpu_torch.train.loops import (init_clip_train_state, init_retrieval_train_state,
                                             make_clip_train_step, make_retrieval_train_step)
    from madtp_tpu_torch.train.optim import make_adamw

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    def free():
        if device.type == "cuda":
            torch.cuda.empty_cache()

    if device.type == "cuda":
        nccl_one_rank(device)
    root = kept["root"]
    out = BUILD_DIR / "mp_runs"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    tokenizer = BertWordPieceTokenizer(str(root / "vocab.txt"))

    # the one-process BLIP retrieval step: the driver's seeded init, queue and generator
    small = ["--batch_size_train", "8", "--batch_size_test", "8"]
    with open(kept["yaml"]) as f:
        rconfig = yaml.safe_load(f)
    rsize = int(rconfig.get("image_size", 384))
    rcfg = build_blip_cfg(rconfig, rsize)
    rb = 8

    def bert(captions):
        tok = tokenizer(captions, padding="max_length", max_length=MAX_LENGTH)
        return (torch.as_tensor(np.asarray(tok["input_ids"]), dtype=torch.long),
                torch.as_tensor(np.asarray(tok["attention_mask"]), dtype=torch.long))

    built = {"retrieval_train": retrieval_first_batches(rconfig, rsize, bert, rb)}
    rows = [{2 * rb: torch.arange(r * rb, (r + 1) * rb),
             6 * rb: torch.cat([torch.arange(r * rb, (r + 1) * rb) + k * 2 * rb
                                for k in range(3)])} for r in range(2)]
    t_one = time.perf_counter()
    model = init_retrieval_model(rcfg, seed=42, device=device,
                                 embed_dim=16 if rcfg.med.hidden_size <= 64 else 256)
    state = init_retrieval_train_state(model, queue_size=rconfig.get("queue_size", 57600))
    step = make_retrieval_train_step(
        state, make_adamw(model.parameters(), lr=0.0, weight_decay=0.0),
        enc_token_id=tokenizer.enc_token_id,
        negative_all_rank=bool(rconfig.get("negative_all_rank", False)), device=device.type)
    g = torch.Generator(device=device).manual_seed(42)  # the driver's, --seed 42
    noise = tuple(gumbel((2 * rb, 2 * rb), generator=g, device=device) for _ in range(2))
    x = [torch.cat([h[i] for h in built["retrieval_train"]]).to(device) for i in range(4)]
    wants = {"retrieval_train": one_process_step(
        "retrieval", step, state, x, built["retrieval_train"], rows, 1.0, RETRIEVAL_GRADS, sync,
        noise=noise)}
    del model, state, step, x, noise
    free()

    # the one-process CLIP step on a seeded full-width checkpoint at MP_CLIP_DEPTH
    ccfg = clip_cfg or dataclasses.replace(clip_config(), vision_layers=MP_CLIP_DEPTH[0],
                                           transformer_layers=MP_CLIP_DEPTH[1])
    pth = out / "clip_mp.pth"
    save_clip_checkpoint(init_clip_model(ccfg, seed=29, device=device), str(pth), epoch=0,
                         temperature=0.0)
    clip_yaml = driver_yaml("retrieval_flickr_clip.yaml", root, out / "clip.yaml",
                            **(clip_override or {}))
    with open(clip_yaml) as f:
        cconfig = yaml.safe_load(f)
    sd, _ = read_checkpoint(str(pth))
    model = load_clip_state_dict(sd, infer_clip_config(sd, cconfig.get("sd_dim", 768)),
                                 device=device)
    del sd
    ctok = ClipBPETokenizer()
    context = model.cfg.context_length
    built["clip_train"] = retrieval_first_batches(
        cconfig, model.cfg.image_resolution,
        lambda caps: (torch.from_numpy(clip_tokenize(ctok, caps, context).astype(np.int64)),),
        rb)
    state = init_clip_train_state(model, queue_size=cconfig.get("queue_size", 57600))
    step = make_clip_train_step(state, make_adamw(model.parameters(), lr=0.0, weight_decay=0.0),
                                device=device.type)
    x = [torch.cat([h[i] for h in built["clip_train"]]).to(device) for i in range(3)]
    clip_grads = mp_clip_grads(model.cfg)
    wants["clip_train"] = one_process_step("clip", step, state, x, built["clip_train"],
                                           [{2 * rb: v[2 * rb]} for v in rows], 1.0,
                                           clip_grads, sync)
    del model, state, step, x
    free()
    log(f"[multiprocess] retrieval and CLIP one-process steps, their temperature searches "
        f"and the CLIP checkpoint: {time.perf_counter() - t_one:.1f} s")

    # phase 27's one-process train run dumped the scores of its opening eval (the
    # seeded init at T 1), which the ranks' retrieval training run opens with too
    one = np.load(kept["scores"])
    plan = dict(device=device.type, coordinator=f"127.0.0.1:{_free_port()}", out=str(out),
                temperatures={"retrieval_train": wants["retrieval_train"]["t"],
                              "clip_train": wants["clip_train"]["t"]},
                retrieval_grads=RETRIEVAL_GRADS, clip_grads=clip_grads,
                argv={"retrieval_train": ["--config", str(kept["yaml"]), "--epoch", "1",
                                          "--pretrained", "", "--p", "0.1", *small],
                      "clip_train": ["--config", str(clip_yaml), "--epoch", "1", "--pretrained",
                                     str(pth), "--p", str(CLIP_DRIVER_P), *small]})
    t0 = time.perf_counter()
    tmp.start_processes(_mp_rank, args=(plan,), nprocs=2, join=True, start_method="spawn")
    wall = time.perf_counter() - t0
    got = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(2)]

    # the retrieval and CLIP drivers: the first steps and queues against one process
    rel_r = check_first_steps("retrieval_train", got, wants["retrieval_train"],
                              built["retrieval_train"])
    rel_c = check_first_steps("clip_train", got, wants["clip_train"], built["clip_train"])
    if got[0]["logs"] != got[1]["logs"] or not got[0]["logs"]:
        raise AssertionError(f"the ranks logged {got[0]['logs']} and {got[1]['logs']}")
    runs = ("retrieval_train", "clip_train")
    for label in runs:
        files = [sorted(p.name for p in (out / f"{label}_r{r}").iterdir()
                        if not p.name.startswith(("scores_", "clip_sims_"))) for r in range(2)]
        if files[1] or not {"config.yaml", "log.txt", "resume_ckpt"} <= set(files[0]):
            raise AssertionError(f"{label}: rank 0 wrote {files[0]}, rank 1 {files[1]}")

    # the retrieval training run's opening eval against one process
    for r in range(2):
        s = np.load(out / f"retrieval_train_r{r}" / f"scores_r{r}.npz")
        if not (np.array_equal(s["i2t"], one["i2t"]) and np.array_equal(s["t2i"], one["t2i"])):
            raise AssertionError(f"rank {r}: retrieval scores differ from one process's")
    launches = {k: sum(g["launches"][run][k] for g in got for run in runs)
                for k in ("K1", "K2", "K4", "K5")}

    def short(n):
        return (n.replace("visual_encoder.", "v.").replace("text_encoder.encoder.", "t.")
                .replace("visual.transformer.", "v.").replace("transformer.", "t."))

    def firsts_of(label):
        return (f"{[round(g['first'][label]['step_ms'], 1) for g in got]} ms (its gloo "
                f"all-reduce {[round(g['first'][label]['reduce_ms'], 1) for g in got]} ms, its row "
                f"gathers {[round(g['first'][label]['gather_ms'], 1) for g in got]} ms; one "
                f"process {wants[label]['step_ms'][1]:.1f} ms)")

    log(f"[multiprocess] two gloo ranks on {card_line() if device.type == 'cuda' else 'cpu'}: "
        f"{wall:.1f} s from spawn to join; driver runs by rank: " + ", ".join(
            f"{run} {[round(g['walls'][run], 1) for g in got]} s" for run in runs))
    for label, name, r_ in (("retrieval_train", "BLIP retrieval", rel_r),
                            ("clip_train", "CLIP", rel_c)):
        f = got[0]["first"][label]
        qerr = max(float((a - b).abs().max()) for a, b in zip(f["queue"][:2],
                                                              wants[label]["queue"][:2]))
        log(f"[multiprocess] {name} first step at T {f['t']:g} {firsts_of(label)}: losses "
            f"{f['metrics']} (one process {wants[label]['metrics']}), grad max|diff| / "
            f"max|grad| " + ", ".join(f"{short(n)} {v:.2e}" for n, v in r_.items())
            + f"; queue after the step {qerr:.2e} from one process's, ids and pointer equal, "
            "bit-equal on both ranks")
    log(f"[multiprocess] LOG lines equal ({len(got[0]['logs'])}); retrieval scores bit-equal; "
        f"launches by rank {[g['launches'] for g in got]}")
    if device.type == "cuda":
        if min(launches.values()) == 0:
            raise AssertionError(f"multiprocess launches {launches}: a kernel was not launched")
        for g in got:
            lr_, lc = g["launches"]["retrieval_train"], g["launches"]["clip_train"]
            if min(lr_.values()) == 0 or min(lc[k] for k in ("K1", "K2", "K5")) == 0 or lc["K4"]:
                raise AssertionError(f"multiprocess training launches: BLIP retrieval {lr_} "
                                     f"(want K1, K2, K4, K5), CLIP {lc} (want K1, K2, K5)")
    shutil.rmtree(out)
    shutil.rmtree(kept["dir"])
    shutil.rmtree(kept["root"])
    return launches


# ---- phase 30: the stochastic and legacy paths ----

RECIPE_RATE = 0.1  # phase 30's drop-path and dropout rates: the reference recipe's


def recipe_config(cfg, rate=RECIPE_RATE):
    """``cfg`` with the training recipe's rates: ``drop_path_rate`` of the
    ViT, both dropout probabilities of the MED."""
    import dataclasses

    return cfg._replace(vit=dataclasses.replace(cfg.vit, drop_path_rate=rate),
                        med=dataclasses.replace(cfg.med, hidden_dropout_prob=rate,
                                                attention_probs_dropout_prob=rate))


class MaskStream:
    """While active, wraps ``ops.layers.keep_mask``, where the port draws
    every dropout and drop-path mask: records each mask with its keep
    probability, or, given ``replay`` (another stream's records), hands
    those masks out in order on the caller's device instead of drawing."""

    def __init__(self, replay=None):
        self.replay = None if replay is None else list(replay)

    def __enter__(self):
        from madtp_tpu_torch.ops import layers

        self.masks, self._mod, self._orig = [], layers, layers.keep_mask

        def keep_mask(shape, p, generator, device):
            if self.replay is None:
                m = self._orig(shape, p, generator, device)
            else:
                m = self.replay.pop(0)[1]
                if tuple(m.shape) != tuple(shape):
                    raise AssertionError(f"a replayed mask of {tuple(m.shape)} where the path "
                                         f"draws {tuple(shape)}")
                m = m.to(device)
            self.masks.append((float(p), m))
            return m

        layers.keep_mask = keep_mask
        return self

    def __exit__(self, exc, *_):
        self._mod.keep_mask = self._orig
        if exc is None and self.replay:
            raise AssertionError(f"{len(self.replay)} replayed masks were not drawn")


def kept_shares(label, masks):
    """Each mask's kept share against its keep probability ``q``: within 6
    binomial standard deviations ``sqrt(q (1 - q) / n)`` (exactly ``q`` at
    ``q`` = 1).  Returns the largest deviation in standard deviations."""
    shares = torch.stack([m.float().mean() for _, m in masks]).cpu().tolist()
    worst = 0.0
    for (q, m), share in zip(masks, shares):
        sd = math.sqrt(q * (1.0 - q) / m.numel())
        if abs(share - q) > 6 * sd + 1e-12:
            raise AssertionError(f"{label}: a mask of {tuple(m.shape)} kept {share:.5f}, want "
                                 f"{q:.5f} within 6 x {sd:.2e}")
        worst = max(worst, abs(share - q) / sd if sd else 0.0)
    return worst


class DrawRecorder:
    """While active, records the scores of every nucleus draw
    (``tasks.caption._draw``: the filtered logits plus the Gumbel noise,
    [B, V]) as fp32 CPU tensors."""

    def __enter__(self):
        from madtp_tpu_torch.tasks import caption

        self.scores, self._mod, self._orig = [], caption, caption._draw

        def draw(filt, noise):
            self.scores.append((filt + noise).float().cpu())
            return self._orig(filt, noise)

        caption._draw = draw
        return self

    def __exit__(self, *exc):
        self._mod._draw = self._orig


def stochastic_counts():
    """K1, K2, K4 and K5 launches (every dtype) since the last zeroing."""
    from madtp_tpu_torch.kernels.attention_scores import attention_scores_cuda
    from madtp_tpu_torch.kernels.attention_scores_bwd import attention_scores_bwd_cuda
    from madtp_tpu_torch.kernels.cross_attention import cross_attention_cuda
    from madtp_tpu_torch.kernels.ffn import ffn_cuda

    torch.cuda.synchronize()
    return dict(K1=attention_scores_cuda.launches, K2=attention_scores_bwd_cuda.launches,
                K4=cross_attention_cuda.launches, K5=ffn_cuda.launches)


def _grads_equal(a, b):
    """Every gradient bit-equal, but the word embeddings', a scatter-add of
    the tokens' rows whose order of addition PyTorch does not fix (on the
    card nor on the CPU's threads): those within 1e-6 of their largest."""
    def same(n):
        if n.endswith("word_embeddings.weight"):
            return float((a[n] - b[n]).abs().max()) <= 1e-6 * float(a[n].abs().max())
        return torch.equal(a[n], b[n])
    return a.keys() == b.keys() and all(same(n) for n in a)


def stochastic_training(device, nlvr_cpu, tokenizer, pairs=16, text_len=26, batch=32,
                        temperature=1.0):
    """Phase 30's dropout training at full width, its main path: the NLVR
    train step (``configs/nlvr.yaml``'s width, 16 pairs) with ``use_dropout``
    (drop-path and dropout ``RECIPE_RATE``) in fp32 mask mode twice from one
    generator seed (bit-equal losses, whole-model gradients and masks), the
    ``--fast_train --amp`` step twice (gather mode: only the text embeddings
    drop out, as in the JAX package), the caption train step
    (``configs/caption_coco.yaml``'s batch, 32) twice from one seed; each
    mask's kept share near its keep probability; then, off the main path,
    the NLVR step with every rate 0 against the step without dropout, bit
    for bit (fp32); K1, K2, K4 and K5 held on the main path's inputs.
    Returns the launches."""
    from madtp_tpu_torch.core.config import caption_config
    from madtp_tpu_torch.models.blip import init_caption_model
    from madtp_tpu_torch.prune.calibrate import fast_capacity_schedule
    from madtp_tpu_torch.tasks import caption as TC
    from madtp_tpu_torch.train.loops import make_caption_train_step, make_nlvr_train_step
    from madtp_tpu_torch.train.optim import make_adamw

    dcfg = nlvr_cpu.cfg
    t_setup = time.perf_counter()
    model = copy.deepcopy(nlvr_cpu).to(device)
    opt = make_adamw(model.parameters(), lr=0.0, weight_decay=0.0)  # the weights stay
    images, ids, mask = synthetic_inputs(dcfg, pairs, text_len, seed=30)
    targets = torch.from_numpy(np.random.RandomState(30).randint(0, 2, pairs))
    x = [t.to(device) for t in (images, ids, mask, targets)]
    step = make_nlvr_train_step(model, opt, use_dropout=True, device=device.type)

    def run(step_fn, args, params, seed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step_fn(*args, temperature, generator=torch.Generator().manual_seed(seed))
        torch.cuda.synchronize()
        return ({k: v.clone() for k, v in m.items()},
                {n: p.grad.clone() for n, p in params.named_parameters() if p.grad is not None},
                (time.perf_counter() - t0) * 1e3)

    with torch.no_grad():
        ref = model(*x[:3], temperature=temperature, prune_active=True)
    caps = fast_capacity_schedule(ref.v_kept.cpu().numpy(), ref.t_kept.cpu().numpy(), "ceil")
    step_amp = make_nlvr_train_step(model, opt, use_dropout=True, capacities_v=caps[0],
                                    capacities_t=caps[1], amp=True, device=device.type)
    ccfg = recipe_config(caption_config())
    rng = np.random.default_rng(30)
    s = ccfg.vit.image_size
    cbatch = [torch.from_numpy(rng.standard_normal((batch, 3, s, s), dtype=np.float32))] + [
        torch.from_numpy(a) for a in TC.train_batch(
            tokenizer, [TC.PROMPT + train_words(rng, 7, 14) for _ in range(batch)],
            len(tokenizer.encode(TC.PROMPT)) - 1)]
    cx = [t.to(device) for t in cbatch]
    cmodel = init_caption_model(ccfg, seed=0, device=device)
    cstep = make_caption_train_step(cmodel, make_adamw(cmodel.parameters(), lr=0.0,
                                                       weight_decay=0.0),
                                    use_dropout=True, device=device.type)
    log(f"[stochastic] training set-up (the two models, their batches): "
        f"{time.perf_counter() - t_setup:.1f} s")

    # ---- the main path: launch counts zeroed just before, read just after ----
    caps_k = (K1Capture(), K2Capture(), K4Capture(), K5Capture())
    zero_launch_counts()
    t_main = time.perf_counter()
    with contextlib.ExitStack() as stack:
        for c in caps_k:
            stack.enter_context(c)
        with MaskStream() as ms_a:
            a = run(step, x, model, 1)
        with MaskStream() as ms_b:
            b = run(step, x, model, 1)
        with MaskStream() as ms_amp:
            amp = run(step_amp, x, model, 2)
        amp2 = run(step_amp, x, model, 2)
        with MaskStream() as ms_c:
            c1 = run(cstep, cx, cmodel, 3)
        c2 = run(cstep, cx, cmodel, 3)
    launches = stochastic_counts()
    wall = time.perf_counter() - t_main

    L, Lt = dcfg.vit.depth, dcfg.med.num_hidden_layers
    if len(ms_a.masks) != 2 * L + 1 + 3 * Lt or len(ms_amp.masks) != 1 or \
            len(ms_c.masks) != 2 * ccfg.vit.depth:
        raise AssertionError(f"masks drawn: NLVR {len(ms_a.masks)}, amp {len(ms_amp.masks)}, "
                             f"caption {len(ms_c.masks)}; want {2 * L + 1 + 3 * Lt}, 1, "
                             f"{2 * ccfg.vit.depth}")
    if not all(torch.equal(m, n) for (_, m), (_, n) in zip(ms_a.masks, ms_b.masks)):
        raise AssertionError("the same generator seed drew other masks")
    for label, (r1, r2) in (("nlvr", (a, b)), ("nlvr amp", (amp, amp2)), ("caption", (c1, c2))):
        if not (all(torch.equal(r1[0][k], r2[0][k]) for k in r1[0]) and
                _grads_equal(r1[1], r2[1])):
            differ = [n for n in r1[1] if not _grads_equal({n: r1[1][n]}, {n: r2[1].get(n)})]
            raise AssertionError(f"{label}: the same generator seed gave losses {r1[0]} and "
                                 f"{r2[0]}, gradients that differ in {differ[:4]}")
    if not all(torch.isfinite(v).all() for r in (a, amp, c1) for v in r[0].values()):
        raise AssertionError("a dropout step's loss is not finite")
    sds = kept_shares("stochastic", ms_a.masks + ms_amp.masks + ms_c.masks)
    log(f"[stochastic] training main path {wall:.1f} s: NLVR mask fp32 (16 pairs) "
        f"{a[2]:.1f} ms, again {b[2]:.1f} ms, bit-equal losses {({k: float(v) for k, v in a[0].items()})}, "
        f"gradients and masks; --fast_train amp {amp[2]:.1f} ms, again {amp2[2]:.1f} ms, "
        f"bit-equal ({({k: float(v) for k, v in amp[0].items()})}); caption fp32 (32) "
        f"{c1[2]:.1f} ms, again "
        f"{c2[2]:.1f} ms, bit-equal; {len(ms_a.masks) + len(ms_amp.masks) + len(ms_c.masks)} "
        f"masks, kept shares within {sds:.2f} sd of 1 - p; launches {launches}")
    del cmodel, cstep, step_amp, ref, a, b, amp, amp2, c1, c2, ms_a, ms_b, ms_amp, ms_c
    torch.cuda.empty_cache()

    # ---- off the main path: every rate 0 is the step without dropout (fp32) ----
    zero_cfg = recipe_config(dcfg, 0.0)
    model.visual_encoder.cfg, model.text_encoder.cfg = zero_cfg.vit, zero_cfg.med
    with MaskStream() as ms0:
        zero = run(step, x, model, 1)
    plain = run(make_nlvr_train_step(model, opt, device=device.type), x, model, 1)
    if not (all(torch.equal(zero[0][k], plain[0][k]) for k in plain[0])
            and _grads_equal(zero[1], plain[1])) or len(ms0.masks) != 2 * L:
        raise AssertionError("the fp32 step at rates 0 differs from the step without dropout")
    log(f"[stochastic] rates 0, fp32: losses and every gradient bit-equal to the step without "
        f"dropout ({len(ms0.masks)} drop-path masks drawn at rate 0); that step {zero[2]:.1f} ms, "
        f"the step without dropout {plain[2]:.1f} ms")
    del model, opt, zero, plain, ms0, x
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    check_k1_cases("stochastic training", caps_k[0], iters=3)
    check_k2_cases("stochastic training", caps_k[1], iters=2)
    check_k4_cases("stochastic training", caps_k[2], iters=3)
    check_k5_cases("stochastic training", caps_k[3], iters=3)
    log(f"[stochastic] training: K1, K2, K4, K5 held on the path's inputs in "
        f"{time.perf_counter() - t0:.1f} s")
    return launches


def stochastic_parity(device, nlvr_cpu, temperature=1.0):
    """Phase 30's dropout step card against CPU: one fp32 NLVR train forward
    and backward at full width, 1 pair (``phase_train_parity``'s size), mask
    mode, drop-path and dropout ``RECIPE_RATE``, the CPU's masks replayed on
    the card; ``train_parity``'s search and limits (losses 1e-4, gradients
    1e-3 of each tensor's largest): 12 K1 (the ViT; the MED's dropped-out
    self-attention runs the plain core, as in the JAX package), 12 K2, 24 K4
    and 24 fp32 K5 a step."""
    from madtp_tpu_torch.train.loops import make_nlvr_train_step

    dcfg = nlvr_cpu.cfg
    models = {"cpu": nlvr_cpu, "card": copy.deepcopy(nlvr_cpu).to(device)}
    images, ids, mask = synthetic_inputs(dcfg, pairs=1, text_len=26, seed=4)
    batch = (images, ids, mask, torch.tensor([1]))
    drawn = {}

    def run(where, t, caps, backward=True):
        model, dev = models[where], (device if where == "card" else torch.device("cpu"))
        step = make_nlvr_train_step(model, torch.optim.SGD(model.parameters(), lr=0.0),
                                    use_dropout=True, device=dev.type)
        with MaskStream(None if where == "cpu" else drawn[t]) as ms:
            out = train_run(model, loss_and_backward(step.loss_fn, backward),
                            GRAD_PARAMS if backward else (), *(a.to(dev) for a in batch), t,
                            generator=torch.Generator().manual_seed(11))
        if where == "cpu":
            drawn[t] = ms.masks
        return out

    L = dcfg.vit.depth
    train_parity("stochastic-parity", temperature, lambda t: {"mask": None}, run, GRAD_PARAMS,
                 dict(K1=L, K2=L, K4=2 * dcfg.med.num_hidden_layers,
                      K5=L + dcfg.med.num_hidden_layers), first=3.2)


def stochastic_nucleus(device, tokenizer, t_cap, batch=32, max_length=20, iters=3):
    """Phase 30's nucleus captioning: its main path at
    ``configs/caption_coco.yaml``'s width (batch 32, ``max_length`` 20,
    ``min_length`` 5, top-p 0.9, repetition penalty 1.1), bf16, gather mode at
    phase 16's temperature, the decoder through ``sharpen_decoder``: the
    encode and the decode as one captured step (``make_nucleus_step``) whose
    noise (``nucleus_noise``) is drawn before each call, twice with one draw
    (equal sequences), once with another; an eager run first, which must
    equal the graph's, for the kernels' inputs.  Then 2 images card against
    CPU, fp32, dense encode, the same noise: memory states within 1e-5, and
    equal sequences in every row where each draw's winning score stands >=
    64 fp32 steps and >= 4x the card's drift from the runner-up (else the
    step that does not is named).  Returns the launches."""
    from madtp_tpu_torch.core.config import caption_config
    from madtp_tpu_torch.models.blip import init_caption_model
    from madtp_tpu_torch.tasks import caption as TC

    cfg = caption_config()
    V = cfg.med.vocab_size
    cpu = init_caption_model(cfg, seed=0, device="cpu")
    sharpen_decoder(cpu.text_decoder, seed=1)
    model = copy.deepcopy(cpu).to(device=device, dtype=torch.bfloat16)
    s = cfg.vit.image_size
    images = np.random.default_rng(30).integers(0, 256, size=(batch, s, s, 3), dtype=np.uint8)
    im = torch.from_numpy(images).to(device)
    prompt = torch.from_numpy(TC.prompt_ids(tokenizer, batch)).to(device)
    steps = max_length - prompt.shape[1]
    caps = TC.probe_capacities(model, iter([(images, None)]), t_cap, "ceil")
    kw = dict(max_length=max_length, min_length=5, eos_token_id=SEP_ID, pad_token_id=0)
    eager = TC.make_nucleus_step(model, True, caps, graph=False, **kw)
    graphed = TC.make_nucleus_step(model, True, caps, **kw)
    g = torch.Generator(device=device).manual_seed(30)

    def noise():
        return TC.nucleus_noise(steps, batch, V, generator=g, device=device)

    n1 = noise()
    k_caps = (K1Capture(), K4Capture(), K5Capture())
    with k_caps[0], k_caps[1], k_caps[2]:
        want, _ = eager(im, prompt, t_cap, n1)
    zero_launch_counts()
    t0 = time.perf_counter()
    first, kept = graphed(im, prompt, t_cap, n1)  # warm-up and capture
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    again, _ = graphed(im, prompt, t_cap, n1)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    other, _ = graphed(im, prompt, t_cap, noise())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = stochastic_counts()
    if not (torch.equal(first, want) and torch.equal(again, want)):
        raise AssertionError("nucleus: the graph's sequences differ from the eager run's or "
                             "from themselves on the same noise")
    if torch.equal(other, want) or first.shape != (batch, max_length):
        raise AssertionError("nucleus: another noise draw gave the same sequences")
    seqs = want.cpu()
    eos = [(row == SEP_ID).nonzero() for row in seqs]
    if any(len(e) and int(e[0]) < 5 for e in eos):
        raise AssertionError("nucleus: an EOS before min_length")
    log(f"[stochastic] nucleus main path, bf16 gather, batch {batch} at T {t_cap:.4f} "
        f"(capacities {list(caps)}): capture and first call {t1 - t0:.2f} s, a replay "
        f"{(t2 - t1) * 1e3:.1f} ms (noise [{steps}, {batch}, {V}] drawn before each); "
        f"{sum(len(e) > 0 for e in eos)} of {batch} rows end at EOS; launches {launches}; "
        f"{wall:.1f} s")
    del model, eager, graphed, n1
    torch.cuda.empty_cache()
    check_k1_cases("stochastic nucleus", k_caps[0], iters=iters)
    check_k4_cases("stochastic nucleus", k_caps[1], iters=iters)
    check_k5_cases("stochastic nucleus", k_caps[2], iters=iters)

    # ---- card against CPU: 2 images, fp32, dense, the same noise ----
    card = copy.deepcopy(cpu).to(device)
    im2 = torch.from_numpy(images[:2])
    p2 = prompt[:2].cpu()
    n2 = TC.nucleus_noise(steps, 2, V, generator=torch.Generator().manual_seed(31),
                          device="cpu")

    def run(m):
        dev = m.space_dict.device
        with DrawRecorder() as rec, torch.inference_mode():
            state, _, _ = m.encode_image(im2.to(dev))
            out = TC.nucleus_generate(m.text_decoder, state, p2.to(dev), noise=n2.to(dev), **kw)
        return out.cpu(), state.x.float().cpu(), rec.scores

    t0 = time.perf_counter()
    want_s, want_x, want_d = run(cpu)
    got_s, got_x, got_d = run(card)
    err_x = float((got_x - want_x).abs().max())
    if not err_x <= 1e-5:
        raise AssertionError(f"nucleus parity: memory states differ by {err_x:.3e}")
    checked, named = 0, []
    for r in range(2):
        same = int((got_s[r] != want_s[r]).nonzero()[0]) if not torch.equal(
            got_s[r], want_s[r]) else max_length
        upto = min(len(want_d), same - p2.shape[1] + 1)
        drift, clear = 0.0, True
        for i in range(upto):
            a, b = want_d[i][r], got_d[i][r]
            inside = (a > TC.NEG / 2) & (b > TC.NEG / 2)
            drift = max(drift, float((a - b)[inside].abs().max()))
        ends = (want_s[r][p2.shape[1]:] == SEP_ID).nonzero()
        last = int(ends[0]) + 1 if len(ends) else len(want_d)  # the draws up to its EOS
        for i in range(last):
            top = want_d[i][r].topk(2).values
            gap = float(top[0] - top[1])
            if gap < GAP_MIN * float(top[0].abs()) or gap < DRIFT_FACTOR * drift:
                clear = False
                named.append(f"row {r} step {i}: margin {gap:.3e}, drift {drift:.3e}")
                break
        if clear:
            checked += 1
            if same != max_length:
                raise AssertionError(f"nucleus parity: row {r} differs at position {same} "
                                     f"though every draw stands clear: card "
                                     f"{got_s[r].tolist()}, cpu {want_s[r].tolist()}")
    log(f"[stochastic] nucleus card against CPU (2 images, fp32, dense): memory states "
        f"within {err_x:.2e}; {checked} of 2 rows clear of the margin rule and equal"
        + (f"; not clear: {named}" if named else "")
        + f"; rows equal {[torch.equal(got_s[r], want_s[r]) for r in range(2)]}; "
        f"{time.perf_counter() - t0:.1f} s")
    return launches


def stochastic_legacy(device, cfg, batch=3, queue_size=256):
    """Phase 30's legacy heads at full width (``retrieval_config``'s BLIP
    plus a 12-layer caption decoder: ``PretrainModel``), fp32, seeded
    weights, card against CPU: ``blip_itm_logits``' ITM and ITC heads on a
    retrieval batch (3 images, 3 captions, one padded; two of one image) over the dense image
    states, and ``blip_pretrain_losses`` (ITC against a queue of 256, the
    two hard negatives from one Gumbel draw made on the CPU, ITM, LM) on one
    batch: logits and losses within 1e-4.  The card side is the main path;
    K4 and K5 held on its inputs.  Returns the launches."""
    from madtp_tpu_torch.models.blip import (blip_itm_logits, blip_pretrain_losses,
                                             init_pretrain_model)
    from madtp_tpu_torch.train.losses import gumbel
    from madtp_tpu_torch.train.momentum import init_queue

    models = {"cpu": init_pretrain_model(cfg, seed=0, device="cpu")}
    models["card"] = copy.deepcopy(models["cpu"]).to(device)
    rng = np.random.RandomState(30)
    s, V = cfg.vit.image_size, cfg.med.vocab_size
    images = torch.from_numpy(rng.randn(batch, 3, s, s).astype(np.float32))
    ids = torch.from_numpy(rng.randint(1000, V - 2, size=(batch, 35)))
    ids[:, 0] = CLS_ID
    mask = torch.ones_like(ids)
    mask[-1, 20:] = 0
    dec = torch.from_numpy(rng.randint(1000, V - 2, size=(batch, 20)))
    dec[:, 0] = DEC_ID
    dec_mask = torch.ones_like(dec)
    dec_mask[0, 14:] = 0
    labels = torch.where(dec_mask == 0, -100, dec)
    idx = torch.tensor([0, 1, 1, 2])[:batch]  # two captions of one image
    g = torch.Generator().manual_seed(30)
    noise = tuple(gumbel((batch, batch), generator=g) for _ in range(2))
    out, launches, k_caps = {}, None, (K4Capture(), K5Capture())
    for where in ("cpu", "card"):
        model, dev = models[where], (device if where == "card" else torch.device("cpu"))
        t0 = time.perf_counter()
        args = [t.to(dev) for t in (images, ids, mask, dec, dec_mask, labels, idx)]
        with contextlib.ExitStack() as stack, torch.no_grad():
            if where == "card":
                for c in k_caps:
                    stack.enter_context(c)
                zero_launch_counts()
            _, vout = model.image_features(args[0])
            itm = blip_itm_logits(model, args[1], args[2], vout.state, head="itm")
            itc = blip_itm_logits(model, args[1], args[2], vout.state, head="itc")
            losses = blip_pretrain_losses(model, *args, init_queue(256, queue_size, 3, dev),
                                          torch.tensor(0.07, device=dev), enc_token_id=ENC_ID,
                                          noise=tuple(n.to(dev) for n in noise))
            if where == "card":
                launches = stochastic_counts()
        out[where] = ([itm.cpu(), itc.cpu()], [float(v) for v in losses],
                      time.perf_counter() - t0)
    err_l = max(float((a - b).abs().max()) for a, b in zip(out["card"][0], out["cpu"][0]))
    err_s = max(abs(a - b) for a, b in zip(out["card"][1], out["cpu"][1]))
    if not (err_l <= 1e-4 and err_s <= 1e-4) or not math.isfinite(sum(out["cpu"][1])):
        raise AssertionError(f"legacy heads: logits {err_l:.3e}, losses {err_s:.3e} apart "
                             "(limits 1e-4)")
    if device.type == "cuda" and (launches["K4"] != 3 * cfg.med.num_hidden_layers
                                  or launches["K5"] == 0):
        raise AssertionError(f"legacy heads: launches {launches}, want {3 * cfg.med.num_hidden_layers}"
                             " K4 (the ITM head, the pretrain ITM, the decoder) and K5")
    log(f"[stochastic] legacy heads card against CPU: ITM and ITC logits within {err_l:.2e}, "
        f"losses (ITA, ITM, LM) card {out['card'][1]} cpu {out['cpu'][1]} within {err_s:.2e}; "
        f"card {out['card'][2]:.1f} s, cpu {out['cpu'][2]:.1f} s; launches {launches}")
    del models
    check_k4_cases("stochastic legacy", k_caps[0], iters=3, where=dict(dtype="float32"))
    check_k5_cases("stochastic legacy", k_caps[1], iters=3)
    return launches


def phase_stochastic(device, tokenizer, t_cap):
    """30. The stochastic and legacy paths (``stochastic_training``,
    ``stochastic_parity``, ``stochastic_nucleus``, ``stochastic_legacy``),
    each on its ``[stochastic]`` lines; the first two share one NLVR model
    with the recipe's rates, drawn on the CPU.  Returns the launches of their
    main paths summed (the kernels line's ``stochastic`` path)."""
    from madtp_tpu_torch.models.blip import init_nlvr_model

    total = collections.Counter()
    nlvr = init_nlvr_model(recipe_config(full_config()), seed=0, device="cpu")
    for part, args in ((stochastic_training, (device, nlvr, tokenizer)),
                       (stochastic_parity, (device, nlvr)),
                       (stochastic_nucleus, (device, tokenizer, t_cap)),
                       (stochastic_legacy, (device, retrieval_config()))):
        t0 = time.perf_counter()
        got = part(*args)
        if got:
            total.update(got)
        torch.cuda.empty_cache()
        log(f"[stochastic] {part.__name__}: {time.perf_counter() - t0:.1f} s")
    if device.type == "cuda" and min(total[k] for k in ("K1", "K2", "K4", "K5")) == 0:
        raise AssertionError(f"stochastic launches {dict(total)}: a kernel was not launched")
    return dict(total)


# ---- phase 31: tensor parallelism, mesh serving, the native JPEG decode ----

TP_PAIRS = 4  # phase 31's NLVR eval: 4 pairs (8 images at 384 px), fp32
TP_SEED = 31
TP_CANDIDATES = 2  # temperatures clear of fp32 rounding one process, all run by the ranks
TP_FIRST_FACTOR = 3.2  # where phase 31's search settled in earlier runs of these seeds


def hold_planes(name, q, k, v, alive, bias, scale, iters=10):
    """K1's planes variant (a tensor-parallel MED's scoring attention on a
    rank's heads) against its plain version on one case, within
    ``PLANES_TOLERANCES``, a relaunch bit-identical; its time, the plain
    version's, SDPA's (``out`` only: less than the variant computes) and the
    bound (K1's work, the plane and the CLS row's two sums written).
    Returns the record for the kernels line."""
    import torch.nn.functional as F

    from madtp_tpu_torch.kernels.attention_scores import (PLANES_TOLERANCES,
                                                          attention_planes_cuda)
    from madtp_tpu_torch.ops.attention import attention_planes_plain

    dtype = q.dtype
    alive = alive.contiguous()
    bias_in = torch.zeros(alive.shape, device=q.device) if bias is None \
        else bias.float().contiguous()
    with torch.inference_mode():
        got = attention_planes_cuda(q, k, v, alive, bias_in, scale)
        want = attention_planes_plain(q, k, v, alive, bias, scale)
        errs = {n: check_close(f"K1 planes {n} {name}", g, w, *PLANES_TOLERANCES[dtype][n])
                for n, g, w in zip(("out", "plane", "num", "den"), got, want)}
        if not all(torch.equal(a, b) for a, b in
                   zip(got, attention_planes_cuda(q, k, v, alive, bias_in, scale))):
            raise AssertionError(f"K1 planes {name}: two launches on the same inputs differ")
        del got, want
        ms = kernel_ms(lambda: attention_planes_cuda(q, k, v, alive, bias_in, scale), iters)
        plain_ms = kernel_ms(lambda: attention_planes_plain(q, k, v, alive, bias, scale), 3)
        mask = sdpa_mask(alive, bias_in, dtype)
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        library_ms = kernel_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask, scale=scale), iters)
    B, N, H, _ = q.shape
    flops, nbytes = k1_work(q, alive)
    nbytes += 4 * B * (N - 1) * (N - 1)  # the plane, beside the sums k1_work counts
    rec = dict(max_abs_err=max(errs.values()), ms=ms, plain_ms=plain_ms, library_ms=library_ms,
               **bounds(flops, nbytes, dtype), shape=dict(B=B, N=N, H=H, dtype=str(dtype)[6:]))
    log(f"[tp] K1 planes {name} {str(dtype)[6:]}: max|err| out {errs['out']:.2e} plane "
        f"{errs['plane']:.2e} num {errs['num']:.2e} den {errs['den']:.2e}, bit-identical "
        f"relaunch | {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {rec['bound_ms']:.4f} ms "
        f"({rec['bound_by']}), sdpa (out only) {library_ms:.4f} ms")
    return rec


def tp_kernels(device, iters=10):
    """Phase 31 (a): the kernels at a tensor-parallel rank's shapes (the
    model axis 2 wide): K1's planes variant at the MED text side of the NLVR
    eval (32 pairs, 35 slots, BLIP's 12 heads halved), K4 on those 6 heads
    over the ViT's 577 slots, K5 on BLIP's F = 1536 (the gather ViT's rows)
    and CLIP-L's F = 2048, fp32 and bf16, each against its plain version.
    Returns ``{kernel: {dtype: record}}``."""
    out = collections.defaultdict(dict)
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype)[6:]
        q, k, v, alive, bias = k1_case(32, 35, with_bias=True, dtype=dtype, device=device, H=6)
        out["K1"][dt] = hold_planes("NLVR text B=32 N=35 H=6", q, k, v, alive, bias, 0.125,
                                    iters)
        q, k, v, alive, bias = k4_case(32, 35, 577, with_bias=False, dtype=dtype,
                                       device=device, H=6)
        key = (32, 35, 577, dtype, False)
        case = types.SimpleNamespace(cases={key: (q, k, v, alive, bias)},
                                     calls=collections.Counter({key: 1}))
        out["K4"][dt] = check_k4_cases("tp 6 heads", case, iters)
        for label, (M, D, F, act) in (("blip", (64 * 584, 768, 1536, "gelu")),
                                      ("clip_l", (32 * 577, 1024, 2048, "quick_gelu"))):
            x, w1, b1, w2, b2 = k5_case(M, D, F, device, dtype=dtype)
            out["K5"][f"{label}_{dt}"] = hold_k5(f"tp {label} M={M} D={D} F={F}", x, w1, b1, w2,
                                                 torch.zeros_like(b2), act, iters)
        del q, k, v, alive, bias, x, w1, b1, w2, b2
    torch.cuda.empty_cache()
    return out


def hold_rank_cases(planes, k4, k5):
    """Every case of K1's planes variant, K4 and K5 that a tensor-parallel
    rank's evals launched (one per distinct shape, as the captures recorded
    them) against its plain version on the rank's own inputs, in its dtype
    within the kernel's tolerances, a relaunch bit-identical.  Returns
    ``{kernel: (cases, calls, max_abs_err)}``."""
    from madtp_tpu_torch.kernels.attention_scores import PLANES_TOLERANCES, attention_planes_cuda
    from madtp_tpu_torch.kernels.cross_attention import TOLERANCES as K4_TOLERANCES
    from madtp_tpu_torch.kernels.cross_attention import cross_attention_cuda
    from madtp_tpu_torch.kernels.ffn import TOLERANCES as K5_TOLERANCES
    from madtp_tpu_torch.kernels.ffn import ffn_cuda
    from madtp_tpu_torch.ops.attention import attention_planes_plain, cross_attention_plain
    from madtp_tpu_torch.ops.layers import mlp_plain

    def held(name, kernel, plain, args, tolerances):
        got, want = kernel(*args), plain(*args)
        got, want = (o if isinstance(o, tuple) else (o,) for o in (got, want))
        err = max(check_close(f"{name} {i}", g, w, *tol)
                  for i, (g, w, tol) in enumerate(zip(got, want, tolerances)))
        again = kernel(*args)
        if not all(torch.equal(a, b) for a, b in zip(got, again if isinstance(again, tuple)
                                                     else (again,))):
            raise AssertionError(f"{name}: two launches on the same inputs differ")
        return err

    out = {}
    with torch.inference_mode():
        errs = []
        for key, (q, k, v, alive, bias, scale) in planes.cases.items():
            tol = PLANES_TOLERANCES[key[3]]
            errs.append(held(f"tp K1 planes B={key[0]} N={key[1]} H={key[2]}",
                             attention_planes_cuda,
                             attention_planes_plain, (q, k, v, alive, bias, scale),
                             [tol[n] for n in ("out", "plane", "num", "den")]))
        out["K1"] = (len(errs), sum(planes.calls.values()), max(errs, default=0.0))
        errs = []
        for key, (q, k, v, alive, bias) in k4.cases.items():
            bias = None if bias is None else bias.float().contiguous()
            errs.append(held(f"tp K4 B={key[0]} Nq={key[1]} S={key[2]}", cross_attention_cuda,
                             cross_attention_plain,
                             (q, k, v, alive.contiguous(), bias, q.shape[-1] ** -0.5),
                             [K4_TOLERANCES[key[3]]]))
        out["K4"] = (len(errs), sum(k4.calls.values()), max(errs, default=0.0))
        errs = []
        for key, case in k5.cases.items():
            errs.append(held(f"tp K5 M={key[0]} D={key[1]} F={key[2]} {key[3]}", ffn_cuda,
                             mlp_plain, case, [K5_TOLERANCES[key[4]]]))
        out["K5"] = (len(errs), sum(k5.calls.values()), max(errs, default=0.0))
    return out


def time_rank_cases(planes, k4, k5):
    """The most-called case of each kernel a tensor-parallel rank's evals
    launched, held and timed as the other phases' recorded cases are
    (``hold_planes``, ``check_k4_cases``, ``hold_k5``): the records for the
    kernels line."""
    records = {}
    key, n = planes.calls.most_common(1)[0]
    records["K1"] = hold_planes(f"NLVR eval rank B={key[0]} N={key[1]} H={key[2]} ({n} calls)",
                                *planes.cases[key])
    key, n = k4.calls.most_common(1)[0]
    records["K4"] = check_k4_cases("tp NLVR eval rank", types.SimpleNamespace(
        cases={key: k4.cases[key]}, calls=collections.Counter({key: n})), 10)
    key, n = k5.calls.most_common(1)[0]
    records["K5"] = hold_k5(f"tp NLVR eval rank M={key[0]} D={key[1]} F={key[2]} ({n} calls)",
                            *k5.cases[key], 5)
    return records


def _tp_rank(rank, plan):
    """One of phase 31's two ranks (spawned): the NLVR model of the plan's
    config with the phase's seeded weights (read from the mesh artifact's
    file), sharded over a 1x2 mesh (gloo, the one card), its
    mask and gather eval at each candidate temperature with the DTP
    decisions recorded, the launches of those runs (counted from 0 just
    before them); on the card every K1-planes, K4 and K5 case of those runs
    held against its plain version (``hold_rank_cases``, both ranks) and
    rank 0's most-called case of each timed (``time_rank_cases``, rank 1
    waiting); written to ``plan["out"]/tp_rank<r>.pt``."""
    from madtp_tpu_torch.kernels.attention_scores import (attention_planes_cuda,
                                                          attention_scores_cuda)
    from madtp_tpu_torch.kernels.cross_attention import cross_attention_cuda
    from madtp_tpu_torch.kernels.ffn import ffn_cuda
    from madtp_tpu_torch.models.blip import NLVRModel
    from madtp_tpu_torch.parallel import dist
    from madtp_tpu_torch.parallel.mesh import make_mesh, shard_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(2)  # four processes beside the script share the host's cores
    dev = dist.init_from_args(types.SimpleNamespace(
        num_processes=2, process_id=rank, coordinator=plan["coordinator"],
        dist_backend="gloo"), torch.device(plan["device"]))
    with torch.device("meta"):  # the phase's seeded weights, as the artifact holds them
        model = NLVRModel(plan["cfg"])
    model.load_state_dict(torch.load(plan["weights"], map_location="cpu", weights_only=True),
                          assign=True)
    model = shard_model(model.to(dev).eval(), make_mesh(1, 2))
    x = [t.to(dev) for t in plan["inputs"]]
    with torch.inference_mode():  # a first call: the kernels' libraries load
        model(*x, temperature=plan["candidates"][0][0], prune_active=True)
    zero_launch_counts()
    t0 = time.perf_counter()
    runs = []
    with PlanesCapture() as planes, K4Capture() as k4, K5Capture() as k5:
        for T, caps in plan["candidates"]:
            res = {}
            for mode in ("mask", "gather"):
                kw = {} if mode == "mask" else dict(capacities_v=caps[0], capacities_t=caps[1])
                with DTPRecorder() as rec, torch.inference_mode():
                    o = model(*x, temperature=T, prune_active=True, **kw)
                res[mode] = dict(logits=o.logits.cpu(), kept=(o.v_kept.cpu(), o.t_kept.cpu()),
                                 dtp=rec.records)
            runs.append(res)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(K1=attention_scores_cuda.launches, planes=attention_planes_cuda.launches,
                      K4=cross_attention_cuda.launches, K5=ffn_cuda.launches,
                      K5_fp32=ffn_cuda.fp32_launches)
    held = timed = None
    if dev.type == "cuda":
        t0 = time.perf_counter()
        held = hold_rank_cases(planes, k4, k5)
        dist.barrier("phase 31 cases held")
        if rank == 0:
            timed = time_rank_cases(planes, k4, k5)
        held["seconds"] = time.perf_counter() - t0
    shapes = {n: list(p.shape) for n, p in model.named_parameters()}
    dist.barrier("phase 31")
    torch.distributed.destroy_process_group()
    torch.save(dict(runs=runs, counts=counts, wall=wall, shapes=shapes, held=held, timed=timed),
               f"{plan['out']}/tp_rank{rank}.pt")


def tp_jpeg(root, iters=40):
    """Phase 31 (d): the port's JPEG decoder built here with g++ (its own
    source; the library's needed libraries name no libjpeg), on fixtures
    this machine's Pillow encodes: mode 1 bit-equal to Pillow's decode, crop
    and bicubic resize (a photo, grayscale, progressive, each chroma
    subsampling cropped, restart intervals, a 1x1 image), mode 2 within the
    JAX test's bound; images/s of a 640x480 photo to 384 px (decode, resize
    and normalize) against Pillow's decode and resize."""
    import io

    from PIL import Image

    from madtp_tpu_torch import native

    t0 = time.perf_counter()
    native.library()
    build_s = time.perf_counter() - t0
    ldd = subprocess.run(["ldd", str(native.target())], capture_output=True, text=True).stdout
    if "jpeg" in ldd:
        raise AssertionError(f"the native decode links libjpeg:\n{ldd}")
    rng = np.random.RandomState(31)
    h, w = 480, 640
    gx = np.linspace(0, 255, w)[None, :] * np.ones((h, 1))
    gy = np.linspace(0, 255, h)[:, None] * np.ones((1, w))
    photo = (np.stack([gx, gy, (gx + gy) / 2], -1) + rng.rand(h, w, 3) * 40).astype(np.uint8)

    def jpeg(arr, **kw):
        b = io.BytesIO()
        Image.fromarray(arr).save(b, "JPEG", **{"quality": 90, **kw})
        return b.getvalue()

    def pil(data, size, box=None):
        im = Image.open(io.BytesIO(data)).convert("RGB")
        if box is not None:
            im = im.crop((box[0], box[1], box[0] + box[2], box[1] + box[3]))
        return np.asarray(im.resize((size, size), Image.BICUBIC), np.uint8)

    noise = (rng.rand(100, 150, 3) * 255).astype(np.uint8)
    cases = [("photo", jpeg(photo), 384, None), ("photo crop", jpeg(photo), 96, (37, 81, 301, 233)),
             ("grayscale", jpeg(photo[:, :, 0]), 64, None),
             ("progressive", jpeg(photo, progressive=True), 96, None),
             ("1x1", jpeg(photo[:1, :1]), 32, None)]
    cases += [(f"subsampling {ss}", jpeg(noise, subsampling=ss), 48, (13, 7, 100, 80))
              for ss in (0, 1, 2)]
    try:
        cases.append(("restart intervals", jpeg(photo, restart_marker_blocks=3), 96, None))
    except TypeError:  # a Pillow without the option
        log("[tp] jpeg: this Pillow writes no restart intervals; that case is left out")
    for name, data, size, box in cases:
        got = native.decode_resize(data, size, crop=box, dct_scale=False)
        if not np.array_equal(got, pil(data, size, box)):
            raise AssertionError(f"native JPEG {name}: mode 1 differs from Pillow")
    data = cases[0][1]
    ref = native.decode_resize(data, 224, dct_scale=False)
    got2 = native.decode_resize(data, 224, dct_scale=True)
    mode2 = float(np.abs(ref.astype(int) - got2.astype(int)).mean())
    if got2.shape != ref.shape or not mode2 < 8.0:
        raise AssertionError(f"native JPEG mode 2: mean |diff| {mode2} (limit 8)")
    t0 = time.perf_counter()
    for _ in range(iters):
        native.decode_resize_norm(data, 384, dct_scale=False)
    ours = iters / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    for _ in range(iters):
        np.asarray(Image.open(io.BytesIO(data)).convert("RGB").resize((384, 384),
                                                                       Image.BICUBIC))
    theirs = iters / (time.perf_counter() - t0)
    log(f"[tp] jpeg: built with g++ in {build_s:.1f} s, no libjpeg linked; {len(cases)} cases "
        f"bit-equal to Pillow {Image.__version__} in mode 1, mode 2 mean |diff| {mode2:.3f} at "
        f"224 px; 640x480 -> 384 px: {ours:.1f} images/s (decode, resize, normalize, one "
        f"thread), Pillow's decode and resize {theirs:.1f} images/s; {card_line()}")
    return dict(cases=len(cases), mode2=mode2, images_per_s=ours, pillow_images_per_s=theirs)


def _serve_reply(url, inputs, timeout=240):
    """The server's reply to ``inputs`` once it is healthy, and the seconds
    spent waiting for it to become healthy and for the reply."""
    from madtp_tpu_torch.serve.server import ServingClient

    client = ServingClient(url, timeout=120)
    t0 = time.perf_counter()
    deadline = time.time() + timeout
    while not client.healthy():
        if time.time() > deadline:
            raise AssertionError(f"the mesh server at {url} never became healthy")
        time.sleep(0.2)
    t1 = time.perf_counter()
    reply = client.predict(*inputs)
    return reply, t1 - t0, time.perf_counter() - t1


def phase_tp(device, t_star, pairs=TP_PAIRS):
    """31. Tensor parallelism, mesh serving and the native JPEG decode.
    (a) ``tp_kernels``.  (b) The full-width NLVR eval (ViT-B/16@384, 12 + 12
    layers, seeded weights, fp32, ``pairs`` pairs, 35 tokens with a padded
    caption) one process on the card at the first ``TP_CANDIDATES`` of
    ``parity_factors(TP_FIRST_FACTOR)`` times phase 5's T* whose DTP
    decisions stand >= 64 fp32 steps from their edge in mask and gather mode;
    then two gloo ranks
    sharing the card (``_tp_rank``), the model sharded over a 1x2 mesh:
    at the first candidate where the ranks' DTP scores drift from the one
    process's at least 4x below its margin, equal kept counts and logits
    within 1e-4 in both modes, both ranks bit-equal; each kernel of the
    path launched (the ``tp`` path of the kernels line: the ranks'
    launches summed, K1's planes variant in the MED and K1 in the ViT).
    (c) The model exported as a 1x2 mask-mode artifact and served by
    ``python -m madtp_tpu_torch.cli.serve`` (its rank 1 started by the
    command, no warm-up: the request runs the step first), while (b) runs:
    the reply at the settled temperature equals the one-process step (logits
    1e-4, kept counts equal), and both ranks end with the server.  (d)
    ``tp_jpeg``.  Returns ``(launches, kernel records)``."""
    import shutil

    import torch.multiprocessing as tmp

    from madtp_tpu_torch.kernels.build import BUILD_DIR
    from madtp_tpu_torch.models.blip import init_nlvr_model
    from madtp_tpu_torch.serve.artifact import save_artifact
    from madtp_tpu_torch.tasks.nlvr import fast_capacity_schedule

    records = tp_kernels(device)
    root = BUILD_DIR / "tp_runs"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    t0 = time.perf_counter()
    cfg = full_config()
    model = init_nlvr_model(cfg, seed=TP_SEED, device=device)
    images, ids, mask = synthetic_inputs(cfg, pairs=pairs, text_len=35, seed=TP_SEED)
    x = [t.to(device) for t in (images, ids, mask)]
    # (c) the mesh artifact first: its server's two ranks start and load it meanwhile
    art = root / "serve" / "nlvr_mesh"
    save_artifact(str(art), model, "nlvr", "eval",
                  (images, ids, mask, torch.tensor(1.0)), meta={"task": "nlvr", "mode": "mask"},
                  mesh=(1, 2))
    port = _free_port()
    serve_log = open(root / "serve.log", "wb")
    t_server = time.perf_counter()
    server = subprocess.Popen(
        [sys.executable, "-m", "madtp_tpu_torch.cli.serve", "--artifact", str(art), "--port",
         str(port), "--device", device.type, "--no_warmup"],
        cwd=str(pathlib.Path(__file__).resolve().parent), stdout=serve_log,
        stderr=subprocess.STDOUT, env={**os.environ, "OMP_NUM_THREADS": "2"})
    try:
        candidates = []
        for f in parity_factors(TP_FIRST_FACTOR):
            T, caps, runs = t_star * f, None, {}
            for mode in ("mask", "gather"):
                kw = {} if mode == "mask" else dict(capacities_v=caps[0], capacities_t=caps[1])
                with DTPRecorder() as rec, torch.inference_mode():
                    o = model(*x, temperature=T, prune_active=True, **kw)
                margin = min(dtp_margins(rec.records))
                if margin < GAP_MIN:
                    break
                runs[mode] = dict(logits=o.logits.cpu(), dtp=rec.records, margin=margin,
                                  kept=(o.v_kept.cpu(), o.t_kept.cpu()))
                if mode == "mask":
                    caps = fast_capacity_schedule(o.v_kept.cpu().numpy(),
                                                  o.t_kept.cpu().numpy(), "ceil")
            if len(runs) == 2:
                candidates.append((T, f, caps, runs))
                if len(candidates) == TP_CANDIDATES:
                    break
        del model
        torch.cuda.empty_cache()
        log(f"[tp] one process: {len(candidates)} candidate temperatures "
            f"{[round(c[0], 4) for c in candidates]} (factors {[c[1] for c in candidates]} of "
            f"T* {t_star:.4f}); the 1x2 mesh artifact written; "
            f"{time.perf_counter() - t0:.1f} s")
        if not candidates:
            raise AssertionError("tp: no temperature near T* clears fp32 rounding in one "
                                 "process")
        plan = dict(device=device.type, coordinator=f"127.0.0.1:{_free_port()}", cfg=cfg,
                    weights=str(art / "weights.pt"), inputs=[images, ids, mask], out=str(root),
                    candidates=[(c[0], c[2]) for c in candidates])
        t0 = time.perf_counter()
        tmp.start_processes(_tp_rank, args=(plan,), nprocs=2, join=True, start_method="spawn")
        spawn_s = time.perf_counter() - t0
        got = [torch.load(root / f"tp_rank{r}.pt", weights_only=False) for r in range(2)]
        settled = None
        for i, (T, f, caps, want) in enumerate(candidates):
            lines = []
            for mode in ("mask", "gather"):
                a, b = (g["runs"][i][mode] for g in got)
                if not (torch.equal(a["logits"], b["logits"])
                        and all(torch.equal(u, v) for u, v in zip(a["kept"], b["kept"]))):
                    raise AssertionError(f"tp {mode} at T {T:g}: the two ranks differ")
                drift = dtp_drift(want[mode]["dtp"], a["dtp"])
                kept_eq = all(torch.equal(u, v) for u, v in zip(a["kept"], want[mode]["kept"]))
                err = float((a["logits"] - want[mode]["logits"]).abs().max())
                lines.append((mode, drift, want[mode]["margin"], kept_eq, err, a["kept"]))
            clear = all(d * DRIFT_FACTOR <= m for _, d, m, *_ in lines)
            log(f"[tp] two ranks at T {T:g} (factor {f:g}): " + "; ".join(
                f"{mode} drift {d:.3e} against margin {m:.3e}, kept equal {k}, max|logit "
                f"diff| {e:.3e}" for mode, d, m, k, e, _ in lines)
                + ("" if clear else ": not clear of rounding, the next temperature"))
            if clear:
                for mode, d, m, k, e, kept in lines:
                    if not k or not e <= 1e-4:
                        raise AssertionError(f"tp {mode} at T {T:g}: kept counts equal {k}, "
                                             f"logits {e:.3e} from one process (limit 1e-4)")
                settled = (T, candidates[i][3]["mask"])
                log(f"[tp] settled at factor {f:g}: kept vision "
                    f"{lines[0][5][0].tolist()} text {lines[0][5][1].tolist()} (mask), "
                    f"{lines[1][5][0].tolist()} {lines[1][5][1].tolist()} (gather), equal to "
                    f"one process")
                break
        if settled is None:
            raise AssertionError("tp: no candidate temperature clear of the ranks' drift")
        counts = [g["counts"] for g in got]
        launches = {"K1": sum(c["K1"] + c["planes"] for c in counts), "K2": 0,
                    "K4": sum(c["K4"] for c in counts), "K5": sum(c["K5"] for c in counts)}
        planes = sum(c["planes"] for c in counts)
        if device.type == "cuda" and (min(launches[k] for k in ("K1", "K4", "K5")) == 0
                                      or planes == 0):
            raise AssertionError(f"tp launches {launches}, planes {planes}: a kernel of the "
                                 "path was not launched")
        log(f"[tp] two gloo ranks on {card_line() if device.type == 'cuda' else 'cpu'}: "
            f"{spawn_s:.1f} s from spawn to join, the evals {[round(g['wall'], 2) for g in got]} "
            f"s by rank ({len(candidates)} temperatures x 2 modes); launches by rank "
            f"{counts}")
        if device.type == "cuda":
            for r, g in enumerate(got):
                held = g["held"]
                log(f"[tp] rank {r}'s cases held against their plain versions in "
                    f"{held['seconds']:.1f} s (with rank 0's timings): " + "; ".join(
                        f"{k} {held[k][0]} cases ({held[k][1]} calls), max|err| {held[k][2]:.2e}"
                        for k in ("K1", "K4", "K5")))
                if min(held[k][0] for k in ("K1", "K4", "K5")) == 0:
                    raise AssertionError(f"tp rank {r}: a kernel of the path recorded no case")
            records["path"] = got[0]["timed"]

        # (c) the served reply at the settled temperature
        T, want = settled
        t0 = time.perf_counter()
        reply, wait_s, call_s = _serve_reply(
            f"http://127.0.0.1:{port}", (images.numpy(), ids.numpy(), mask.numpy(),
                                         np.float32(T)))
        err = float(np.abs(reply[0] - want["logits"].numpy()).max())
        if not (err <= 1e-4 and np.array_equal(reply[1], want["kept"][0].numpy())
                and np.array_equal(reply[2], want["kept"][1].numpy())):
            raise AssertionError(f"tp served reply: logits {err:.3e} from the direct step, kept "
                                 f"{reply[1].tolist()} {reply[2].tolist()} against "
                                 f"{want['kept'][0].tolist()} {want['kept'][1].tolist()}")
        log(f"[tp] cli.serve on the 1x2 mesh artifact (two processes, gloo): reply at T {T:g} "
            f"equal to the direct step (kept equal, max|logit diff| {err:.3e}); after the "
            f"ranks joined, {wait_s:.1f} s until it was healthy, the call {call_s:.1f} s "
            f"(the server started {time.perf_counter() - t_server:.1f} s before the reply)")
    finally:
        server.terminate()
        try:
            server.wait(timeout=90)
        finally:
            if server.poll() is None:
                server.kill()
            serve_log.close()
    log_text = (root / "serve.log").read_text(errors="replace")
    if "over 2 processes" not in log_text:
        raise AssertionError(f"the mesh server did not run on two processes:\n{log_text[-2000:]}")
    records["jpeg"] = tp_jpeg(root)
    records["planes"] = planes
    shutil.rmtree(root, ignore_errors=True)
    return launches, records


def jpeg_headers():
    """Whether libjpeg's header and library are on this machine, for the
    native JPEG decode a later slice ports: a file check for ``jpeglib.h`` in
    the C compiler's include directories (``cc -E -v``) and
    ``ctypes.util.find_library("jpeg")``; nothing is built."""
    import ctypes.util
    import pathlib
    import shutil

    cc = shutil.which("cc") or shutil.which("gcc")
    dirs = []
    if cc:
        err = subprocess.run([cc, "-E", "-v", "-x", "c", "/dev/null"], capture_output=True,
                             text=True, timeout=60).stderr.splitlines()
        if "#include <...> search starts here:" in err and "End of search list." in err:
            dirs = [d.strip() for d in err[err.index("#include <...> search starts here:") + 1:
                                           err.index("End of search list.")]]
    dirs += [d for d in ("/usr/include", "/usr/local/include") if d not in dirs]
    header = next((str(pathlib.Path(d) / "jpeglib.h") for d in dirs
                   if (pathlib.Path(d) / "jpeglib.h").is_file()), None)
    lib = ctypes.util.find_library("jpeg")
    log(f"[jpeg] jpeglib.h: {header or 'not found'} (in the include directories of "
        f"{cc or 'no C compiler'}: {dirs}); libjpeg: {lib or 'not found'}")
    return header, lib


def _timed(fn):
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


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
    jpeg_headers()

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
    record4_one_query = timed(phase_k4, device)
    record5, record5_fp32 = timed(phase_k5, device)
    record3 = timed(phase_k1_large, device)
    cfg = full_config()
    fp32_k5 = {}  # fp32 K5 launches of each fp32 path, counted apart
    _, fp32_k5["nlvr_parity"], _ = timed(fp32_k5_held, "nlvr parity", phase_model_parity,
                                         device, cfg)
    k1_eval, k4_eval, k5_eval, record1_eval, nlvr_main = timed(phase_main_path, device, cfg)
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

    # phase 26: the NLVR, caption and VQA drivers through their entry points
    drivers, _, driver_records = timed(phase_drivers, device)
    tk.update({f"driver_{f}": c for f, c in drivers.items()})
    # phase 27: the BLIP and CLIP retrieval drivers (CLIP ViT-L/14@336 and RN50), the loaders
    retrieval_drivers, retrieval_driver_records, kept = timed(phase_retrieval_drivers, device)
    tk.update({f"driver_{f}": c for f, c in retrieval_drivers.items()})
    torch.cuda.empty_cache()
    # phase 28: the serving stack over HTTP (the NLVR main path's model, T* and capacities)
    k1_serve, k4_serve, k5_serve = timed(
        phase_serving, device, *nlvr_main,
        {"retrieval": (rcfg, t_ret), "clip": (ccfg, t_clip), "vqa": (vqa_config(480), t_vqa),
         "caption": (caption_config(), t_cap)}, tokenizer)
    t_nlvr = nlvr_main[1]
    del nlvr_main
    torch.cuda.empty_cache()
    # phase 29: multi-process runs (a one-rank NCCL group; two gloo ranks on the card)
    tk["multiprocess"] = timed(phase_multiprocess, device, kept)
    # phase 30: dropout training, nucleus captioning, the legacy heads
    tk["stochastic"] = timed(phase_stochastic, device, tokenizer, t_cap)
    torch.cuda.empty_cache()
    # phase 31: tensor parallelism over two gloo ranks, a mesh artifact served, the JPEG decode
    tk["tp"], tp_records = timed(phase_tp, device, t_nlvr)

    def train_total(k):
        return sum(c[k] for c in (*tk.values(), *te.values()))

    def train_paths(k):
        return {**{p: c[k] for p, c in tk.items()}, **{p: c[k] for p, c in te.items() if c[k]}}

    kernels = [
        dict(name="attention_scores", route="cuda",
             source="madtp_tpu_torch/csrc/attention_scores.cu",
             replaces="madtp_tpu/ops/pallas/fused_attention.py:595",
             launches=k1_eval + k1_train + k1_ret + k1_clip + k1_vqa + k1_640 + k1_gen + k1_cap
             + train_total("K1") + k1_serve,
             launches_by_path={"eval": k1_eval, "train": k1_train, "retrieval": k1_ret,
                               "clip": k1_clip, "vqa": k1_vqa, "vqa640": k1_640,
                               "vqa_generate": k1_gen, "caption": k1_cap,
                               **train_paths("K1"), "serve": k1_serve},
             launches_in_profiled_replays=REPLAYS["K1"],
             **record, at_nlvr_gather_eval=record1_eval, at_retrieval_eval=record1_ret,
             at_clip_vision_h16=record1_clip, at_vqa_gather_eval=record1_vqa,
             at_caption_eval=record1_cap, at_train_nlvr=record1_train,
             at_tp_planes=tp_records["K1"], at_tp_path_planes=tp_records["path"]["K1"],
             tp_plane_launches=tp_records["planes"],
             **{f"at_train_{f}": r["K1"] for f, r in trec.items()},
             fp32_at_train_shape=record1_32, fp32_at_driver_nlvr=driver_records["K1"],
             fp32_at_driver_clip_h16=retrieval_driver_records["K1"],
             library_note="library_ms is scaled_dot_product_attention, out only; vqa640 "
                          "counts the launches in K3's range too (attention_scores_large_n); "
                          "train_<family>_eval counts the training path's controller evals "
                          "and capacity probe, train_<family> its train steps, "
                          "driver_<family> the driver's train and evaluate runs, "
                          "multiprocess the two ranks' driver runs of phase 29 (summed), "
                          "stochastic phase 30's dropout train steps, nucleus decode and "
                          "legacy heads, tp phase 31's two tensor-parallel ranks (K1 in the "
                          "ViT and its planes variant, k1_attention_planes, in the MED: "
                          "tp_plane_launches; at_tp_planes holds the variant at 32 pairs, "
                          "at_tp_path_planes at the tp path's most-called case, "
                          "library_ms SDPA out only)",
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
             + train_total("K4") + k4_serve,
             launches_by_path={"eval": k4_eval, "train": k4_train, "retrieval": k4_ret,
                               "vqa": k4_vqa, "vqa640": k4_640, "vqa_generate": k4_gen,
                               "caption": k4_cap, **train_paths("K4"), "serve": k4_serve},
             launches_in_profiled_replays=REPLAYS["K4"],
             **record4, at_vqa_gather_eval=record4_vqa, at_vqa_dense_eval=dense4_vqa,
             at_vqa640_eval=record4_640, at_vqa_generate=record4_gen,
             at_caption_eval=record4_cap, fp32_at_train_nlvr=record4_train32,
             fp32_at_one_query=record4_one_query, fp32_at_driver_nlvr=driver_records["K4"],
             fp32_at_driver_retrieval_itm=retrieval_driver_records["K4"],
             **{f"at_train_{f}": r["K4"] for f, r in trec.items() if r["K4"] is not None},
             at_tp=tp_records["K4"], at_tp_path=tp_records["path"]["K4"],
             library_note="library_ms is scaled_dot_product_attention with the "
                          "same additive mask: the same function",
             previous_note="previous_ms is the replaced design "
                           "(madtp_tpu_torch/csrc/previous/cross_attention.cu: bf16 "
                           "k4_cross_attention, fp32 k4_cross_attention_fp32, k4_simt) on the "
                           "same inputs and card"),
        dict(name="ffn", route="cuda", source="madtp_tpu_torch/csrc/ffn.cu",
             replaces="madtp_tpu/ops/pallas/fused_ffn.py:79",
             launches=k5_eval + k5_train + k5_ret + k5_clip + k5_vqa + k5_640 + k5_gen + k5_cap
             + train_total("K5") + k5_serve,
             launches_by_path={"eval": k5_eval, "train": k5_train, "retrieval": k5_ret,
                               "clip": k5_clip, "vqa": k5_vqa, "vqa640": k5_640,
                               "vqa_generate": k5_gen, "caption": k5_cap,
                               **train_paths("K5"), "serve": k5_serve},
             launches_in_profiled_replays=REPLAYS["K5"],
             **record5, at_clip_gather_eval=record5_clip, at_vqa_gather_eval=record5_vqa,
             at_vqa_dense_eval=dense5_vqa, at_vqa640_eval=record5_640,
             at_vqa_generate=record5_gen, at_caption_eval=record5_cap,
             fp32=record5_fp32, fp32_at_train_main=record5_train,
             fp32_at_driver_nlvr=driver_records["K5"],
             **{f"fp32_at_train_{f}": r["K5_fp32"] for f, r in trec.items()},
             at_tp=tp_records["K5"], at_tp_path=tp_records["path"]["K5"],
             fp32_launches=sum(fp32_k5.values()), fp32_launches_by_path=fp32_k5,
             library_note="library_ms is two F.linear and the activation: the same function",
             previous_note="previous_ms is the replaced design (madtp_tpu_torch/csrc/previous/"
                           "ffn.cu: bf16 k5_ffn, fp32 k5_ffn_fp32, the first SGEMM) on the same "
                           "inputs and card; launches counts the bf16 main paths and the "
                           "fp32 FFNs of the drivers (driver_<family>), phase 29 "
                           "(multiprocess), phase 30 (stochastic) and phase 31 (tp: a rank's "
                           "half of each FFN, fp32), fp32_launches the other fp32 paths"),
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
    K5 (D = 768, F = 3072, GELU) at the paths' row counts, fp32 K1 at their
    lengths and fp32 K4 at their shapes (a quarter of the keys dead), each
    with the library call's time and its passes' or GEMMs' device times
    apart."""
    import torch.nn.functional as F

    import madtp_tpu_torch
    from madtp_tpu_torch.kernels import cross_attention as k4
    from madtp_tpu_torch.kernels.attention_scores import attention_scores_cuda
    from madtp_tpu_torch.kernels.cross_attention import cross_attention_cuda
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
        for B, Nq, S in ((16, 40, 592), (96, 35, 592), (32, 35, 577), (96, 1, 577)):
            q, k, v, alive, bias = k4_case(B, Nq, S, with_bias=True, dtype=torch.float32,
                                           device=device)
            k4_ms = kernel_ms(lambda: cross_attention_cuda(q, k, v, alive, bias, 0.125), 20)
            qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
            attn_mask = sdpa_mask(alive, bias, torch.float32)
            sdpa_ms = kernel_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=attn_mask, scale=0.125), 20)
            log(f"[probe] fp32 K4 B={B} Nq={Nq} S={S}: {k4_ms:.4f} ms, sdpa (same function) "
                f"{sdpa_ms:.4f} ms")
            pass_times(f"fp32 K4 B={B} Nq={Nq} S={S}",
                       lambda: cross_attention_cuda(q, k, v, alive, bias, 0.125), 5)
            if hasattr(k4, "FP32_MAX_CHUNK_KEYS"):  # a package whose fp32 K4 splits
                log(f"[probe] fp32 K4 B={B} Nq={Nq} S={S}, 1-5 chunks (the rule's "
                    f"{k4.split_chunks(B, 12, Nq, S, torch.float32)}): "
                    + k4_split_sweep(k4, lambda: cross_attention_cuda(q, k, v, alive, bias,
                                                                      0.125), S))
            del q, k, v, alive, bias, qh, kh, vh, attn_mask
    return 0


def k4_split_sweep(k4, fn, S):
    """Device times of ``fn`` (an fp32 K4 call) with the keys in 1 to 5
    chunks of whole 64-key tiles, ``k4.split_chunks`` forced for each and
    put back after."""
    rule, times, tiles = k4.split_chunks, {}, -(-S // k4.KEY_TILE)
    for c in range(1, 6):
        chunk_keys = -(-tiles // c) * k4.KEY_TILE
        split = (-(-S // chunk_keys), chunk_keys)
        if split in times or chunk_keys > k4.FP32_MAX_CHUNK_KEYS:
            continue
        k4.split_chunks = lambda *args, _split=split: _split
        try:
            times[split] = kernel_ms(fn, 20)
        finally:
            k4.split_chunks = rule
    return ", ".join(f"{c}x{n} keys {ms:.4f} ms" for (c, n), ms in times.items())


if __name__ == "__main__":
    sys.exit(probe_fp32() if sys.argv[1:] == ["probe"] else main())
