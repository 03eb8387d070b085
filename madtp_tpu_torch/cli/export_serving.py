"""Export a compressed checkpoint as a serving artifact
(counterpart of ``madtp_tpu/cli/export_serving.py``).

    python -m madtp_tpu_torch.cli.export_serving --task nlvr \\
        --pretrained ckpt.pth --config configs/nlvr.yaml \\
        --batch 32 --output_dir artifacts/nlvr_p0.5

    python -m madtp_tpu_torch.cli.export_serving --task clip \\
        --pretrained clip.pth --config configs/retrieval_flickr_clip.yaml \\
        --output_dir artifacts/clip   # -> clip/image_encoder + clip/text_encoder

All five task families export: ``nlvr`` (the classification step), ``clip``
(the two towers), ``caption`` (the pruned encode and the beam decode as one
unit), ``vqa`` (rank: the BOS shortlist and the candidate rerank, the answer
list a call-time input) and ``retrieval`` (the ITC towers and the ITM rerank
unit).  An artifact (:mod:`madtp_tpu_torch.serve.artifact`) holds the unit's
weights and its ``meta.json``; the serving process rebuilds the step from
the port's code and runs it as a CUDA graph on the card.

The DTP temperature is read from the checkpoint and may be overridden with
``--temperature``.  The default is the exact mask mode; ``--fast_eval``
exports the gather path at capacities calibrated on mask-mode probe batches
(the JAX exporter's synthetic draws, ``RandomState(0).randn``, by default, so
both packages export the same capacities; ``--probe_npz`` or
``--probe_sentences`` for real ones).  ``--row_independent`` exports per-row
DTP: every row computes as if served alone, so the server may merge requests
into one device call; NLVR's two images of a pair then prune apart too.

``--mesh DxM`` exports a multi-device artifact to be served over a (data,
model) mesh of D x M processes (:mod:`madtp_tpu_torch.parallel.mesh`:
tensor parallelism over M, rows over D): the same whole weights, with
``nr_devices`` and ``mesh`` in ``meta.json``, for every task.

``--device`` (default ``cuda``; without a card it raises) takes the place of
the JAX exporter's ``--platforms``.  A model loaded here computes in
bfloat16 on the card, as the eval main paths do, and in float32 on the CPU;
``export_<task>(args, config, device, model=..., capacities=...)`` exports
a model already built, in its own dtype, at given capacities.
"""

from __future__ import annotations

import argparse
import os
import types
from typing import Optional, Sequence

import numpy as np
import torch

from madtp_tpu_torch.prune.calibrate import fast_capacity_schedule
from madtp_tpu_torch.serve.artifact import save_artifact


def _probe_images(args, shape):
    """The probe batch of ``--fast_eval``: the npz's first array (at least
    ``shape[0]`` images; NLVR needs 2*batch, the pair concatenated on the
    batch dim), else ``RandomState(0)`` normals."""
    if args.probe_npz:
        with np.load(args.probe_npz) as z:
            imgs = z[z.files[0]].astype(np.float32)
        if imgs.shape[1:] != tuple(shape[1:]):
            raise SystemExit(f"--probe_npz images {imgs.shape} do not match the export "
                             f"shape {tuple(shape)}")
        if imgs.shape[0] < shape[0]:
            raise SystemExit(f"--probe_npz supplies {imgs.shape[0]} images but the export "
                             f"needs {shape[0]} (NLVR needs 2*batch: the image pair is "
                             "concatenated on the batch dim)")
        return imgs[:shape[0]]
    return np.random.RandomState(0).randn(*shape).astype(np.float32)


def _probe_text(args, batch, text_len, tokenize=None):
    """Probe text of ``--fast_eval``'s text schedule: ``ids`` / ``mask`` in
    the ``--probe_npz``, or ``--probe_sentences`` tokenized, else all-zero
    ids with a warning (gather mode truncates to the calibrated capacity)."""
    if args.probe_npz:
        with np.load(args.probe_npz) as z:
            if "ids" in z.files and "mask" in z.files:
                ids, mask = z["ids"].astype(np.int32), z["mask"].astype(np.int32)
                if ids.shape[0] < batch or ids.shape[1] != text_len:
                    raise SystemExit(f"--probe_npz ids {ids.shape} do not cover the export "
                                     f"text shape ({batch}, {text_len})")
                return ids[:batch], mask[:batch]
    if args.probe_sentences:
        if tokenize is None:
            raise SystemExit("--probe_sentences needs a task tokenizer")
        with open(args.probe_sentences) as f:
            sents = [line.strip() for line in f if line.strip()]
        if len(sents) < batch:
            raise SystemExit(f"--probe_sentences supplies {len(sents)} sentences but the "
                             f"export batch is {batch}")
        ids, mask = tokenize(sents[:batch])
        return np.asarray(ids, np.int32), np.asarray(mask, np.int32)
    print("WARNING: --fast_eval text capacities calibrated on all-zero-id probe text (no "
          "ids/mask in --probe_npz, no --probe_sentences); served text pruning may truncate "
          "real sentences — supply real probe text for production calibration")
    return np.zeros((batch, text_len), np.int32), np.ones((batch, text_len), np.int32)


def _mark_row_independent(meta, outputs, kept_outputs=None, note=""):
    """``--row_independent`` bookkeeping: per-row output multiplicities and
    the flag the server gates merging on; ``kept_outputs`` maps an output
    index to the capacity schedule (``"vision"`` / ``"text"``) its per-row
    decision counts are checked against (``/stats`` overflow)."""
    bat = dict(meta["batching"])
    bat["outputs"] = list(outputs)
    bat["row_independent"] = True
    if kept_outputs:
        bat["kept_outputs"] = {str(k): v for k, v in kept_outputs.items()}
    tag = " [row-independent: per-row DTP decisions" + note + "]"
    return {**meta, "batching": bat, "outputs": meta.get("outputs", "") + tag}


def _dtype(dev: torch.device) -> torch.dtype:
    return torch.bfloat16 if dev.type == "cuda" else torch.float32


def _mode(prune, caps):
    return "gather" if caps is not None else ("mask" if prune else "dense")


def _t(x: float) -> torch.Tensor:
    return torch.tensor(float(x), dtype=torch.float32)


def _given_temperature(args) -> float:
    if args.temperature is None:
        raise ValueError("exporting a model already built needs --temperature")
    return args.temperature


def _blip_model(args, config, family, image_size, dev, *, twin_cross=False):
    """``(model, temperature)`` from ``--pretrained`` (its stored temperature)
    or seeded random weights (temperature 1), in :func:`_dtype`, with
    ``--temperature`` over either."""
    from madtp_tpu_torch.ckpt import convert
    from madtp_tpu_torch.cli.common import build_blip_cfg, read_checkpoint
    from madtp_tpu_torch.models import blip

    cfg = build_blip_cfg(config, image_size, twin_cross=twin_cross)
    if args.pretrained:
        sd, extras = read_checkpoint(args.pretrained)
        model = getattr(convert, f"load_{family}_state_dict")(sd, cfg, device=dev)
        temperature = float(extras.get("temperature", 0.0))
    else:  # seeded weights: an artifact-pipeline smoke run
        model = getattr(blip, f"init_{family}_model")(cfg, seed=0, device=dev)
        temperature = 1.0
    if args.temperature is not None:
        temperature = args.temperature
    return model.to(_dtype(dev)), temperature


def export_nlvr(args, config, dev, model=None, capacities=None):
    """The NLVR unit.  ``model`` (with ``--temperature``) and ``capacities``
    (``(vision, text)``) skip the load and the probe: a caller that has
    both (the card's smoke run) exports what it already calibrated."""
    from madtp_tpu_torch.tasks.nlvr import make_eval_step

    image_size = config.get("image_size", 384)
    if model is None:
        model, temperature = _blip_model(args, config, "nlvr", image_size, dev, twin_cross=True)
    else:
        temperature = _given_temperature(args)
    image_size = model.cfg.vit.image_size
    prune = temperature > 0
    dtype = next(model.parameters()).dtype
    B, T = args.batch, args.text_len
    images = torch.zeros((2 * B, 3, image_size, image_size), dtype=dtype)
    ids = torch.zeros((B, T), dtype=torch.int32)
    mask = torch.ones((B, T), dtype=torch.int32)

    caps_v = caps_t = None
    if capacities is not None and prune:
        caps_v, caps_t = (tuple(int(c) for c in caps) for caps in capacities)
    elif args.fast_eval and prune:
        tokenize = None
        if args.probe_sentences:
            from madtp_tpu_torch.data.tokenizer_bert import BertWordPieceTokenizer

            if not args.bert_vocab:
                raise SystemExit("--probe_sentences needs --bert_vocab")
            tokzr = BertWordPieceTokenizer(args.bert_vocab)

            def tokenize(sents):
                out = tokzr(sents, padding="max_length", max_length=T)
                ids = np.asarray(out["input_ids"], np.int32)
                ids[:, 0] = tokzr.enc_token_id  # reference blip_nlvr.py:69
                return ids, np.asarray(out["attention_mask"], np.int32)

        probe = torch.from_numpy(_probe_images(args, tuple(images.shape)))
        p_ids, p_mask = _probe_text(args, B, T, tokenize)
        out = make_eval_step(model, True, graph=False)(
            probe.to(dev), torch.from_numpy(p_ids).to(dev), torch.from_numpy(p_mask).to(dev),
            temperature)
        caps_v, caps_t = fast_capacity_schedule(out.v_kept.cpu().numpy(),
                                                out.t_kept.cpu().numpy(), args.cap_mode)
    meta = {
        "task": "nlvr",
        "temperature": float(temperature),
        "mode": _mode(prune, caps_v),
        "capacities_vision": None if caps_v is None else list(caps_v),
        "capacities_text": None if caps_t is None else list(caps_t),
        "outputs": "(logits [B,2], vision_kept, text_kept)",
        # images stack the pair as two n-row blocks (reference compress_nlvr_dtp.py:43)
        "batching": {"batch": B, "inputs": [2, 1, 1, 0], "outputs": [1, 0, 0]},
    }
    if args.row_independent:
        # per-row kept counts, batch-leading: vision [2B, L] (two pair blocks), text [B, L];
        # each image of a pair prunes on its own counts
        meta = _mark_row_independent(
            meta, [1, 2, 1], kept_outputs={1: "vision", 2: "text"},
            note="; NLVR pair images also prune independently of each other — scores can "
                 "differ slightly from batched/reference eval")
    save_artifact(args.output_dir, model, "nlvr", "eval", (images, ids, mask, _t(temperature)),
                  meta=meta, mesh=_mesh(args))
    print(f"exported NLVR serving artifact -> {args.output_dir} (T={temperature}, "
          f"mode={meta['mode']})")


def export_clip(args, config, dev, model=None, capacities=None):
    """The CLIP towers ``image_encoder`` and ``text_encoder``, each with its
    own weights (the codebook in both)."""
    from madtp_tpu_torch.ckpt.convert import load_clip_state_dict
    from madtp_tpu_torch.cli.common import read_checkpoint
    from madtp_tpu_torch.core.config import CLIPConfig, infer_clip_config
    from madtp_tpu_torch.models.clip import init_clip_model

    if model is None:
        if args.pretrained:
            sd, extras = read_checkpoint(args.pretrained)
            cfg = infer_clip_config(sd, sd_dim=config.get("sd_dim", 768))
            model = load_clip_state_dict(sd, cfg, device=dev)
            temperature = float(extras.get("temperature", 0.0))
        else:
            cfg = CLIPConfig(image_resolution=config.get("image_size", 224))
            model = init_clip_model(cfg, seed=0, device=dev, sd_num=config.get("sd_num", 100))
            temperature = 1.0
        model = model.to(_dtype(dev))
    else:
        temperature = _given_temperature(args)
    if args.temperature is not None:
        temperature = args.temperature
    cfg = model.cfg
    prune = temperature > 0
    dtype = next(model.parameters()).dtype
    B = args.batch
    images = torch.zeros((B, 3, cfg.image_resolution, cfg.image_resolution), dtype=dtype)
    text = torch.zeros((B, cfg.context_length), dtype=torch.int32)

    caps_v = None
    if capacities is not None and prune and not cfg.is_resnet:
        caps_v = tuple(int(c) for c in capacities[0])
    elif args.fast_eval and prune and not cfg.is_resnet:
        probe = torch.from_numpy(_probe_images(args, tuple(images.shape))).to(dev)
        with torch.inference_mode():
            vk = model.encode_image(probe, temperature=temperature, prune_active=True).kept_counts
        caps_v, _ = fast_capacity_schedule(vk.cpu().numpy(), None, args.cap_mode)
        caps_v = tuple(caps_v)
    ri = args.row_independent
    meta = {"temperature": float(temperature), "mode": _mode(prune, caps_v),
            "capacities_vision": None if caps_v is None else list(caps_v)}
    img_meta = {"task": "clip_image", "outputs": "(features [B,E], kept_counts)",
                "batching": {"batch": B, "inputs": [1, 0], "outputs": [1, 0]}, **meta}
    txt_meta = {"task": "clip_text", "outputs": "(features [B,E], kept_counts)",
                "batching": {"batch": B, "inputs": [1, 0], "outputs": [1, 0]}, **meta}
    if ri:  # an RN tower runs unpruned: its empty kept array stays unbatched
        img_meta = _mark_row_independent(img_meta, [1, 0 if cfg.is_resnet else 1],
                                         kept_outputs=None if cfg.is_resnet else {1: "vision"})
        txt_meta = _mark_row_independent(txt_meta, [1, 1], kept_outputs={1: "text"})
    save_artifact(os.path.join(args.output_dir, "image_encoder"), model, "clip",
                  "image_encoder", (images, _t(temperature)), meta=img_meta,
                  mesh=_mesh(args))
    save_artifact(os.path.join(args.output_dir, "text_encoder"), model, "clip",
                  "text_encoder", (text, _t(temperature)), meta=txt_meta,
                  mesh=_mesh(args))
    print(f"exported CLIP serving artifacts -> {args.output_dir}"
          f"/{{image_encoder,text_encoder}} (T={temperature})")


def export_caption(args, config, dev, model=None, capacities=None):
    """The caption unit: the pruned image encode and the beam decode from
    the call-time prompt ids (BOS first); beam settings recorded in meta."""
    image_size = config.get("image_size", 384)
    if model is None:
        model, temperature = _blip_model(args, config, "caption", image_size, dev)
    else:
        temperature = _given_temperature(args)
    image_size = model.cfg.vit.image_size
    prune = temperature > 0
    dtype = next(model.parameters()).dtype
    B = args.batch
    images = torch.zeros((B, 3, image_size, image_size), dtype=dtype)
    prompt = torch.zeros((B, args.prompt_len), dtype=torch.int32)

    caps_v = None
    if capacities is not None and prune:
        caps_v = tuple(int(c) for c in capacities[0])
    elif args.fast_eval and prune:
        probe = torch.from_numpy(_probe_images(args, tuple(images.shape))).to(dev)
        with torch.inference_mode():
            _, _, vk = model.encode_image(probe, temperature=temperature, prune_active=True)
        caps_v = tuple(fast_capacity_schedule(vk.cpu().numpy(), None, args.cap_mode)[0])
    meta = {
        "task": "caption",
        "temperature": float(temperature),
        "mode": _mode(prune, caps_v),
        "capacities_vision": None if caps_v is None else list(caps_v),
        "num_beams": args.num_beams, "max_length": args.max_length,
        "min_length": args.min_length, "eos_id": args.eos_id, "pad_id": args.pad_id,
        "outputs": "(sequences [B,max_length] incl. prompt, vision_kept)",
        "batching": {"batch": B, "inputs": [1, 1, 0], "outputs": [1, 0]},
    }
    if args.row_independent:  # the decode is per row by construction
        meta = _mark_row_independent(meta, [1, 1], kept_outputs={1: "vision"})
    save_artifact(args.output_dir, model, "caption", "generate",
                  (images, prompt, _t(temperature)), meta=meta, mesh=_mesh(args))
    print(f"exported caption serving artifact -> {args.output_dir} "
          f"(T={temperature}, beams={args.num_beams})")


def export_vqa(args, config, dev, model=None, capacities=None):
    """The VQA rank unit; the tokenized answer list ``[num_answers,
    answer_len]`` is a call-time input."""
    image_size = config.get("image_size", 480)
    if model is None:
        model, temperature = _blip_model(args, config, "vqa", image_size, dev)
    else:
        temperature = _given_temperature(args)
    image_size = model.cfg.vit.image_size
    prune = temperature > 0
    dtype = next(model.parameters()).dtype
    B, T = args.batch, args.text_len
    nA, La = args.num_answers, args.answer_len
    k = min(args.k_test, nA)
    images = torch.zeros((B, 3, image_size, image_size), dtype=dtype)
    q_ids = torch.zeros((B, T), dtype=torch.int32)
    q_mask = torch.ones((B, T), dtype=torch.int32)
    a_ids = torch.zeros((nA, La), dtype=torch.int32)
    a_mask = torch.ones((nA, La), dtype=torch.int32)

    caps_v = caps_t = None
    if capacities is not None and prune:
        caps_v, caps_t = (tuple(int(c) for c in caps) for caps in capacities)
    elif args.fast_eval and prune:
        probe = torch.from_numpy(_probe_images(args, tuple(images.shape))).to(dev)
        p_ids, p_mask = _probe_text(args, B, T)
        with torch.inference_mode():
            out, _, vk = model.encode(probe, torch.from_numpy(p_ids).long().to(dev),
                                      torch.from_numpy(p_mask).long().to(dev),
                                      temperature=temperature, prune_active=True)
        caps_v, caps_t = fast_capacity_schedule(vk.cpu().numpy(),
                                                out.kept_counts.cpu().numpy(), args.cap_mode)
    meta = {
        "task": "vqa_rank",
        "temperature": float(temperature),
        "mode": _mode(prune, caps_v),
        "capacities_vision": None if caps_v is None else list(caps_v),
        "capacities_text": None if caps_t is None else list(caps_t),
        "k_test": k,
        "pad_id": args.pad_id,
        "outputs": "(best answer index [B], topk candidate ids [B,k], vision_kept, text_kept)",
        # the answer list is not batched (inputs 3 and 4)
        "batching": {"batch": B, "inputs": [1, 1, 1, 0, 0, 0], "outputs": [1, 1, 0, 0]},
    }
    if args.row_independent:  # requests merge only with equal answer lists
        meta = _mark_row_independent(meta, [1, 1, 1, 1], kept_outputs={2: "vision", 3: "text"})
    save_artifact(args.output_dir, model, "vqa", "rank",
                  (images, q_ids, q_mask, a_ids, a_mask, _t(temperature)), meta=meta,
                  mesh=_mesh(args))
    print(f"exported VQA rank serving artifact -> {args.output_dir} "
          f"(T={temperature}, k={k}, answers={nA}x{La})")


def export_retrieval(args, config, dev, model=None, capacities=None):
    """The retrieval units ``image_encoder`` (ITC feature and the pruned
    token state the rerank reads), ``text_encoder`` (ITC feature) and
    ``itm_rerank`` (row i: text i against image state i); the rerank's
    state shapes are the image encoder's own."""
    from madtp_tpu_torch.prune.dtp import TokenState
    from madtp_tpu_torch.tasks.retrieval import corpus_steps

    image_size = config.get("image_size", 384)
    if model is None:
        model, temperature = _blip_model(args, config, "retrieval", image_size, dev)
    else:
        temperature = _given_temperature(args)
    image_size = model.cfg.vit.image_size
    prune = temperature > 0
    dtype = next(model.parameters()).dtype
    B, T = args.batch, args.text_len
    images = torch.zeros((B, 3, image_size, image_size), dtype=dtype)
    ids = torch.zeros((B, T), dtype=torch.int32)
    mask = torch.ones((B, T), dtype=torch.int32)

    caps_v = caps_t = None
    if capacities is not None and prune:
        caps_v, caps_t = (tuple(int(c) for c in caps) for caps in capacities)
    elif args.fast_eval and prune:
        probe = torch.from_numpy(_probe_images(args, tuple(images.shape))).to(dev)
        p_ids, p_mask = (torch.from_numpy(a).long().to(dev) for a in _probe_text(args, B, T))
        with torch.inference_mode():
            # text and multimodal keep counts: the ITM pass under the image prunes apart
            _, vout = model.image_features(probe, temperature=temperature, prune_active=True)
            _, tout = model.text_features(p_ids, p_mask, temperature=temperature,
                                          prune_active=True)
            vs = vout.state
            mm = model.text_encoder(p_ids, p_mask, encoder_state=TokenState(vs.x, vs.alive, None),
                                    space_dict=model.space_dict, temperature=temperature,
                                    prune_active=True)
        caps_v, caps_t = fast_capacity_schedule(
            vout.kept_counts.cpu().numpy(),
            torch.maximum(tout.kept_counts, mm.kept_counts).cpu().numpy(), args.cap_mode)
    ri = args.row_independent
    # the rerank's state shapes: the image step's own outputs at one image
    img_step = corpus_steps(model, prune, caps_v, caps_t, graph=False, row_independent=ri)[0]
    _, sx1, sa1 = img_step(torch.zeros((1,) + tuple(images.shape[1:]), dtype=dtype,
                                       device=dev), temperature)
    n = args.rerank_batch
    sx = torch.zeros((n,) + tuple(sx1.shape[1:]), dtype=sx1.dtype)
    sa = torch.zeros((n,) + tuple(sa1.shape[1:]), dtype=sa1.dtype)
    r_ids = torch.zeros((n, T), dtype=torch.int32)
    r_mask = torch.ones((n, T), dtype=torch.int32)

    meta = {"temperature": float(temperature), "mode": _mode(prune, caps_v),
            "capacities_vision": None if caps_v is None else list(caps_v),
            "capacities_text": None if caps_t is None else list(caps_t)}
    img_meta = {"task": "retrieval_image",
                "outputs": "(itc feature [B,E], state_x, state_alive)",
                "batching": {"batch": B, "inputs": [1, 0], "outputs": [1, 1, 1]}, **meta}
    txt_meta = {"task": "retrieval_text", "outputs": "(itc feature [B,E], kept_counts)",
                "batching": {"batch": B, "inputs": [1, 1, 0], "outputs": [1, 0]}, **meta}
    rr_meta = {"task": "retrieval_itm_rerank",
               "outputs": "itm match scores [n] (row i = text i vs image-state i; add the "
                          "ITC sim like the reference, compress_retrieval_dtp.py:178)",
               "batching": {"batch": n, "inputs": [1, 1, 1, 1, 0], "outputs": [1]}, **meta}
    if ri:
        img_meta = _mark_row_independent(img_meta, [1, 1, 1])
        txt_meta = _mark_row_independent(txt_meta, [1, 1], kept_outputs={1: "text"})
        rr_meta = _mark_row_independent(rr_meta, [1])
    t = _t(temperature)
    save_artifact(os.path.join(args.output_dir, "image_encoder"), model, "retrieval",
                  "image_encoder", (images, t), meta=img_meta, mesh=_mesh(args))
    save_artifact(os.path.join(args.output_dir, "text_encoder"), model, "retrieval",
                  "text_encoder", (ids, mask, t), meta=txt_meta, mesh=_mesh(args))
    save_artifact(os.path.join(args.output_dir, "itm_rerank"), model, "retrieval",
                  "itm_rerank", (r_ids, r_mask, sx, sa, t), meta=rr_meta, mesh=_mesh(args))
    print(f"exported retrieval serving artifacts -> {args.output_dir}"
          f"/{{image_encoder,text_encoder,itm_rerank}} (T={temperature})")


EXPORTERS = {"nlvr": export_nlvr, "clip": export_clip, "caption": export_caption,
             "vqa": export_vqa, "retrieval": export_retrieval}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--task", required=True, choices=sorted(EXPORTERS))
    p.add_argument("--config", default="")
    p.add_argument("--pretrained", default="")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--batch", default=32, type=int, help="served batch size (static)")
    p.add_argument("--text_len", default=26, type=int,
                   help="served text length (static; nlvr/vqa questions/retrieval captions)")
    p.add_argument("--prompt_len", default=4, type=int,
                   help="caption: BOS-prefixed prompt token count ('[DEC] a picture of' = 4)")
    p.add_argument("--num_beams", default=3, type=int)
    p.add_argument("--max_length", default=20, type=int)
    p.add_argument("--min_length", default=5, type=int)
    p.add_argument("--eos_id", default=102, type=int, help="EOS token id (BERT [SEP]=102)")
    p.add_argument("--pad_id", default=0, type=int)
    p.add_argument("--num_answers", default=3128, type=int,
                   help="vqa: answer-list rows the artifact accepts (static)")
    p.add_argument("--answer_len", default=10, type=int,
                   help="vqa: tokenized answer length (static)")
    p.add_argument("--k_test", default=128, type=int, help="vqa: rerank shortlist size")
    p.add_argument("--rerank_batch", default=128, type=int,
                   help="retrieval: rows per itm_rerank call")
    p.add_argument("--temperature", default=None, type=float,
                   help="override the checkpoint's stored DTP temperature")
    p.add_argument("--fast_eval", action="store_true",
                   help="export the calibrated gather fast path")
    p.add_argument("--cap_mode", default="ceil", choices=["ceil", "nearest"])
    p.add_argument("--probe_npz", default="",
                   help="npz for --fast_eval calibration: first array = real images "
                        "(>= batch; NLVR needs 2*batch); optional 'ids'/'mask' = real text")
    p.add_argument("--probe_sentences", default="",
                   help="text file (one sentence per line, >= batch) for --fast_eval text "
                        "calibration (nlvr)")
    p.add_argument("--bert_vocab", default="",
                   help="BERT vocab.txt for --probe_sentences tokenization")
    p.add_argument("--row_independent", action="store_true",
                   help="export per-row DTP: every row computes as if served alone, so the "
                        "server may merge requests into one device call")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the model runs: the card (raises without one) or the CPU")
    p.add_argument("--mesh", default="",
                   help="DATAxMODEL, e.g. 1x2: a multi-device artifact served over that "
                        "(data, model) mesh of processes")
    return p


def _mesh(args):
    """``--mesh`` as ``(n_data, n_model)``, or None."""
    if not getattr(args, "mesh", ""):
        return None
    n_data, n_model = (int(v) for v in args.mesh.lower().split("x"))
    return n_data, n_model


def load_export_config(args) -> dict:
    """The task yaml (PyYAML at the call), as the JAX exporter reads it."""
    from madtp_tpu_torch.cli.common import load_config

    if not args.config:
        return {}
    return load_config(types.SimpleNamespace(
        config=args.config, synthetic=False, p=0.5, pretrained=args.pretrained, epoch=0,
        batch_size_train=0, batch_size_test=0))


def main(argv: Optional[Sequence[str]] = None):
    from madtp_tpu_torch.core.device import resolve_device

    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    EXPORTERS[args.task](args, load_export_config(args), dev)


if __name__ == "__main__":
    main()
