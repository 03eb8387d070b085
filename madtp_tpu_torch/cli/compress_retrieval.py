"""BLIP image-text retrieval compression and evaluation driver (counterpart of
``madtp_tpu/cli/compress_retrieval.py``, reference ``compress_retrieval_dtp.py``
and ``compress_retrieval_flickr_dtp.py``, which differ only in config).

    python -m madtp_tpu_torch.cli.compress_retrieval --config configs/retrieval_coco.yaml \
        --evaluate --pretrained output/Retrieval_coco/checkpoint_best.pth
    python -m madtp_tpu_torch.cli.compress_retrieval --config configs/retrieval_flickr.yaml \
        --p 0.5 --pretrained pretrained/model_base_retrieval_flickr.pth

The eval embeds the test corpus (ITC), reranks each row's ``k_test``
candidates with the ITM head on the encoder-token text, and writes
``itm_eval``'s recalls to ``evaluate.txt``.  Training runs the controller's
epochs of the ITC + ITM step (momentum towers, the feature queue, hard
negatives), each followed by the eval; the best ``r_mean`` within 10 GFLOPs of
the target goes to ``checkpoint_best.pth``, every epoch to ``log.txt`` and the
resume checkpoint.  ``--synthetic`` evaluates a tiny seeded model on a random
corpus.  ``--device cpu`` runs on the CPU; by default the driver needs a card.

Under ``--num_processes`` N the eval runs over the ranks: each encodes a
contiguous block of the image batches (:func:`~madtp_tpu_torch.tasks.
retrieval.encode_corpus_sharded`), reranks its rows of each direction by the
reference's row arithmetic, and the score matrices are merged on every rank
(bit for bit those of one process).  Training runs each step over the global
batch, each rank a shard of ``batch_size_train`` (the last partial batch
dropped): the ITC against every rank's momentum features, the hard negatives
from every rank's rows with ``negative_all_rank`` (on in
``configs/retrieval_coco.yaml``) or from the rank's own, the queue fed every
rank's batch (``train/loops.py`` ``make_retrieval_train_step``).  Every rank
draws the hard negatives' global noise from a generator seeded alike, so the
parameters, the queue and the generator stay the same on every rank; rank 0
writes the logs, the config, the checkpoints and the resume file, which
resumes every rank.  With one process both values of ``negative_all_rank``
mine the whole batch.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from madtp_tpu_torch.ckpt.convert import load_retrieval_state_dict, save_retrieval_checkpoint
from madtp_tpu_torch.cli.common import (base_parser, build_blip_cfg, cached_probe_batches,
                                        dump_config, dump_log, eval_image_transform,
                                        load_config, load_resume, make_tokenizer,
                                        read_checkpoint, save_resume, set_seed, setup_runtime,
                                        train_image_transform)
from madtp_tpu_torch.core.config import BlipConfig, MedConfig, ViTConfig
from madtp_tpu_torch.data.datasets import CaptionTrainDataset, RetrievalEvalDataset
from madtp_tpu_torch.data.loader import batched_loader, num_batches
from madtp_tpu_torch.data.transforms import PerSampleRng
from madtp_tpu_torch.eval.metrics import itm_eval
from madtp_tpu_torch.models.blip import init_retrieval_model
from madtp_tpu_torch.parallel import dist
from madtp_tpu_torch.tasks import retrieval as task
from madtp_tpu_torch.train.controller import TemperatureController
from madtp_tpu_torch.train.loops import init_retrieval_train_state, make_retrieval_train_step
from madtp_tpu_torch.train.optim import cosine_lr, make_adamw, set_lr
from madtp_tpu_torch.utils import preempt
from madtp_tpu_torch.utils.cache import BoundedCache
from madtp_tpu_torch.utils.logging import MetricLogger

ORI_GFLOPS = 153.2  # reference compress_retrieval_dtp.py:383
BEST_SLACK = 10.0  # GFLOPs above the target a best checkpoint may be (:486)


def synthetic_setup(image_size: int, vocab_size: int, n_img: int, device):
    """``--synthetic``'s model and corpus (``compress_retrieval.py:57-94``): a
    2-layer ViT and MED of width 64, 16-wide projections, a codebook of 10,
    seeded; ``n_img`` random images in batches of 3 (the last one ragged)
    and one text each."""
    vit = ViTConfig(image_size=image_size, patch_size=16, embed_dim=64, depth=2, num_heads=4,
                    sd_dim=64)
    med = MedConfig(vocab_size=vocab_size, hidden_size=64, num_hidden_layers=2,
                    num_attention_heads=4, intermediate_size=256, max_position_embeddings=64,
                    encoder_width=64, sd_dim=64)
    model = init_retrieval_model(BlipConfig(vit=vit, med=med, sd_num=10, sd_dim=64), seed=0,
                                 device=device, embed_dim=16)
    rng = np.random.RandomState(1)
    batches = [rng.randn(min(3, n_img - i), 3, image_size, image_size).astype(np.float32)
               for i in range(0, n_img, 3)]
    texts = [f"a picture of w{i}" for i in range(n_img)]
    return model, batches, texts, {i: i for i in range(n_img)}, {i: [i] for i in range(n_img)}


def first_batch(batches) -> np.ndarray:
    it = iter(batches)
    try:
        return next(it)
    finally:
        close = getattr(it, "close", None)
        if close is not None:
            close()


def build_parser():
    """The driver's flags (the JAX driver's, ``--device`` for ``--platform``)."""
    return base_parser("configs/retrieval_flickr.yaml", "pretrained/model_base_retrieval_coco.pth",
                       default_output="output/Retrieval_flickr")


def main(argv=None):
    # the reference defaults to the Flickr yaml with a COCO checkpoint (its
    # scripts always pass --config)
    args = build_parser().parse_args(argv)
    device = setup_runtime(args)
    config = load_config(args)
    set_seed(args.seed)
    os.makedirs(args.output_dir, exist_ok=True)
    dump_config(config, args.output_dir)

    image_size = config.get("image_size", 64 if args.synthetic else 384)
    tokenizer = make_tokenizer(args, config)
    enc = tokenizer.enc_token_id
    k_test = config.get("k_test", 4 if args.synthetic else 256)
    batch_test = config.get("batch_size_test", 32)

    if args.synthetic:
        model, synthetic_batches, texts, txt2img, img2txt = synthetic_setup(
            image_size, len(tokenizer.vocab), args.synthetic_corpus, device)
        temperature = 1.0
        n_image_batches = len(synthetic_batches)

        def image_blocks(lo, hi):
            return iter(synthetic_batches[lo:hi])
    else:
        cfg = build_blip_cfg(config, image_size)
        if config.get("pretrained"):
            sd, extras = read_checkpoint(config["pretrained"])
            model = load_retrieval_state_dict(sd, cfg, device=device)
            temperature = float(extras.get("temperature", 0.0))
        else:
            print("WARNING: no --pretrained given; random init")
            model = init_retrieval_model(cfg, seed=args.seed, device=device,
                                         embed_dim=16 if cfg.med.hidden_size <= 64 else 256)
            temperature = 1.0
        ds = RetrievalEvalDataset(eval_image_transform(args, image_size), config["image_root"],
                                  config["ann_root"], "test", dataset=config.get("dataset", "coco"))
        texts, txt2img, img2txt = ds.text, ds.txt2img, ds.img2txt
        n_image_batches = -(-len(ds.image) // batch_test)

        def image_blocks(lo, hi):
            # a rank decodes only its block of the batch schedule
            return (b[0] for b in batched_loader(ds, batch_test, batch_range=(lo, hi)))

    def image_batches():
        return image_blocks(0, n_image_batches)

    tok = tokenizer(texts, padding="longest", max_length=35)
    text_ids, text_mask = np.asarray(tok["input_ids"]), np.asarray(tok["attention_mask"])
    enc_ids = text_ids.copy()  # the ITM reranks on [ENC]-token text (reference :168)
    enc_ids[:, 0] = enc

    n_procs, rank = dist.process_count(), dist.process_index()
    shard = (n_procs, rank) if n_procs > 1 else None

    def full_scores(temperature, prune, caps_v=None, caps_t=None):
        img_feats, img_states, txt_feats = task.encode_corpus_sharded(
            model, image_blocks, n_image_batches, text_ids, text_mask,
            temperature=temperature, prune_active=prune, capacities_v=caps_v,
            capacities_t=caps_t)
        s_i2t, s_t2i = task.rerank_scores(
            model, img_feats, img_states, txt_feats, enc_ids, text_mask,
            k_test=min(k_test, len(texts)), temperature=temperature, prune_active=prune,
            capacities_t=caps_t, shard=shard)
        if shard is not None:
            # a rank that died in its rerank shows here, not inside the gather
            dist.barrier("retrieval_scores")
            s_i2t, s_t2i = dist.merge_scores(s_i2t), dist.merge_scores(s_t2i)
        return s_i2t, s_t2i

    prune = temperature > 0
    caps_v = caps_t = None
    if args.fast_eval and prune:
        # several mask-mode batches (max + margin covers their spread)
        caps_v, caps_t = task.probe_capacities(model, image_batches(), text_ids, text_mask,
                                               temperature, args.cap_mode)
        print("fast_eval capacities:", caps_v, caps_t)
    s_i2t, s_t2i = full_scores(temperature, prune, caps_v, caps_t)
    if os.environ.get("MADTP_DUMP_SCORES"):
        # each rank holds the merged matrices; a name a rank keeps a shared
        # output directory free of races
        name = "scores.npz" if n_procs <= 1 else f"scores_r{rank}.npz"
        np.savez(os.path.join(args.output_dir, name), i2t=s_i2t, t2i=s_t2i)
    stats = itm_eval(s_i2t, s_t2i, txt2img, img2txt)
    log = {k: round(v, 3) for k, v in stats.items()}
    dump_log(args.output_dir, "evaluate.txt", log, append=False)
    print("LOG:", log)
    if args.evaluate or args.synthetic:
        return

    # ---- compression training (reference compress_retrieval_dtp.py:389-470) ----
    target = ORI_GFLOPS * (1.0 - config["p"])
    alpha_cfg = float(config.get("alpha", 0.4))
    init_lr = config.get("init_lr", 1e-5)
    batch_train = config.get("batch_size_train", 16)
    state = init_retrieval_train_state(model, queue_size=config.get("queue_size", 57600))
    opt = make_adamw(model.parameters(), lr=init_lr,
                     weight_decay=config.get("weight_decay", 0.05), capturable=False)

    def make_step(caps=(None, None)):
        return make_retrieval_train_step(
            state, opt, alpha=alpha_cfg, enc_token_id=enc,
            negative_all_rank=bool(config.get("negative_all_rank", False)),
            capacities_v=caps[0], capacities_t=caps[1], amp=args.amp, device=device.type)

    train_step = make_step()
    controller = TemperatureController(target_gflops=target)
    train_ds = CaptionTrainDataset(train_image_transform(args, image_size,
                                                         PerSampleRng(args.seed)),
                                   config["image_root"], config["ann_root"],
                                   dataset=config.get("dataset", "coco"))
    epoch_len = num_batches(len(train_ds), batch_train, num_shards=n_procs, drop_last=True)
    step_cache = BoundedCache()  # --fast_train: capacity schedule -> step
    probe_cache = [None]

    def fast_train_step(temperature):
        """Capacities from the cached mask-mode probe batches at this epoch's
        temperature, and the gather-mode step (both towers, the momentum
        ones and the ITM compacted).  The probe batches are not sharded, so
        every rank computes the same capacities."""
        probe = cached_probe_batches(probe_cache, lambda: batched_loader(
            train_ds, batch_train, shuffle=True, epoch=0,
            drop_last=len(train_ds) >= batch_train))  # the partial batch when it is the only one
        key = task.train_capacities(model, probe, tokenizer, enc, temperature, args.cap_mode)
        if key not in step_cache:
            step_cache[key] = make_step(key)
        return step_cache[key], key

    # the hard negatives' draws: the JAX driver carries a PRNG key, this one a
    # generator, seeded alike on every rank (each takes its rows of the global draw)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    extra = {**{f"params_m.{n}": t for n, t in state.params_m.items()},
             **{f"queue.{k}": getattr(state.queue, k) for k in state.queue._fields},
             "temp": state.temp, "generator": generator}
    best, best_epoch, cur_g = 0.0, 0, ORI_GFLOPS
    start_epoch = resume_skip = 0
    if args.resume:
        meta = load_resume(args.resume, model, opt,
                           {"epoch": 0, "temperature": 0.0, "cur_gflops": 0.0, "best": 0.0,
                            "batches_done": 0}, extra=extra)
        start_epoch = int(meta["epoch"]) + 1
        controller.temperature = float(meta["temperature"])
        cur_g, best = float(meta["cur_gflops"]), float(meta["best"])
        resume_skip = int(meta["batches_done"])
        print(f"resumed from {args.resume} at epoch {start_epoch}"
              + (f" (skipping {resume_skip} trained batches)" if resume_skip else ""))

    guard = preempt.PreemptionGuard()
    print("LOG: preemption guard armed", flush=True)
    for epoch in range(start_epoch, config["max_epoch"]):
        pre_temp = controller.temperature  # the interrupted epoch's resume state
        if epoch > 0:
            controller.update(cur_g)
        temperature = controller.temperature
        lr = cosine_lr(epoch, config["max_epoch"], init_lr, config.get("min_lr", 0.0))
        set_lr(opt, lr)
        step_fn = train_step
        if args.fast_train and temperature > 0:
            step_fn, sched = fast_train_step(temperature)
            print("fast_train capacities:", sched)
        skip = resume_skip if epoch == start_epoch else 0
        train_stats = task.train_epoch(
            model, step_fn,
            lambda: MetricLogger().log_every(
                batched_loader(train_ds, batch_train, shuffle=True, epoch=epoch,
                               drop_last=True, num_shards=n_procs, shard_id=rank,
                               batch_range=(skip, 1 << 31) if skip else None),
                50, f"Train [{epoch}]"),
            tokenizer, temperature, epoch=epoch, epoch_len=epoch_len, alpha=alpha_cfg,
            generator=generator, lr=lr, stop=guard.should_stop, done0=skip)
        print("Train:", train_stats)
        if guard.sync_now():
            # the pre-epoch controller state and the trained batch count:
            # --resume restarts this epoch and skips those batches
            save_resume(args.output_dir, model, opt,
                        {"epoch": epoch - 1, "temperature": float(pre_temp),
                         "cur_gflops": float(cur_g), "best": float(best),
                         "batches_done": skip + train_stats["batches_done"]}, extra=extra)
            print("LOG: preempted — resume checkpoint saved; restart with --resume")
            return
        s_i2t, s_t2i = full_scores(temperature, True)
        stats = itm_eval(s_i2t, s_t2i, txt2img, img2txt)
        cur_g = task.epoch_gflops(model, first_batch(image_batches()), temperature,
                                  text_ids.shape[1])
        log = {"epoch": epoch, "Cur_Gflops": round(cur_g, 2),
               **{k: round(v, 3) for k, v in stats.items()}}
        # every rank tracks the best (the merged scores are the same); rank 0 writes
        if stats["r_mean"] > best and cur_g - target < BEST_SLACK:
            best, best_epoch = stats["r_mean"], epoch
            if dist.is_main_process():
                save_retrieval_checkpoint(model, os.path.join(args.output_dir,
                                                              "checkpoint_best.pth"),
                                          epoch=epoch, temperature=temperature)
        dump_log(args.output_dir, "log.txt", log)
        print("LOG:", log)
        save_resume(args.output_dir, model, opt,
                    {"epoch": epoch, "temperature": float(temperature),
                     "cur_gflops": float(cur_g), "best": float(best), "batches_done": 0},
                    extra=extra)
    print(f"LOG: best epoch: {best_epoch}")


if __name__ == "__main__":
    sys.exit(main())
