"""CLIP image-text retrieval compression and evaluation driver (counterpart of
``madtp_tpu/cli/compress_retrieval_clip.py``, reference
``compress_retrieval_clip_dtp.py``): dual-tower ITC ranking, no ITM rerank.

    python -m madtp_tpu_torch.cli.compress_retrieval_clip \
        --config configs/retrieval_flickr_clip.yaml --evaluate --pretrained ...
    python -m madtp_tpu_torch.cli.compress_retrieval_clip \
        --config configs/retrieval_flickr_clip.yaml --p 0.5 --pretrained ...

The architecture comes from the checkpoint's shapes (ViT or ModifiedResNet
visual tower); its codebook ``space_dict`` and stored temperature decide
whether the eval prunes.  The test corpus is decoded once and sliced into
batches; the eval writes ``itm_eval``'s recalls on ``img @ txt.T`` and the
GFLOPs to ``evaluate.txt``.  Training runs the controller's epochs of the
queue InfoNCE step, each followed by the eval; the best ``r_mean`` within 5
GFLOPs of the target goes to ``checkpoint_best.pth``, every epoch to
``log.txt`` and the resume checkpoint.  An RN checkpoint evaluates but does
not train: its tower is inference-only, as in the JAX package, whose driver
fails on one at its first checkpoint write.  ``--synthetic`` evaluates a
tiny seeded model.  ``--device cpu`` runs on the CPU; by default the driver
needs a card.

Under ``--num_processes`` N the eval runs over the ranks: each decodes and
encodes a contiguous block of both towers' batches
(:func:`~madtp_tpu_torch.tasks.clip_retrieval.encode_towers_sharded`), and
every rank ranks the gathered features, bit for bit those of one process.
Training runs each step over the global batch, each rank a shard of
``batch_size_train`` (the last partial batch dropped): the ITC against every
rank's momentum features and the queue fed every rank's batch
(``train/loops.py`` ``make_clip_train_step``), so the parameters and the
queue stay the same on every rank; rank 0 writes the logs, the config, the
checkpoints and the resume file, which resumes every rank.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from madtp_tpu_torch.ckpt.convert import (clip_from_jax_params, load_clip_state_dict,
                                          save_clip_checkpoint)
from madtp_tpu_torch.cli.common import (base_parser, cached_probe_batches, dump_config,
                                        dump_log, eval_image_transform, load_config,
                                        load_resume, read_checkpoint, save_resume, set_seed,
                                        setup_runtime, train_image_transform)
from madtp_tpu_torch.core.config import CLIPConfig, infer_clip_config
from madtp_tpu_torch.data.datasets import CaptionTrainDataset, RetrievalEvalDataset
from madtp_tpu_torch.data.loader import batched_loader, num_batches
from madtp_tpu_torch.data.tokenizer_clip import ClipBPETokenizer, clip_tokenize
from madtp_tpu_torch.data.transforms import PerSampleRng
from madtp_tpu_torch.eval.metrics import itm_eval
from madtp_tpu_torch.parallel import dist
from madtp_tpu_torch.prune.flops import clip_gflops
from madtp_tpu_torch.tasks import clip_retrieval as task
from madtp_tpu_torch.train.controller import TemperatureController
from madtp_tpu_torch.train.loops import init_clip_train_state, make_clip_train_step
from madtp_tpu_torch.train.optim import cosine_lr, make_adamw, set_lr
from madtp_tpu_torch.utils import preempt
from madtp_tpu_torch.utils.cache import BoundedCache
from madtp_tpu_torch.utils.logging import MetricLogger

ORI_GFLOPS = 395.7  # reference compress_retrieval_clip_dtp.py:281


def jax_layout_params(cfg: CLIPConfig, rng: np.random.RandomState) -> dict:
    """Seeded random CLIP weights in the JAX package's tree layout, drawn as
    its ``init_clip_params`` draws them (``madtp_tpu/models/clip.py:298-343``),
    so that ``--synthetic`` runs the JAX driver's model: linears N(0,
    1/fan_in) stacked per tower, LayerNorms 1, ``conv1`` and the token
    embedding N(0, 0.02^2), the text position embedding N(0, 0.01^2), the
    class and vision position embeddings and both projections N(0, 1/width)."""
    W, LV = cfg.vision_width, cfg.vision_layers
    TW, LT = cfg.transformer_width, cfg.transformer_layers
    E, K = cfg.embed_dim, cfg.sd_dim

    def blocks(L, D):
        def lin(i, o):
            return {"kernel": (rng.randn(L, i, o) * (i ** -0.5)).astype(np.float32),
                    "bias": np.zeros((L, o), np.float32)}

        def ln():
            return {"scale": np.ones((L, D), np.float32), "bias": np.zeros((L, D), np.float32)}

        return {"ln_1": ln(), "attn": {"in_proj": lin(D, 3 * D), "out_proj": lin(D, D)},
                "ln_2": ln(), "mlp": {"c_fc": lin(D, 4 * D), "c_proj": lin(4 * D, D)},
                "query_model": {"q_map": lin(D, K)}}

    def ln1(D):
        return {"scale": np.ones((D,), np.float32), "bias": np.zeros((D,), np.float32)}

    pdim = 3 * cfg.vision_patch_size ** 2
    return {
        "visual": {
            "conv1": {"kernel": (rng.randn(pdim, W) * 0.02).astype(np.float32)},
            "class_embedding": (rng.randn(W) * W ** -0.5).astype(np.float32),
            "positional_embedding": (rng.randn(cfg.vision_num_patches + 1, W)
                                     * W ** -0.5).astype(np.float32),
            "ln_pre": ln1(W), "blocks": blocks(LV, W), "ln_post": ln1(W),
            "proj": (rng.randn(W, E) * W ** -0.5).astype(np.float32)},
        "token_embedding": (rng.randn(cfg.vocab_size, TW) * 0.02).astype(np.float32),
        "positional_embedding": (rng.randn(cfg.context_length, TW) * 0.01).astype(np.float32),
        "blocks": blocks(LT, TW),
        "ln_final": ln1(TW),
        "text_projection": (rng.randn(TW, E) * TW ** -0.5).astype(np.float32),
        "logit_scale": np.asarray(np.log(1.0 / 0.07), np.float32),
    }


def synthetic_setup(device):
    """``--synthetic``'s model and corpus (``compress_retrieval_clip.py:
    102-125``): 2 + 2 layers of width 64 (4 vision heads) at 64 px, context
    16 over 200 ids, a codebook of 10, and 6 random images with a text each
    (EOT the highest id), all from one seeded stream."""
    cfg = CLIPConfig(embed_dim=16, image_resolution=64, vision_layers=2, vision_width=64,
                     vision_patch_size=16, vision_heads_override=4, context_length=16,
                     vocab_size=200, transformer_width=64, transformer_heads=4,
                     transformer_layers=2, sd_dim=64)
    rng = np.random.RandomState(0)
    tree = jax_layout_params(cfg, rng)
    space_dict = rng.randn(10, 64).astype(np.float32)
    model = clip_from_jax_params(tree, cfg, space_dict, device=device)
    n = 6
    images = rng.randn(n, 3, 64, 64).astype(np.float32)
    text = np.zeros((n, 16), np.int64)
    for i in range(n):
        text[i, 0] = 197  # SOT
        text[i, 1:3 + i % 3] = rng.randint(5, 190, size=2 + i % 3)
        text[i, 3 + i % 3] = 199  # EOT, the highest id
    return model, images, text, {i: i for i in range(n)}, {i: [i] for i in range(n)}


def build_parser():
    """The driver's flags (the JAX driver's, ``--device`` for ``--platform``)."""
    return base_parser("configs/retrieval_flickr_clip.yaml",
                       "pretrained/clip_large_retrieval_flickr.pth",
                       default_output="output/Retrieval_flickr")


def main(argv=None):
    # the reference defaults to the BLIP Flickr yaml, which its CLIP driver
    # cannot load; this one defaults to the CLIP yaml
    args = build_parser().parse_args(argv)
    device = setup_runtime(args)
    config = load_config(args)
    set_seed(args.seed)
    os.makedirs(args.output_dir, exist_ok=True)
    dump_config(config, args.output_dir)

    bt = int(config.get("batch_size_test", 32))
    n_procs, rank = dist.process_count(), dist.process_index()
    if args.synthetic:
        model, corpus, text, txt2img, img2txt = synthetic_setup(device)
        temperature = 1.0
        n_images = len(corpus)
    else:
        sd, extras = read_checkpoint(config["pretrained"])
        cfg = infer_clip_config(sd, config.get("sd_dim", 768))
        model = load_clip_state_dict(sd, cfg, device=device)
        temperature = float(extras.get("temperature", 0.0))
        ds = RetrievalEvalDataset(eval_image_transform(args, cfg.image_resolution),
                                  config["image_root"], config["ann_root"], "test",
                                  dataset=config.get("dataset", "flickr"))
        tokenizer = ClipBPETokenizer()
        text = clip_tokenize(tokenizer, ds.text, cfg.context_length)
        txt2img, img2txt = ds.txt2img, ds.img2txt
        n_images, corpus = len(ds), None
    cfg = model.cfg

    def image_blocks(lo, hi):
        """Image batches ``lo`` to ``hi`` of the test schedule.  One process
        decodes the corpus once and slices it (every training epoch
        evaluates it); under several, each rank decodes only its block."""
        nonlocal corpus
        if corpus is None and n_procs > 1:
            return (b[0] for b in batched_loader(ds, bt, batch_range=(lo, hi)))
        if corpus is None:
            corpus = np.concatenate([b[0] for b in batched_loader(ds, bt)])
        return (corpus[b * bt:(b + 1) * bt] for b in range(lo, hi))

    def image_batches():
        return image_blocks(0, -(-n_images // bt))

    prune = temperature > 0
    caps_v = None
    if args.fast_eval and prune and not cfg.is_resnet and (args.evaluate or args.synthetic):
        # an evaluation run's vision schedule (training moves the temperature
        # every epoch, so a schedule calibrated at start would go stale); the
        # causal text tower stays in mask mode
        caps_v = task.probe_capacities(model, image_batches(), temperature, args.cap_mode)
        print("fast_eval vision capacities:", caps_v)
    img, txt, v_kept, t_kept = task.encode_towers_sharded(
        model, image_blocks, n_images, text, temperature=temperature, prune_active=prune,
        capacities_v=caps_v, batch_size=bt)
    sims = img @ txt.T
    if os.environ.get("MADTP_DUMP_SCORES"):  # every rank's gathered similarities
        np.savez(os.path.join(args.output_dir, f"clip_sims_r{rank}.npz"), sims=sims)
    stats = itm_eval(sims, sims.T, txt2img, img2txt)
    # a dense encode's kept counts are the full token counts: the dense GFLOPs
    cur_g = clip_gflops(cfg, v_kept, t_kept)
    log = {**{k: round(v, 3) for k, v in stats.items()}, "Cur_Gflops": round(cur_g, 3)}
    dump_log(args.output_dir, "evaluate.txt", log, append=False)
    print("LOG:", log)
    if args.evaluate or args.synthetic:
        return

    # ---- compression training (reference compress_retrieval_clip_dtp.py:283-365) ----
    if cfg.is_resnet:
        raise NotImplementedError(
            "compression training of a ModifiedResNet CLIP tower: the tower is inference-only "
            "(BatchNorm on the checkpoint's running statistics, no pruning), as in the JAX "
            "package, whose driver fails on one at its first checkpoint write (ROADMAP)")
    target = ORI_GFLOPS * (1.0 - config["p"])
    alpha_cfg = float(config.get("alpha", 0.4))
    init_lr = config.get("init_lr", 1e-5)
    batch_train = config.get("batch_size_train", 16)
    state = init_clip_train_state(model, queue_size=config.get("queue_size", 57600))
    opt = make_adamw(model.parameters(), lr=init_lr,
                     weight_decay=config.get("weight_decay", 0.2))

    def make_step(caps_v=None):
        return make_clip_train_step(state, opt, alpha=alpha_cfg, capacities_v=caps_v,
                                    amp=args.amp, device=device.type)

    train_step = make_step()
    controller = TemperatureController(target_gflops=target)
    train_ds = CaptionTrainDataset(train_image_transform(args, cfg.image_resolution,
                                                         PerSampleRng(args.seed)),
                                   config["image_root"], config["ann_root"],
                                   dataset=config.get("dataset", "flickr"))
    epoch_len = num_batches(len(train_ds), batch_train, num_shards=n_procs, drop_last=True)
    step_cache = BoundedCache()  # --fast_train: vision capacity schedule -> step
    probe_cache = [None]

    def fast_train_step(temperature):
        """Vision capacities from the cached mask-mode probe batches at this
        epoch's temperature, and the gather-mode step (the causal text tower
        stays in mask mode).  The probe batches are not sharded, so every
        rank computes the same capacities."""
        probe = cached_probe_batches(probe_cache, lambda: batched_loader(
            train_ds, batch_train, shuffle=True, epoch=0,
            drop_last=len(train_ds) >= batch_train))  # the partial batch when it is the only one
        cv = task.train_capacities(model, probe, temperature, args.cap_mode)
        if cv not in step_cache:
            step_cache[cv] = make_step(cv)
        return step_cache[cv], cv

    extra = {**{f"params_m.{n}": t for n, t in state.params_m.items()},
             **{f"queue.{k}": getattr(state.queue, k) for k in state.queue._fields}}
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
            tokenizer, temperature, epoch=epoch, epoch_len=epoch_len, alpha=alpha_cfg, lr=lr,
            stop=guard.should_stop, done0=skip)
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
        # the eval prunes when the epoch's temperature does, whatever the
        # (dense) checkpoint the run started from
        stats, cur_g, improved = task.eval_epoch(model, image_batches(), text, txt2img,
                                                 img2txt, temperature, best=best,
                                                 target_gflops=target, batch_size=bt)
        log = {"epoch": epoch, "Cur_Gflops": round(cur_g, 2),
               **{k: round(v, 3) for k, v in stats.items()}}
        if improved:  # every rank tracks the best (the same stats); rank 0 writes
            best, best_epoch = stats["r_mean"], epoch
            if dist.is_main_process():
                save_clip_checkpoint(model, os.path.join(args.output_dir,
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
