"""COCO captioning compression and evaluation driver (counterpart of
``madtp_tpu/cli/compress_caption.py``, reference ``compress_caption_dtp.py``).

    python -m madtp_tpu_torch.cli.compress_caption --p 0.5 \
        --pretrained pretrained/model_base_caption_capfilt_large.pth
    python -m madtp_tpu_torch.cli.compress_caption --evaluate --pretrained ...

Evaluation decodes 3 beams (``max_length`` 20, ``min_length`` 5) from the
prompt ``"a picture of "`` over the pruned image tokens and writes the
captions as JSON.  Training starts from a pre-searched temperature; each
epoch's val captions are scored by :mod:`madtp_tpu_torch.eval.caption_metrics`
when the ground truth is there, and the checkpoint gate is CIDEr +
SPICE_offline (the reference's CIDEr + SPICE, with the offline scene-graph
scorer in SPICE's place) within 5 GFLOPs of the target.

Under ``--num_processes`` N every split is sharded over the ranks, each
train step spans the global batch (captions padded to 40 tokens), each
rank's captions go through :func:`~madtp_tpu_torch.data.text_utils.
save_result` (rank 0 merges them and scores the merged val split), the
GFLOPs are averaged over the ranks, and rank 0 writes the logs and
checkpoints.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

from madtp_tpu_torch.ckpt.convert import load_caption_state_dict, save_caption_checkpoint
from madtp_tpu_torch.cli.common import (base_parser, build_blip_cfg, cached_probe_batches,
                                        dump_config, dump_log, eval_image_transform,
                                        load_config, load_resume, make_tokenizer,
                                        mean_over_ranks, read_checkpoint, save_resume,
                                        set_seed, setup_runtime, synthetic_cfg,
                                        train_image_transform)
from madtp_tpu_torch.data.datasets import CaptionEvalDataset, CaptionTrainDataset
from madtp_tpu_torch.data.loader import batched_loader
from madtp_tpu_torch.data.text_utils import save_result
from madtp_tpu_torch.data.transforms import PerSampleRng
from madtp_tpu_torch.eval.caption_metrics import coco_caption_scores
from madtp_tpu_torch.models.blip import init_caption_model
from madtp_tpu_torch.parallel import dist
from madtp_tpu_torch.tasks import caption as task
from madtp_tpu_torch.train.controller import TemperatureController
from madtp_tpu_torch.train.loops import make_caption_train_step
from madtp_tpu_torch.train.optim import cosine_lr, make_adamw, set_lr
from madtp_tpu_torch.utils import preempt
from madtp_tpu_torch.utils.cache import BoundedCache
from madtp_tpu_torch.utils.logging import MetricLogger

ORI_GFLOPS = 65.7  # reference compress_caption_dtp.py:216
PROMPT = task.PROMPT


def build_parser():
    """The driver's flags (the JAX driver's, ``--device`` for ``--platform``)."""
    return base_parser("configs/caption_coco.yaml",
                       "pretrained/model_base_caption_capfilt_large.pth",
                       default_output="output/Caption_coco")


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = setup_runtime(args)
    config = load_config(args)
    set_seed(args.seed)
    os.makedirs(args.output_dir, exist_ok=True)
    dump_config(config, args.output_dir)

    image_size = config.get("image_size", 64 if args.synthetic else 384)
    tokenizer = make_tokenizer(args, config)
    n_procs, rank = dist.process_count(), dist.process_index()

    temperature = 1.0
    if args.synthetic:
        model = init_caption_model(synthetic_cfg(image_size, len(tokenizer.vocab)), seed=0,
                                   device=device)  # the JAX driver's
    else:
        cfg = build_blip_cfg(config, image_size)
        if config.get("pretrained"):
            sd, extras = read_checkpoint(config["pretrained"])
            model = load_caption_state_dict(sd, cfg, device=device)
            if args.evaluate:
                temperature = float(extras.get("temperature", 0.0))
        else:
            print("WARNING: no --pretrained given; random init")
            model = init_caption_model(cfg, seed=args.seed, device=device)

    caps_v = None

    def calibrate_fast_eval(batches):
        nonlocal caps_v
        caps_v = task.probe_capacities(model, batches, temperature, args.cap_mode)
        print("fast_eval vision capacities:", caps_v)

    def eval_epoch(temperature, loader):
        return task.evaluate(model, tokenizer, MetricLogger().log_every(loader(), 10,
                                                                        "Caption eval:"),
                             temperature=temperature, capacities=caps_v)

    if args.synthetic:
        rng = np.random.RandomState(1)

        def loader():
            for i in range(args.synthetic_batches):
                yield (rng.randn(2, 3, image_size, image_size).astype(np.float32),
                       np.arange(2) + 2 * i)

        if args.fast_eval and temperature > 0:
            rngp = np.random.RandomState(9)
            calibrate_fast_eval([(rngp.randn(4, 3, image_size, image_size)
                                  .astype(np.float32), None) for _ in range(2)])
        results, cur_g = eval_epoch(temperature, loader)
        save_result(results, args.output_dir, "test_epoch_eval", remove_duplicate="image_id")
        cur_g = mean_over_ranks(cur_g)
        log = {"n_captions": len(results), "Cur_Gflops": round(cur_g, 4),
               "sample": results[0]["caption"] if results else ""}
        dump_log(args.output_dir, "evaluate.txt", log, append=False)
        print("LOG:", log)
        return

    def make_loader(split):
        ds = CaptionEvalDataset(eval_image_transform(args, image_size), config["image_root"],
                                config["ann_root"], split)
        return lambda: batched_loader(ds, config.get("batch_size_test", 32),
                                      num_shards=n_procs, shard_id=rank)

    if args.evaluate:
        if args.fast_eval and temperature > 0:
            calibrate_fast_eval(cached_probe_batches([None], make_loader("test"), n=4))
        results, cur_g = eval_epoch(temperature, make_loader("test"))
        save_result(results, args.output_dir, "test_epoch_eval", remove_duplicate="image_id")
        dump_log(args.output_dir, "evaluate.txt",
                 {"Cur_Gflops": round(mean_over_ranks(cur_g), 2)}, append=False)
        return

    # ---- compression training ----
    target = ORI_GFLOPS * (1.0 - config["p"])
    opt = make_adamw(model.parameters(), lr=config.get("init_lr", 1e-5),
                     weight_decay=config.get("weight_decay", 0.05))
    train_step = make_caption_train_step(model, opt, amp=args.amp, device=device.type)
    controller = TemperatureController(target_gflops=target)
    ds = CaptionTrainDataset(train_image_transform(args, image_size, PerSampleRng(args.seed)),
                             config["image_root"], config["ann_root"],
                             prompt=config.get("prompt", PROMPT))
    batch_train = config.get("batch_size", 32)

    # the pre-search and --fast_train probe: 3 shuffled batches, cached once
    # (a partial batch only when the dataset has no full one)
    probe_bs = min(8, batch_train)
    probe_images = [b[0] for b in cached_probe_batches([None], lambda: batched_loader(
        ds, probe_bs, shuffle=True, num_workers=0, drop_last=len(ds) >= probe_bs), n=3)]
    if not args.resume:  # a resumed run restores the controller instead
        controller.temperature = task.presearch(model, probe_images[0], target, t0=1.0,
                                                tol=1.0)
        print("pre-searched temperature:", controller.temperature)

    step_cache = BoundedCache()  # --fast_train: capacity schedule -> step

    def fast_train_step(temperature):
        """Vision capacities from the probe batches at this epoch's
        temperature (the decoder runs unpruned) and the gather-mode step."""
        cv = task.probe_capacities(model, ((im, None) for im in probe_images), temperature,
                                   args.cap_mode)
        if cv not in step_cache:
            step_cache[cv] = make_caption_train_step(model, opt, capacities_v=cv,
                                                     amp=args.amp, device=device.type)
        return step_cache[cv], cv

    best, cur_g = -1.0, ORI_GFLOPS
    start_epoch = resume_skip = 0
    if args.resume:
        meta = load_resume(args.resume, model, opt,
                           {"epoch": 0, "temperature": 0.0, "cur_gflops": 0.0, "best": 0.0,
                            "batches_done": 0})
        start_epoch = int(meta["epoch"]) + 1
        controller.temperature = float(meta["temperature"])
        cur_g, best = float(meta["cur_gflops"]), float(meta["best"])
        resume_skip = int(meta["batches_done"])
        print(f"resumed from {args.resume} at epoch {start_epoch}"
              + (f" (skipping {resume_skip} trained batches)" if resume_skip else ""))

    guard = preempt.PreemptionGuard()
    print("LOG: preemption guard armed", flush=True)
    for epoch in range(start_epoch, config["max_epoch"]):
        pre_temp = controller.temperature
        if epoch > 0:
            controller.update(cur_g)
        temperature = controller.temperature
        lr = cosine_lr(epoch, config["max_epoch"], config.get("init_lr", 1e-5),
                       config.get("min_lr", 0.0))
        set_lr(opt, lr)
        step_fn = train_step
        if args.fast_train and temperature > 0:
            step_fn, sched = fast_train_step(temperature)
            print("fast_train capacities:", sched)
        skip = resume_skip if epoch == start_epoch else 0
        stats = task.train_epoch(
            model, step_fn,
            lambda: MetricLogger().log_every(
                batched_loader(ds, batch_train, shuffle=True, epoch=epoch,
                               num_shards=n_procs, shard_id=rank, drop_last=n_procs > 1,
                               batch_range=(skip, 1 << 31) if skip else None),
                50, f"Train [{epoch}]"),
            tokenizer, temperature, lr=lr, stop=guard.should_stop)
        if guard.sync_now():
            save_resume(args.output_dir, model, opt,
                        {"epoch": epoch - 1, "temperature": float(pre_temp),
                         "cur_gflops": float(cur_g), "best": float(best),
                         "batches_done": skip + stats["batches_done"]})
            print("LOG: preempted — resume checkpoint saved; restart with --resume")
            return
        results, cur_g = eval_epoch(temperature, make_loader("val"))
        if n_procs > 1:
            # rank 0 scores the whole split: every rank's captions, merged
            merged = save_result(results, args.output_dir, f"val_epoch{epoch}",
                                 remove_duplicate="image_id")
            if dist.is_main_process():
                with open(merged) as f:
                    results = json.load(f)
        cur_g = mean_over_ranks(cur_g)
        log = {"epoch": epoch, "Cur_Gflops": round(cur_g, 2), "train_loss": stats["loss"]}
        gt_root = config.get("coco_gt_root", "")
        gt_path = os.path.join(gt_root, "gt.json")
        if not os.path.exists(gt_path):
            gt_path = os.path.join(gt_root, "caption_gt.json")  # the fixture's name
        metric = 0.0
        if os.path.exists(gt_path) and dist.is_main_process():
            with open(gt_path) as f:
                scores = coco_caption_scores(results, json.load(f))
            log.update({k: round(v, 4) for k, v in scores.items()})
            metric = scores["CIDEr"] + scores["SPICE_offline"]
            log["ckpt_gate"] = "CIDEr+SPICE_offline (reference: CIDEr+SPICE)"
        if metric >= best and cur_g - target < 5.0 and dist.is_main_process():
            save_caption_checkpoint(model, os.path.join(args.output_dir, "checkpoint_best.pth"),
                                    epoch=epoch, temperature=temperature)
            best = metric
        dump_log(args.output_dir, "log.txt", log)
        print("LOG:", log)
        save_resume(args.output_dir, model, opt,
                    {"epoch": epoch, "temperature": float(temperature),
                     "cur_gflops": float(cur_g), "best": float(best), "batches_done": 0})


if __name__ == "__main__":
    sys.exit(main())
