"""NLVR2 compression and evaluation driver (counterpart of
``madtp_tpu/cli/compress_nlvr.py``, reference ``compress_nlvr_dtp.py``).

    python -m madtp_tpu_torch.cli.compress_nlvr --p 0.5 \
        --pretrained pretrained/model_base_nlvr.pth --config configs/nlvr.yaml
    python -m madtp_tpu_torch.cli.compress_nlvr --evaluate \
        --pretrained output/NLVR/checkpoint_best.pth

Each epoch the temperature controller steps toward the GFLOPs target, the
model trains one epoch (mask mode, or gather mode at recalibrated capacities
with ``--fast_train``) and is evaluated on the val and test splits; the best
test accuracy within 5 GFLOPs of the target is written to
``checkpoint_best.pth``, every epoch to ``log.txt`` and the resume
checkpoint.  ``--synthetic`` runs the same loop on seeded random weights and
data.  ``--device cpu`` runs on the CPU; by default the driver needs a card.

Under ``--num_processes`` N (one process per card) every split is sharded
over the ranks, each train step spans the global batch (DTP's counts and the
gradients over all ranks: :mod:`madtp_tpu_torch.parallel.data`), the train
text is padded to 40 tokens, the ``--fast_train`` probe reads the same
unsharded batches on every rank, the evals sum their totals over the ranks,
and rank 0 writes the logs and checkpoints.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from madtp_tpu_torch.ckpt.convert import load_nlvr_state_dict, save_nlvr_checkpoint
from madtp_tpu_torch.cli.common import (base_parser, build_blip_cfg, cached_probe_batches,
                                        dump_config, dump_log, eval_image_transform,
                                        load_config, load_resume, make_tokenizer,
                                        read_checkpoint, save_resume, set_seed, setup_runtime,
                                        train_image_transform)
from madtp_tpu_torch.core.config import BlipConfig, MedConfig, ViTConfig
from madtp_tpu_torch.data.datasets import NLVRDataset
from madtp_tpu_torch.data.loader import batched_loader
from madtp_tpu_torch.data.transforms import PerSampleRng
from madtp_tpu_torch.models.blip import init_nlvr_model
from madtp_tpu_torch.parallel import dist
from madtp_tpu_torch.tasks import nlvr as task
from madtp_tpu_torch.train.controller import TemperatureController
from madtp_tpu_torch.train.loops import make_nlvr_train_step
from madtp_tpu_torch.train.optim import cosine_lr, make_adamw, set_lr
from madtp_tpu_torch.utils import preempt
from madtp_tpu_torch.utils.cache import BoundedCache

ORI_GFLOPS = 132.54  # reference compress_nlvr_dtp.py:162


def synthetic_cfg(image_size: int, vocab_size: int) -> BlipConfig:
    """``--synthetic``'s model: the JAX driver's ``_nlvr_setup``
    configuration (tiny at 128 px and below, else BLIP base)."""
    if image_size <= 128:
        vit = ViTConfig(image_size=image_size, patch_size=16, embed_dim=64, depth=2,
                        num_heads=4, sd_dim=64)
        med = MedConfig(vocab_size=vocab_size, hidden_size=64, num_hidden_layers=2,
                        num_attention_heads=4, intermediate_size=256,
                        max_position_embeddings=64, twin_cross=True, encoder_width=64,
                        sd_dim=64)
        return BlipConfig(vit=vit, med=med, sd_num=100, sd_dim=64)
    vit = ViTConfig(image_size=image_size)
    return BlipConfig(vit=vit, med=MedConfig(twin_cross=True, encoder_width=768))


def synthetic_loader(n_batches, batch, image_size, seed=0, batch_skip=0):
    rng = np.random.RandomState(seed)
    data = []
    for _ in range(n_batches):
        img0 = rng.randn(batch, 3, image_size, image_size).astype(np.float32)
        img1 = rng.randn(batch, 3, image_size, image_size).astype(np.float32)
        sents = ["the object is on the left" for _ in range(batch)]
        targets = rng.randint(0, 2, size=(batch,))
        data.append((img0, img1, sents, targets))
    return lambda: iter(data[batch_skip:])


def real_loader(config, split, *, train, batch, epoch=0, batch_skip=0, uint8=False,
                num_shards=1, shard_id=0):
    """``(image0, image1, sentences, targets)`` batches of shard ``shard_id``
    of ``num_shards`` of an NLVR2 split; ``batch_skip`` drops the first
    batches of the epoch's schedule (the exactly-once resume)."""
    size = config["image_size"]
    if train:
        tf = train_image_transform(None, size, PerSampleRng(42), uint8=uint8)
    else:
        tf = eval_image_transform(None, size, uint8=uint8)
    ds = NLVRDataset(tf, config["image_root"], config["ann_root"], split)
    return lambda: batched_loader(ds, batch, shuffle=train, epoch=epoch, drop_last=train,
                                  num_shards=num_shards, shard_id=shard_id,
                                  batch_range=(batch_skip, 1 << 31) if batch_skip else None)


def load_model(path: str, cfg: BlipConfig, device):
    """The model of a reference-layout ``.pth`` and its temperature."""
    sd, extras = read_checkpoint(path)
    return load_nlvr_state_dict(sd, cfg, device=device), float(extras.get("temperature", 0.0))


def build_parser():
    """The driver's flags (the JAX driver's, ``--device`` for ``--platform``)."""
    return base_parser("configs/nlvr.yaml", "pretrained/model_base_nlvr.pth",
                       default_epoch=15, default_output="output/NLVR")


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = setup_runtime(args)
    config = load_config(args)
    set_seed(args.seed)
    os.makedirs(args.output_dir, exist_ok=True)
    dump_config(config, args.output_dir)

    image_size = config.get("image_size", 64 if args.synthetic else 384)
    if args.synthetic:
        config.setdefault("image_size", image_size)
    tokenizer = make_tokenizer(args, config)
    enc = tokenizer.enc_token_id

    n_procs, rank = dist.process_count(), dist.process_index()

    def tokenize(sentences):
        # padded to the batch's longest, as the reference does
        out = tokenizer(sentences, padding="longest")
        return out["input_ids"], out["attention_mask"]

    def tokenize_train(sentences):
        # under several processes every rank pads to one length, as the JAX
        # package's one global train program must (compress_nlvr.py:123-130):
        # the text DTP's largest alive count depends on it
        if n_procs > 1:
            out = tokenizer(sentences, padding="max_length", max_length=40)
            return out["input_ids"], out["attention_mask"]
        return tokenize(sentences)

    # ---- model ----
    temperature = 1.0
    if args.synthetic:
        cfg = synthetic_cfg(image_size, len(tokenizer.vocab))
        model = init_nlvr_model(cfg, seed=0, device=device)
        if args.evaluate and args.pretrained and os.path.exists(args.pretrained):
            model, temperature = load_model(args.pretrained, cfg, device)
    else:
        cfg = build_blip_cfg(config, image_size, twin_cross=True)
        if config.get("pretrained"):
            model, ckpt_temp = load_model(config["pretrained"], cfg, device)
            if args.evaluate:
                temperature = ckpt_temp
        else:  # the reference always starts from a checkpoint
            print("WARNING: no --pretrained given; random init")
            model = init_nlvr_model(cfg, seed=args.seed, device=device)

    target_gflops = ORI_GFLOPS * (1.0 - config["p"])
    batch_train = config.get("batch_size_train", 4 if args.synthetic else 16)
    batch_test = config.get("batch_size_test", 4 if args.synthetic else 32)

    def get_loader(split, train=False, epoch=0, batch_skip=0, sharded=True):
        # sharded=False: the same batches on every rank (the --fast_train
        # probe, whose capacities every rank's train step must share)
        if args.synthetic:  # the same data on every rank, as the JAX driver's
            return synthetic_loader(args.synthetic_batches, batch_test, image_size,
                                    batch_skip=batch_skip)
        ns, si = (n_procs, rank) if sharded else (1, 0)
        return real_loader(config, split, train=train,
                           batch=batch_train if train else batch_test, epoch=epoch,
                           batch_skip=batch_skip, uint8=args.uint8_feed, num_shards=ns,
                           shard_id=si)

    def evaluate(split, prune_active, caps_v=None, caps_t=None):
        stats, cur_g = task.evaluate(model, get_loader(split), tokenize, temperature,
                                     prune_active=prune_active, enc_token_id=enc,
                                     capacities_v=caps_v, capacities_t=caps_t)
        if "overflow" in stats:  # printed, not logged: the log keeps the JAX driver's keys
            print(f"{split}: tokens over the gather capacities: {stats.pop('overflow')}")
        return stats, cur_g

    if args.evaluate:
        caps_v = caps_t = None
        if args.fast_eval and temperature > 0:
            # gather capacities from several mask-mode batches (max + margin)
            probe = cached_probe_batches([None], get_loader("val"), n=4)
            caps_v, caps_t = task.probe_capacities(model, probe, tokenize, enc, temperature,
                                                   args.cap_mode)
            print("fast_eval capacities:", caps_v, caps_t)
        val_stats, cur_g = evaluate("val", temperature > 0, caps_v, caps_t)
        test_stats, _ = evaluate("test", temperature > 0, caps_v, caps_t)
        log = {**{f"val_{k}": v for k, v in val_stats.items()},
               **{f"test_{k}": v for k, v in test_stats.items()},
               "Cur_Gflops": round(cur_g, 2)}
        dump_log(args.output_dir, "evaluate.txt", log, append=False)
        print("LOG:", log)
        return

    # ---- compression training ----
    opt = make_adamw(model.parameters(), lr=config.get("init_lr", 3e-6),
                     weight_decay=config.get("weight_decay", 0.05))
    train_step = make_nlvr_train_step(model, opt, amp=args.amp, device=device.type)
    step_cache = BoundedCache()  # capacity schedule -> gather-mode train step
    probe_cache = [None]

    def fast_train_step(temperature):
        """``--fast_train``: capacities from the cached mask-mode probe
        batches at this epoch's temperature, and the gather-mode step."""
        probe = cached_probe_batches(probe_cache, get_loader("train", True, 0, sharded=False))
        key = task.probe_capacities(model, probe, tokenize, enc, temperature, args.cap_mode)
        if key not in step_cache:
            step_cache[key] = make_nlvr_train_step(
                model, opt, capacities_v=key[0], capacities_t=key[1], amp=args.amp,
                device=device.type)
        return step_cache[key], key

    controller = TemperatureController(target_gflops=target_gflops)
    if args.synthetic:
        controller.target_gflops = 1e-3  # the tiny model: exercise the ladder

    best, best_epoch, cur_g = 0.0, 0, ORI_GFLOPS
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
        pre_temp = controller.temperature  # the interrupted epoch's resume state
        if epoch > 0:
            controller.update(cur_g)
        temperature = controller.temperature
        print("Temperature:", temperature)
        lr = cosine_lr(epoch, config["max_epoch"], config.get("init_lr", 3e-6),
                       config.get("min_lr", 0.0))
        set_lr(opt, lr)
        step_fn = train_step
        if args.fast_train and temperature > 0:
            step_fn, sched = fast_train_step(temperature)
            print("fast_train capacities:", sched)
        skip = resume_skip if epoch == start_epoch else 0
        train_stats = task.train_epoch(model, step_fn,
                                       get_loader("train", True, epoch, batch_skip=skip),
                                       tokenize_train, enc, temperature, lr=lr,
                                       stop=guard.should_stop)
        done = skip + int(train_stats.pop("batches_done", 0))
        if guard.sync_now():
            # the pre-epoch controller state and the trained batch count:
            # --resume restarts this epoch and skips those batches
            save_resume(args.output_dir, model, opt,
                        {"epoch": epoch - 1, "temperature": float(pre_temp),
                         "cur_gflops": float(cur_g), "best": float(best),
                         "batches_done": done})
            print(f"LOG: preempted after {done} batches of epoch {epoch} — resume checkpoint "
                  "saved; restart with --resume")
            return
        val_stats, cur_g = evaluate("val", True)
        test_stats, _ = evaluate("test", True)
        log = {**{f"train_{k}": v for k, v in train_stats.items()},
               **{f"val_{k}": v for k, v in val_stats.items()},
               **{f"test_{k}": v for k, v in test_stats.items()},
               "epoch": epoch, "Cur_Gflops": round(cur_g, 2)}
        acc = float(test_stats["acc"])
        # every rank tracks the best (the stats are the ranks' totals); rank 0 writes
        if acc > best and cur_g - controller.target_gflops < 5.0:
            best, best_epoch = acc, epoch
            if dist.is_main_process():
                save_nlvr_checkpoint(model, os.path.join(args.output_dir,
                                                         "checkpoint_best.pth"),
                                     epoch=epoch, temperature=temperature)
        dump_log(args.output_dir, "log.txt", log)
        print("LOG:", log)
        save_resume(args.output_dir, model, opt,
                    {"epoch": epoch, "temperature": float(temperature),
                     "cur_gflops": float(cur_g), "best": float(best), "batches_done": 0})
    print(f"LOG: best epoch: {best_epoch}")


if __name__ == "__main__":
    sys.exit(main())
