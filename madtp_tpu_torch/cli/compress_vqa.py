"""VQAv2 compression and evaluation driver (counterpart of
``madtp_tpu/cli/compress_vqa.py``, reference ``compress_vqa_dtp.py``).

    python -m madtp_tpu_torch.cli.compress_vqa --p 0.5 \
        --pretrained pretrained/model_base_vqa_capfilt_large.pth
    python -m madtp_tpu_torch.cli.compress_vqa --evaluate --pretrained ...

The eval ranks each question against the answer list (``k_test`` candidates
rescored by the decoder; ``inference: generate`` decodes 3 beams instead)
and writes the answers as JSON.  Training runs the temperature controller
over epochs of the soft-weighted answer loss (a question's first
``tasks.vqa.MAX_A`` = 10 answers) and writes a checkpoint every epoch, as
the reference does.

Under ``--num_processes`` N the train and test splits are sharded over the
ranks, each train step spans the global batch (questions padded to 35
tokens, answers to 24), each rank's answers go through
:func:`~madtp_tpu_torch.data.text_utils.save_result` (rank 0 merges them),
the GFLOPs are averaged over the ranks, and rank 0 writes the logs and
checkpoints.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

from madtp_tpu_torch.ckpt.convert import load_vqa_state_dict, save_vqa_checkpoint
from madtp_tpu_torch.cli.common import (base_parser, build_blip_cfg, cached_probe_batches,
                                        dump_config, dump_log, eval_image_transform,
                                        load_config, load_resume, make_tokenizer,
                                        mean_over_ranks, read_checkpoint, save_resume,
                                        set_seed, setup_runtime, synthetic_cfg,
                                        train_image_transform)
from madtp_tpu_torch.data.datasets import VQADataset, vqa_collate
from madtp_tpu_torch.data.loader import batched_loader
from madtp_tpu_torch.data.text_utils import save_result
from madtp_tpu_torch.data.transforms import PerSampleRng
from madtp_tpu_torch.models.blip import init_vqa_model
from madtp_tpu_torch.parallel import dist
from madtp_tpu_torch.prune.flops import vqa_gflops
from madtp_tpu_torch.tasks import vqa as task
from madtp_tpu_torch.train.controller import TemperatureController
from madtp_tpu_torch.train.loops import make_vqa_train_step
from madtp_tpu_torch.train.optim import cosine_lr, make_adamw, set_lr
from madtp_tpu_torch.utils import preempt
from madtp_tpu_torch.utils.cache import BoundedCache
from madtp_tpu_torch.utils.logging import MetricLogger

ORI_GFLOPS = 186.1  # reference compress_vqa_dtp.py:239


def build_parser():
    """The driver's flags (the JAX driver's, ``--device`` for ``--platform``)."""
    return base_parser("configs/vqa.yaml", "pretrained/model_base_vqa_capfilt_large.pth",
                       default_output="output/VQA")


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = setup_runtime(args)
    config = load_config(args)
    set_seed(args.seed)
    os.makedirs(args.output_dir, exist_ok=True)
    dump_config(config, args.output_dir)

    image_size = config.get("image_size", 64 if args.synthetic else 480)
    tokenizer = make_tokenizer(args, config)
    k_test = config.get("k_test", 8 if args.synthetic else 128)
    n_procs, rank = dist.process_count(), dist.process_index()

    temperature = 1.0
    if args.synthetic:
        cfg = synthetic_cfg(image_size, len(tokenizer.vocab))  # the JAX driver's
        model = init_vqa_model(cfg, seed=0, device=device)
        answer_list = [f"w{i}" for i in range(16)]
    else:
        cfg = build_blip_cfg(config, image_size)
        if config.get("pretrained"):
            sd, extras = read_checkpoint(config["pretrained"])
            model = load_vqa_state_dict(sd, cfg, device=device)
            temperature = float(extras.get("temperature", 0.0))
        else:
            print("WARNING: no --pretrained given; random init")
            model = init_vqa_model(cfg, seed=args.seed, device=device)
        with open(os.path.join(config["ann_root"], "answer_list.json")) as f:
            answer_list = json.load(f)
    a_ids, a_mask = task.tokenize_answers(tokenizer, answer_list)
    inference = config.get("inference", "rank")
    caps_v = caps_t = None

    def questions(q):
        out = tokenizer(list(q), padding="longest")
        ids = np.array(out["input_ids"], np.int64)
        ids[:, 0] = tokenizer.enc_token_id
        return ids, np.array(out["attention_mask"], np.int64)

    def batches(loader):
        for images, q, qids in MetricLogger().log_every(loader(), 10, "VQA:"):
            yield (images, *questions(q), qids)

    def calibrate_fast_eval(loader):
        nonlocal caps_v, caps_t
        caps_v, caps_t = task.probe_capacities(model, batches(loader), temperature,
                                               args.cap_mode)
        print("fast_eval capacities:", caps_v, caps_t)

    def run_eval(loader):
        """``[{"question_id", "answer"}]`` and the mean GFLOPs (``k_test``
        answers a question); the towers run in mask mode, or at the
        ``--fast_eval`` capacities."""
        if inference != "generate":
            pairs, cur_g = task.evaluate(model, batches(loader), a_ids, a_mask,
                                         temperature=temperature, k_test=k_test,
                                         capacities_v=caps_v, capacities_t=caps_t,
                                         pad_token_id=tokenizer.pad_token_id,
                                         prune_active=True)
            return [{"question_id": q, "answer": answer_list[b]} for q, b in pairs], cur_g
        results, g_sum, n = [], 0.0, 0
        dev = model.space_dict.device
        for images, q_ids, q_mask, qids in batches(loader):
            seqs, v_kept, q_kept = task.generate_answers(
                model, torch.from_numpy(np.asarray(images)).to(dev),
                torch.from_numpy(q_ids).to(dev), torch.from_numpy(q_mask).to(dev),
                temperature=temperature, bos_token_id=tokenizer.bos_token_id,
                eos_token_id=tokenizer.sep_token_id, pad_token_id=tokenizer.pad_token_id,
                prune_active=True)
            for row, qid in zip(seqs.cpu().numpy(), qids):
                results.append({"question_id": int(qid), "answer": tokenizer.decode(row)})
            g_sum += vqa_gflops(cfg.vit, cfg.med, v_kept.cpu().numpy(), q_kept.cpu().numpy(),
                                q_ids.shape[1], n_answers=k_test)
            n += 1
        return results, g_sum / max(n, 1)

    if args.synthetic:
        rng = np.random.RandomState(1)

        def loader():
            for i in range(args.synthetic_batches):
                yield (rng.randn(2, 3, image_size, image_size).astype(np.float32),
                       ["where is the object"] * 2, np.arange(2) + 2 * i)

        if args.fast_eval:
            calibrate_fast_eval(loader)
        results, cur_g = run_eval(loader)
        save_result(results, args.output_dir, "vqa_result", remove_duplicate="question_id")
        cur_g = mean_over_ranks(cur_g)
        log = {"n_answers": len(results), "Cur_Gflops": round(cur_g, 4),
               "sample": results[0]["answer"]}
        dump_log(args.output_dir, "evaluate.txt", log, append=False)
        print("LOG:", log)
        return

    ds = VQADataset(eval_image_transform(args, image_size), config["ann_root"],
                    config["vqa_root"], config.get("vg_root", ""), split="test")

    def test_loader():
        return batched_loader(ds, config.get("batch_size_test", 16), num_shards=n_procs,
                              shard_id=rank)

    if args.evaluate:
        if args.fast_eval:
            calibrate_fast_eval(test_loader)
        results, cur_g = run_eval(test_loader)
        save_result(results, args.output_dir, "vqa_result", remove_duplicate="question_id")
        dump_log(args.output_dir, "evaluate.txt",
                 {"Cur_Gflops": round(mean_over_ranks(cur_g), 2)}, append=False)
        return

    # ---- compression training ----
    target = ORI_GFLOPS * (1.0 - config["p"])
    opt = make_adamw(model.parameters(), lr=config.get("init_lr", 2e-5),
                     weight_decay=config.get("weight_decay", 0.05))
    train_step = make_vqa_train_step(model, opt, amp=args.amp, device=device.type)
    controller = TemperatureController(target_gflops=target)
    train_ds = VQADataset(
        train_image_transform(args, image_size, PerSampleRng(args.seed)),
        config["ann_root"], config["vqa_root"], config.get("vg_root", ""), split="train",
        train_files=tuple(config.get("train_files", ("vqa_train", "vqa_val", "vg_qa"))))
    batch_train = config.get("batch_size_train", 16)
    step_cache = BoundedCache()  # --fast_train: capacity schedule -> step
    probe_cache = [None]

    def fast_train_step(temperature):
        """Both towers' capacities from cached mask-mode train batches (the
        questions padded to 35 tokens) and the gather-mode step."""
        probe = cached_probe_batches(probe_cache, lambda: batched_loader(
            train_ds, batch_train, shuffle=True, epoch=0, collate=vqa_collate))
        key = task.probe_capacities(
            model, ((images, *questions(q), None) for images, q, *_ in probe), temperature,
            args.cap_mode)
        if key not in step_cache:
            step_cache[key] = make_vqa_train_step(model, opt, capacities_v=key[0],
                                                  capacities_t=key[1], amp=args.amp,
                                                  device=device.type)
        return step_cache[key], key

    cur_g = ORI_GFLOPS
    start_epoch = resume_skip = 0
    if args.resume:
        meta = load_resume(args.resume, model, opt,
                           {"epoch": 0, "temperature": 0.0, "cur_gflops": 0.0,
                            "batches_done": 0})
        start_epoch = int(meta["epoch"]) + 1
        controller.temperature = float(meta["temperature"])
        cur_g = float(meta["cur_gflops"])
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
        lr = cosine_lr(epoch, config["max_epoch"], config.get("init_lr", 2e-5),
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
                batched_loader(train_ds, batch_train, shuffle=True, epoch=epoch,
                               collate=vqa_collate, num_shards=n_procs, shard_id=rank,
                               drop_last=n_procs > 1,
                               batch_range=(skip, 1 << 31) if skip else None),
                50, f"Train [{epoch}]"),
            tokenizer, temperature, lr=lr, stop=guard.should_stop)
        if guard.sync_now():
            save_resume(args.output_dir, model, opt,
                        {"epoch": epoch - 1, "temperature": float(pre_temp),
                         "cur_gflops": float(cur_g),
                         "batches_done": skip + stats["batches_done"]})
            print("LOG: preempted — resume checkpoint saved; restart with --resume")
            return
        results, cur_g = run_eval(test_loader)
        save_result(results, args.output_dir, f"vqa_result_epoch{epoch}",
                    remove_duplicate="question_id")
        cur_g = mean_over_ranks(cur_g)
        if dist.is_main_process():
            save_vqa_checkpoint(model, os.path.join(args.output_dir,
                                                    f"checkpoint_{epoch:02d}.pth"),
                                epoch=epoch, temperature=temperature)
        dump_log(args.output_dir, "log.txt", {"epoch": epoch, "Cur_Gflops": round(cur_g, 2),
                                              "train_loss": stats["loss"]})
        save_resume(args.output_dir, model, opt,
                    {"epoch": epoch, "temperature": float(temperature),
                     "cur_gflops": float(cur_g), "batches_done": 0})


if __name__ == "__main__":
    sys.exit(main())
