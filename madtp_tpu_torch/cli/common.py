"""Shared plumbing of the compress_* drivers (counterpart of
``madtp_tpu/cli/common.py``): the argument parser, the image transforms, the
config (YAML, read and written by PyYAML imported at the call), seeding,
the log, the tokenizer, the BLIP model config and the resume checkpoint.

``--device`` takes the JAX driver's ``--platform`` place: ``cuda`` (the
default) raises without a card, ``cpu`` runs the plain PyTorch path.  A
driver runs as one process, or as ``--num_processes`` N processes over
``torch.distributed`` (:mod:`madtp_tpu_torch.parallel.dist`), one per card:
data parallelism in the port is one process per card, so ``--dp`` over
several cards in one process is refused.  Under several processes the
config, the logs and the checkpoints are written by rank 0 only."""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import random
from typing import Optional

import numpy as np
import torch

from madtp_tpu_torch.core.config import BlipConfig, MedConfig, ViTConfig
from madtp_tpu_torch.core.device import resolve_device
from madtp_tpu_torch.data.tokenizer_bert import BertWordPieceTokenizer
from madtp_tpu_torch.data.transforms import (eval_resize_uint8, eval_transform,
                                             train_transform, train_transform_uint8)
from madtp_tpu_torch.parallel import dist
from madtp_tpu_torch.tasks.nlvr import cached_probe_batches  # noqa: F401  (the drivers')


def base_parser(default_config: str, default_pretrained: str = "", default_epoch: int = 5,
                default_output: str = "output/run") -> argparse.ArgumentParser:
    """The JAX drivers' flags, ``--device`` in place of ``--platform``."""
    p = argparse.ArgumentParser()
    p.add_argument("--config", default=default_config)
    p.add_argument("--output_dir", default=default_output)
    p.add_argument("--evaluate", action="store_true")
    p.add_argument("--seed", default=42, type=int)
    p.add_argument("--pretrained", default=default_pretrained, type=str)
    # --epoch always overrides max_epoch (reference defaults: 15 NLVR, 5 others)
    p.add_argument("--epoch", default=default_epoch, type=int)
    p.add_argument("--p", default=0.5, type=float, help="total compression ratio")
    p.add_argument("--bert_vocab", default="", type=str,
                   help="path to bert-base-uncased vocab.txt")
    p.add_argument("--fast_eval", action="store_true",
                   help="evaluate in gather mode at capacities calibrated on 4 batches")
    p.add_argument("--cap_mode", default="ceil", choices=["ceil", "nearest"],
                   help="--fast_eval / --fast_train capacity rounding: 'ceil' (lossless) "
                        "or 'nearest' to 128")
    p.add_argument("--fast_train", action="store_true",
                   help="train in gather mode at capacities recalibrated each epoch on "
                        "mask-mode probe batches")
    p.add_argument("--synthetic", action="store_true",
                   help="seeded random weights and data: a pipeline smoke run that needs "
                        "no checkpoint or dataset")
    p.add_argument("--synthetic_batches", default=4, type=int)
    p.add_argument("--synthetic_corpus", default=6, type=int,
                   help="synthetic retrieval corpus size (images and texts)")
    p.add_argument("--resume", default="", type=str,
                   help="resume compression from a resume checkpoint (weights, optimizer "
                        "state and controller state)")
    p.add_argument("--dp", default="auto", choices=["auto", "off"],
                   help="data-parallel over all visible cards; 'off' forces one")
    p.add_argument("--batch_size_train", default=0, type=int,
                   help="override config batch_size_train (0 = config default)")
    p.add_argument("--batch_size_test", default=0, type=int,
                   help="override config batch_size_test (0 = config default)")
    p.add_argument("--num_processes", default=0, type=int,
                   help="process count (0 or 1: one process; env MADTP_NUM_PROCESSES)")
    p.add_argument("--process_id", default=-1, type=int,
                   help="this process's rank (env MADTP_PROCESS_ID)")
    p.add_argument("--coordinator", default="",
                   help="coordinator host:port (env MADTP_COORDINATOR, default "
                        f"{dist.DEFAULT_COORDINATOR})")
    p.add_argument("--dist_backend", default="auto", choices=dist.BACKENDS,
                   help="torch.distributed backend under --num_processes: auto is nccl on "
                        "the card and gloo on the CPU; gloo lets ranks share a card")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the driver runs: the card (raises without one) or the CPU")
    p.add_argument("--amp", action="store_true",
                   help="mixed-precision training: bf16 compute against fp32 masters "
                        "and optimizer state")
    p.add_argument("--uint8_feed", action="store_true",
                   help="feed images (eval and train) as uint8 HWC; the model normalizes "
                        "them on the device")
    return p


def setup_runtime(args) -> torch.device:
    """The device this process runs on: the requested one with one process;
    under ``--num_processes`` N this rank's, after joining the process group
    (:func:`madtp_tpu_torch.parallel.dist.init_from_args`)."""
    dev = resolve_device(args.device)
    if dist.requested_processes(args) > 1:
        return dist.init_from_args(args, dev)
    if dev.type == "cuda" and args.dp != "off" and torch.cuda.device_count() > 1:
        raise NotImplementedError(
            f"--dp {args.dp} over {torch.cuda.device_count()} cards in one process: in the port "
            "data parallelism is one process per card (--num_processes N, one per card); "
            "pass --dp off to run on one card")
    return dev


def mean_over_ranks(value: float) -> float:
    """``value`` averaged over the ranks, each its own with one process: the
    GFLOPs of the ranks' eval shards (``madtp_tpu/cli/compress_caption.py:
    123``, ``compress_vqa.py:229``)."""
    n = dist.process_count()
    return value if n <= 1 else float(dist.host_sum(np.asarray([value]))[0]) / n


def eval_image_transform(args, image_size: int, *, uint8=None):
    """fp32 normalized CHW, or under ``--uint8_feed`` the resized uint8 HWC
    that the model normalizes on the device."""
    if uint8 is None:
        uint8 = getattr(args, "uint8_feed", False)
    if uint8:
        return lambda im: eval_resize_uint8(im, image_size)
    return lambda im: eval_transform(im, image_size)


def train_image_transform(args, image_size: int, rng, *, uint8=None):
    """Crop, flip and RandAugment, fp32 CHW or (``--uint8_feed``) uint8
    HWC; both draw the same rng stream."""
    if uint8 is None:
        uint8 = getattr(args, "uint8_feed", False)
    if uint8:
        return lambda im: train_transform_uint8(im, image_size, rng)
    return lambda im: train_transform(im, image_size, rng)


def load_config(args) -> dict:
    """The YAML config with the command line's overrides; strings YAML 1.1
    leaves unparsed (``3e-6``) become floats."""
    if args.synthetic:
        config = {}  # synthetic runs ignore the task yaml
    else:
        import yaml

        with open(args.config) as f:
            config = yaml.safe_load(f)
    config["pretrained"] = args.pretrained or config.get("pretrained", "")
    config["max_epoch"] = args.epoch
    config["p"] = args.p
    if getattr(args, "batch_size_train", 0):
        config["batch_size_train"] = args.batch_size_train
        config["batch_size"] = args.batch_size_train  # the caption yaml's key
    if getattr(args, "batch_size_test", 0):
        config["batch_size_test"] = args.batch_size_test
    for k, v in list(config.items()):
        if isinstance(v, str):
            try:
                config[k] = float(v) if any(c in v for c in ".eE") and (
                    v.replace(".", "").replace("e", "").replace("E", "")
                    .replace("-", "").replace("+", "").isdigit()) else v
            except ValueError:
                pass
    return config


def dump_config(config: dict, output_dir: str) -> None:
    """The merged run config as ``<output_dir>/config.yaml`` (rank 0)."""
    if not dist.is_main_process():
        return
    import yaml

    with open(os.path.join(output_dir, "config.yaml"), "w") as f:
        yaml.dump(config, f)


def set_seed(seed: int) -> None:
    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)


def dump_log(output_dir: str, name: str, stats: dict, append: bool = True) -> None:
    """One JSON line of ``stats`` into ``<output_dir>/<name>`` (rank 0)."""
    if not dist.is_main_process():
        return
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, name), "a" if append else "w") as f:
        f.write(json.dumps(stats) + "\n")


def make_tokenizer(args, config) -> BertWordPieceTokenizer:
    """The BERT tokenizer from a local vocab; synthetic runs build a toy one."""
    vocab_path = args.bert_vocab or config.get("bert_vocab", "")
    if vocab_path and os.path.exists(vocab_path):
        return BertWordPieceTokenizer(vocab_path)
    if not args.synthetic:
        raise FileNotFoundError("bert vocab.txt not found; pass --bert_vocab or use "
                                "--synthetic (nothing is downloaded)")
    words = [f"w{i}" for i in range(64)] + [
        "the", "a", "left", "right", "is", "on", "object", "picture", "of"]
    return BertWordPieceTokenizer.toy(words)


def _med_config(config: dict, **kw) -> MedConfig:
    """The MED config, from the yaml's ``med_config`` json when it exists."""
    path = config.get("med_config", "")
    if path and os.path.exists(path):
        with open(path) as f:
            raw = json.load(f)
        known = {f.name for f in dataclasses.fields(MedConfig)}
        return MedConfig(**{**{k: v for k, v in raw.items() if k in known}, **kw})
    return MedConfig(**kw)


def build_blip_cfg(config: dict, image_size: int, *, twin_cross: bool = False) -> BlipConfig:
    """The BLIP model config: the reference's presets ``base`` and ``large``
    and the ``tiny`` preset of the fixture runs.  ``vit_grad_ckpt``
    (recompute the ViT blocks in the backward) defaults on for the full-size
    presets, and ``vit_ckpt_layer`` limits it to the last N blocks."""
    preset = config.get("vit", "base")
    remat = bool(config.get("vit_grad_ckpt", preset != "tiny"))
    ckpt_layers = int(config.get("vit_ckpt_layer", -1))
    if preset == "large":
        vit = ViTConfig(image_size=image_size, embed_dim=1024, depth=24, num_heads=16,
                        grad_checkpoint=remat, ckpt_layers=ckpt_layers)
        med = _med_config(config, twin_cross=twin_cross, encoder_width=vit.embed_dim)
        return BlipConfig(vit=vit, med=med, sd_num=config.get("sd_num", 100),
                          sd_dim=config.get("sd_dim", 768))
    if preset == "tiny":
        vit = ViTConfig(image_size=image_size, patch_size=16, embed_dim=64, depth=2,
                        num_heads=4, sd_dim=64, grad_checkpoint=remat,
                        ckpt_layers=ckpt_layers)
        med = _med_config(config, twin_cross=twin_cross, encoder_width=64, hidden_size=64,
                          num_hidden_layers=2, num_attention_heads=4,
                          intermediate_size=256, vocab_size=config.get("vocab_size", 30524),
                          sd_dim=64)
        return BlipConfig(vit=vit, med=med, sd_num=config.get("sd_num", 100), sd_dim=64)
    vit = ViTConfig(image_size=image_size, grad_checkpoint=remat, ckpt_layers=ckpt_layers)
    med = _med_config(config, twin_cross=twin_cross, encoder_width=vit.embed_dim)
    return BlipConfig(vit=vit, med=med, sd_num=config.get("sd_num", 100),
                      sd_dim=config.get("sd_dim", 768))


def synthetic_cfg(image_size: int, vocab_size: int) -> BlipConfig:
    """The caption and VQA drivers' ``--synthetic`` model: a 2-layer ViT
    and MED of width 64, a codebook of 10."""
    vit = ViTConfig(image_size=image_size, patch_size=16, embed_dim=64, depth=2, num_heads=4,
                    sd_dim=64)
    med = MedConfig(vocab_size=vocab_size, hidden_size=64, num_hidden_layers=2,
                    num_attention_heads=4, intermediate_size=256, max_position_embeddings=64,
                    encoder_width=64, sd_dim=64)
    return BlipConfig(vit=vit, med=med, sd_num=10, sd_dim=64)


def read_checkpoint(path: str):
    """``(state dict, extras)`` of a ``.pth``: the ``model`` or ``state_dict``
    entry, else the whole object; the extras are the other entries
    (``epoch``, ``temperature``)."""
    obj = torch.load(path, map_location="cpu")
    for key in ("model", "state_dict"):
        if isinstance(obj, dict) and key in obj:
            return obj[key], {k: v for k, v in obj.items() if k != key}
    return obj, {}


# ---------------------------------------------------------------------------
# Mid-run resume checkpoints: written at each epoch's end and on preemption
# ---------------------------------------------------------------------------


def _extra_state(extra: Optional[dict]) -> dict:
    """The saved form of ``extra``: tensors as CPU copies, generators as
    their state."""
    out = {}
    for k, v in (extra or {}).items():
        out[k] = v.get_state() if isinstance(v, torch.Generator) else v.detach().cpu().clone()
    return out


def save_resume(output_dir: str, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                meta: dict, *, extra: Optional[dict] = None) -> str:
    """``torch.save`` of the model's and the optimizer's state, ``meta`` (a
    flat dict of numbers) and ``extra`` (named tensors a run carries besides
    its parameters, such as momentum copies and feature queues, and
    ``torch.Generator`` s, saved as their state) into
    ``<output_dir>/resume_ckpt``, the path that ``--resume`` takes.  The new
    file is written beside the old one and renamed into place, so a kill
    during the save keeps the last state.  Under several processes only
    rank 0 writes (every rank holds the same state); each rank returns the
    path."""
    path = os.path.abspath(os.path.join(output_dir, "resume_ckpt"))
    if not dist.is_main_process():
        return path
    new, old = path + ".new", path + ".stale"
    for p in (new, old):
        if os.path.exists(p):
            os.remove(p)
    torch.save({"model": model.state_dict(), "optimizer": optimizer.state_dict(),
                "meta": dict(meta), "extra": _extra_state(extra)}, new)
    if os.path.exists(path):
        os.rename(path, old)
    os.rename(new, path)
    if os.path.exists(old):
        os.remove(old)
    return path


def load_resume(path: str, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                meta_template: dict, *, extra: Optional[dict] = None) -> dict:
    """Restore a :func:`save_resume` checkpoint into ``model``,
    ``optimizer`` and the tensors and generators of ``extra`` (by the names
    they were saved under), in place; returns the meta, with
    ``meta_template``'s defaults for keys it lacks."""
    state = torch.load(path, map_location=model.space_dict.device)
    model.load_state_dict(state["model"])
    optimizer.load_state_dict(state["optimizer"])
    saved = state.get("extra", {})
    for k, v in (extra or {}).items():
        if isinstance(v, torch.Generator):
            v.set_state(saved[k].cpu())
        else:
            with torch.no_grad():
                v.copy_(saved[k])
    return {k: state["meta"].get(k, v) for k, v in meta_template.items()}
