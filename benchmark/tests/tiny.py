"""Cells at a tiny size for the CPU tests: the same drivers, mixes and
checks as the benchmark's cells, on models a few layers deep and a few
dozen wide, so that a whole run (set-up, window, reference) takes seconds
on the CPU."""

from __future__ import annotations

import copy
import time
from pathlib import Path
from unittest import mock

import torch

from benchmark import calibrate, harness

ROOT = Path(__file__).resolve().parents[2]

NLVR = {"name": "tiny-nlvr", "model": "blip_nlvr", "dtype": "float32",
        "vit": {"image_size": 64, "patch_size": 16, "embed_dim": 64, "depth": 3, "num_heads": 4,
                "mlp_ratio": 4.0, "layer_norm_eps": 1e-06},
        "med": {"vocab_size": 200, "hidden_size": 64, "num_hidden_layers": 3,
                "num_attention_heads": 4, "intermediate_size": 256,
                "max_position_embeddings": 64, "layer_norm_eps": 1e-12, "encoder_width": 64,
                "merge_start_layer": 1},
        "sd_num": 100, "sd_dim": 64, "enc_token_id": 199}

CLIP = {"name": "tiny-clip", "model": "clip", "dtype": "float32", "embed_dim": 32,
        "image_resolution": 56, "vision_layers": 3, "vision_width": 128,
        "vision_patch_size": 14, "context_length": 20, "vocab_size": 500,
        "transformer_width": 64, "transformer_heads": 4, "transformer_layers": 3,
        "sd_num": 100, "sd_dim": 48}

# the tiny models' scores are spread wider: their temperature lies higher
BISECT_RANGE = (0.5, 500.0)

# the cell's own mix, cut in size; the sizes of the cut are the keys changed
CUTS = {
    "nlvr-eval-p50": (NLVR, {"pairs_per_batch": 4, "pool_batches": 4, "probe_batches": 2,
                              "word_ids": [103, 199],
                              "text_lengths": {"mean": 8.0, "std": 3.0, "min": 4,
                                               "max": 16}}),
    "clip-eval-p50": (CLIP, {"images": 12, "image_batch": 5, "text_batch": 8,
                             "probe_images": 8, "probe_batch": 4, "caption_lengths": [4, 12],
                             "token_ids": [1, 400]}),
    "nlvr-train-p50": (NLVR, {"pairs_per_batch": 4, "pool_batches": 5, "probe_batches": 2,
                               "word_ids": [103, 199], "lr": 1e-3,
                               "text_lengths": {"mean": 8.0, "std": 3.0, "min": 4,
                                                "max": 16}}),
}


def cell(name: str) -> harness.Cell:
    """The benchmark's cell ``name`` with its model and traffic cut to a tiny
    size (its limits kept)."""
    full = harness.load_cell(ROOT, name)
    cfg, cut = CUTS[name]
    mix = copy.deepcopy(full.mix)
    mix.update(cut)
    return harness.Cell(name=name, chips=1, config=copy.deepcopy(cfg), mix=mix,
                        limits=dict(full.limits), end_to_end=full.end_to_end,
                        per_layer=full.per_layer)


def run(name: str, seed: int = 3, seconds: float = 0.5, control=None, c=None) -> harness.Run:
    """One run of the tiny cell on the CPU, as ``run.py`` makes it on a card."""
    r = harness.Run(cell=c or cell(name), seed=seed, seconds=seconds, trace=False,
                    device=torch.device("cpu"), t_start=time.perf_counter(), control=control)
    with mock.patch.object(calibrate, "BISECT_RANGE", BISECT_RANGE):
        harness.driver(r.cell.mix).run(r)
    return r
