"""The raw facts a driver records in ``run.readings``, and the arithmetic the
per-layer metric readers share to turn them into operations, launches and
shares.  A driver reduces nothing itself, so a later metric is a file of
its own that reads the same facts.

What every driver records:

* ``capacities``: ``{"vision": [...], "text": [...] or None}``, the gather
  schedule's capacity at each layer (the text's None where its tower runs
  in mask mode);
* ``batches``: one record per batch of the window, each a dict with
  ``tower`` (``"nlvr"``: a batch of pairs, two images and a sentence each;
  ``"clip_image"``; ``"clip_text"``), ``rows`` (pairs, images or captions),
  the kept counts per layer the step returned (``v_kept`` for the vision
  tower, ``t_kept`` for the text), ``width`` (NLVR: the padded sentence
  length) and ``traced`` (the batch lies in the traced stretch).  The train
  step returns no kept counts: there each step's record holds those of a
  probe batch at the same temperature, the probe batches in turn
  (``"probe": True``);
* counters and spans by name: ``graph_capture_s``, ``graph_captures``,
  ``dispatch_ms``, ``peak_mem_gib``, where the cell has them."""

from __future__ import annotations

from typing import List, Sequence

from benchmark import flops
from benchmark.roofline import STEP_PEAK_FP32, bound_s


def traced(run) -> List[dict]:
    """The records of the traced stretch's batches ([] without a trace)."""
    if run.stretch is None:
        return []
    return [b for b in run.readings.get("batches", ()) if b["traced"]]


def patches(cfg: dict) -> int:
    """Patches of one image (the CLS left out)."""
    if "vit" in cfg:
        return (cfg["vit"]["image_size"] // cfg["vit"]["patch_size"]) ** 2
    return (cfg["image_resolution"] // cfg["vision_patch_size"]) ** 2


def vit_slots(cfg: dict, caps: Sequence[int]) -> List[int]:
    """The vision buffer's slots at each layer's exit: the patches and CLS
    rounded up to 8, then each layer's capacity where it is smaller."""
    slots = -(-(patches(cfg) + 1) // 8) * 8
    out = []
    for c in caps:
        slots = min(c, slots)
        out.append(slots)
    return out


def images(b: dict) -> int:
    """Images through the vision tower in batch record ``b``."""
    return {"nlvr": 2, "clip_image": 1}.get(b["tower"], 0) * b["rows"]


def batch_flops(cfg: dict, b: dict) -> float:
    """Operations of the forward pass over batch record ``b`` (the frozen
    count on its kept counts)."""
    if b["tower"] == "nlvr":
        return b["rows"] * flops.nlvr_flops(cfg, b["v_kept"], b["t_kept"], b["width"])
    if b["tower"] == "clip_image":
        return b["rows"] * flops.clip_image_flops(cfg, b["v_kept"])
    return b["rows"] * flops.clip_text_flops(cfg, b["t_kept"])


def k1_launches(cfg: dict, caps: dict, b: dict) -> List[tuple]:
    """The scoring attention's launches over batch record ``b``, each as
    ``(B, N, H, Dh, alive keys)``: each ViT layer over the images' buffer,
    each MED layer over the sentences'.  CLIP's causal text tower runs the
    plain attention, not the kernel."""
    calls = []
    if b.get("v_kept") is not None:
        if "vit" in cfg:
            H, D = cfg["vit"]["num_heads"], cfg["vit"]["embed_dim"]
        else:
            H, D = cfg["vision_width"] // 64, cfg["vision_width"]
        n = images(b)
        slots, alive = -(-(patches(cfg) + 1) // 8) * 8, patches(cfg) + 1
        for cap, kept in zip(caps["vision"], b["v_kept"]):
            calls.append((n, slots, H, D // H, n * alive))
            slots, alive = min(cap, slots), kept + 1
    if b["tower"] == "nlvr":
        med = cfg["med"]
        H = med["num_attention_heads"]
        n, slots = b["rows"], b["width"]
        alive = slots
        for cap, kept in zip(caps["text"], b["t_kept"]):
            calls.append((n, slots, H, med["hidden_size"] // H, n * alive))
            slots, alive = min(cap, slots), kept + 1
    return calls


def step_mfu(run, passes: int = 1):
    """The traced batches' operations (``passes`` times the forward's:
    3 for a train step's forward and backward) over the stretch's wall time
    and the fp32 step peak, %."""
    batches = traced(run)
    if not batches:
        return None
    ops = passes * sum(batch_flops(run.cell.config, b) for b in batches)
    return 100.0 * ops / run.stretch.window_s / STEP_PEAK_FP32


def attention_roofline(run, work, peak: float, kernels: Sequence[str]):
    """The least time of the scoring attention's launches in the traced
    batches, ``work`` giving each launch's (flops, bytes) at ``peak``, over
    the device time of the kernels whose names hold any of ``kernels``, %."""
    batches = traced(run)
    device_s = run.stretch.kernel_s(kernels) if batches else 0.0
    if device_s <= 0:
        return None
    cfg, caps = run.cell.config, run.readings["capacities"]
    need = sum(bound_s(*work(*c), peak) for b in batches for c in k1_launches(cfg, caps, b))
    return 100.0 * need / device_s


def capacity_fill(run):
    """The CLS, kept and merged tokens summed over the ViT's layers and every
    image of the window, over the slots of the layers' capacities, %."""
    vis = [b for b in run.readings.get("batches", ()) if images(b)]
    if not vis:
        return None
    slots = sum(vit_slots(run.cell.config, run.readings["capacities"]["vision"]))
    used = sum(images(b) * sum(k + 1 for k in b["v_kept"]) for b in vis)
    return 100.0 * used / (sum(images(b) for b in vis) * slots)


def idle_pct(run):
    """The share of the traced stretch in which no kernel, copy or set ran
    on the card, %."""
    if run.stretch is None:
        return None
    return 100.0 * (1.0 - run.stretch.busy_s / run.stretch.window_s)
