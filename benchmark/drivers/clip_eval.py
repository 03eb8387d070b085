"""CLIP image-text retrieval evaluation as ``--evaluate --fast_eval`` runs it
(``madtp_tpu_torch/cli/compress_retrieval_clip.py``, ``tasks/
clip_retrieval.py``'s ``evaluate``): the vision tower in gather mode at the
capacities ``probe_capacities`` calibrates, the text tower in mask mode,
both through ``tower_steps``' captured steps, the images uploaded batch by
batch from host memory and the captions once a pass (``encode_towers``'
order), then ``sims = img @ txt.T`` and ``itm_eval``.  Whole passes over
the gallery repeat until the window ends; the rate counts whole passes.

Set-up: the model, the gallery, the temperature (bisected in mask mode on
the first image batch until the frozen FLOP count of the vision tower reads
``p`` of dense), the capacities and one capture per batch shape.
Correctness: the first pass's features, kept counts and recalls against the
plain reference (``reference/clip.py``) over the same batches, at capacities
it works out again; every later pass must equal the first."""

from __future__ import annotations

import numpy as np
import torch

from benchmark import calibrate, flops, programs, traffic
from benchmark.drivers import common
from benchmark.harness import Run, Stretch

ROW_OFF = 1e-4  # a row's unit-norm features off by more than this


def _batches(n: int, size: int):
    return [(i, min(i + size, n)) for i in range(0, n, size)]


def _temperature(img_step, images, cfg, mix):
    """The temperature at which the vision tower's frozen FLOP count, on the
    mask-mode kept counts of ``images``, reads ``p`` of dense."""
    P = (cfg["image_resolution"] // cfg["vision_patch_size"]) ** 2
    dense = flops.clip_image_flops(cfg, [P] * cfg["vision_layers"])
    return calibrate.bisect_temperature(
        lambda t: flops.clip_image_flops(cfg, img_step(images, t)[1].tolist()),
        (1.0 - mix["p"]) * dense)


def run(run: Run):
    from madtp_tpu_torch.eval.metrics import itm_eval
    from madtp_tpu_torch.tasks import clip_retrieval as task

    cfg, mix, dev = run.cell.config, run.cell.mix, run.device
    run.mark("imports")
    n_img = mix["images"]
    gen = torch.Generator(device=dev).manual_seed(run.seed)
    images = traffic.host_images(n_img, cfg["image_resolution"], gen, dev)
    text = traffic.clip_captions(mix, cfg, run.seed)
    tpi = mix["texts_per_image"]
    txt2img = [t // tpi for t in range(len(text))]
    img2txt = [list(range(i * tpi, (i + 1) * tpi)) for i in range(n_img)]
    img_batches = _batches(n_img, mix["image_batch"])

    run.mark("traffic")
    model, spec = programs.clip_model(cfg, run.seed, dev)
    run.mark("model")
    mask_img, _ = task.tower_steps(model, True)
    first = torch.from_numpy(images[:mix["image_batch"]]).to(dev)
    temperature = _temperature(mask_img, first, cfg, mix)
    run.mark("bisection")
    probe = (images[a:b] for a, b in _batches(mix["probe_images"], mix["probe_batch"]))
    caps = task.probe_capacities(model, probe, temperature, mix["cap_mode"])
    run.mark("capacities")
    run.log("temperature", temperature, "capacities", caps)
    passes = None
    if not run.control:
        passes = _window(run, task, itm_eval, model, images, text, txt2img, img2txt,
                         img_batches, temperature, caps)
    del model, mask_img
    common.free_device()
    run.mark("window")
    _check(run, spec, images, text, txt2img, img2txt, img_batches, temperature, caps, passes)
    run.mark("reference")


def _window(run, task, itm_eval, model, images, text, txt2img, img2txt, img_batches,
            temperature, caps):
    from madtp_tpu_torch.utils.graph import CapturedStep

    cfg, mix, dev = run.cell.config, run.cell.mix, run.device
    img_step, txt_step = task.tower_steps(model, True, caps)
    tb = mix["text_batch"]
    txt_batches = _batches(len(text), tb)

    def one_pass(stretch=None):
        """``encode_towers``' loop, keeping every batch's kept counts, then the
        ranking."""
        if stretch is not None:
            stretch.start()
        img, v_kept, txt, t_kept = [], [], [], []
        for a, b in img_batches:
            with Stretch.span("feed"):
                x = torch.from_numpy(images[a:b]).to(dev)
            with Stretch.span("dispatch"):
                feat, kept = img_step(x, temperature)
            img.append(feat)
            v_kept.append(kept)
        with Stretch.span("feed"):
            ids = torch.as_tensor(text, dtype=torch.long).to(dev)
        for a, b in txt_batches:
            with Stretch.span("dispatch"):
                feat, kept = txt_step(ids[a:b], temperature)
            txt.append(feat)
            t_kept.append(kept)
        with Stretch.span("readback"):
            img = torch.cat(img).float().cpu().numpy()
            txt = torch.cat(txt).float().cpu().numpy()
            v_kept = [k.tolist() for k in torch.stack(v_kept).cpu()]
            t_kept = [k.tolist() for k in torch.stack(t_kept).cpu()]
        with Stretch.span("rank"):
            sims = img @ txt.T
            stats = itm_eval(sims, sims.T, txt2img, img2txt)
        if stretch is not None:
            stretch.stop()
        return img, txt, v_kept, t_kept, stats

    ids = torch.as_tensor(text, dtype=torch.long).to(dev)
    for a, b in {img_batches[0], img_batches[-1]}:  # set-up: a capture per batch shape
        img_step(torch.from_numpy(images[a:b]).to(dev), temperature)
    for a, b in {txt_batches[0], txt_batches[-1]}:
        txt_step(ids[a:b], temperature)
    del ids
    common.sync(dev)
    run.mark("captures")
    captures0, capture_s = CapturedStep.captures, CapturedStep.capture_seconds
    passes = []
    start = common.now()
    run.setup_s = start - run.t_start
    common.reset_peak(dev)
    deadline = start + run.seconds
    while common.now() < deadline:
        passes.append(one_pass())
    end = common.now()
    run.memory_peak_bytes = common.peak_bytes(dev)
    run.e2e["retrieval_images_per_s"] = len(passes) * len(images) / (end - start)
    run.e2e["setup_s"] = run.setup_s
    run.attempted = len(passes) * len(images)
    if run.trace:
        run.stretch = Stretch()
        passes.append(one_pass(run.stretch))  # judged with the others
    r = run.readings
    r["graph_capture_s"] = capture_s
    r["graph_captures"] = CapturedStep.captures - captures0
    r["capacities"] = {"vision": list(caps), "text": None}
    r["batches"] = []
    for i, p in enumerate(passes):
        traced = run.trace and i == len(passes) - 1
        r["batches"] += [{"tower": "clip_image", "rows": b - a, "v_kept": k, "traced": traced}
                         for (a, b), k in zip(img_batches, p[2])]
        r["batches"] += [{"tower": "clip_text", "rows": b - a, "t_kept": k, "traced": traced}
                         for (a, b), k in zip(txt_batches, p[3])]
    return passes


def _reference(run, spec, images, text, img_batches, temperature, tf32: bool):
    """The reference's capacities (from its own mask-mode counts on the probe
    images), features and kept counts of every batch."""
    from benchmark.reference import clip as ref

    cfg, mix, dev = run.cell.config, run.cell.mix, run.device
    W = common.reference_weights(spec, run.seed, dev)
    with common.precision(tf32), torch.no_grad():
        probe = [ref.encode_image(W, torch.from_numpy(images[a:b]).to(dev), cfg,
                                  temperature)[1]
                 for a, b in _batches(mix["probe_images"], mix["probe_batch"])]
        caps = calibrate.schedules(probe, None, mix["cap_mode"])[0]
        img, v_kept, txt, t_kept = [], [], [], []
        for a, b in img_batches:
            f, k = ref.encode_image(W, torch.from_numpy(images[a:b]).to(dev), cfg,
                                    temperature, caps)
            img.append(f.float().cpu())
            v_kept.append(k)
        ids = torch.as_tensor(text, dtype=torch.long).to(dev)
        for a, b in _batches(len(text), mix["text_batch"]):
            f, k = ref.encode_text(W, ids[a:b], cfg, temperature)
            txt.append(f.float().cpu())
            t_kept.append(k)
    return caps, torch.cat(img).numpy(), torch.cat(txt).numpy(), v_kept, t_kept


def _recalls(img, txt, txt2img, img2txt):
    """The recalls of features ``img``, ``txt`` by the plain ranking, over
    their similarities formed as the eval forms them (fp32 ``img @ txt.T``)."""
    from benchmark.reference.recall import recalls

    return recalls(img @ txt.T, txt2img, img2txt)


def _batches_off(run, kind, batches, feats, ref_feats, kept, ref_kept):
    """The batches of one tower that are off: a kept count differs from the
    reference's, or a row's unit-norm features differ by more than
    ``ROW_OFF``.  Returns ``(batches off, every row's gap)``."""
    gaps = np.abs(feats - ref_feats).max(axis=1)
    off = 0
    for (a, b), k, rk in zip(batches, kept, ref_kept):
        counts = max(abs(x - y) for x, y in zip(k, rk))
        rows = int((gaps[a:b] > ROW_OFF).sum())
        if counts or rows:
            off += 1
            run.log(f"{kind} batch {a}:{b} off: counts by {counts}, {rows} row(s) off, the "
                    f"widest by {float(gaps[a:b].max()):.3g}")
    return off, gaps


def _check(run, spec, images, text, txt2img, img2txt, img_batches, temperature, caps, passes):
    """The first pass against the reference, every later pass equal to the
    first, and every pass's recalls.

    A batch of either tower is off where one of its kept counts differs
    from the reference's or one of its rows' unit-norm features differs by
    more than ``ROW_OFF``.  Compared: the shares of image and of caption
    batches that are off, each over its own tower's batches, and the median
    row's gap.  A batch, not a row or a count, is the unit: a score near a
    tie in the ranking of an image's tokens, or at the threshold of a
    batch's fullest row, can fall either way in fp32, in the reference as in
    the program, and moves that row, or that batch's counts and every row
    of it (``PERF.md``); a fault in every batch, as one image's slot wrong
    in each, puts every batch off.  The recalls the timed path's ranking
    (``itm_eval``) returned are compared with the plain ranking's
    (``reference/recall.py``) over the same pass's features.  The
    capacities are logged, not compared."""
    ref_caps, r_img, r_txt, r_vk, r_tk = _reference(run, spec, images, text, img_batches,
                                                     temperature, tf32=False)
    if passes is None:  # the control: the reference in TF32 in the program's place
        caps, img, txt, vk, tk = _reference(run, spec, images, text, img_batches,
                                            temperature, tf32=True)
        passes = [(img, txt, vk, tk, _recalls(img, txt, txt2img, img2txt))]
        run.attempted = len(images)
    first = passes[0]
    same = True
    for i, p in enumerate(passes[1:], 1):
        if not (np.array_equal(p[0], first[0]) and np.array_equal(p[1], first[1])
                and p[2] == first[2] and p[3] == first[3]):
            same = False
            run.log(f"pass {i} differs from the first: features by "
                    f"{float(np.abs(p[0] - first[0]).max()):.3g}, "
                    f"{float(np.abs(p[1] - first[1]).max()):.3g}")
    run.log("capacities off by", max(abs(a - b) for a, b in zip(caps, ref_caps)))
    txt_batches = _batches(len(text), run.cell.mix["text_batch"])
    img_off, img_gaps = _batches_off(run, "image", img_batches, first[0], r_img, first[2], r_vk)
    txt_off, txt_gaps = _batches_off(run, "caption", txt_batches, first[1], r_txt, first[3],
                                     r_tk)
    gaps = np.concatenate([img_gaps, txt_gaps])
    run.log(f"the widest row's gap {float(gaps.max()):.3g}")
    run.check("feature_gap_median", float(np.median(gaps)) if same else float("nan"))
    run.check("image_batches_off_pct", 100.0 * img_off / len(img_batches))
    run.check("caption_batches_off_pct", 100.0 * txt_off / len(txt_batches))
    run.check("ranking_gap", max(abs(p[4][k] - v) for p in passes
                                 for k, v in _recalls(p[0], p[1], txt2img, img2txt).items()))
    run.failed = 0 if run.correct else run.attempted
