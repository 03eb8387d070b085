"""NLVR2 evaluation as ``--evaluate --fast_eval`` runs it
(``madtp_tpu_torch/cli/compress_nlvr.py:181-189``): gather mode at the
capacities ``probe_capacities`` calibrates on the first batches, every
batch uploaded from host memory by ``tasks/nlvr.py``'s ``_device_batch`` and
run through ``make_eval_step``'s captured step, batch ``i+1`` dispatched
before batch ``i`` is read back (``evaluate``'s order).  A pool of seeded
batches is cycled in one closed stream for the window.

Set-up: the model, the pool, the temperature (bisected in mask mode on the
first batch until the frozen FLOP count reads ``p`` of dense), the
capacities, and one capture per padded text length.  Correctness: every
batch of the window against the plain reference (``reference/blip_nlvr.py``)
over the same batch, at the same temperature and at capacities it works out
again from its own mask-mode counts on the probe batches."""

from __future__ import annotations

import statistics

import numpy as np
import torch

from benchmark import calibrate, flops, programs, traffic
from benchmark.drivers import common
from benchmark.harness import Run, Stretch

PAIR_OFF = 1e-4  # a pair's logits off by more than this share of the batch's largest


def _temperature(step, batch, cfg, mix):
    """The temperature at which the frozen FLOP count, on the mask-mode
    step's kept counts for ``batch``, reads ``p`` of dense."""
    images, ids, mask = batch
    width = ids.shape[1]
    P = (cfg["vit"]["image_size"] // cfg["vit"]["patch_size"]) ** 2
    dense = flops.nlvr_flops(cfg, [P] * cfg["vit"]["depth"],
                             [width - 1] * cfg["med"]["num_hidden_layers"], width)

    def flops_at(t):
        out = step(images, ids, mask, t)
        return flops.nlvr_flops(cfg, out.v_kept.tolist(), out.t_kept.tolist(), width)
    return calibrate.bisect_temperature(flops_at, (1.0 - mix["p"]) * dense)


def run(run: Run):
    from madtp_tpu_torch.tasks import nlvr as task
    from madtp_tpu_torch.utils.graph import CapturedStep

    cfg, mix, dev = run.cell.config, run.cell.mix, run.device
    enc = cfg["enc_token_id"]
    run.mark("imports")
    pool = traffic.nlvr_batches(mix, cfg, run.seed, dev)
    run.mark("traffic")
    n_probe = mix["probe_batches"]

    def tokenize(j):
        return pool[j].ids, pool[j].mask

    def upload(j):
        b = pool[j]
        return task._device_batch(b.image0, b.image1, j, tokenize, enc, dev)

    model, spec = programs.nlvr_model(cfg, run.seed, dev)
    run.mark("model")
    temperature = _temperature(task.make_eval_step(model, prune_active=True), upload(0)[0],
                               cfg, mix)
    run.mark("bisection")
    probe = [(pool[j].image0, pool[j].image1, j, pool[j].targets) for j in range(n_probe)]
    caps_v, caps_t = task.probe_capacities(model, probe, tokenize, enc, temperature,
                                           mix["cap_mode"])
    run.mark("capacities")
    run.log("temperature", temperature, "capacities", caps_v, caps_t)
    outs = None if run.control else _window(run, task, CapturedStep, model, upload, pool,
                                            temperature, caps_v, caps_t)
    del model
    common.free_device()
    run.mark("window")
    _check(run, spec, pool, temperature, (caps_v, caps_t), outs)
    run.mark("reference")


def _window(run, task, CapturedStep, model, upload, pool, temperature, caps_v, caps_t):
    """Set-up's captures, then the measured window.  Returns the window's
    outputs, one tuple per batch."""
    cfg, mix = run.cell.config, run.cell.mix
    pairs = mix["pairs_per_batch"]
    step = task.make_eval_step(model, True, caps_v, caps_t)
    seen = set()
    for j in range(len(pool)):  # one capture per padded text length
        if pool[j].ids.shape[1] not in seen:
            seen.add(pool[j].ids.shape[1])
            step(*upload(j)[0], temperature).logits.cpu()
    common.sync(run.device)
    run.mark(f"captures of {len(seen)} text lengths")
    captures0, capture_s = CapturedStep.captures, CapturedStep.capture_seconds
    stretch = Stretch() if run.trace else None
    trace_at = mix["trace_from"]
    outs, pending, i = [], None, 0

    def consume(p):
        j, out, t0, width = p
        with Stretch.span("readback"):
            rec = (j, out.logits.cpu(), out.v_kept.cpu().tolist(), out.t_kept.cpu().tolist(),
                   int(out.overflow.cpu()), width)
        outs.append(rec + (t0, common.now()))

    start = common.now()
    run.setup_s = start - run.t_start
    common.reset_peak(run.device)
    deadline = start + run.seconds
    while common.now() < deadline:
        if stretch is not None and i == trace_at:
            stretch.start()
        j = i % len(pool)
        t0 = common.now()
        with Stretch.span("feed"):
            batch, width = upload(j)
        with Stretch.span("dispatch"):
            out = step(*batch, temperature)
        if pending is not None:
            consume(pending)
        pending = (j, out, t0, width)
        i += 1
        if stretch is not None and i == trace_at + mix["trace_batches"]:
            consume(pending)
            pending = None
            stretch.stop()
    if pending is not None:
        consume(pending)
    end = common.now()
    run.memory_peak_bytes = common.peak_bytes(run.device)
    n = len(outs)
    run.e2e["eval_samples_per_s"] = n * pairs / (end - start)
    run.e2e["eval_batch_p90_ms"] = 1e3 * common.quantile([o[7] - o[6] for o in outs], 0.9)
    run.e2e["setup_s"] = run.setup_s
    run.attempted = n * pairs
    r = run.readings
    r["graph_capture_s"] = capture_s
    r["graph_captures"] = CapturedStep.captures - captures0
    r["capacities"] = {"vision": list(caps_v), "text": list(caps_t)}
    traced = range(trace_at, trace_at + mix["trace_batches"]) if stretch is not None else ()
    r["batches"] = [{"tower": "nlvr", "rows": pairs, "width": o[5], "v_kept": o[2],
                     "t_kept": o[3], "traced": k in traced} for k, o in enumerate(outs)]
    if stretch is not None:
        if len(outs) < trace_at + mix["trace_batches"]:
            raise RuntimeError("the window ended before the traced stretch")
        run.stretch = stretch
    return outs


def _reference_outputs(run, spec, pool, temperature, tf32: bool):
    """The reference over the probe batches (its own capacities) and then
    over every batch of the pool: ``(caps, {j: output})``."""
    from benchmark.reference import blip_nlvr as ref

    cfg, mix, dev = run.cell.config, run.cell.mix, run.device
    W = common.reference_weights(spec, run.seed, dev)
    with common.precision(tf32), torch.no_grad():
        def fwd(j, caps=(None, None)):
            b = pool[j]
            ids = torch.from_numpy(b.ids.copy()).to(dev)
            ids[:, 0] = cfg["enc_token_id"]
            images = torch.from_numpy(np.concatenate([b.image0, b.image1])).to(dev)
            return ref.forward(W, images, ids, torch.from_numpy(b.mask).to(dev), cfg,
                               temperature, *caps)
        probe = [fwd(j) for j in range(mix["probe_batches"])]
        caps = calibrate.schedules([p.v_kept for p in probe], [p.t_kept for p in probe],
                                   mix["cap_mode"])
        outs = {}
        for j in range(len(pool)):
            o = fwd(j, caps)
            outs[j] = (o.logits.float().cpu(), o.v_kept, o.t_kept, o.overflow)
    return caps, outs


def _check(run, spec, pool, temperature, caps, outs):
    """Every batch of the window against the reference's output for it.  A
    batch is off where a kept count of any layer of either tower or its
    overflow count differs from the reference's, or where any pair's gap
    exceeds ``PAIR_OFF``; a pair's gap is the largest difference of its two
    logits over the batch's largest reference logit.  Compared: the share
    of the window's batches that are off, and the median pair's gap.

    A batch, and not a pair or a count, is the unit: a score near a tie in
    the ranking of one image's tokens, or at the threshold of the batch's
    fullest row, can fall either way in fp32, in the reference as in the
    program; it moves that pair's logits by up to about 1e-2 or, at the
    threshold, that batch's counts and every pair of it (``PERF.md``), and
    stays in the one batch of the pool.  A fault in every batch, as one
    pair's slot wrong in each, puts every batch off.  The capacities are
    logged, not compared: they reach the outputs only through the counts
    and the logits."""
    ref_caps, ref = _reference_outputs(run, spec, pool, temperature, tf32=False)
    if outs is None:  # the control: the reference in TF32 in the program's place
        caps, ctl = _reference_outputs(run, spec, pool, temperature, tf32=True)
        outs = [(j,) + ctl[j] for j in range(len(pool))]
    run.log("capacities off by", max(abs(a - b) for x, y in zip(caps, ref_caps)
                                     for a, b in zip(x, y)))
    gaps, off = [], []
    for i, o in enumerate(outs):
        r = ref[o[0]]
        counts = max([abs(o[4] - r[3])] + [abs(a - b) for a, b in zip(o[2] + o[3], r[1] + r[2])])
        rows = ((o[1] - r[0]).abs().amax(dim=1) / r[0].abs().max()).tolist()
        gaps.extend(rows)
        pairs = sum(g > PAIR_OFF for g in rows)
        if counts or pairs:
            off.append(len(rows))
            run.log(f"batch {i} (pool {o[0]}) off: counts by {counts}, {pairs} pair(s) off, "
                    f"the widest by {max(rows):.3g}")
    run.log(f"the widest pair's gap {max(gaps):.3g}")
    run.check("logit_gap_median", statistics.median(gaps))
    run.check("batches_off_pct", 100.0 * len(off) / len(outs))
    run.attempted = run.attempted or len(gaps)
    run.failed = 0 if run.correct else sum(off)
