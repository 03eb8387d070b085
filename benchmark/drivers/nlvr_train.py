"""NLVR2 compression fine-tuning as ``--fast_train`` runs it
(``scripts/torch/compress_nlvr_nlvr2_p0.5.sh``,
``madtp_tpu_torch/cli/compress_nlvr.py:201-251``): AdamW at the config's
learning rate and weight decay, ``probe_capacities``' gather capacities on
the first batches, ``train/loops.py``'s ``make_nlvr_train_step`` driven by
``tasks/nlvr.py``'s ``train_epoch`` (the upload, the step, the one-deep
read of the losses) with a ``stop()`` at the deadline.

Set-up builds the one model and optimizer the window trains, fixes the
temperature (bisected in mask mode on the probe batches until the frozen
FLOP count reads ``p`` of dense), calibrates the capacities and takes the
first steps through ``train_epoch``.  Correctness: the plain reference
(``reference/blip_nlvr.py``, ``reference/adamw.py``) from the same weights
follows those steps on the same batches: each step's two losses, the norm
of each parameter's first gradient (from the optimizer's first moment after
one step) and of its change over the steps, worst leaf."""

from __future__ import annotations

import itertools
import statistics

import numpy as np
import torch

from benchmark import calibrate, flops, programs, traffic
from benchmark.drivers import common
from benchmark.harness import Run, Stretch


def _temperature(step, batches, cfg, mix):
    """The temperature at which the frozen FLOP count, averaged over the
    mask-mode step's kept counts on ``batches``, reads ``p`` of dense.
    Returns it and its kept counts, one pair of lists per batch."""
    P = (cfg["vit"]["image_size"] // cfg["vit"]["patch_size"]) ** 2

    def count(v, t, b):
        return flops.nlvr_flops(cfg, v, t, b[1].shape[1])
    dense = statistics.fmean(count([P] * cfg["vit"]["depth"],
                                   [b[1].shape[1] - 1] * cfg["med"]["num_hidden_layers"], b)
                             for b in batches)
    kept = {}

    def flops_at(t):
        outs = [step(*b, t) for b in batches]
        kept[t] = [(o.v_kept.tolist(), o.t_kept.tolist()) for o in outs]
        return statistics.fmean(count(v, k, b) for (v, k), b in zip(kept[t], batches))
    t = calibrate.bisect_temperature(flops_at, (1.0 - mix["p"]) * dense)
    return t, kept[t]


class Steps:
    """The train step as ``train_epoch`` is handed it: the harness's span
    around each call (its host time until it returns), the losses each
    call returned, and the traced stretch started and stopped at the steps
    the mix names."""

    def __init__(self, step, stretch=None, trace_from=0, trace_steps=0):
        self.step, self.stretch = step, stretch
        self.trace_from, self.trace_steps = trace_from, trace_steps
        self.losses, self.dispatch_s = [], []

    def __call__(self, *args):
        n = len(self.losses)
        if self.stretch is not None and n == self.trace_from:
            self.stretch.start()
        if self.stretch is not None and n == self.trace_from + self.trace_steps:
            self.stretch.stop()
        t0 = common.now()
        with Stretch.span("dispatch"):
            out = self.step(*args)
        self.dispatch_s.append(common.now() - t0)
        self.losses.append(out)
        return out


def run(run: Run):
    from madtp_tpu_torch.tasks import nlvr as task
    from madtp_tpu_torch.train.loops import make_nlvr_train_step
    from madtp_tpu_torch.train.optim import make_adamw

    cfg, mix, dev = run.cell.config, run.cell.mix, run.device
    enc = cfg["enc_token_id"]
    run.mark("imports")
    pool = traffic.nlvr_batches(mix, cfg, run.seed, dev)
    run.mark("traffic")
    n_probe = mix["probe_batches"]

    def tokenize(j):
        return pool[j].ids, pool[j].mask

    def batch(j):
        b = pool[j]
        return b.image0, b.image1, j, b.targets

    model, spec = programs.nlvr_model(cfg, run.seed, dev)
    run.mark("model")
    probe = [batch(j) for j in range(n_probe)]
    mask_step = task.make_eval_step(model, prune_active=True)
    uploads = [task._device_batch(*b[:3], tokenize, enc, dev)[0] for b in probe]
    temperature, probe_kept = _temperature(mask_step, uploads, cfg, mix)
    del mask_step, uploads
    run.mark("bisection")
    caps = task.probe_capacities(model, probe, tokenize, enc, temperature, mix["cap_mode"])
    run.mark("capacities")
    run.log("temperature", temperature, "capacities", caps)
    first = None
    if not run.control:
        opt = make_adamw(model.parameters(), lr=mix["lr"], weight_decay=mix["weight_decay"])
        step = make_nlvr_train_step(model, opt, capacities_v=caps[0], capacities_t=caps[1],
                                    device=dev.type)
        first = _first_steps(run, task, model, opt, step, spec, batch, tokenize, temperature)
        run.mark("first steps")
        _window(run, task, model, step, batch, tokenize, temperature, pool, caps, probe_kept,
                probe)
        del opt, step
    del model
    common.free_device()
    run.mark("window")
    _check(run, spec, pool, temperature, caps, first)
    run.mark("reference")


def _first_steps(run, task, model, opt, step, spec, batch, tokenize, temperature):
    """Set-up's steps through ``train_epoch``: the losses of each, the norm
    of each parameter's first gradient as AdamW holds it after one step
    (its first moment over 1 - beta1), and of its change after them."""
    n_first, enc = run.cell.mix["checked_steps"], run.cell.config["enc_token_id"]
    steps = Steps(step)
    lr = run.cell.mix["lr"]
    task.train_epoch(model, steps, lambda: iter([batch(0)]), tokenize, enc, temperature,
                     print_fn=None, print_freq=0, lr=lr)
    beta1 = opt.param_groups[0]["betas"][0]
    # a parameter with no moment has had no gradient applied: 0
    grad = {n: float(opt.state[p]["exp_avg"].norm()) / (1.0 - beta1)
            if "exp_avg" in opt.state[p] else 0.0 for n, p in model.named_parameters()}
    task.train_epoch(model, steps, lambda: (batch(j) for j in range(1, n_first)), tokenize,
                     enc, temperature, print_fn=None, print_freq=0, lr=lr)
    common.sync(run.device)
    losses = [(float(o["loss_ori"]), float(o["loss_fdt"])) for o in steps.losses]
    start = common.reference_weights(spec, run.seed, run.device)
    with torch.no_grad():
        change = {n: float((p - start[n]).norm()) for n, p in model.named_parameters()}
    del start
    return losses, grad, change


def _window(run, task, model, step, batch, tokenize, temperature, pool, caps, probe_kept,
            probe):
    cfg, mix = run.cell.config, run.cell.mix
    n_first, enc = mix["checked_steps"], cfg["enc_token_id"]
    stretch = Stretch() if run.trace else None
    steps = Steps(step, stretch, mix["trace_from"], mix["trace_steps"])
    order = itertools.cycle(range(len(pool)))
    for _ in range(n_first):  # the window goes on from the batch after the set-up's
        next(order)
    common.sync(run.device)
    start = common.now()
    run.setup_s = start - run.t_start
    common.reset_peak(run.device)
    deadline = start + run.seconds
    stats = task.train_epoch(model, steps, lambda: (batch(j) for j in order), tokenize,
                             enc, temperature, print_fn=None, print_freq=0, lr=mix["lr"],
                             stop=lambda: common.now() >= deadline)
    common.sync(run.device)
    end = common.now()
    run.memory_peak_bytes = common.peak_bytes(run.device)
    n = int(stats["batches_done"])
    pairs = mix["pairs_per_batch"]
    run.e2e["train_samples_per_s"] = n * pairs / (end - start)
    run.e2e["setup_s"] = run.setup_s
    run.attempted = n * pairs
    run.failed = sum(pairs for o in steps.losses if not torch.isfinite(o["loss"]))
    r = run.readings
    r["dispatch_ms"] = 1e3 * statistics.fmean(steps.dispatch_s)
    r["peak_mem_gib"] = run.memory_peak_bytes / 2 ** 30
    r["capacities"] = {"vision": list(caps[0]), "text": list(caps[1])}
    # the step returns no kept counts: for each step of the window, the probe
    # batch's at the same temperature stand for them, the probe batches in turn
    traced = (range(mix["trace_from"], mix["trace_from"] + mix["trace_steps"])
              if stretch is not None else ())
    stand_ins = list(zip(probe_kept, probe))
    r["batches"] = []
    for i in range(n):
        (v, t), b = stand_ins[i % len(stand_ins)]
        r["batches"].append({"tower": "nlvr", "rows": pairs, "width": pool[b[2]].ids.shape[1],
                             "v_kept": v, "t_kept": t, "traced": i in traced, "probe": True})
    if stretch is not None:
        if stretch.busy_s is None:
            raise RuntimeError("the window ended before the traced stretch")
        run.stretch = stretch


def _reference_steps(run, spec, pool, temperature, tf32: bool):
    """The reference's capacities (from its own mask-mode counts on the probe
    batches) and its first steps: losses, first gradients' norms, and the
    parameters' change."""
    from benchmark.reference import blip_nlvr as ref
    from benchmark.reference.adamw import adamw_step

    cfg, mix, dev = run.cell.config, run.cell.mix, run.device

    def inputs(j):
        b = pool[j]
        ids = torch.from_numpy(b.ids.copy()).to(dev)
        ids[:, 0] = cfg["enc_token_id"]
        return (torch.from_numpy(np.concatenate([b.image0, b.image1])).to(dev), ids,
                torch.from_numpy(b.mask).to(dev), torch.from_numpy(b.targets).to(dev))

    start = common.reference_weights(spec, run.seed, dev)
    params = {n: t.clone() for n, t in start.items()}
    with common.precision(tf32):
        with torch.no_grad():
            probe = [ref.forward(params, *inputs(j)[:3], cfg, temperature)
                     for j in range(mix["probe_batches"])]
        caps = calibrate.schedules([p.v_kept for p in probe], [p.t_kept for p in probe],
                                   mix["cap_mode"])
        del probe
        state, losses, grad = {}, [], None
        for i in range(mix["checked_steps"]):
            leaves = {n: t.detach().requires_grad_() for n, t in params.items()}
            loss, lo, lf = ref.losses(leaves, *inputs(i), cfg, temperature, *caps)
            grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
            grads = {n: torch.zeros_like(params[n]) if g is None else g
                     for n, g in zip(leaves, grads)}
            losses.append((lo.item(), lf.item()))
            if i == 0:
                grad = {n: float(g.norm()) for n, g in grads.items()}
            params = adamw_step({n: t.detach() for n, t in params.items()}, grads, state,
                                i + 1, lr=mix["lr"], weight_decay=mix["weight_decay"])
            del leaves, grads, loss
    change = {n: float((params[n] - start[n]).norm()) for n in params}
    return caps, losses, grad, change


def _check(run, spec, pool, temperature, caps, first):
    ref_caps, r_losses, r_grad, r_change = _reference_steps(run, spec, pool, temperature,
                                                            tf32=False)
    if first is None:  # the control: the reference in TF32 in the program's place
        caps, losses, grad, change = _reference_steps(run, spec, pool, temperature, tf32=True)
        run.attempted = run.cell.mix["checked_steps"] * run.cell.mix["pairs_per_batch"]
    else:
        losses, grad, change = first
    run.log("capacities off by", max(abs(a - b) for x, y in zip(caps, ref_caps)
                                     for a, b in zip(x, y)))
    # each step's gap is its worse loss's; the median step is compared, as a
    # score near a tie in one image's token ranking can fall either way in
    # fp32 and move one step's losses by up to 1e-4 (PERF.md)
    steps = [max(abs(a - b) / abs(b) for a, b in zip(p, r)) for p, r in zip(losses, r_losses)]
    run.log("each step's loss gap", steps)
    run.check("loss_gap", statistics.median(steps))
    # leaves whose reference gradient is nought to rounding (a key's bias under
    # the softmax) move under AdamW by round-off alone: left out by this rule
    med = statistics.median(r_grad.values())
    live = [n for n, g in r_grad.items() if g >= 1e-3 * med]
    run.log(f"{len(r_grad) - len(live)} leaves left out:", sorted(set(r_grad) - set(live)))
    run.check("grad_gap", common.leaf_gap(grad, r_grad, live))
    run.check("change_gap", common.leaf_gap(change, r_change, live))
