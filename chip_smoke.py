"""Smoke run of the PyTorch/CUDA port (``madtp_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. build kernels K1 (``madtp_tpu_torch/csrc/attention_scores.cu``), K2
   (``csrc/attention_scores_bwd.cu``), K4 (``csrc/cross_attention.cu``) and
   K5 (``csrc/ffn.cu``) with nvcc, one process each, together;
2. K1 against its plain PyTorch version on the card at the NLVR shapes, fp32
   and bf16, with times, the card's bound, and the time of
   ``F.scaled_dot_product_attention`` for the ``out`` part alone (a yardstick
   that computes less than K1; the port never calls it);
3. K2 against its plain version (autograd through K1's) at the train step's
   shapes, fp32 and bf16, two launches bit-identical, with times, the bound,
   and SDPA forward + backward for the ``out`` part alone (partial again);
3b. K4 against its plain version on synthetic inputs at the ITM rerank's,
   the NLVR twin cross's and ragged shapes, with and without bias, fp32 and
   bf16, two launches bit-identical, with times, the bound, and SDPA with the
   same additive mask (the same function);
3c. K5 against its plain version at the CLIP vision (M = 32 x 584, 1024 /
   4096), CLIP text (M = 32 x 96, 768 / 3072), BLIP (M = 64 x 584, 768 /
   3072) and a ragged shape, GELU and QuickGELU, two launches bit-identical,
   with times, the bound, and the library call (two ``F.linear`` and the
   activation: the same function);
4. the full-width NLVR model (ViT-B/16@384 + 12-layer twin MED, seeded random
   weights, 2 pairs, fp32) on the card against the same model on the CPU, in
   mask and gather mode: equal kept counts, logits within 1e-4, K1 launched in
   every layer;
5. the eval main path in bf16 at 32 pairs: temperature bisection toward half
   the dense GFLOPs in mask mode, the capacity schedule, and the gather-mode
   eval through ``tasks.nlvr.evaluate``; samples/s of the gather step and of
   the dense forward;
6. one fp32 train step of the full-width model, 1 pair, on the card against
   the CPU, mask and gather mode: equal kept counts, losses within 1e-4,
   named gradients within 1e-3 of their largest value, K2 launched once per
   K1 launch;
7. the training main path at 16 pairs: controller epochs (temperature update,
   cosine LR, a mask-mode fp32 train epoch, an eval for the GFLOPs), then a
   ``--fast_train`` epoch (probe, capacities, gather-mode train) in fp32 and
   with ``amp``; a gather step under the sync guard; the checkpoint round
   trip; step times, a profile of the gather amp step;
8. the full-width BLIP retrieval model (ViT-B/16@384 + 12-layer MED with
   single-stream cross-attention, the width of ``configs/retrieval_coco.yaml``,
   seeded random weights, fp32) on the card against the CPU: 4 images, 8
   texts, ``k_test`` 4, mask and gather mode, at a temperature whose DTP
   decisions on the CPU stand clear of fp32 rounding: equal kept counts and
   candidate sets, features within 1e-5, rerank scores within 1e-4, 12 K4
   launches per ITM forward;
9. the retrieval main path in bf16 at p=0.5: temperature bisection toward half
   the dense ``retrieval_gflops`` in mask mode, the ``--fast_eval`` capacities,
   ``tasks.retrieval.evaluate`` in gather mode on 256 synthetic images (8
   batches of 32) and 1,280 texts at ``k_test`` 256, the dense eval, and one
   ITM forward at ``k_test`` 256: images/s, texts/s, ITM candidates/s, eval
   wall time, a profile of the ITM forward;
10. the CLIP ViT-L/14@336 retrieval eval main path in bf16 at p=0.5
   (``tools/bench_clip.py``'s configuration, seeded random weights): the
   temperature bisected toward half the dense ``clip_gflops`` in mask mode,
   the ``--fast_eval`` capacities, ``tasks.clip_retrieval.evaluate`` in
   gather mode on 1,024 synthetic uint8 images (32 batches of 32) and 5,120
   token-id texts, and the dense eval; images/s, texts/s, eval wall time, a
   profile of one image batch;
11. the full-width CLIP model on the card against the CPU, fp32, 2 images
   and 4 texts, mask and gather mode, at the first temperature near the main
   path's whose DTP decisions stand clear of fp32 rounding (as phase 8):
   equal kept counts in both towers, features within 1e-5, equal rankings.

The NLVR phases (4-7) also hold K4 to 24 launches per forward: the twin
cross-attention's two streams in each of the 12 MED layers.  Each main path
(5, 7, 9, 10) also holds K4 and K5 against their plain versions on the
inputs that path gave them, one case per distinct shape (K4 where the path
has cross-attention), and phase 10 holds K1 on the CLIP vision tower's own
H = 16 inputs; each path times its step with the FFNs on K5 and on two
linears (the path before K5), in turns.

Prints the card's name and power limit, a JSON line of kernel measurements,
and as its last line ``{"ok": true, "device": {...}}``.  Without a CUDA
device it exits non-zero before printing any result.
"""

from __future__ import annotations

import collections
import copy
import importlib
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

PAD_BIAS = -10000.0
CLS_ID, SEP_ID, ENC_ID = 101, 102, 30523  # BERT's [CLS], [SEP]; BLIP's added [ENC]
MEM_RATE = 3.35e12  # H100 SXM HBM3, bytes/s
PEAK = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense tensor-core bf16; fp32 CUDA cores


def log(*args):
    print(*args, flush=True)


def k1_case(B, N, *, with_bias, dtype, device, H=12, Dh=64, seed=0):
    """K1 inputs at one shape: q, k, v as [B, N, H, Dh] views of one packed
    [B, N, 3*H*Dh] tensor (the qkv linear's layout), about a quarter of slots
    1.. dead plus a dead tail like a mask-mode buffer's, and with
    ``with_bias`` PAD_BIAS on about a fifth of the keys."""
    rng = np.random.RandomState(seed)
    packed = torch.from_numpy(rng.randn(B, N, 3 * H * Dh).astype(np.float32))
    packed = packed.to(device=device, dtype=dtype)
    q, k, v = (packed[..., i * H * Dh:(i + 1) * H * Dh].unflatten(-1, (H, Dh))
               for i in range(3))
    alive = rng.rand(B, N) > 0.25
    alive[:, 0] = True
    alive[:, N - max(1, N // 50):] = False
    bias = None
    if with_bias:
        bias = torch.from_numpy(
            (rng.rand(B, N) < 0.2).astype(np.float32) * PAD_BIAS).to(device)
    return q, k, v, torch.from_numpy(alive).to(device), bias


def k2_case(B, N, *, with_bias, dtype, device, H=12, seed=0):
    """K2 inputs: a K1 case, K1's out and row statistics on it, and random
    N(0, 1) cotangents of all three outputs."""
    from madtp_tpu_torch.kernels.attention_scores import attention_scores_cuda

    q, k, v, alive, bias = k1_case(B, N, with_bias=with_bias, dtype=dtype, device=device,
                                   H=H, seed=seed)
    bias_in = torch.zeros(alive.shape, device=device) if bias is None else bias
    scale = q.shape[-1] ** -0.5
    with torch.no_grad():
        out, _, _, stats = attention_scores_cuda(q, k, v, alive, bias_in, scale,
                                                 return_stats=True)
    rng = np.random.RandomState(seed + 1)
    d_out = torch.from_numpy(rng.randn(*out.shape).astype(np.float32)).to(device, dtype)
    d_cls, d_col = (torch.from_numpy(rng.randn(B, N - 1).astype(np.float32)).to(device)
                    for _ in range(2))
    return dict(q=q, k=k, v=v, alive=alive, bias=bias, bias_in=bias_in, scale=scale,
                out=out, stats=stats, d_out=d_out, d_cls=d_cls, d_col=d_col)


def head_max_near_ties(c, rel=1e-5):
    """[B, N, N] bool: the (alive query i >= 1, key j >= 1) whose two largest
    head probabilities agree within ``rel``.  The gradient of the head max
    is discontinuous there: two versions whose P differ in the last bits may
    send it to different heads."""
    q, k, alive = c["q"].float(), c["k"].float(), c["alive"]
    logits = torch.einsum("bihd,bjhd->bhij", q, k) * c["scale"]
    logits = (logits + c["bias_in"][:, None, None, :]).masked_fill(
        ~alive[:, None, None, :], float("-inf"))
    top = torch.nan_to_num(torch.softmax(logits, dim=-1)).topk(2, dim=1).values
    del logits
    near = (top[:, 0] - top[:, 1] <= rel * top[:, 0]) & (top[:, 0] > 0)
    near &= alive[:, :, None]
    near[:, 0, :] = False
    near[:, :, 0] = False
    return near


def compare_k2(c, got, want, tol, label):
    """K2's (dq, dk, dv, dbias) against the plain version's, leaving out the
    query rows (dq) and key rows (dk, dbias) of head-max near ties.  Returns
    the max abs errors and the number of near ties."""
    near = head_max_near_ties(c)
    rows, cols = ~near.any(dim=2), ~near.any(dim=1)
    errs = {}
    for name, g, w, keep in zip(("dq", "dk", "dv", "dbias"), got, want,
                                (rows, cols, None, cols)):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"K2 {name} {label}: {g.shape} {g.dtype} vs {w.shape} {w.dtype}")
        if keep is not None:
            g, w = g[keep], w[keep]
        errs[name] = check_close(f"K2 {name} {label}", g, w, *tol[name])
    return errs, int(near.sum())


def k1_work(q, alive):
    """(flops, bytes) the function needs: 4 Dh flops per (head, query, alive
    key) for q k^T and P v; each input read once, each output written once."""
    B, N, H, Dh = q.shape
    alive_keys = int(alive.sum())
    flops = 4.0 * H * Dh * N * alive_keys
    el = q.element_size()
    nbytes = (3 * B * N * H * Dh * el + B * N + B * N * 4  # q, k, v, alive, bias
              + B * N * H * Dh * el + 2 * B * N * 4)  # out, col_mass, cls_attn
    return flops, nbytes


def k2_work(q, alive):
    """(flops, bytes) of the backward itself: one q k^T recompute and the four
    gradient products, 10 Dh flops per (head, query, alive key); q, k, v,
    alive, bias, dout, dcls, dcol read once, dq, dk, dv, dbias written once."""
    B, N, H, Dh = q.shape
    flops = 10.0 * H * Dh * N * int(alive.sum())
    el = q.element_size()
    nbytes = (4 * B * N * H * Dh * el + B * N + B * N * 4 + 2 * B * (N - 1) * 4
              + 3 * B * N * H * Dh * el + B * N * 4)
    return flops, nbytes


def k4_case(B, Nq, S, *, with_bias, dtype, device, H=12, Dh=64, seed=0, packed_q=False):
    """K4 inputs at one shape: q a [B, Nq, H, Dh] view of the query linear's
    output (with ``packed_q``, of a packed [B, Nq, 3*H*Dh] tensor: strided),
    k and v views of two separate [B, S, H*Dh] tensors (the key and value
    linears' outputs), a quarter of the keys dead (slot 0 alive, so every row
    has a live key), and with ``with_bias`` PAD_BIAS on about a fifth."""
    rng = np.random.RandomState(seed)

    def heads(*shape):
        t = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(device=device, dtype=dtype)
        return t[..., :H * Dh].unflatten(-1, (H, Dh))

    q = heads(B, Nq, (3 if packed_q else 1) * H * Dh)
    k, v = heads(B, S, H * Dh), heads(B, S, H * Dh)
    alive = rng.rand(B, S) > 0.25
    alive[:, 0] = True
    bias = None
    if with_bias:
        bias = torch.from_numpy(
            (rng.rand(B, S) < 0.2).astype(np.float32) * PAD_BIAS).to(device)
    return q, k, v, torch.from_numpy(alive).to(device), bias


def k4_work(q, k, alive, bias):
    """(flops, bytes) of the cross-attention: 4 Dh flops per (head, query,
    alive key) for q k^T and P v; q, k, v, alive, bias read once, out
    written once."""
    B, Nq, H, Dh = q.shape
    S = k.shape[1]
    flops = 4.0 * H * Dh * Nq * int(alive.sum())
    el = q.element_size()
    nbytes = (2 * B * Nq * H * Dh + 2 * B * S * H * Dh) * el + B * S
    return flops, nbytes + (0 if bias is None else B * S * 4)


def sdpa_mask(alive, bias, dtype):
    """The additive [B, 1, 1, S] mask that makes scaled_dot_product_attention
    compute the kernels' masking: the bias (None: none), -inf at dead keys."""
    mask = torch.zeros(alive.shape, device=alive.device).masked_fill(~alive, float("-inf"))
    if bias is not None:
        mask = mask + bias
    return mask[:, None, None, :].to(dtype)


class _Capture:
    """While active, replaces ``module.attr`` with a recorder that keeps the
    inputs of the first call of each distinct ``key`` (detached, completed
    to ``len(defaults)`` arguments) and counts the calls of each; every call
    goes on to the original unchanged, so the launch counts are those of the
    path itself."""

    module = attr = None
    defaults = ()  # (name, default) of each argument, in order

    def key(self, *args):
        raise NotImplementedError

    def __enter__(self):
        self._mod = importlib.import_module(self.module)
        self._orig = getattr(self._mod, self.attr)
        self.cases, self.calls = {}, collections.Counter()

        def record(*args, **kw):
            full = list(args) + [kw.get(n, d) for n, d in self.defaults[len(args):]]
            key = self.key(*full)
            self.calls[key] += 1
            if key not in self.cases:
                self.cases[key] = tuple(t.detach() if torch.is_tensor(t) else t for t in full)
            return self._orig(*args, **kw)

        setattr(self._mod, self.attr, record)
        return self

    def __exit__(self, *exc):
        setattr(self._mod, self.attr, self._orig)


class K4Capture(_Capture):
    """The MED's cross-attention calls, by (B, Nq, S, dtype, bias or none)."""

    module, attr = "madtp_tpu_torch.models.med", "cross_attention"
    defaults = (("q", None), ("k", None), ("v", None), ("key_alive", None), ("key_bias", None))

    def key(self, q, k, v, key_alive, key_bias):
        return (q.shape[0], q.shape[1], k.shape[1], q.dtype, key_bias is not None)


class K5Capture(_Capture):
    """K5's calls (from ``ops.layers.mlp`` and ``FusedMLP``), by (M, D, F,
    act)."""

    module, attr = "madtp_tpu_torch.ops.layers", "ffn_cuda"
    defaults = (("x", None), ("w1", None), ("b1", None), ("w2", None), ("b2", None),
                ("act", "gelu"))

    def key(self, x, w1, b1, w2, b2, act):
        return (x.shape[0], x.shape[1], w1.shape[0], act)


class K1Capture(_Capture):
    """The scoring attention's calls, by (B, N, H, dtype, bias or none)."""

    module, attr = "madtp_tpu_torch.ops.attention", "attention_scores"
    defaults = (("q", None), ("k", None), ("v", None), ("key_alive", None),
                ("key_bias", None), ("scale", None))

    def key(self, q, k, v, key_alive, key_bias, scale):
        return (q.shape[0], q.shape[1], q.shape[2], q.dtype, key_bias is not None)


class PlainFFN:
    """While active, the models' FFNs run their plain version (two linears)
    on the card too: the path before K5, for an A/B inside one run."""

    MODULES = ("madtp_tpu_torch.models.vit", "madtp_tpu_torch.models.med",
               "madtp_tpu_torch.models.clip")

    def __enter__(self):
        from madtp_tpu_torch.ops.layers import mlp_plain

        def plain(x, fc1, fc2, act="gelu"):
            return mlp_plain(x, fc1.weight, fc1.bias, fc2.weight, fc2.bias, act)

        self._saved = [(m, m.mlp) for m in map(importlib.import_module, self.MODULES)]
        for m, _ in self._saved:
            m.mlp = plain
        return self

    def __exit__(self, *exc):
        for m, f in self._saved:
            m.mlp = f


def ffn_ab(label, fn, iters):
    """``fn``'s CUDA-event time with the FFNs on K5 and on two linears (the
    path before K5), in turns plain, K5, K5, plain.  Returns the two means."""
    times = {"k5": [], "plain": []}
    for which in ("plain", "k5", "k5", "plain"):
        if which == "plain":
            with PlainFFN():
                times[which].append(time_ms(fn, iters))
        else:
            times[which].append(time_ms(fn, iters))
    k5, plain = (sum(times[w]) / 2 for w in ("k5", "plain"))
    log(f"[ffn-ab] {label}: FFNs on K5 {k5:.2f} ms ({times['k5'][0]:.2f}, {times['k5'][1]:.2f}), "
        f"on two linears (before K5) {plain:.2f} ms ({times['plain'][0]:.2f}, "
        f"{times['plain'][1]:.2f}): {plain / k5:.3f}x")
    return k5, plain


def check_k4_cases(label, capture, iters=20):
    """K4 against its plain version on the inputs a main path gave it (one
    case per distinct shape, dtype and bias, as ``capture`` recorded them):
    in their own dtype within ``TOLERANCES``, bf16 cases also cast to fp32
    within the fp32 tolerance, two launches bit-identical; with the times of
    K4, the plain version and SDPA (the same function), and the bound.
    Returns the record of the most-called case for the kernels line."""
    import torch.nn.functional as F

    from madtp_tpu_torch.kernels.cross_attention import TOLERANCES, cross_attention_cuda
    from madtp_tpu_torch.ops.attention import cross_attention_plain

    records = {}
    with torch.inference_mode():
        for key, (q, k, v, alive, bias) in capture.cases.items():
            B, Nq, S, dtype, _ = key
            alive = alive.contiguous()
            bias = None if bias is None else bias.float().contiguous()
            scale = q.shape[-1] ** -0.5
            name = (f"{label} B={B} Nq={Nq} S={S} bias={bias is not None} "
                    f"({capture.calls[key]} calls)")
            errs = []
            for dt in dict.fromkeys((dtype, torch.float32)):
                qd, kd, vd = (t.to(dt) for t in (q, k, v))
                got = cross_attention_cuda(qd, kd, vd, alive, bias, scale)
                want = cross_attention_plain(qd, kd, vd, alive, bias, scale)
                errs.append(check_close(f"K4 {name} {str(dt)[6:]}", got, want, *TOLERANCES[dt]))
                if not torch.equal(got, cross_attention_cuda(qd, kd, vd, alive, bias, scale)):
                    raise AssertionError(f"K4 {name} {str(dt)[6:]}: two launches differ")
                del qd, kd, vd, got, want
            ms = time_ms(lambda: cross_attention_cuda(q, k, v, alive, bias, scale), iters)
            plain_ms = time_ms(lambda: cross_attention_plain(q, k, v, alive, bias, scale), 5)
            mask = sdpa_mask(alive, bias, dtype)
            qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
            sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask, scale=scale), iters)
            bound_ms, bound_by = bound(*k4_work(q, k, alive, bias), dtype)
            log(f"[k4-main] {name} {str(dtype)[6:]}: max|err| {errs[0]:.2e}"
                + (f" (as fp32 {errs[1]:.2e})" if len(errs) > 1 else "")
                + f", bit-identical relaunch | K4 {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"bound {bound_ms:.4f} ms ({bound_by}), sdpa (same function) {sdpa_ms:.4f} ms")
            records[key] = dict(max_abs_err=errs[0], ms=ms, plain_ms=plain_ms,
                                bound_ms=bound_ms, bound_by=bound_by, library_ms=sdpa_ms,
                                shape=dict(B=B, Nq=Nq, S=S, dtype=str(dtype)[6:]))
            del mask, qh, kh, vh
    capture.cases.clear()
    torch.cuda.empty_cache()
    if not records:
        raise AssertionError(f"{label}: the path made no cross-attention call")
    return records[capture.calls.most_common(1)[0][0]]


def bound(flops, nbytes, dtype):
    """The least time the card could take, ms, and what bounds it."""
    t_ops, t_bytes = flops / PEAK[dtype] * 1e3, nbytes / MEM_RATE * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def time_ms(fn, iters):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def enqueue_ms(fn, iters):
    """Host time per call for ``fn`` to enqueue its kernels, the card left
    to drain only after the last call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize()
    return ms


def host_ms(fn, iters):
    """Host time for ``fn`` to return (to dispatch its kernels), with the card
    drained before each call: near the step's CUDA-event time when the step
    is bound by the host."""
    fn()
    total = 0.0
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        total += time.perf_counter() - t0
    torch.cuda.synchronize()
    return total / iters * 1e3


def profile_step(label, fn, step_ms, top=10):
    """Device time by kernel for one call of ``fn`` under torch.profiler, and
    the device's busy share of ``step_ms``, the call's time without the
    profiler (whose own cost would lengthen a wall time taken under it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]  # ranges, not kernels
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"[profile] {label}: device busy {busy_ms:.2f} ms of the {step_ms:.2f} ms step "
        f"({busy_ms / step_ms:.1%}); {sum(e.count for e in kernels)} launches of "
        f"{len(kernels)} kernels; " + kernel_totals(kernels, busy_ms))
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        ms = e.self_device_time_total / 1e3
        log(f"[profile]   {ms:8.3f} ms {ms / max(busy_ms, 1e-9):6.1%} x{e.count:<5d} {e.key[:90]}")


def kernel_totals(kernels, busy_ms):
    """Device time of K1's, K2's, K4's and K5's passes among profiler averages."""
    out = []
    for name, tag in (("K1", "::k1_"), ("K2", "::k2_"), ("K4", "::k4_"), ("K5", "::k5_")):
        ms = sum(e.self_device_time_total for e in kernels if tag in e.key) / 1e3
        out.append(f"{name} {ms:.2f} ms ({ms / max(busy_ms, 1e-9):.1%})")
    return ", ".join(out)


def profile_backward(label, step, batch):
    """Device time of the backward pass alone of one train step's loss, and
    K1's (remat only) and K2's part of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    loss = step.loss_fn(*batch)[0]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        loss.backward()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"[profile] {label} backward alone: device {busy_ms:.2f} ms; "
        + kernel_totals(kernels, busy_ms))


def check_close(name, got, want, rtol, atol):
    got, want = got.float(), want.float()
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if not torch.isfinite(got).all() or bad.any():
        raise AssertionError(
            f"{name}: {int(bad.sum())} values outside rtol={rtol} atol={atol}; "
            f"max abs err {float(err.max()):.3e}")
    return float(err.max())


def phase_build():
    from madtp_tpu_torch.kernels import attention_scores as k1
    from madtp_tpu_torch.kernels import attention_scores_bwd as k2
    from madtp_tpu_torch.kernels import cross_attention as k4
    from madtp_tpu_torch.kernels import ffn as k5
    from madtp_tpu_torch.kernels.build import build_all

    t0 = time.perf_counter()
    built = build_all([k1.SOURCE, k2.SOURCE, k4.SOURCE, k5.SOURCE])
    log(f"[build] {time.perf_counter() - t0:.2f} s wall for {len(built)} kernel source(s)")
    for name, b in built.items():
        log(f"[build] {name}: nvcc {b.seconds:.2f} s -> {b.path.name}")
        for line in b.log.splitlines():
            if "registers" in line or "bytes stack" in line or "spill" in line:
                log(f"[build]   {line.strip()}")


def phase_k1(device, main_n=584):
    """K1 vs plain at the main path's shapes.  Returns the bf16 record at
    N = ``main_n`` (the gather path's first layer) for the kernels line."""
    import torch.nn.functional as F

    from madtp_tpu_torch.kernels.attention_scores import TOLERANCES, attention_scores_cuda
    from madtp_tpu_torch.ops.attention import attention_scores_plain

    cases = [(64, 584, False), (64, 592, False), (64, 320, False), (32, 35, True)]
    record = None
    for dtype in (torch.float32, torch.bfloat16):
        tol = TOLERANCES[dtype]
        for B, N, with_bias in cases:
            q, k, v, alive, bias = k1_case(B, N, with_bias=with_bias, dtype=dtype,
                                           device=device)
            bias_in = (torch.zeros(alive.shape, device=device) if bias is None else bias)
            scale = q.shape[-1] ** -0.5
            got = attention_scores_cuda(q, k, v, alive, bias_in, scale)
            want = attention_scores_plain(q, k, v, alive, bias, scale)
            torch.cuda.synchronize()
            errs = {name: check_close(f"K1 {name} B={B} N={N} {dtype}", g, w, *tol[name])
                    for name, g, w in zip(("out", "cls_attn", "col_mass"), got, want)}
            ms = time_ms(lambda: attention_scores_cuda(q, k, v, alive, bias_in, scale), 10)
            plain_ms = time_ms(lambda: attention_scores_plain(q, k, v, alive, bias, scale), 3)
            mask = sdpa_mask(alive, bias_in, dtype)
            qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
            sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask, scale=scale), 10)
            bound_ms, bound_by = bound(*k1_work(q, alive), dtype)
            log(f"[k1] {str(dtype)[6:]} B={B} N={N} bias={with_bias}: "
                f"max|err| out {errs['out']:.2e} col {errs['col_mass']:.2e} "
                f"cls {errs['cls_attn']:.2e} | K1 {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"bound {bound_ms:.4f} ms ({bound_by}), "
                f"sdpa(out only, computes less than K1) {sdpa_ms:.4f} ms")
            if dtype == torch.bfloat16 and N == main_n:
                record = dict(max_abs_err=max(errs.values()), ms=ms, plain_ms=plain_ms,
                              bound_ms=bound_ms, bound_by=bound_by, library_ms=sdpa_ms)
            del q, k, v, got, want
            torch.cuda.empty_cache()
    return record


def phase_k2(device, main_n=592):
    """K2 vs plain at the train step's shapes: the mask-mode ViT buffer
    (N = 592), the gather path's first layer (584) and a later one (320) at
    32 images, the text side at 16 captions with PAD_BIAS keys (40 mask, 26
    gather).  Returns the fp32 record at N = ``main_n`` (the mask-mode fp32
    train step, ``compress_nlvr``'s default) for the kernels line."""
    import torch.nn.functional as F

    from madtp_tpu_torch.kernels import attention_scores_bwd as k2
    from madtp_tpu_torch.ops.attention import attention_scores_bwd_plain

    cases = [(32, 592, False), (32, 584, False), (32, 320, False), (16, 40, True),
             (16, 26, True)]
    record = None
    for dtype in (torch.float32, torch.bfloat16):
        for B, N, with_bias in cases:
            c = k2_case(B, N, with_bias=with_bias, dtype=dtype, device=device)
            args = [c[n] for n in ("q", "k", "v", "alive", "bias_in", "scale", "out", "stats",
                                   "d_out", "d_cls", "d_col")]
            plain_args = [c[n] for n in ("q", "k", "v", "alive", "bias", "scale", "d_out",
                                         "d_cls", "d_col")]
            got = k2.attention_scores_bwd_cuda(*args)
            want = attention_scores_bwd_plain(*plain_args)
            torch.cuda.synchronize()
            label = f"B={B} N={N} {str(dtype)[6:]}"
            errs, near = compare_k2(c, got, want, k2.TOLERANCES[dtype], label)
            again = k2.attention_scores_bwd_cuda(*args)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"K2 {label}: two launches on the same inputs differ")
            del got, want, again
            ms = time_ms(lambda: k2.attention_scores_bwd_cuda(*args), 5)
            plain_ms = time_ms(lambda: attention_scores_bwd_plain(*plain_args), 2)
            mask = sdpa_mask(c["alive"], c["bias_in"], dtype)
            qh, kh, vh = (c[n].transpose(1, 2).detach().requires_grad_() for n in "qkv")
            do = c["d_out"].view(c["q"].shape).transpose(1, 2)

            def sdpa():
                o = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask, scale=c["scale"])
                torch.autograd.grad(o, (qh, kh, vh), do)

            sdpa_ms = time_ms(sdpa, 5)
            bound_ms, bound_by = bound(*k2_work(c["q"], c["alive"]), dtype)
            log(f"[k2] {label} bias={with_bias}: max|err| dq {errs['dq']:.2e} dk {errs['dk']:.2e} "
                f"dv {errs['dv']:.2e} dbias {errs['dbias']:.2e} ({near} head-max near ties "
                f"left out); bit-identical relaunch | K2 {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"bound {bound_ms:.4f} ms ({bound_by}), sdpa fwd+bwd (out only, computes "
                f"less than K2) {sdpa_ms:.4f} ms")
            if dtype == torch.float32 and N == main_n:
                record = dict(max_abs_err=max(errs.values()), ms=ms, plain_ms=plain_ms,
                              bound_ms=bound_ms, bound_by=bound_by, library_ms=sdpa_ms)
            del c, args, plain_args, qh, kh, vh, do, mask
            torch.cuda.empty_cache()
    return record


def phase_k4(device):
    """K4 vs plain on synthetic inputs at the ITM rerank's shapes (256
    candidates, 35 text queries, 592 image slots in mask mode and 320 in
    gather mode), the NLVR twin cross's (32 pairs, 32 text slots, 320 image
    slots) and ragged ones (Nq 1 and 7, S not a multiple of the 64-key
    tile), with and without bias, fp32 and bf16; two launches bit-identical.
    The shapes the main paths really give K4 are checked on their own inputs
    (``check_k4_cases``)."""
    import torch.nn.functional as F

    from madtp_tpu_torch.kernels.cross_attention import TOLERANCES, cross_attention_cuda
    from madtp_tpu_torch.ops.attention import cross_attention_plain

    cases = [(256, 35, 592), (256, 35, 320), (32, 32, 320), (8, 1, 100), (8, 7, 130)]
    for dtype in (torch.float32, torch.bfloat16):
        for B, Nq, S in cases:
            for with_bias in (False, True):
                q, k, v, alive, bias = k4_case(B, Nq, S, with_bias=with_bias, dtype=dtype,
                                               device=device, packed_q=Nq == 7)
                scale = q.shape[-1] ** -0.5
                got = cross_attention_cuda(q, k, v, alive, bias, scale)
                want = cross_attention_plain(q, k, v, alive, bias, scale)
                torch.cuda.synchronize()
                label = f"B={B} Nq={Nq} S={S} bias={with_bias} {str(dtype)[6:]}"
                err = check_close(f"K4 {label}", got, want, *TOLERANCES[dtype])
                if not torch.equal(got, cross_attention_cuda(q, k, v, alive, bias, scale)):
                    raise AssertionError(f"K4 {label}: two launches on the same inputs differ")
                ms = time_ms(lambda: cross_attention_cuda(q, k, v, alive, bias, scale), 20)
                plain_ms = time_ms(lambda: cross_attention_plain(q, k, v, alive, bias, scale), 5)
                mask = sdpa_mask(alive, bias, dtype)
                qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
                sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(
                    qh, kh, vh, attn_mask=mask, scale=scale), 20)
                bound_ms, bound_by = bound(*k4_work(q, k, alive, bias), dtype)
                log(f"[k4] {label}: max|err| {err:.2e}, bit-identical relaunch | K4 {ms:.4f} ms, "
                    f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
                    f"sdpa (same function) {sdpa_ms:.4f} ms")
                del q, k, v, got, want, mask
                torch.cuda.empty_cache()


def k5_case(M, D, F, device, seed=0):
    """K5 inputs: x N(0, 1), W1 and W2 N(0, 1/fan_in), biases N(0, 0.01),
    all bf16 on the card."""
    g = torch.Generator(device=device).manual_seed(seed)

    def r(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=device) * scale).to(torch.bfloat16)

    return r(M, D), r(F, D, scale=D ** -0.5), r(F, scale=0.1), r(D, F, scale=F ** -0.5), \
        r(D, scale=0.1)


def k5_work(M, D, F):
    """(flops, bytes): 2 M D F for each product; x, W1, b1, W2, b2 read once
    and y written once, bf16 (the hidden is the kernel's own traffic)."""
    return 4.0 * M * D * F, 2 * (2 * M * D + 2 * D * F + D + F)


def ffn_library(x, w1, b1, w2, b2, act):
    """The same function as K5 in PyTorch calls: two ``F.linear`` and the
    activation (QuickGELU as the reference ``clip/model.py`` writes it)."""
    import torch.nn.functional as F

    h = F.linear(x, w1, b1)
    h = F.gelu(h) if act == "gelu" else h * torch.sigmoid(1.702 * h)
    return F.linear(h, w2, b2)


def hold_k5(name, x, w1, b1, w2, b2, act, iters):
    """K5 against its plain version on one set of inputs, within
    ``TOLERANCES``, a relaunch bit-identical; times of K5, the plain version
    and the library call, and the bound.  Returns the record."""
    from madtp_tpu_torch.kernels.ffn import TOLERANCES, ffn_cuda
    from madtp_tpu_torch.ops.layers import mlp_plain

    args = (x, w1, b1, w2, b2, act)
    with torch.inference_mode():
        got, want = ffn_cuda(*args), mlp_plain(*args)
        err = check_close(f"K5 {name}", got, want, *TOLERANCES[torch.bfloat16])
        if not torch.equal(got, ffn_cuda(*args)):
            raise AssertionError(f"K5 {name}: two launches on the same inputs differ")
        del got, want
        ms = time_ms(lambda: ffn_cuda(*args), iters)
        plain_ms = time_ms(lambda: mlp_plain(*args), max(3, iters // 4))
        library_ms = time_ms(lambda: ffn_library(*args), iters)
    M, D = x.shape
    F = w1.shape[0]
    bound_ms, bound_by = bound(*k5_work(M, D, F), torch.bfloat16)
    log(f"[k5] {name}: max|err| {err:.2e}, bit-identical relaunch | K5 {ms:.4f} ms "
        f"({4.0 * M * D * F / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}), library (same function) {library_ms:.4f} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms, shape=dict(M=M, D=D, F=F, act=act))


def phase_k5(device, iters=20):
    """K5 vs plain on synthetic inputs at the CLIP vision tower's gather
    shape (32 images x 584 slots, 1024 / 4096), the text tower's mask-mode
    shape (32 x 96, 768 / 3072), BLIP's (64 x 584, 768 / 3072) and a ragged
    M, both activations.  Returns the CLIP vision QuickGELU record."""
    from madtp_tpu_torch.kernels.ffn import ffn_cuda
    from madtp_tpu_torch.ops.layers import mlp_plain

    cases = [("clip vision", 32 * 584, 1024, 4096), ("clip text", 32 * 96, 768, 3072),
             ("blip", 64 * 584, 768, 3072), ("ragged", 1000, 768, 3072)]
    args = k5_case(256, 768, 3072, device)
    with torch.inference_mode():
        host = {name: enqueue_ms(lambda: fn(*args, "gelu"), 200)
                for name, fn in (("K5", ffn_cuda), ("plain", mlp_plain))}
    log(f"[k5] host time to enqueue one FFN (M=256, 768/3072): K5's wrapper "
        f"{host['K5']:.4f} ms, the plain version {host['plain']:.4f} ms")
    record = None
    for label, M, D, F in cases:
        args = k5_case(M, D, F, device)
        for act in ("quick_gelu", "gelu"):
            rec = hold_k5(f"{label} M={M} D={D} F={F} {act}", *args, act, iters)
            if label == "clip vision" and act == "quick_gelu":
                record = rec
        del args
        torch.cuda.empty_cache()
    return record


def check_k5_cases(label, capture, iters=5):
    """K5 against its plain version on the inputs a main path gave it (one
    case per distinct (M, D, F, act), as ``capture`` recorded them), and
    the FFNs' device time over the path's calls on K5, on the plain version
    and on the library call.  Returns the record of the most-called case."""
    records = {key: hold_k5(f"{label} M={key[0]} D={key[1]} F={key[2]} {key[3]} "
                            f"({capture.calls[key]} calls)", *case, iters)
               for key, case in capture.cases.items()}
    capture.cases.clear()
    torch.cuda.empty_cache()
    if not records:
        raise AssertionError(f"{label}: the path made no K5 call")
    total = {k: sum(capture.calls[key] * r[k] for key, r in records.items())
             for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    log(f"[k5-path] {label}: the FFNs' device time over {sum(capture.calls.values())} calls: "
        f"K5 {total['ms']:.2f} ms, plain {total['plain_ms']:.2f} ms, library "
        f"{total['library_ms']:.2f} ms, bound {total['bound_ms']:.2f} ms")
    return records[capture.calls.most_common(1)[0][0]]


def check_k1_cases(label, capture, iters=10):
    """K1 against its plain version on the inputs a main path gave it (one
    case per distinct (B, N, H, dtype, bias)); the most-called case also
    timed with its plain version, SDPA (out only) and the bound.  Returns
    that case's record."""
    import torch.nn.functional as F

    from madtp_tpu_torch.kernels.attention_scores import TOLERANCES, attention_scores_cuda
    from madtp_tpu_torch.ops.attention import attention_scores_plain

    top = capture.calls.most_common(1)[0][0] if capture.calls else None
    record = None
    with torch.inference_mode():
        for key, (q, k, v, alive, bias, scale) in capture.cases.items():
            B, N, H, dtype, _ = key
            alive = alive.contiguous()
            scale = q.shape[-1] ** -0.5 if scale is None else scale
            bias_in = torch.zeros(alive.shape, device=q.device) if bias is None \
                else bias.float().contiguous()
            got = attention_scores_cuda(q, k, v, alive, bias_in, scale)
            want = attention_scores_plain(q, k, v, alive, bias, scale)
            name = f"{label} B={B} N={N} H={H} {str(dtype)[6:]} ({capture.calls[key]} calls)"
            errs = {n: check_close(f"K1 {n} {name}", g, w, *TOLERANCES[dtype][n])
                    for n, g, w in zip(("out", "cls_attn", "col_mass"), got, want)}
            del got, want
            line = (f"[k1-main] {name}: max|err| out {errs['out']:.2e} col "
                    f"{errs['col_mass']:.2e} cls {errs['cls_attn']:.2e}")
            if key == top:
                ms = time_ms(lambda: attention_scores_cuda(q, k, v, alive, bias_in, scale), iters)
                plain_ms = time_ms(lambda: attention_scores_plain(q, k, v, alive, bias, scale), 3)
                mask = sdpa_mask(alive, bias_in, dtype)
                qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
                sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(
                    qh, kh, vh, attn_mask=mask, scale=scale), iters)
                bound_ms, bound_by = bound(*k1_work(q, alive), dtype)
                record = dict(max_abs_err=max(errs.values()), ms=ms, plain_ms=plain_ms,
                              bound_ms=bound_ms, bound_by=bound_by, library_ms=sdpa_ms,
                              shape=dict(B=B, N=N, H=H, dtype=str(dtype)[6:]))
                line += (f" | K1 {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                         f"({bound_by}), sdpa(out only) {sdpa_ms:.4f} ms")
                del mask, qh, kh, vh
            log(line)
    capture.cases.clear()
    torch.cuda.empty_cache()
    if record is None:
        raise AssertionError(f"{label}: the path made no scoring-attention call")
    return record


def full_config():
    from madtp_tpu_torch.core.config import BlipConfig, MedConfig, ViTConfig

    vit = ViTConfig()  # ViT-B/16 @ 384
    med = MedConfig(twin_cross=True, encoder_width=vit.embed_dim, sd_dim=vit.embed_dim)
    return BlipConfig(vit=vit, med=med, sd_dim=vit.embed_dim)


def synthetic_inputs(cfg, pairs, text_len, seed):
    rng = np.random.RandomState(seed)
    s = cfg.vit.image_size
    images = torch.from_numpy(rng.randn(2 * pairs, 3, s, s).astype(np.float32))
    ids = torch.from_numpy(rng.randint(1, cfg.med.vocab_size, size=(pairs, text_len)))
    mask = torch.ones((pairs, text_len), dtype=torch.int64)
    mask[-1, text_len - 5:] = 0  # one padded caption: PAD_BIAS keys
    return images, ids, mask


def phase_model_parity(device, cfg, temperature=1.0):
    """The full-width model on the card (K1, K4) and the CPU (plain), fp32."""
    from madtp_tpu_torch.kernels.attention_scores import attention_scores_cuda
    from madtp_tpu_torch.kernels.cross_attention import cross_attention_cuda
    from madtp_tpu_torch.models.blip import init_nlvr_model
    from madtp_tpu_torch.tasks.nlvr import fast_capacity_schedule

    cpu_model = init_nlvr_model(cfg, seed=0, device="cpu")
    gpu_model = copy.deepcopy(cpu_model).to(device)
    images, ids, mask = synthetic_inputs(cfg, pairs=2, text_len=26, seed=1)
    per_forward = cfg.vit.depth + cfg.med.num_hidden_layers
    caps = None
    for mode in ("mask", "gather"):
        kw = dict(temperature=temperature, prune_active=True)
        if mode == "gather":
            kw.update(capacities_v=caps[0], capacities_t=caps[1])
        with torch.inference_mode():
            t0 = time.perf_counter()
            ref = cpu_model(images, ids, mask, **kw)
            cpu_s = time.perf_counter() - t0
            before, k4_before = attention_scores_cuda.launches, cross_attention_cuda.launches
            out = gpu_model(images.to(device), ids.to(device), mask.to(device), **kw)
            torch.cuda.synchronize()
            launches = attention_scores_cuda.launches - before
            k4 = cross_attention_cuda.launches - k4_before
        vk, tk = out.v_kept.cpu(), out.t_kept.cpu()
        if not (torch.equal(vk, ref.v_kept) and torch.equal(tk, ref.t_kept)):
            raise AssertionError(f"{mode}: kept counts differ: card {vk.tolist()} "
                                 f"{tk.tolist()} vs cpu {ref.v_kept.tolist()} {ref.t_kept.tolist()}")
        err = float((out.logits.cpu() - ref.logits).abs().max())
        if not err <= 1e-4:
            raise AssertionError(f"{mode}: logits differ by {err:.3e} (limit 1e-4)")
        if launches < per_forward:
            raise AssertionError(f"{mode}: K1 launched {launches} times, want >= {per_forward}")
        if k4 != 2 * cfg.med.num_hidden_layers:
            raise AssertionError(f"{mode}: K4 launched {k4} times, want "
                                 f"{2 * cfg.med.num_hidden_layers} (two streams per layer)")
        log(f"[parity] {mode}: kept vision {vk.tolist()} text {tk.tolist()} equal on card "
            f"and cpu; max|logit diff| {err:.3e}; K1 launches {launches}, K4 {k4}; "
            f"cpu {cpu_s:.1f} s")
        if mode == "mask":
            caps = fast_capacity_schedule(ref.v_kept.numpy(), ref.t_kept.numpy(), "ceil")
            log(f"[parity] gather capacities vision {list(caps[0])} text {list(caps[1])}")


def phase_main_path(device, cfg, pairs=32, text_len=26, p_target=0.5, bisect_steps=8,
                    eval_batches=3, iters=10):
    """NLVR2 eval at p=0.5, bf16: bisection, capacities, gather eval.
    Returns the K1, K4 and K5 launch counts of that run."""
    from madtp_tpu_torch.kernels.attention_scores import attention_scores_cuda
    from madtp_tpu_torch.kernels.cross_attention import cross_attention_cuda
    from madtp_tpu_torch.kernels.ffn import ffn_cuda
    from madtp_tpu_torch.models.blip import init_nlvr_model
    from madtp_tpu_torch.prune.flops import nlvr_gflops
    from madtp_tpu_torch.tasks.nlvr import evaluate, fast_capacity_schedule, make_eval_step

    log(f"[main] {card_line()}")
    model = init_nlvr_model(cfg, seed=0, device=device, dtype=torch.bfloat16)
    images, ids, mask = synthetic_inputs(cfg, pairs, text_len, seed=2)
    mask.fill_(1)
    images = images.to(device, torch.bfloat16)
    ids, mask = ids.to(device), mask.to(device)
    ori = nlvr_gflops(cfg.vit, cfg.med, [cfg.vit.num_patches] * cfg.vit.depth,
                      [text_len - 1] * cfg.med.num_hidden_layers, text_len)
    target = ori * (1.0 - p_target)
    step_mask = make_eval_step(model, prune_active=True)

    rng = np.random.default_rng(3)
    s = cfg.vit.image_size

    def loader():
        for _ in range(eval_batches):
            im = rng.standard_normal((2 * pairs, 3, s, s), dtype=np.float32)
            yield im[:pairs], im[pairs:], [f"sentence {i}" for i in range(pairs)], \
                rng.integers(0, 2, size=pairs)

    def tokenize(sentences):
        return (rng.integers(1, cfg.med.vocab_size, size=(len(sentences), text_len)),
                np.ones((len(sentences), text_len), np.int64))

    attention_scores_cuda.launches = cross_attention_cuda.launches = ffn_cuda.launches = 0
    with K4Capture() as capture, K5Capture() as k5_capture:  # the path's own inputs
        lo, hi = 0.05, 60.0
        for _ in range(bisect_steps):
            t = math.sqrt(lo * hi)
            out = step_mask(images, ids, mask, t)
            vk, tk = out.v_kept.cpu().numpy(), out.t_kept.cpu().numpy()
            g = nlvr_gflops(cfg.vit, cfg.med, vk, tk, text_len)
            log(f"[main] bisect T={t:.4f}: {g:.2f} GFLOPs (target {target:.2f})")
            if g > target:
                lo = t
            else:
                hi = t
        t_star, g_star = t, g
        caps_v, caps_t = fast_capacity_schedule(vk, tk, "ceil")

        stats, cur_gflops = evaluate(model, loader, tokenize, t_star, prune_active=True,
                                     enc_token_id=2, capacities_v=caps_v, capacities_t=caps_t,
                                     print_fn=lambda m: log(f"[main] {m}"), print_freq=1)
    torch.cuda.synchronize()
    launches, k4, k5 = attention_scores_cuda.launches, cross_attention_cuda.launches, \
        ffn_cuda.launches
    per_forward = cfg.vit.depth + cfg.med.num_hidden_layers
    want = per_forward * (bisect_steps + eval_batches)
    if launches < want:
        raise AssertionError(f"main path launched K1 {launches} times, want >= {want}")
    if k4 != 2 * cfg.med.num_hidden_layers * (bisect_steps + eval_batches):
        raise AssertionError(f"main path launched K4 {k4} times, want 24 per forward")
    if k5 != want:
        raise AssertionError(f"main path launched K5 {k5} times, want {want} (every FFN)")
    if not (math.isfinite(cur_gflops) and 0 < cur_gflops < ori):
        raise AssertionError(f"gather eval GFLOPs {cur_gflops} not in (0, {ori})")
    check_k4_cases("nlvr eval", capture)
    check_k5_cases("nlvr eval", k5_capture)

    step_gather = make_eval_step(model, True, caps_v, caps_t)
    step_dense = make_eval_step(model, False)
    torch.cuda.set_sync_debug_mode("error")  # the forward must not wait on the card
    try:
        out = step_gather(images, ids, mask, t_star)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if out.logits.shape != (pairs, 2) or not torch.isfinite(out.logits.float()).all():
        raise AssertionError("gather logits are not finite [pairs, 2]")
    gather_ms = time_ms(lambda: step_gather(images, ids, mask, t_star), iters)
    dense_ms = time_ms(lambda: step_dense(images, ids, mask, 0.0), iters)
    gather_host_ms = host_ms(lambda: step_gather(images, ids, mask, t_star), iters)
    log(f"[main] T*={t_star:.4f} GFLOPs {g_star:.2f} pruned / {ori:.2f} dense; eval "
        f"GFLOPs {cur_gflops:.2f}; acc {stats['acc']}; overflow {stats['overflow']}")
    log(f"[main] capacities vision {list(caps_v)} text {list(caps_t)}")
    log(f"[main] gather step {gather_ms:.2f} ms = {pairs / gather_ms * 1e3:.1f} samples/s; "
        f"dense bf16 {dense_ms:.2f} ms = {pairs / dense_ms * 1e3:.1f} samples/s; "
        f"ratio {dense_ms / gather_ms:.3f}")
    log(f"[main] gather step host dispatch time {gather_host_ms:.2f} ms")
    log(f"[main] launches on the main path: K1 {launches}, K4 {k4}, K5 {k5}")
    ffn_ab("nlvr eval gather step", lambda: step_gather(images, ids, mask, t_star), iters)
    profile_step("gather step", lambda: step_gather(images, ids, mask, t_star), gather_ms)
    profile_step("dense step", lambda: step_dense(images, ids, mask, 0.0), dense_ms)
    return launches, k4, k5


GRAD_PARAMS = ("visual_encoder.patch_embed.proj.weight", "visual_encoder.blocks.0.attn.qkv.weight",
               "visual_encoder.blocks.11.attn.qkv.weight", "space_dict",
               "text_encoder.encoder.layer.0.attention.self.query.weight", "cls_head.0.weight")
GRAD_TOL = 1e-3  # of the largest |gradient| of the tensor: fp32 on both, sums in
# another order, and a head-max tie may send col_mass's gradient to another head


def phase_train_parity(device, cfg, temperature=1.0):
    """One fp32 train forward and backward of the full-width model, 1 pair,
    on the card (K1 forward, K2 backward) and on the CPU (plain), in mask
    mode and in gather mode at lossless capacities."""
    from madtp_tpu_torch.kernels.attention_scores import attention_scores_cuda
    from madtp_tpu_torch.kernels.attention_scores_bwd import attention_scores_bwd_cuda
    from madtp_tpu_torch.kernels.cross_attention import cross_attention_cuda
    from madtp_tpu_torch.models.blip import init_nlvr_model
    from madtp_tpu_torch.tasks.nlvr import fast_capacity_schedule

    cpu_model = init_nlvr_model(cfg, seed=0, device="cpu")
    gpu_model = copy.deepcopy(cpu_model).to(device)
    images, ids, mask = synthetic_inputs(cfg, pairs=1, text_len=26, seed=4)
    targets = torch.tensor([1])
    per_forward = cfg.vit.depth + cfg.med.num_hidden_layers
    with torch.inference_mode():
        ref = cpu_model(images, ids, mask, temperature=temperature, prune_active=True)
    caps = fast_capacity_schedule(ref.v_kept.numpy(), ref.t_kept.numpy(), "ceil")
    for mode, (cv, ct) in (("mask", (None, None)), ("gather", caps)):
        kw = dict(temperature=temperature, prune_active=True, capacities_v=cv,
                  capacities_t=ct)
        res = {}
        for where, model, dev in (("cpu", cpu_model, torch.device("cpu")),
                                  ("card", gpu_model, device)):
            x = [t.to(dev) for t in (images, ids, mask)]
            with torch.inference_mode():
                out = model(*x, **kw)
            k1_before = attention_scores_cuda.launches
            k2_before = attention_scores_bwd_cuda.launches
            k4_before = cross_attention_cuda.launches
            model.zero_grad(set_to_none=True)
            lo, lf, _ = model(*x, targets=targets.to(dev), **kw)
            (lo + 0.1 * lf).backward()
            named = dict(model.named_parameters())
            res[where] = dict(kept=(out.v_kept.cpu(), out.t_kept.cpu()),
                              losses=(float(lo.detach()), float(lf.detach())),
                              grads={n: named[n].grad.cpu() for n in GRAD_PARAMS},
                              k1=attention_scores_cuda.launches - k1_before,
                              k2=attention_scores_bwd_cuda.launches - k2_before,
                              k4=cross_attention_cuda.launches - k4_before)
        cpu, card = res["cpu"], res["card"]
        if not all(torch.equal(a, b) for a, b in zip(cpu["kept"], card["kept"])):
            raise AssertionError(f"train {mode}: kept counts differ: card {card['kept']} "
                                 f"cpu {cpu['kept']}")
        loss_err = max(abs(a - b) for a, b in zip(cpu["losses"], card["losses"]))
        if not loss_err <= 1e-4:
            raise AssertionError(f"train {mode}: losses differ by {loss_err:.3e} (limit 1e-4)")
        rel = {}
        for n in GRAD_PARAMS:
            g, want = card["grads"][n], cpu["grads"][n]
            scale = float(want.abs().max())
            rel[n] = float((g - want).abs().max()) / scale if scale > 0 else float("inf")
            if not (torch.isfinite(g).all() and rel[n] <= GRAD_TOL):
                raise AssertionError(f"train {mode}: grad of {n} differs by {rel[n]:.3e} of "
                                     f"its max {scale:.3e} (limit {GRAD_TOL})")
        if card["k1"] != per_forward or card["k2"] != card["k1"]:
            raise AssertionError(f"train {mode}: K1 {card['k1']} and K2 {card['k2']} launches, "
                                 f"want {per_forward} each")
        if card["k4"] != 2 * cfg.med.num_hidden_layers:
            raise AssertionError(f"train {mode}: K4 {card['k4']} launches, want 24 per step")
        log(f"[train-parity] {mode}: kept vision {card['kept'][0].tolist()} text "
            f"{card['kept'][1].tolist()} equal; losses card {card['losses']} cpu "
            f"{cpu['losses']} (max diff {loss_err:.2e}); K1 {card['k1']} K2 {card['k2']} "
            f"K4 {card['k4']} launches per step")
        log("[train-parity]   grad max|diff| / max|grad|: " + ", ".join(
            f"{n.replace('visual_encoder.', 'v.').replace('text_encoder.encoder.', 't.')} "
            f"{r:.2e}" for n, r in rel.items()))


def phase_train_main(device, cfg, pairs=16, text_len=26, epochs=3, batches=2, iters=5,
                     p_target=0.5, enc_token_id=2):
    """Compression training as ``madtp_tpu/cli/compress_nlvr.py:335-384``
    runs it, on synthetic data: controller epochs in mask mode fp32, then a
    ``--fast_train`` epoch in fp32 and with ``amp``.  Returns the K1, K2, K4
    and K5 launch counts of that run (K5: the amp epoch's FFNs)."""
    import tempfile

    from madtp_tpu_torch.ckpt.convert import load_nlvr_state_dict, save_nlvr_checkpoint
    from madtp_tpu_torch.kernels.attention_scores import attention_scores_cuda
    from madtp_tpu_torch.kernels.attention_scores_bwd import attention_scores_bwd_cuda
    from madtp_tpu_torch.kernels.cross_attention import cross_attention_cuda
    from madtp_tpu_torch.kernels.ffn import ffn_cuda
    from madtp_tpu_torch.models.blip import init_nlvr_model
    from madtp_tpu_torch.prune.flops import nlvr_gflops
    from madtp_tpu_torch.tasks.nlvr import (cached_probe_batches, evaluate, probe_capacities,
                                            train_epoch)
    from madtp_tpu_torch.train.controller import TemperatureController
    from madtp_tpu_torch.train.loops import make_nlvr_train_step
    from madtp_tpu_torch.train.optim import cosine_lr, make_adamw, set_lr

    log(f"[train] {card_line()}")
    model = init_nlvr_model(cfg, seed=0, device=device)  # fp32 masters
    opt = make_adamw(model.parameters(), lr=3e-6, weight_decay=0.05)  # configs/nlvr.yaml
    rng = np.random.default_rng(5)
    s = cfg.vit.image_size

    def loader_fn(n):
        def loader():
            for _ in range(n):
                im = rng.standard_normal((2 * pairs, 3, s, s), dtype=np.float32)
                yield (im[:pairs], im[pairs:], [f"sentence {i}" for i in range(pairs)],
                       rng.integers(0, 2, size=pairs))
        return loader

    def tokenize(sentences):
        mask = np.ones((len(sentences), text_len), np.int64)
        mask[-1, text_len - 5:] = 0  # one padded caption: PAD_BIAS keys
        return rng.integers(1, cfg.med.vocab_size, size=(len(sentences), text_len)), mask

    ori = nlvr_gflops(cfg.vit, cfg.med, [cfg.vit.num_patches] * cfg.vit.depth,
                      [text_len - 1] * cfg.med.num_hidden_layers, text_len)
    controller = TemperatureController(target_gflops=ori * (1.0 - p_target))
    quiet = dict(print_fn=lambda m: log(f"[train]   {m}"), print_freq=0)

    attention_scores_cuda.launches = attention_scores_bwd_cuda.launches = 0
    cross_attention_cuda.launches = ffn_cuda.launches = 0
    with K4Capture() as capture, K5Capture() as k5_capture:  # the path's own inputs
        step_mask = make_nlvr_train_step(model, opt)  # mask mode, fp32: compress_nlvr's default
        cur_g = ori
        for epoch in range(epochs):
            if epoch > 0:
                controller.update(cur_g)
            temperature = controller.temperature
            lr = cosine_lr(epoch, epochs, 3e-6, 0.0)
            set_lr(opt, lr)
            stats = train_epoch(model, step_mask, loader_fn(batches), tokenize, enc_token_id,
                                temperature, lr=lr, **quiet)
            _, cur_g = evaluate(model, loader_fn(1), tokenize, temperature, prune_active=True,
                                enc_token_id=enc_token_id, **quiet)
            log(f"[train] epoch {epoch}: T={temperature:.2f} lr={lr:.3e} loss {stats['loss']} "
                f"(ori {stats['loss_ori']}, fdt {stats['loss_fdt']}); eval GFLOPs {cur_g:.2f} "
                f"(target {controller.target_gflops:.2f}, dense {ori:.2f})")
            if not (all(math.isfinite(float(stats[k])) for k in ("loss", "loss_ori", "loss_fdt"))
                    and stats["batches_done"] == batches and 0 < cur_g <= ori):
                raise AssertionError(f"epoch {epoch}: stats {stats}, GFLOPs {cur_g}")
        probe = cached_probe_batches([None], loader_fn(2), n=2)
        caps_v, caps_t = probe_capacities(model, probe, tokenize, enc_token_id, temperature, "ceil")
        log(f"[train] fast_train capacities vision {list(caps_v)} text {list(caps_t)}")
        steps = {}
        for amp in (False, True):
            name = "gather " + ("amp" if amp else "fp32")
            steps[name] = make_nlvr_train_step(model, opt, capacities_v=caps_v,
                                               capacities_t=caps_t, amp=amp)
            stats = train_epoch(model, steps[name], loader_fn(batches), tokenize, enc_token_id,
                                temperature, lr=lr, **quiet)
            log(f"[train] fast_train epoch, {name}: loss {stats['loss']} (ori {stats['loss_ori']}, "
                f"fdt {stats['loss_fdt']})")
            if not math.isfinite(float(stats["loss"])):
                raise AssertionError(f"{name}: loss {stats['loss']}")
    torch.cuda.synchronize()
    launches = (attention_scores_cuda.launches, attention_scores_bwd_cuda.launches,
                cross_attention_cuda.launches, ffn_cuda.launches)
    log(f"[train] launches on the training main path: K1 {launches[0]}, K2 {launches[1]}, "
        f"K4 {launches[2]}, K5 {launches[3]}")
    if min(launches) == 0 or launches[2] != launches[0]:
        raise AssertionError(f"training main path launched K1/K2/K4/K5 {launches} times "
                             "(K4 should match K1: 24 of each per forward)")
    want_k5 = (cfg.vit.depth + cfg.med.num_hidden_layers) * batches
    if launches[3] != want_k5:
        raise AssertionError(f"training main path launched K5 {launches[3]} times, want "
                             f"{want_k5}: every FFN of the amp epoch, none of the fp32 steps")
    check_k4_cases("nlvr train", capture)
    check_k5_cases("nlvr train amp", k5_capture)

    # one fixed batch on the card for the guard, the timings and the profile
    im0, im1, _, tg = next(iter(loader_fn(1)()))
    ids, mask = tokenize([""] * pairs)
    ids[:, 0] = enc_token_id
    batch = tuple(torch.from_numpy(a).to(device) for a in (np.concatenate([im0, im1]), ids,
                                                           mask, tg)) + (temperature,)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # the train step must not wait on the card
    try:
        m = steps["gather fp32"](*batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if not torch.isfinite(m["loss"]):
        raise AssertionError("gather train step under the sync guard: loss not finite")
    log("[train] gather fp32 train step ran under set_sync_debug_mode('error')")

    steps["mask fp32"] = step_mask
    steps["dense fp32"] = make_nlvr_train_step(model, opt, prune_active=False)
    steps["dense amp"] = make_nlvr_train_step(model, opt, prune_active=False, amp=True)
    times = {}
    for name in ("mask fp32", "gather fp32", "gather amp", "dense fp32", "dense amp"):
        step = steps[name]
        step(*batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times[name] = time_ms(lambda: step(*batch), iters)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"[train] {name} step {times[name]:.2f} ms = {pairs / times[name] * 1e3:.1f} "
            f"pairs/s; peak memory {peak:.2f} GiB")
    for name in ("mask fp32", "gather amp"):
        profile_backward(name, steps[name], batch)
    host = host_ms(lambda: steps["gather amp"](*batch), iters)
    log(f"[train] gather amp step host dispatch time {host:.2f} ms")
    ffn_ab("train gather amp step", lambda: steps["gather amp"](*batch), iters)
    profile_step("gather amp train step", lambda: steps["gather amp"](*batch),
                 times["gather amp"], top=12)

    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/checkpoint_best.pth"
        save_nlvr_checkpoint(model, path, epoch=epochs - 1, temperature=temperature)
        ck = torch.load(path)
        again = load_nlvr_state_dict(ck["model"], cfg, device=device)
    with torch.inference_mode():
        a = model(*batch[:3], temperature=temperature, prune_active=True)
        b = again(*batch[:3], temperature=temperature, prune_active=True)
    if not (torch.equal(a.logits, b.logits) and ck["temperature"] == temperature):
        raise AssertionError("the reloaded checkpoint gives other logits or temperature")
    log(f"[train] checkpoint round trip: identical logits, temperature {ck['temperature']:.2f}")
    return launches


def retrieval_config():
    """BLIP retrieval at the width of ``configs/retrieval_coco.yaml``: ViT-B/16
    @ 384 and the 12-layer BERT-base MED with single-stream cross-attention."""
    from madtp_tpu_torch.core.config import BlipConfig, MedConfig, ViTConfig

    vit = ViTConfig()
    med = MedConfig(encoder_width=vit.embed_dim, sd_dim=vit.embed_dim)
    return BlipConfig(vit=vit, med=med, sd_dim=vit.embed_dim)


def retrieval_corpus(cfg, n_images, texts_per_image, seed, text_len=35):
    """A synthetic corpus: ``n_images`` images and ``texts_per_image`` texts
    for each (COCO has 5), token ids with CLS at slot 0 and SEP at the end of
    a random length in [10, text_len], padded to the longest (the
    tokenizer's ``padding="longest"``, at most 35 tokens).  Returns
    ``(images, ids, mask, txt2img, img2txt)``."""
    rng = np.random.default_rng(seed)
    s = cfg.vit.image_size
    images = rng.standard_normal((n_images, 3, s, s), dtype=np.float32)
    n_texts = n_images * texts_per_image
    lengths = rng.integers(10, text_len + 1, size=n_texts)
    lengths[0] = text_len
    ids = rng.integers(1000, 30000, size=(n_texts, text_len))
    mask = (np.arange(text_len)[None, :] < lengths[:, None]).astype(np.int64)
    ids[:, 0] = CLS_ID
    ids[np.arange(n_texts), lengths - 1] = SEP_ID
    ids = np.where(mask > 0, ids, 0)
    txt2img = [t // texts_per_image for t in range(n_texts)]
    img2txt = [list(range(i * texts_per_image, (i + 1) * texts_per_image))
               for i in range(n_images)]
    return images, ids, mask, txt2img, img2txt


FP32_ULP = 2.0 ** -23  # relative rounding step of fp32
GAP_MIN = 64 * FP32_ULP  # least relative DTP margin the parity phase runs at
DRIFT_FACTOR = 4  # the margin must also hold this many times the card's drift
PARITY_TEMPERATURES = (4.0, 5.0, 3.5, 3.0, 6.0, 2.5)


class DTPRecorder:
    """While active, records every DTP keep decision as CPU tensors: the
    scores, each row's threshold, the alive mask, the ranking, the batch keep
    count and whether the step applies."""

    def __enter__(self):
        from madtp_tpu_torch.prune import dtp

        self.records = []
        self._dtp, self._orig = dtp, dtp._keep_rule

        def record(score, signals, palive, temperature, *rest):
            order, topk_num, alive_cnt, apply = self._orig(score, signals, palive, temperature,
                                                           *rest)
            t = torch.as_tensor(temperature, dtype=torch.float32, device=score.device)
            thr = dtp.dtp_threshold(signals.token_attn, score, palive, t)
            self.records.append((score.float().cpu(), thr.float().cpu(), palive.cpu(),
                                 order.cpu(), int(topk_num), bool(apply)))
            return order, topk_num, alive_cnt, apply

        dtp._keep_rule = record
        return self

    def __exit__(self, *exc):
        self._dtp._keep_rule = self._orig


def dtp_margins(records):
    """The smallest relative margins of recorded DTP decisions: the distance
    of a score from its row's threshold, over the rows that hold the batch's
    largest keep count (the rows that set it), and, in every row that drops
    tokens, the gap between the last kept and the first dropped score.  A
    rounding error smaller than both changes no decision."""
    thr_gap = rank_gap = math.inf
    for score, thr, palive, order, k, apply in records:
        counts = (palive & (score > thr[:, None])).sum(dim=1)
        deciding = palive & (counts == counts.max())[:, None]
        if deciding.any():
            rel = (score - thr[:, None]).abs() / thr.abs()[:, None]
            thr_gap = min(thr_gap, float(rel[deciding].min()))
        drops = palive.sum(dim=1) > k
        if apply and k >= 1 and drops.any():
            ranked = torch.gather(score, 1, order)[drops]
            gap = (ranked[:, k - 1] - ranked[:, k]) / ranked[:, k - 1].abs()
            rank_gap = min(rank_gap, float(gap.min()))
    return thr_gap, rank_gap


def dtp_drift(want, got):
    """The largest change of (score - threshold) between two runs' recorded
    decisions, relative to the larger of the score and the threshold (the
    scale of both roundings), bounded by |change of score| + |change of
    threshold|.  Each row's alive scores are compared in sorted order:
    gather mode places kept tokens by rank, so two near-equal scores may
    trade slots between runs without changing any decision."""
    if len(want) != len(got):
        raise AssertionError(f"{len(got)} DTP decisions against {len(want)}")
    drift = 0.0
    for (s0, t0, a0, *_), (s1, t1, a1, *_) in zip(want, got):
        n_alive = a0.sum(dim=1, keepdim=True)
        if s0.shape != s1.shape or not torch.equal(n_alive, a1.sum(dim=1, keepdim=True)):
            raise AssertionError("a DTP decision ran on another number of alive tokens")
        r0, r1 = (s.masked_fill(~a, -math.inf).sort(dim=1, descending=True).values
                  for s, a in ((s0, a0), (s1, a1)))
        alive = torch.arange(s0.shape[1])[None, :] < n_alive
        if alive.any():
            d = (((r1 - r0).abs() + (t1 - t0).abs()[:, None])
                 / torch.maximum(r0.abs(), t0.abs()[:, None]))
            drift = max(drift, float(d[alive].max()))
    return drift


def phase_retrieval_parity(device, cfg, k_test=4):
    """The full-width retrieval model on the card (K1, K4) and the CPU
    (plain), fp32, seeded weights: 4 images, 8 texts, ``k_test`` 4, in mask
    and gather mode.  Equal kept counts and candidate sets, features within
    1e-5, rerank scores within 1e-4, 12 K4 launches per ITM forward.

    Equal kept counts hold only where no DTP decision sits within rounding
    of its edge.  Random weights can put one there: at T=1 the threshold is
    exactly one token's own score in several layers (the codebook's softmax
    over tokens is one-hot), and card and CPU kept 257 and 256 tokens.  So
    the phase measures, on the CPU runs, the smallest margin of every
    decision (``dtp_margins``) at the first of ``PARITY_TEMPERATURES`` where
    it reaches ``GAP_MIN`` (64 fp32 rounding steps), and holds the card to
    it: the largest drift of the card's (score - threshold) from the CPU's
    must stay ``DRIFT_FACTOR`` times below that margin."""
    from madtp_tpu_torch.kernels.cross_attention import cross_attention_cuda
    from madtp_tpu_torch.models.blip import init_retrieval_model
    from madtp_tpu_torch.tasks.retrieval import encode_corpus, probe_capacities, rerank_scores

    cpu_model = init_retrieval_model(cfg, seed=0, device="cpu")
    gpu_model = copy.deepcopy(cpu_model).to(device)
    images, ids, mask, _, _ = retrieval_corpus(cfg, 4, 2, seed=6)
    enc_ids = ids.copy()
    enc_ids[:, 0] = ENC_ID

    def run(model, dev, temperature, cv, ct):
        kw = dict(temperature=temperature, prune_active=True)
        t0 = time.perf_counter()
        with DTPRecorder() as rec:
            with torch.inference_mode():
                _, iout = model.image_features(torch.from_numpy(images).to(dev),
                                               capacities=cv, **kw)
                _, tout = model.text_features(torch.from_numpy(ids).to(dev),
                                              torch.from_numpy(mask).to(dev), capacities=ct, **kw)
            feats = encode_corpus(model, [images], ids, mask, capacities_v=cv, capacities_t=ct,
                                  **kw)
            before = cross_attention_cuda.launches
            scores = rerank_scores(model, *feats, enc_ids, mask, k_test=k_test,
                                   capacities_t=ct, **kw)
            k4 = cross_attention_cuda.launches - before
        return dict(kept=(iout.kept_counts.cpu(), tout.kept_counts.cpu()),
                    feats=(feats[0], feats[2]), scores=scores, k4=k4, dtp=rec.records,
                    seconds=time.perf_counter() - t0)

    for temperature in PARITY_TEMPERATURES:
        caps = probe_capacities(cpu_model, [images], ids, mask, temperature, "ceil")
        modes = {"mask": (None, None), "gather": caps}
        cpu_runs = {mode: run(cpu_model, torch.device("cpu"), temperature, *c)
                    for mode, c in modes.items()}
        thr_gap, rank_gap = (min(g) for g in zip(*(dtp_margins(r["dtp"])
                                                   for r in cpu_runs.values())))
        margin = min(thr_gap, rank_gap)
        cpu_s = sum(r["seconds"] for r in cpu_runs.values())
        log(f"[r-parity] T={temperature}: smallest DTP margins on the CPU: threshold "
            f"{thr_gap:.3e}, rank {rank_gap:.3e} ({margin / FP32_ULP:.0f} fp32 steps, want "
            f">= {GAP_MIN / FP32_ULP:.0f}); cpu {cpu_s:.1f} s")
        if margin >= GAP_MIN:
            break
    else:
        raise AssertionError(f"no temperature of {PARITY_TEMPERATURES} keeps every DTP decision "
                             f"{GAP_MIN / FP32_ULP:.0f} fp32 steps from its edge")
    log(f"[r-parity] T={temperature}: gather capacities vision {list(caps[0])} text "
        f"{list(caps[1])}")
    for mode, (cv, ct) in modes.items():
        cpu, card = cpu_runs[mode], run(gpu_model, device, temperature, cv, ct)
        if not all(torch.equal(a, b) for a, b in zip(cpu["kept"], card["kept"])):
            raise AssertionError(f"retrieval {mode}: kept counts differ: card {card['kept']} "
                                 f"cpu {cpu['kept']}")
        drift = dtp_drift(cpu["dtp"], card["dtp"])
        if not drift * DRIFT_FACTOR <= margin:
            raise AssertionError(f"retrieval {mode}: the card's DTP scores drift {drift:.3e} "
                                 f"from the CPU's, more than 1/{DRIFT_FACTOR} of the margin "
                                 f"{margin:.3e}")
        feat_err = max(float(np.abs(a - b).max()) for a, b in zip(card["feats"], cpu["feats"]))
        if not feat_err <= 1e-5:
            raise AssertionError(f"retrieval {mode}: features differ by {feat_err:.3e}")
        score_err = 0.0
        for g, w in zip(card["scores"], cpu["scores"]):
            if not np.array_equal(g == -100.0, w == -100.0):
                raise AssertionError(f"retrieval {mode}: candidate sets differ")
            score_err = max(score_err, float(np.abs(g - w).max()))
        if not score_err <= 1e-4:
            raise AssertionError(f"retrieval {mode}: rerank scores differ by {score_err:.3e}")
        n_forwards = sum(sc.shape[0] for sc in card["scores"])
        if card["k4"] != cfg.med.num_hidden_layers * n_forwards:
            raise AssertionError(f"retrieval {mode}: K4 launched {card['k4']} times in "
                                 f"{n_forwards} ITM forwards, want 12 per forward")
        log(f"[r-parity] {mode}: kept vision {card['kept'][0].tolist()} text "
            f"{card['kept'][1].tolist()} equal on card and cpu; candidate sets equal; max|diff| "
            f"features {feat_err:.2e}, scores {score_err:.2e}; DTP drift {drift:.2e} "
            f"({margin / drift if drift else math.inf:.0f}x below the margin); K4 {card['k4']} launches "
            f"in {n_forwards} ITM forwards; cpu {cpu['seconds']:.1f} s")


def phase_retrieval_main(device, cfg, p_target=0.5, bisect_steps=8, n_images=256,
                         texts_per_image=5, batch=32, k_test=256, iters=5):
    """BLIP retrieval eval at p=0.5, bf16: the temperature bisected toward
    half the dense ``retrieval_gflops`` in mask mode, the ``--fast_eval``
    capacities, then the gather-mode ``evaluate`` on a synthetic corpus (8
    batches of 32 images, 5 texts each) at ``k_test`` 256, so that every
    rerank row in both directions scores 256 candidates, and the dense eval
    (temperature 0); K4 against its plain version on the inputs each eval
    gave it; then one ITM forward at ``k_test`` 256, timed and profiled.
    Returns the K1, K4 and K5 launch counts of the gather eval and the K4
    record of its ITM shape."""
    from madtp_tpu_torch.kernels.attention_scores import attention_scores_cuda
    from madtp_tpu_torch.kernels.cross_attention import cross_attention_cuda
    from madtp_tpu_torch.kernels.ffn import ffn_cuda
    from madtp_tpu_torch.models.blip import init_retrieval_model
    from madtp_tpu_torch.prune.dtp import TokenState
    from madtp_tpu_torch.prune.flops import retrieval_gflops
    from madtp_tpu_torch.tasks.retrieval import evaluate, probe_capacities

    log(f"[retrieval] {card_line()}")
    model = init_retrieval_model(cfg, seed=0, device=device, dtype=torch.bfloat16)
    images, ids, mask, txt2img, img2txt = retrieval_corpus(cfg, n_images, texts_per_image,
                                                           seed=7)
    batches = [images[i:i + batch] for i in range(0, n_images, batch)]
    text_len = ids.shape[1]
    L = cfg.med.num_hidden_layers
    ori = retrieval_gflops(cfg.vit, cfg.med, [cfg.vit.num_patches] * cfg.vit.depth,
                           [text_len - 1] * L, text_len)
    target = ori * (1.0 - p_target)
    im0 = torch.from_numpy(batches[0]).to(device)
    ids_d, mask_d = torch.from_numpy(ids).to(device), torch.from_numpy(mask).to(device)

    lo, hi = 0.05, 60.0
    with torch.inference_mode():
        for _ in range(bisect_steps):
            t = math.sqrt(lo * hi)
            _, iout = model.image_features(im0, temperature=t, prune_active=True)
            _, tout = model.text_features(ids_d[:batch], mask_d[:batch], temperature=t,
                                          prune_active=True)
            g = retrieval_gflops(cfg.vit, cfg.med, iout.kept_counts.cpu().numpy(),
                                 tout.kept_counts.cpu().numpy(), text_len)
            log(f"[retrieval] bisect T={t:.4f}: {g:.2f} GFLOPs (target {target:.2f})")
            if g > target:
                lo = t
            else:
                hi = t
    t_star, g_star = t, g
    caps_v, caps_t = probe_capacities(model, batches, ids, mask, t_star, "ceil")
    log(f"[retrieval] T*={t_star:.4f}: {g_star:.2f} GFLOPs pruned / {ori:.2f} dense; "
        f"capacities vision {list(caps_v)} text {list(caps_t)}")

    def run_eval(temperature, cv, ct):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with K4Capture() as capture, K5Capture() as k5_capture:  # the eval's own inputs
            stats = evaluate(model, iter(batches), ids, mask, txt2img, img2txt, temperature,
                             enc_token_id=ENC_ID, k_test=k_test, capacities_v=cv,
                             capacities_t=ct)
        return stats, time.perf_counter() - t0, capture, k5_capture

    attention_scores_cuda.launches = cross_attention_cuda.launches = ffn_cuda.launches = 0
    stats, eval_s, gather_capture, gather_k5 = run_eval(t_star, caps_v, caps_t)
    k1, k4, k5 = attention_scores_cuda.launches, cross_attention_cuda.launches, ffn_cuda.launches
    n_texts = len(ids)
    n_itm = n_images + n_texts  # one ITM forward per rerank row, both directions
    if k4 != L * n_itm:
        raise AssertionError(f"retrieval eval launched K4 {k4} times in {n_itm} ITM forwards, "
                             f"want {L} per forward")
    want_k1 = cfg.vit.depth * len(batches) + L * (-(-n_texts // 256) + n_itm)
    if k1 != want_k1:
        raise AssertionError(f"retrieval eval launched K1 {k1} times, want {want_k1} (every "
                             "self-attention of the towers and the ITM forwards)")
    if k5 != k1:
        raise AssertionError(f"retrieval eval launched K5 {k5} times, want {k1}: one FFN "
                             "beside every scoring attention")
    if not all(math.isfinite(v) and 0.0 <= v <= 100.0 for v in stats.values()):
        raise AssertionError(f"retrieval stats out of range: {stats}")
    log(f"[retrieval] gather eval: {n_images} images, {n_texts} texts, k_test {k_test}: "
        f"{eval_s:.2f} s wall; r_mean {stats['r_mean']:.3f} (random weights); launches "
        f"K1 {k1}, K4 {k4} ({k4 // n_itm} per ITM forward), K5 {k5}")
    dense_stats, dense_s, dense_capture, dense_k5 = run_eval(0.0, None, None)
    log(f"[retrieval] dense eval: {dense_s:.2f} s wall; r_mean {dense_stats['r_mean']:.3f}")
    record = check_k4_cases("retrieval gather eval", gather_capture)
    check_k4_cases("retrieval dense eval", dense_capture)
    check_k5_cases("retrieval gather eval", gather_k5)
    check_k5_cases("retrieval dense eval", dense_k5)

    def encode_rates(temperature, cv, ct):
        """images/s of the image tower over the corpus, texts/s of the text
        tower in batches of 256 (the rates of encode_corpus's two loops)."""
        prune = temperature > 0
        with torch.inference_mode():
            def img():
                for b in batches:
                    model.image_features(torch.from_numpy(b).to(device), temperature=temperature,
                                         prune_active=prune, capacities=cv)

            def txt():
                for i in range(0, n_texts, 256):
                    model.text_features(ids_d[i:i + 256], mask_d[i:i + 256],
                                        temperature=temperature, prune_active=prune,
                                        capacities=ct)
            return (n_images / time_ms(img, 3) * 1e3, n_texts / time_ms(txt, 3) * 1e3)

    # one ITM forward at k_test 256: text 0 against 256 image states (t2i's shape)
    k = k_test

    def itm_inputs(temperature, cv):
        with torch.inference_mode():
            _, out = model.image_features(im0, temperature=temperature,
                                          prune_active=temperature > 0, capacities=cv)
        idx = torch.arange(k, device=device) % out.state.x.shape[0]
        sx, sa = out.state.x[idx], out.state.alive[idx]
        eids = ids_d[:1].clone()
        eids[:, 0] = ENC_ID
        return eids.expand(k, -1), mask_d[:1].expand(k, -1), TokenState(sx, sa, None)

    rates = {}
    for name, temperature, cv, ct in (("gather", t_star, caps_v, caps_t),
                                      ("dense", 0.0, None, None)):
        e_ids, e_mask, st = itm_inputs(temperature, cv)
        kw = dict(temperature=temperature, prune_active=temperature > 0, capacities=ct)

        @torch.inference_mode()
        def itm(e_ids=e_ids, e_mask=e_mask, st=st, kw=kw):
            return model.itm_score(e_ids, e_mask, st, **kw)

        if name == "gather":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")  # the ITM forward must not wait on the card
            try:
                score = itm()
            finally:
                torch.cuda.set_sync_debug_mode("default")
            if score.shape != (k,) or not torch.isfinite(score.float()).all():
                raise AssertionError("ITM scores at k_test 256 are not finite [256]")
        itm_ms = time_ms(itm, iters)
        img_rate, txt_rate = encode_rates(temperature, cv, ct)
        rates[name] = (img_rate, txt_rate, k / itm_ms * 1e3, itm_ms)
        log(f"[retrieval] {name}: image encode {img_rate:.1f} images/s, text encode "
            f"{txt_rate:.1f} texts/s, ITM forward at k={k} over {st.x.shape[1]} image slots "
            f"{itm_ms:.2f} ms = {k / itm_ms * 1e3:.1f} candidates/s, host dispatch "
            f"{host_ms(itm, iters):.2f} ms")
        if name == "gather":
            ffn_ab(f"retrieval gather ITM forward, k={k}", itm, iters)
        profile_step(f"{name} ITM forward, k={k}", itm, itm_ms)
    g, d = rates["gather"], rates["dense"]
    log(f"[retrieval] pruned/dense: eval wall {dense_s / eval_s:.3f}x, images/s "
        f"{g[0] / d[0]:.3f}x, texts/s {g[1] / d[1]:.3f}x, ITM candidates/s {g[2] / d[2]:.3f}x")
    return k1, k4, k5, record


def clip_config():
    """CLIP ViT-L/14@336, the model of ``configs/retrieval_*_clip.yaml``, as
    ``tools/bench_clip.py:38-41`` configures it: vision 24 x 1024 (16 heads,
    patch 14, 577 tokens), text 12 x 768 (12 heads, context 77), embed 768,
    codebook 100 x 768."""
    from madtp_tpu_torch.core.config import CLIPConfig

    return CLIPConfig(embed_dim=768, image_resolution=336, vision_layers=24, vision_width=1024,
                      vision_patch_size=14, transformer_width=768, transformer_heads=12,
                      transformer_layers=12, sd_dim=768)


CLIP_EOT = 49407  # the CLIP BPE vocabulary's end-of-text id, its highest


def clip_corpus(cfg, n_images, texts_per_image, seed):
    """A synthetic CLIP corpus: uint8 [H, W, 3] images (the ``--uint8_feed``
    layout) and ``texts_per_image`` texts each, token ids as
    ``tools/bench_clip.py:45-49`` makes them (random ids, EOT ending a length
    in [8, 20), zeros after).  Returns ``(images, text, txt2img, img2txt)``."""
    rng = np.random.default_rng(seed)
    s = cfg.image_resolution
    images = rng.integers(0, 256, size=(n_images, s, s, 3), dtype=np.uint8)
    n_texts = n_images * texts_per_image
    lengths = rng.integers(8, 20, size=n_texts)
    ids = rng.integers(1, 40000, size=(n_texts, cfg.context_length))
    text = np.where(np.arange(cfg.context_length)[None, :] < lengths[:, None], ids, 0)
    text[np.arange(n_texts), lengths - 1] = CLIP_EOT
    txt2img = [t // texts_per_image for t in range(n_texts)]
    img2txt = [list(range(i * texts_per_image, (i + 1) * texts_per_image))
               for i in range(n_images)]
    return images, text, txt2img, img2txt


def phase_clip_main(device, cfg, p_target=0.5, bisect_steps=10, n_images=1024,
                    texts_per_image=5, batch=32, rate_batches=8, iters=5):
    """CLIP retrieval eval at p=0.5, bf16: the temperature bisected toward
    half the dense ``clip_gflops`` in mask mode (``tools/bench_clip.py:
    80-91``; first image batch and first 32 texts), the ``--fast_eval``
    capacities, ``evaluate`` in gather mode on a synthetic corpus cut from
    COCO's 5,000 images and 25,000 texts to 1,024 and 5,120 (1:5), and the
    dense eval.  K5 and K1 (at H=16) held against their plain versions on
    the inputs the evals gave them.  Returns the temperature, the K1 and K5
    launch counts of the gather eval and the K5 and K1 records."""
    from madtp_tpu_torch.kernels.attention_scores import attention_scores_cuda
    from madtp_tpu_torch.kernels.ffn import ffn_cuda
    from madtp_tpu_torch.models.clip import init_clip_model
    from madtp_tpu_torch.prune.flops import clip_gflops
    from madtp_tpu_torch.tasks.clip_retrieval import evaluate, probe_capacities

    log(f"[clip] {card_line()}")
    model = init_clip_model(cfg, seed=0, device=device, dtype=torch.bfloat16)
    images, text, txt2img, img2txt = clip_corpus(cfg, n_images, texts_per_image, seed=9)
    batches = [images[i:i + batch] for i in range(0, n_images, batch)]
    Lv, Lt = cfg.vision_layers, cfg.transformer_layers
    ori = clip_gflops(cfg, [cfg.vision_num_patches] * Lv, [cfg.context_length - 1] * Lt)
    target = ori * (1.0 - p_target)
    im0 = torch.from_numpy(batches[0]).to(device)
    tx = torch.from_numpy(text).to(device)

    lo, hi = 0.05, 60.0
    with torch.inference_mode():
        for _ in range(bisect_steps):
            t = math.sqrt(lo * hi)
            vk = model.encode_image(im0, temperature=t, prune_active=True).kept_counts
            tk = model.encode_text(tx[:batch], temperature=t, prune_active=True).kept_counts
            g = clip_gflops(cfg, vk.cpu().numpy(), tk.cpu().numpy())
            log(f"[clip] bisect T={t:.4f}: {g:.2f} GFLOPs (target {target:.2f}); kept vision "
                f"{vk.tolist()[::4]}... text {tk.tolist()[::3]}...")
            if g > target:
                lo = t
            else:
                hi = t
    t_star, g_star = t, g
    caps_v = probe_capacities(model, batches, t_star, "ceil")
    log(f"[clip] T*={t_star:.4f}: {g_star:.2f} GFLOPs pruned / {ori:.2f} dense; "
        f"capacities vision {list(caps_v)}")

    def run_eval(temperature, cv):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with K5Capture() as k5_capture, K1Capture() as k1_capture:  # the eval's own inputs
            stats, gflops = evaluate(model, iter(batches), text, txt2img, img2txt, temperature,
                                     capacities_v=cv, batch_size=batch)
        return stats, gflops, time.perf_counter() - t0, k5_capture, k1_capture

    attention_scores_cuda.launches = ffn_cuda.launches = 0
    stats, cur_g, eval_s, k5_capture, k1_capture = run_eval(t_star, caps_v)
    k1, k5 = attention_scores_cuda.launches, ffn_cuda.launches
    n_texts = len(text)
    n_tb = -(-n_texts // batch)
    if k1 != Lv * len(batches):
        raise AssertionError(f"clip eval launched K1 {k1} times, want {Lv * len(batches)}: "
                             "every vision layer (the causal text attention stays plain)")
    if k5 != Lv * len(batches) + Lt * n_tb:
        raise AssertionError(f"clip eval launched K5 {k5} times, want every FFN of both towers "
                             f"({Lv * len(batches) + Lt * n_tb})")
    if not all(math.isfinite(v) and 0.0 <= v <= 100.0 for v in stats.values()):
        raise AssertionError(f"clip stats out of range: {stats}")
    if not (math.isfinite(cur_g) and 0 < cur_g < ori):
        raise AssertionError(f"clip eval GFLOPs {cur_g} not in (0, {ori})")
    log(f"[clip] gather eval: {n_images} images, {n_texts} texts: {eval_s:.2f} s wall = "
        f"{n_images / eval_s:.1f} images/s with their texts; r_mean {stats['r_mean']:.3f} "
        f"(random weights); Cur_Gflops {cur_g:.2f}; launches K1 {k1}, K5 {k5}")
    dense_stats, dense_g, dense_s, dense_k5, dense_k1 = run_eval(0.0, None)
    if dense_k1.calls or abs(dense_g - ori) > 1e-6 * ori:
        raise AssertionError(f"dense eval: {sum(dense_k1.calls.values())} scoring attentions, "
                             f"GFLOPs {dense_g} (want none, {ori})")
    log(f"[clip] dense eval: {dense_s:.2f} s wall; r_mean {dense_stats['r_mean']:.3f}; "
        f"pruned/dense eval wall {dense_s / eval_s:.3f}x")
    record5 = check_k5_cases("clip gather eval", k5_capture)
    check_k5_cases("clip dense eval", dense_k5)
    record1 = check_k1_cases("clip vision gather eval", k1_capture)

    def tower_rates(temperature, cv):
        """images/s of the vision tower over ``rate_batches`` batches and
        texts/s of the text tower over 4x as many, batches of ``batch``."""
        kw = dict(temperature=temperature, prune_active=temperature > 0)
        ims = [torch.from_numpy(b).to(device) for b in batches[:rate_batches]]

        @torch.inference_mode()
        def img():
            for im in ims:
                model.encode_image(im, capacities=cv, **kw)

        @torch.inference_mode()
        def txt():
            for i in range(0, 4 * rate_batches * batch, batch):
                model.encode_text(tx[i:i + batch], **kw)

        return (rate_batches * batch / time_ms(img, 2) * 1e3,
                4 * rate_batches * batch / time_ms(txt, 2) * 1e3)

    rates = {}
    for name, temperature, cv in (("gather", t_star, caps_v), ("dense", 0.0, None)):
        kw = dict(temperature=temperature, prune_active=temperature > 0, capacities=cv)

        @torch.inference_mode()
        def one_batch(kw=kw):
            return model.encode_image(im0, **kw)

        rates[name] = tower_rates(temperature, cv)
        batch_ms = time_ms(one_batch, iters)
        log(f"[clip] {name}: vision {rates[name][0]:.1f} images/s, text {rates[name][1]:.1f} "
            f"texts/s; one image batch of {batch} {batch_ms:.2f} ms, host dispatch "
            f"{host_ms(one_batch, iters):.2f} ms")
        if name == "gather":
            ffn_ab(f"clip gather image batch of {batch}", one_batch, iters)
        profile_step(f"clip {name} image batch of {batch}", one_batch, batch_ms, top=8)
    g, d = rates["gather"], rates["dense"]
    log(f"[clip] pruned/dense: images/s {g[0] / d[0]:.3f}x, texts/s {g[1] / d[1]:.3f}x")
    return t_star, k1, k5, record5, record1


def phase_clip_parity(device, cfg, t_main, n_images=2, texts_per_image=2):
    """The full-width CLIP model on the card (K1 in the vision tower) and
    the CPU (plain), fp32, seeded weights: 2 images and 4 texts, mask and
    gather mode.  Equal kept counts in both towers, unit features within
    1e-5, equal rankings of ``sims`` in both directions, one K1 launch per
    vision layer.  The temperature is the first of a few around the main
    path's ``t_main`` at which the vision tower prunes on the CPU and every
    DTP decision stands ``GAP_MIN`` from its edge, with the card's drift
    ``DRIFT_FACTOR`` times below that margin (as phase 8)."""
    from madtp_tpu_torch.kernels.attention_scores import attention_scores_cuda
    from madtp_tpu_torch.models.clip import init_clip_model
    from madtp_tpu_torch.tasks.clip_retrieval import encode_towers, probe_capacities

    cpu_model = init_clip_model(cfg, seed=0, device="cpu")
    gpu_model = copy.deepcopy(cpu_model).to(device)
    images, text, _, _ = clip_corpus(cfg, n_images, texts_per_image, seed=8)

    def run(model, temperature, cv):
        t0 = time.perf_counter()
        before = attention_scores_cuda.launches
        with DTPRecorder() as rec:
            img, txt, vk, tk = encode_towers(model, [images], text, temperature=temperature,
                                             prune_active=True, capacities_v=cv,
                                             batch_size=len(text))
        return dict(kept=(vk, tk), feats=(img, txt), sims=img @ txt.T, dtp=rec.records,
                    k1=attention_scores_cuda.launches - before,
                    seconds=time.perf_counter() - t0)

    for temperature in (t_main * f for f in (1.0, 1.25, 0.8, 1.6, 0.6, 2.0)):
        caps = probe_capacities(cpu_model, [images], temperature)
        modes = {"mask": None, "gather": caps}
        cpu_runs = {mode: run(cpu_model, temperature, cv) for mode, cv in modes.items()}
        thr_gap, rank_gap = (min(g) for g in zip(*(dtp_margins(r["dtp"])
                                                   for r in cpu_runs.values())))
        margin = min(thr_gap, rank_gap)
        vk = cpu_runs["mask"]["kept"][0]
        log(f"[clip-parity] T={temperature:.4f}: smallest DTP margins on the CPU: threshold "
            f"{thr_gap:.3e}, rank {rank_gap:.3e} ({margin / FP32_ULP:.0f} fp32 steps, want "
            f">= {GAP_MIN / FP32_ULP:.0f}); vision keeps {int(vk[-1])} of "
            f"{cfg.vision_num_patches}; cpu {sum(r['seconds'] for r in cpu_runs.values()):.1f} s")
        if margin >= GAP_MIN and vk[-1] < cfg.vision_num_patches:
            break
    else:
        raise AssertionError("no temperature near the main path's prunes with every DTP "
                             f"decision {GAP_MIN / FP32_ULP:.0f} fp32 steps from its edge")
    log(f"[clip-parity] T={temperature:.4f}: gather capacities vision {list(caps)}")
    for mode, cv in modes.items():
        cpu, card = cpu_runs[mode], run(gpu_model, temperature, cv)
        if not all(np.array_equal(a, b) for a, b in zip(cpu["kept"], card["kept"])):
            raise AssertionError(f"clip {mode}: kept counts differ: card {card['kept']} "
                                 f"cpu {cpu['kept']}")
        drift = dtp_drift(cpu["dtp"], card["dtp"])
        if not drift * DRIFT_FACTOR <= margin:
            raise AssertionError(f"clip {mode}: the card's DTP scores drift {drift:.3e} from "
                                 f"the CPU's, more than 1/{DRIFT_FACTOR} of the margin {margin:.3e}")
        feat_err = max(float(np.abs(a - b).max()) for a, b in zip(card["feats"], cpu["feats"]))
        if not feat_err <= 1e-5:
            raise AssertionError(f"clip {mode}: features differ by {feat_err:.3e} (limit 1e-5)")
        for s_card, s_cpu in ((card["sims"], cpu["sims"]), (card["sims"].T, cpu["sims"].T)):
            if not np.array_equal(np.argsort(-s_card, axis=1, kind="stable"),
                                  np.argsort(-s_cpu, axis=1, kind="stable")):
                raise AssertionError(f"clip {mode}: the rankings of sims differ")
        if card["k1"] != cfg.vision_layers:
            raise AssertionError(f"clip {mode}: K1 launched {card['k1']} times, want "
                                 f"{cfg.vision_layers} (one image batch)")
        log(f"[clip-parity] {mode}: kept vision {card['kept'][0].tolist()} text "
            f"{card['kept'][1].tolist()} equal on card and cpu; rankings equal; max|diff| "
            f"features {feat_err:.2e}; DTP drift {drift:.2e} "
            f"({margin / drift if drift else math.inf:.0f}x below the margin); K1 {card['k1']}; "
            f"cpu {cpu['seconds']:.1f} s")


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    import madtp_tpu_torch  # noqa: F401  fails here when run outside the repo

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    log(card_line())

    phase_build()
    record = phase_k1(device)
    record2 = phase_k2(device)
    phase_k4(device)
    record5 = phase_k5(device)
    cfg = full_config()
    phase_model_parity(device, cfg)
    k1_eval, k4_eval, k5_eval = phase_main_path(device, cfg)
    phase_train_parity(device, cfg)
    k1_train, k2_train, k4_train, k5_train = phase_train_main(device, cfg)
    rcfg = retrieval_config()
    phase_retrieval_parity(device, rcfg)
    k1_ret, k4_ret, k5_ret, record4 = phase_retrieval_main(device, rcfg)
    ccfg = clip_config()
    t_clip, k1_clip, k5_clip, record5_clip, record1_clip = phase_clip_main(device, ccfg)
    phase_clip_parity(device, ccfg, t_clip)

    kernels = [
        dict(name="attention_scores", route="cuda",
             source="madtp_tpu_torch/csrc/attention_scores.cu",
             replaces="madtp_tpu/ops/pallas/fused_attention.py:595",
             launches=k1_eval + k1_train + k1_ret + k1_clip,
             launches_by_path={"eval": k1_eval, "train": k1_train, "retrieval": k1_ret,
                               "clip": k1_clip},
             **record, at_clip_vision_h16=record1_clip,
             library_note="library_ms is scaled_dot_product_attention, out only"),
        dict(name="attention_scores_bwd", route="cuda",
             source="madtp_tpu_torch/csrc/attention_scores_bwd.cu",
             replaces="madtp_tpu/ops/pallas/fused_attention.py:306",
             launches=k2_train, launches_by_path={"train": k2_train}, **record2,
             library_note="library_ms is scaled_dot_product_attention forward + backward, "
                          "out only"),
        dict(name="cross_attention", route="cuda",
             source="madtp_tpu_torch/csrc/cross_attention.cu",
             replaces="madtp_tpu/ops/pallas/cross_attention.py:56",
             launches=k4_eval + k4_train + k4_ret,
             launches_by_path={"eval": k4_eval, "train": k4_train, "retrieval": k4_ret},
             **record4, library_note="library_ms is scaled_dot_product_attention with the "
                                     "same additive mask: the same function"),
        dict(name="ffn", route="cuda", source="madtp_tpu_torch/csrc/ffn.cu",
             replaces="madtp_tpu/ops/pallas/fused_ffn.py:79",
             launches=k5_eval + k5_train + k5_ret + k5_clip,
             launches_by_path={"eval": k5_eval, "train": k5_train, "retrieval": k5_ret,
                               "clip": k5_clip},
             **record5, at_clip_gather_eval=record5_clip,
             library_note="library_ms is two F.linear and the activation: the same function"),
    ]
    log(card_line())
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
