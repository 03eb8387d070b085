"""Smoke run of the PyTorch/CUDA port (``madtp_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. build kernel K1 (``madtp_tpu_torch/csrc/attention_scores.cu``) with nvcc;
2. K1 against its plain PyTorch version on the card at the NLVR shapes, fp32
   and bf16, with times, the card's bound, and the time of
   ``F.scaled_dot_product_attention`` for the ``out`` part alone (a yardstick
   that computes less than K1; the port never calls it);
3. the full-width NLVR model (ViT-B/16@384 + 12-layer twin MED, seeded random
   weights, 2 pairs, fp32) on the card against the same model on the CPU, in
   mask and gather mode: equal kept counts, logits within 1e-4, K1 launched in
   every layer;
4. the main path in bf16 at 32 pairs: temperature bisection toward half the
   dense GFLOPs in mask mode, the capacity schedule, and the gather-mode eval
   through ``tasks.nlvr.evaluate``; samples/s of the gather step and of the
   dense forward.

Prints the card's name and power limit, a JSON line of kernel measurements,
and as its last line ``{"ok": true, "device": {...}}``.  Without a CUDA
device it exits non-zero before printing any result.
"""

from __future__ import annotations

import copy
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

PAD_BIAS = -10000.0
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
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"[profile] {label}: device busy {busy_ms:.2f} ms of the {step_ms:.2f} ms step "
        f"({busy_ms / step_ms:.1%}); {len(kernels)} kernel names")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        ms = e.self_device_time_total / 1e3
        log(f"[profile]   {ms:8.3f} ms {ms / max(busy_ms, 1e-9):6.1%} x{e.count:<5d} {e.key[:90]}")


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
    from madtp_tpu_torch.kernels.build import build_all

    t0 = time.perf_counter()
    built = build_all([k1.SOURCE])
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
            mask = torch.zeros(alive.shape, device=device).masked_fill(~alive, float("-inf"))
            mask = (mask + bias_in)[:, None, None, :].to(dtype)
            qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
            sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask, scale=scale), 10)
            flops, nbytes = k1_work(q, alive)
            t_ops, t_bytes = flops / PEAK[dtype] * 1e3, nbytes / MEM_RATE * 1e3
            bound_ms = max(t_ops, t_bytes)
            bound_by = "operations" if t_ops >= t_bytes else "bytes"
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
    """The full-width model on the card (K1) and the CPU (plain), fp32."""
    from madtp_tpu_torch.kernels.attention_scores import attention_scores_cuda
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
            before = attention_scores_cuda.launches
            out = gpu_model(images.to(device), ids.to(device), mask.to(device), **kw)
            torch.cuda.synchronize()
            launches = attention_scores_cuda.launches - before
        vk, tk = out.v_kept.cpu(), out.t_kept.cpu()
        if not (torch.equal(vk, ref.v_kept) and torch.equal(tk, ref.t_kept)):
            raise AssertionError(f"{mode}: kept counts differ: card {vk.tolist()} "
                                 f"{tk.tolist()} vs cpu {ref.v_kept.tolist()} {ref.t_kept.tolist()}")
        err = float((out.logits.cpu() - ref.logits).abs().max())
        if not err <= 1e-4:
            raise AssertionError(f"{mode}: logits differ by {err:.3e} (limit 1e-4)")
        if launches < per_forward:
            raise AssertionError(f"{mode}: K1 launched {launches} times, want >= {per_forward}")
        log(f"[parity] {mode}: kept vision {vk.tolist()} text {tk.tolist()} equal on card "
            f"and cpu; max|logit diff| {err:.3e}; K1 launches {launches}; cpu {cpu_s:.1f} s")
        if mode == "mask":
            caps = fast_capacity_schedule(ref.v_kept.numpy(), ref.t_kept.numpy(), "ceil")
            log(f"[parity] gather capacities vision {list(caps[0])} text {list(caps[1])}")


def phase_main_path(device, cfg, pairs=32, text_len=26, p_target=0.5, bisect_steps=8,
                    eval_batches=3, iters=10):
    """NLVR2 eval at p=0.5, bf16: bisection, capacities, gather eval."""
    from madtp_tpu_torch.kernels.attention_scores import attention_scores_cuda
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

    attention_scores_cuda.launches = 0
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

    stats, cur_gflops = evaluate(model, loader, tokenize, t_star, prune_active=True,
                                 enc_token_id=2, capacities_v=caps_v, capacities_t=caps_t,
                                 print_fn=lambda m: log(f"[main] {m}"), print_freq=1)
    torch.cuda.synchronize()
    launches = attention_scores_cuda.launches
    per_forward = cfg.vit.depth + cfg.med.num_hidden_layers
    want = per_forward * (bisect_steps + eval_batches)
    if launches < want:
        raise AssertionError(f"main path launched K1 {launches} times, want >= {want}")
    if not (math.isfinite(cur_gflops) and 0 < cur_gflops < ori):
        raise AssertionError(f"gather eval GFLOPs {cur_gflops} not in (0, {ori})")

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
    log(f"[main] K1 launches on the main path: {launches}")
    profile_step("gather step", lambda: step_gather(images, ids, mask, t_star), gather_ms)
    profile_step("dense step", lambda: step_dense(images, ids, mask, 0.0), dense_ms)
    return launches


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
    cfg = full_config()
    phase_model_parity(device, cfg)
    launches = phase_main_path(device, cfg)

    kernel = dict(name="attention_scores", route="cuda",
                  source="madtp_tpu_torch/csrc/attention_scores.cu",
                  replaces="madtp_tpu/ops/pallas/fused_attention.py:595",
                  launches=launches, **record,
                  library_note="library_ms is scaled_dot_product_attention, out only")
    log(card_line())
    log(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
