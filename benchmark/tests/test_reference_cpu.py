"""The plain reference against the port's plain (CPU) path at a tiny size:
the same kept counts and the same outputs to fp32 rounding, in mask and
gather mode with tokens overflowing the capacities, and the same train
steps.  The reference itself imports nothing of the port; these tests hold
the two side by side."""

from __future__ import annotations

import statistics

import pytest
import torch

from benchmark import programs
from benchmark.reference import blip_nlvr, clip
from benchmark.reference.adamw import adamw_step
from benchmark.tests import tiny
from benchmark.weights import make_weights

CPU = torch.device("cpu")


def _nlvr_inputs(cfg, B=4, N=12, seed=1):
    g = torch.Generator().manual_seed(seed)
    s = cfg["vit"]["image_size"]
    images = torch.randn(2 * B, 3, s, s, generator=g)
    ids = torch.randint(103, cfg["med"]["vocab_size"], (B, N), generator=g)
    ids[:, 0] = cfg["enc_token_id"]
    mask = torch.ones(B, N, dtype=torch.long)
    mask[1, 8:] = 0
    mask[2, 5:] = 0
    return images, ids, mask, torch.randint(0, 2, (B,), generator=g)


@pytest.mark.parametrize("temperature", [5.0, 50.0])
@pytest.mark.parametrize("gather", [False, True])
def test_nlvr_reference_matches_the_port(temperature, gather):
    cfg = tiny.NLVR
    model, spec = programs.nlvr_model(cfg, 5, CPU)
    W = make_weights(spec, 5, CPU)
    images, ids, mask, _ = _nlvr_inputs(cfg)
    caps_v = caps_t = None
    if gather:  # capacities that make tokens overflow in the second layer
        caps_v, caps_t = [64, 12, 64], [12, 6, 12]
    with torch.no_grad():
        out = model(images, ids, mask, temperature=temperature, prune_active=True,
                    capacities_v=caps_v, capacities_t=caps_t)
        ref = blip_nlvr.forward(W, images, ids, mask, cfg, temperature, caps_v, caps_t)
    assert out.v_kept.tolist() == ref.v_kept and out.t_kept.tolist() == ref.t_kept
    if gather:
        assert int(out.overflow) == ref.overflow > 0
    torch.testing.assert_close(out.logits, ref.logits, rtol=0, atol=1e-6)


@pytest.mark.parametrize("temperature", [5.0, 50.0])
def test_clip_reference_matches_the_port(temperature):
    cfg = tiny.CLIP
    model, spec = programs.clip_model(cfg, 7, CPU)
    W = make_weights(spec, 7, CPU)
    g = torch.Generator().manual_seed(1)
    images = torch.randn(5, 3, 56, 56, generator=g)
    L = torch.randint(5, 12, (5,), generator=g)
    text = torch.where(torch.arange(20)[None] < L[:, None],
                       torch.randint(1, 400, (5, 20), generator=g), 0)
    text[torch.arange(5), L - 1] = cfg["vocab_size"] - 1
    caps = [64, 8, 64]
    with torch.no_grad():
        for c in (None, caps):
            o = model.encode_image(images, temperature=temperature, prune_active=True,
                                   capacities=c)
            f, k = clip.encode_image(W, images, cfg, temperature, c)
            assert o.kept_counts.tolist() == k
            torch.testing.assert_close(o.features / o.features.norm(dim=-1, keepdim=True), f,
                                       rtol=0, atol=1e-6)
        o = model.encode_text(text, temperature=temperature, prune_active=True)
        f, k = clip.encode_text(W, text, cfg, temperature)
    assert o.kept_counts.tolist() == k
    torch.testing.assert_close(o.features / o.features.norm(dim=-1, keepdim=True), f,
                               rtol=0, atol=1e-6)


def test_nlvr_train_steps_match_the_port():
    from madtp_tpu_torch.train.loops import make_nlvr_train_step
    from madtp_tpu_torch.train.optim import make_adamw

    cfg = tiny.NLVR
    model, spec = programs.nlvr_model(cfg, 5, CPU)
    batches = [_nlvr_inputs(cfg, seed=s) for s in range(3)]
    caps_v, caps_t, T = [32, 16, 16], [12, 10, 8], 5.0
    opt = make_adamw(model.parameters(), lr=1e-3, weight_decay=0.05)
    step = make_nlvr_train_step(model, opt, capacities_v=caps_v, capacities_t=caps_t,
                                device="cpu")
    losses = [step(*b, T) for b in batches]
    P = {n: t.clone() for n, t in make_weights(spec, 5, CPU).items()}
    state, first = {}, None
    for i, (images, ids, mask, targets) in enumerate(batches):
        leaves = {n: t.requires_grad_() for n, t in P.items()}
        loss, lo, lf = blip_nlvr.losses(leaves, images, ids, mask, targets, cfg, T,
                                        caps_v, caps_t)
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        first = first or {n: float(g.norm()) for n, g in grads.items()}
        assert abs(float(losses[i]["loss_ori"]) - lo.item()) < 1e-6
        assert abs(float(losses[i]["loss_fdt"]) - lf.item()) < 1e-6
        P = adamw_step({n: t.detach() for n, t in P.items()}, grads, state, i + 1, lr=1e-3,
                       weight_decay=0.05)
    start = make_weights(spec, 5, CPU)
    change = {n: float((P[n] - start[n]).norm()) for n in P}
    med = statistics.median(change.values())
    g_med = statistics.median(first.values())
    for n, p in model.named_parameters():
        if first[n] < 1e-3 * g_med:  # moved by round-off alone (a key's bias)
            continue
        got = float((p.detach() - start[n]).norm())
        assert abs(got - change[n]) <= 1e-3 * max(change[n], med), n
