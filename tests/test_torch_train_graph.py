"""The captured NLVR train step (``make_nlvr_train_step``'s graph through
``utils/graph.py`` ``CapturedStep``, ``train=True``).

On the CPU there is no graph: the step's static buffers go through the same
update eagerly, and it is held bit for bit against ``graph=False`` over
steps of two text widths (losses, parameters, AdamW's state), with a new
learning rate between calls.  Also on the CPU: ``make_adamw`` keeps its
step count and rate on the host, a dropout generator or a step spanning the
ranks runs eagerly, and each call records the towers' kept counts once.

On the card (marked ``cuda``, skipped elsewhere; run with
``python -m pytest --noconftest tests/test_torch_train_graph.py -q``): each
replay against the eager step with the same capturable AdamW, bit for bit,
over steps that repeat a width and change the rate, the captures under
``set_sync_debug_mode("error")``, K2's and K5's launches per replay those of
an eager step; the capture and replay counters under a profiler that
traces the card; no ``.grad`` after a graphed call, and one pool for the
capacity schedules of one optimizer; an optimizer with a host learning rate
runs eagerly."""

import copy

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from madtp_tpu_torch.core.config import BlipConfig, MedConfig, ViTConfig
from madtp_tpu_torch.models.blip import init_nlvr_model
from madtp_tpu_torch.parallel import data
from madtp_tpu_torch.train.loops import make_nlvr_train_step
from madtp_tpu_torch.train.optim import make_adamw, set_lr
from madtp_tpu_torch.utils import profiling
from madtp_tpu_torch.utils.cache import BoundedCache
from madtp_tpu_torch.utils.graph import CapturedStep, _Step, graph_count

CFG = BlipConfig(ViTConfig(image_size=64, embed_dim=32, depth=2, num_heads=2, sd_dim=32),
                 MedConfig(vocab_size=50, hidden_size=32, num_hidden_layers=2,
                           num_attention_heads=2, intermediate_size=64,
                           max_position_embeddings=16, encoder_width=32, sd_dim=32,
                           twin_cross=True, merge_start_layer=1),
                 sd_num=10, sd_dim=32)
B = 2
TEMPERATURE = 30.0
CAPS = {"mask": (None, None), "gather": ((14, 12), (8, 8))}


@pytest.fixture(autouse=True)
def empty():
    profiling.clear()
    yield
    profiling.clear()


def _batches(widths, device, vocab=50, image_size=64, seed=0):
    """One batch of ``B`` pairs per text width: images, ids, mask, targets."""
    g = torch.Generator().manual_seed(seed)
    out = []
    for w in widths:
        ids = torch.randint(3, vocab, (B, w), generator=g)
        ids[:, 0] = 2
        mask = torch.ones(B, w, dtype=torch.long)
        mask[1, w - 2:] = 0
        out.append(tuple(t.to(device) for t in (
            torch.randn(2 * B, 3, image_size, image_size, generator=g), ids, mask,
            torch.randint(0, 2, (B,), generator=g))))
    return out


def _pair(model, caps, **kw):
    """Two copies of ``model`` with an optimizer and a step each: graphed and
    ``graph=False``."""
    steps = []
    for graph in (True, False):
        m = copy.deepcopy(model)
        opt = make_adamw(m.parameters(), lr=1e-3, weight_decay=0.05)
        steps.append((m, opt, make_nlvr_train_step(
            m, opt, capacities_v=caps[0], capacities_t=caps[1],
            device=m.space_dict.device.type, graph=graph, **kw)))
    return steps


def _assert_same_state(a, b):
    (ma, oa, _), (mb, ob, _) = a, b
    for (n, p), q in zip(ma.named_parameters(), mb.parameters()):
        assert torch.equal(p, q), n
        sa, sb = oa.state[p], ob.state[q]
        assert sa.keys() == sb.keys(), n
        for k in sa:
            assert torch.equal(sa[k], sb[k]), (n, k)


@pytest.mark.parametrize("mode", ["mask", "gather"])
def test_graph_step_on_the_cpu_matches_graph_false_bit_for_bit(mode):
    """Four steps over two text widths, the rate changed before the third:
    the same losses, parameters and AdamW moments and step counts; one entry
    of buffers per width."""
    model = init_nlvr_model(CFG, seed=0, device="cpu")
    graphed, eager = _pair(model, CAPS[mode])
    batches = _batches((8, 6, 8, 6), "cpu")
    for i, b in enumerate(batches):
        if i == 2:
            set_lr(graphed[1], 5e-4)
            set_lr(eager[1], 5e-4)
        got, want = graphed[2](*b, TEMPERATURE), eager[2](*b, TEMPERATURE)
        assert got.keys() == want.keys() == {"loss", "loss_ori", "loss_fdt"}
        for k in got:
            assert torch.equal(got[k], want[k]), (i, k)
    _assert_same_state(graphed, eager)
    assert graph_count(graphed[2].graphs) == 2
    assert graph_count(eager[2].graphs) == 0


def test_set_lr_reaches_the_step_between_calls():
    """A rate of 0 between two calls of one signature leaves every weight as
    it was (the decay is scaled by the rate too); a rate held as a tensor is
    filled in place."""
    model = init_nlvr_model(CFG, seed=0, device="cpu")
    opt = make_adamw(model.parameters(), lr=1e-3, weight_decay=0.05)
    step = make_nlvr_train_step(model, opt, device="cpu")
    b = _batches((8,), "cpu")[0]
    before = [p.detach().clone() for p in model.parameters()]
    step(*b, TEMPERATURE)
    assert any(not torch.equal(p, q) for p, q in zip(model.parameters(), before))
    set_lr(opt, 0.0)
    before = [p.detach().clone() for p in model.parameters()]
    step(*b, TEMPERATURE)
    assert all(torch.equal(p, q) for p, q in zip(model.parameters(), before))
    held = torch.nn.Parameter(torch.ones(3))
    tensor_lr = torch.optim.AdamW([held], lr=torch.tensor(1e-3))
    rate = tensor_lr.param_groups[0]["lr"]
    set_lr(tensor_lr, 2e-3)
    assert tensor_lr.param_groups[0]["lr"] is rate and float(rate) == pytest.approx(2e-3)


@pytest.mark.parametrize("capturable", [None, False])
def test_make_adamw_keeps_the_step_count_and_rate_on_the_host_on_the_cpu(capturable):
    """By default on the CPU, and where asked (the eager CLIs): a host rate
    and step count."""
    opt = make_adamw([torch.nn.Parameter(torch.ones(2))], lr=1e-3, weight_decay=0.05,
                     capturable=capturable)
    group = opt.param_groups[0]
    assert group["capturable"] is False and group["lr"] == 1e-3


@pytest.mark.parametrize("case", ["dropout", "spans", "graph_false"])
def test_steps_a_graph_cannot_hold_run_eagerly(monkeypatch, case):
    """A step with a dropout generator (its key drawn on the host), one
    inside a step spanning the ranks (collectives) and ``graph=False`` run
    the update eagerly: no buffers are made, and the update happens."""
    model = init_nlvr_model(CFG, seed=0, device="cpu")
    opt = make_adamw(model.parameters(), lr=1e-3, weight_decay=0.05)
    kw = {"dropout": dict(use_dropout=True), "spans": {},
          "graph_false": dict(graph=False)}[case]
    step = make_nlvr_train_step(model, opt, device="cpu", **kw)
    if case == "spans":
        monkeypatch.setattr(data, "spans", lambda: True)
    gen = torch.Generator().manual_seed(3) if case == "dropout" else None
    before = [p.detach().clone() for p in model.parameters()]
    out = step(*_batches((8,), "cpu")[0], TEMPERATURE, generator=gen)
    assert torch.isfinite(out["loss"])
    assert graph_count(step.graphs) == 0
    assert any(not torch.equal(p, q) for p, q in zip(model.parameters(), before))


@pytest.mark.parametrize("graph", [True, False])
def test_each_call_records_the_kept_counts_once(graph):
    """``kept.vision`` and ``kept.text``: one record each per call, the
    towers' counts at the weights before that call's update."""
    model = init_nlvr_model(CFG, seed=0, device="cpu")
    opt = make_adamw(model.parameters(), lr=1e-3, weight_decay=0.05)
    caps = CAPS["gather"]
    step = make_nlvr_train_step(model, opt, capacities_v=caps[0], capacities_t=caps[1],
                                device="cpu", graph=graph)
    want = []
    with profile(activities=[ProfilerActivity.CPU]):
        for b in _batches((8, 6, 8), "cpu"):
            with torch.no_grad():
                out = model(*b[:3], temperature=TEMPERATURE, prune_active=True,
                            capacities_v=caps[0], capacities_t=caps[1])
            want.append((out.v_kept.tolist(), out.t_kept.tolist()))
            step(*b, TEMPERATURE)
    kept = {n: [r["value"] for r in profiling.records() if r["name"] == n]
            for n in ("kept.vision", "kept.text")}
    assert kept["kept.vision"] == [v for v, _ in want]
    assert kept["kept.text"] == [t for _, t in want]


def test_the_steps_over_one_optimizer_share_its_graphs():
    """Steps made over one optimizer (``--fast_train``'s capacity schedules,
    the mask-mode step) keep their entries in the optimizer's one cache, a
    key each, at most 8, the least recently used dropped; another
    optimizer's steps have their own."""
    model = init_nlvr_model(CFG, seed=0, device="cpu")
    opt = make_adamw(model.parameters(), lr=1e-3, weight_decay=0.05)
    b = _batches((8,), "cpu")[0]
    steps = [make_nlvr_train_step(model, opt, capacities_v=(14, n), capacities_t=(8, 8),
                                  device="cpu") for n in range(4, 13)]
    for step in steps:
        step(*b, TEMPERATURE)
    assert all(step.graphs is opt._captured_steps for step in steps)
    assert len(opt._captured_steps) == 8
    assert ("nlvr_train", (True, (14, 4), (8, 8), False)) not in steps[0].graphs
    assert ("nlvr_train", (True, (14, 12), (8, 8), False)) in steps[0].graphs
    other = make_adamw(model.parameters(), lr=1e-3, weight_decay=0.05)
    assert make_nlvr_train_step(model, other, device="cpu").graphs is not steps[0].graphs


def test_capacities_given_as_lists_key_the_graphs_as_tuples():
    model = init_nlvr_model(CFG, seed=0, device="cpu")
    opt = make_adamw(model.parameters(), lr=1e-3, weight_decay=0.05)
    step = make_nlvr_train_step(model, opt, capacities_v=[14, 12], capacities_t=[8, 8],
                                device="cpu")
    assert torch.isfinite(step(*_batches((8,), "cpu")[0], TEMPERATURE)["loss"])
    assert list(step.graphs) == [("nlvr_train", (True, (14, 12), (8, 8), False))]


def test_a_cache_holds_one_memory_pool():
    """A new entry of a cache takes the pool and stream the cache's graphs
    were captured into, so every graph of a cache shares them."""
    cache = BoundedCache()
    first = _Step(cache)
    assert first.pool is None and first.stream is None
    first.pool, first.stream = ("pool",), "stream"
    cache["a"] = first
    second = _Step(cache)
    assert (second.pool, second.stream) == (("pool",), "stream")
    assert second.entries == {} and second.entries is not first.entries


def test_loss_fn_returns_the_three_losses():
    model = init_nlvr_model(CFG, seed=0, device="cpu")
    opt = make_adamw(model.parameters(), lr=1e-3, weight_decay=0.05)
    step = make_nlvr_train_step(model, opt, device="cpu")
    out = step.loss_fn(*_batches((8,), "cpu")[0], TEMPERATURE)
    assert len(out) == 3
    assert torch.equal(out[0], out[1] + 0.1 * out[2])


# --- on the card ----------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tiny_on_card(cuda):
    """A two-layer NLVR model the kernels take (heads of 64, widths of 128),
    fp32, gather capacities."""
    vit = ViTConfig(image_size=64, patch_size=16, embed_dim=128, depth=2, num_heads=2,
                    sd_dim=128)
    med = MedConfig(hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
                    intermediate_size=256, twin_cross=True, encoder_width=128, vocab_size=64,
                    max_position_embeddings=16, merge_start_layer=1, sd_dim=128)
    model = init_nlvr_model(BlipConfig(vit, med, sd_num=16, sd_dim=128), seed=0, device=cuda)
    return model, ((14, 10), (8, 8))


def _launches():
    from madtp_tpu_torch.kernels.attention_scores_bwd import attention_scores_bwd_cuda
    from madtp_tpu_torch.kernels.ffn import ffn_cuda

    return attention_scores_bwd_cuda.launches, ffn_cuda.launches, ffn_cuda.fp32_launches


@pytest.mark.cuda
@pytest.mark.parametrize("amp", [False, True])
@pytest.mark.parametrize("mode", ["mask", "gather"])
def test_replays_match_the_eager_capturable_step_bit_for_bit(cuda, mode, amp):
    """Five steps at text widths 10, 7, 10, 13, 7 (two replays), the rate
    changed before the third: each replay's losses, and after the last step
    every parameter and AdamW's moments and step counts, equal the eager
    step's with the same capturable AdamW; the graphed calls wait on
    nothing; a replay launches K2 and K5 as often as an eager step.  Mask
    mode is the driver's step without ``--fast_train``; ``amp`` its bf16
    compute against the fp32 masters."""
    model, caps = _tiny_on_card(cuda)
    graphed, eager = _pair(model, caps if mode == "gather" else (None, None), amp=amp)
    group = graphed[1].param_groups[0]
    assert group["capturable"] and group["lr"].is_cuda and group["lr"].dim() == 0
    batches = _batches((10, 7, 10, 13, 7), cuda, vocab=64)
    captures = CapturedStep.captures
    for i, b in enumerate(batches):
        if i == 2:
            set_lr(graphed[1], 5e-4)
            set_lr(eager[1], 5e-4)
        torch.cuda.synchronize()
        n0 = _launches()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = graphed[2](*b, 4.0)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        n1 = _launches()
        want = eager[2](*b, 4.0)
        n2 = _launches()
        torch.cuda.synchronize()
        for k in got:
            assert torch.equal(got[k], want[k]), (i, k)
        if i in (2, 4):  # replays
            assert tuple(b - a for a, b in zip(n0, n1)) == tuple(
                b - a for a, b in zip(n1, n2)), i
            assert n2[0] > n1[0] and n2[1] > n1[1]
    assert CapturedStep.captures - captures == 3
    assert graph_count(graphed[2].graphs) == 3
    _assert_same_state(graphed, eager)


@pytest.mark.cuda
def test_captures_and_replays_are_counted_under_a_card_trace(cuda):
    """Under a profiler that traces the card, a new width is captured (the
    counter ``graph.capture``) and a seen one replayed (``graph.replay``),
    each naming the step, and every call records its kept counts."""
    model, caps = _tiny_on_card(cuda)
    opt = make_adamw(model.parameters(), lr=1e-3, weight_decay=0.05)
    step = make_nlvr_train_step(model, opt, capacities_v=caps[0], capacities_t=caps[1])
    batches = _batches((10, 10, 7, 10), cuda, vocab=64)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        losses = [step(*b, 4.0)["loss"] for b in batches]
        torch.cuda.synchronize()
    held = profiling.records()
    graphs = [(r["name"], r["value"]) for r in held if r["name"].startswith("graph.")]
    assert graphs == [("graph.capture", "nlvr_train"), ("graph.replay", "nlvr_train"),
                      ("graph.capture", "nlvr_train"), ("graph.replay", "nlvr_train")]
    assert len([r for r in held if r["name"] == "kept.vision"]) == 4
    assert all(np.isfinite(float(v)) for v in losses)


@pytest.mark.cuda
def test_graphed_calls_leave_no_gradient_and_share_one_pool(cuda):
    """After every graphed call, a capture or a replay, no parameter holds a
    ``.grad`` (the graphs' gradients lie in their pool, where the next
    replay overwrites them); two capacity schedules over one optimizer
    capture into one pool."""
    model, caps = _tiny_on_card(cuda)
    opt = make_adamw(model.parameters(), lr=1e-3, weight_decay=0.05)
    steps = [make_nlvr_train_step(model, opt, capacities_v=cv, capacities_t=caps[1])
             for cv in (caps[0], (12, 8))]
    batches = _batches((10, 7), cuda, vocab=64)
    for step in steps + steps:
        for b in batches:
            assert torch.isfinite(step(*b, 4.0)["loss"])
            assert all(p.grad is None for p in model.parameters())
    held = list(opt._captured_steps.values())
    assert len(held) == 2 and graph_count(opt._captured_steps) == 4
    assert held[0].pool is not None and held[0].pool == held[1].pool


@pytest.mark.cuda
def test_an_optimizer_with_a_host_rate_runs_eagerly_on_the_card(cuda):
    model, caps = _tiny_on_card(cuda)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=0.05)
    step = make_nlvr_train_step(model, opt, capacities_v=caps[0], capacities_t=caps[1])
    for b in _batches((10, 10), cuda, vocab=64):
        assert torch.isfinite(step(*b, 4.0)["loss"])
    assert graph_count(step.graphs) == 0
