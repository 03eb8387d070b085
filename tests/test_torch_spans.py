"""The program's spans and counters (``madtp_tpu_torch/utils/profiling.py``)
on the CPU: nothing kept and no profiler range made without a profiler;
under one, the nesting, the parents, the self times and the times of the
profiler's own events; the ring's bound; the spans of the NLVR train epoch
and eval loop; and the train step's kept counts against the model's.  A
tiny NLVR model, fp32."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from madtp_tpu_torch.core.config import BlipConfig, MedConfig, ViTConfig
from madtp_tpu_torch.models.blip import init_nlvr_model
from madtp_tpu_torch.tasks.nlvr import evaluate, train_epoch
from madtp_tpu_torch.train.loops import make_nlvr_train_step
from madtp_tpu_torch.train.optim import make_adamw
from madtp_tpu_torch.utils import profiling

CFG = BlipConfig(ViTConfig(image_size=64, embed_dim=32, depth=2, num_heads=2, sd_dim=32),
                 MedConfig(vocab_size=50, hidden_size=32, num_hidden_layers=2,
                           num_attention_heads=2, intermediate_size=64,
                           max_position_embeddings=16, encoder_width=32, sd_dim=32,
                           twin_cross=True, merge_start_layer=1),
                 sd_num=10, sd_dim=32)
B, TEXT = 2, 8
TEMPERATURE = 30.0
ENC = 2


@pytest.fixture(autouse=True)
def empty():
    profiling.clear()
    yield
    profiling.clear()


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


def _spans(name=None):
    return [r for r in profiling.records()
            if r["kind"] == "span" and (name is None or r["name"] == name)]


def test_without_a_profiler_nothing_is_kept_and_no_range_is_made(monkeypatch):
    made = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a, **k: made.append(a) or pytest.fail("a range was made"))
    with profiling.span("feed", 3):
        profiling.count("kept.vision", torch.tensor([1, 2]))
    assert profiling.records() == [] and made == []


def test_nesting_parents_self_times_and_the_profilers_clock():
    with _profiled() as prof:
        # a process's first range sets the profiler's path up after its stamp;
        # the harness opens its own range first, as here
        with torch.profiler.record_function("stretch"):
            pass
        with profiling.span("dispatch", 0):
            with profiling.span("forward"):
                torch.ones(1000).sum()
                profiling.count("kept.vision", torch.tensor([5, 3]))
            with profiling.span("backward"):
                torch.ones(1000).sum()
        with profiling.span("readback", 0):
            pass
    outer, fwd, bwd, rb = _spans()
    assert [r["name"] for r in (outer, fwd, bwd, rb)] == ["dispatch", "forward", "backward",
                                                         "readback"]
    assert outer["parent"] is None and rb["parent"] is None and outer["item"] == 0
    assert fwd["parent"] == bwd["parent"] == outer["id"]
    (kept,) = [r for r in profiling.records() if r["kind"] == "count"]
    assert kept["value"] == [5, 3] and kept["parent"] == fwd["id"]
    assert fwd["start_ns"] <= kept["at_ns"] <= fwd["end_ns"]
    inner = sum(r["end_ns"] - r["start_ns"] for r in (fwd, bwd))
    assert outer["self_ns"] == outer["end_ns"] - outer["start_ns"] - inner
    assert fwd["self_ns"] == fwd["end_ns"] - fwd["start_ns"]
    events = {}
    for e in prof.profiler.kineto_results.events():
        events.setdefault(e.name(), []).append(e)
    for r in (outer, fwd, bwd, rb):
        (e,) = events[r["name"]]
        # the test shares the host with other workers: 1 ms
        assert abs(e.start_ns() - r["start_ns"]) < 1e6 and abs(e.end_ns() - r["end_ns"]) < 1e6


def test_the_ring_keeps_the_newest_and_counts_the_drops(monkeypatch):
    ring = profiling._ring
    monkeypatch.setattr(profiling, "MAX_RECORDS", 4)
    monkeypatch.setattr(profiling, "_ring", type(ring)(maxlen=4))
    with _profiled():
        for i in range(6):
            profiling.count("n", i)
    assert [r["value"] for r in profiling.records()] == [2, 3, 4, 5]
    assert profiling.dropped() == 2
    profiling.clear()
    assert profiling.records() == [] and profiling.dropped() == 0


@pytest.fixture(scope="module")
def nlvr():
    g = np.random.RandomState(0)
    model = init_nlvr_model(CFG, seed=0, device="cpu")
    batches = [(g.randn(B, 3, 64, 64).astype(np.float32),
                g.randn(B, 3, 64, 64).astype(np.float32), [k] * B, g.randint(0, 2, B))
               for k in range(3)]
    ids = g.randint(3, CFG.med.vocab_size, (B, TEXT))
    mask = np.ones((B, TEXT), np.int64)
    mask[1, 6:] = 0
    with torch.no_grad():
        out = model(*_inputs(batches[0], ids, mask), temperature=TEMPERATURE,
                    prune_active=True)
    caps = (tuple(int(k) + 2 for k in out.v_kept), tuple(int(k) + 2 for k in out.t_kept))
    return model, batches, (lambda _: (ids.copy(), mask.copy())), ids, mask, caps


def _inputs(batch, ids, mask):
    ids = ids.copy()
    ids[:, 0] = ENC
    return (torch.from_numpy(np.concatenate(batch[:2])), torch.from_numpy(ids),
            torch.from_numpy(mask))


def test_train_epoch_records_each_steps_phases_and_its_read_back_a_step_late(nlvr):
    model, batches, tokenize, ids, mask, caps = nlvr
    state = {k: v.clone() for k, v in model.state_dict().items()}
    opt = make_adamw(model.parameters(), lr=1e-4, weight_decay=0.05)
    step = make_nlvr_train_step(model, opt, capacities_v=caps[0], capacities_t=caps[1],
                                device="cpu")
    with torch.no_grad():
        want = model(*_inputs(batches[0], ids, mask), temperature=TEMPERATURE,
                     prune_active=True, capacities_v=caps[0], capacities_t=caps[1])
    with _profiled():
        stats = train_epoch(model, step, lambda: iter(batches), tokenize, ENC, TEMPERATURE,
                            print_fn=None, print_freq=0)
    model.load_state_dict(state)
    assert stats["batches_done"] == 3
    spans = _spans()
    by_id = {r["id"]: r for r in spans}
    for name in ("feed", "dispatch", "forward", "backward", "optimizer", "readback"):
        assert len([r for r in spans if r["name"] == name and (
            r["parent"] is None or by_id[r["parent"]]["name"] != name)]) == 3, name
    top = [(r["name"], r["item"]) for r in spans if r["parent"] is None]
    assert top == [("feed", 0), ("dispatch", None), ("feed", 1), ("dispatch", None),
                   ("readback", 0), ("feed", 2), ("dispatch", None), ("readback", 1),
                   ("readback", 2)]
    for r in _spans("feed"):  # _device_batch's inside the step's own
        assert r["item"] is not None or by_id[r["parent"]]["name"] == "feed"
    for name in ("forward", "backward", "optimizer"):
        assert all(by_id[r["parent"]]["name"] == "dispatch" for r in _spans(name))
    kept = {n: [r["value"] for r in profiling.records() if r["name"] == n]
            for n in ("kept.vision", "kept.text")}
    assert len(kept["kept.vision"]) == len(kept["kept.text"]) == 3
    # the first step's counts: those of the model at its weights before it
    assert kept["kept.vision"][0] == want.v_kept.tolist()
    assert kept["kept.text"][0] == want.t_kept.tolist()


def test_eval_records_each_batchs_feed_dispatch_and_read_back(nlvr):
    model, batches, tokenize, *_ = nlvr
    with _profiled():
        evaluate(model, lambda: iter(batches), tokenize, TEMPERATURE, prune_active=True,
                 enc_token_id=ENC, print_fn=lambda *_: None)
    names = [r["name"] for r in _spans()]
    assert names.count("feed") == names.count("dispatch") == names.count("readback") == 3
    assert [r["item"] for r in _spans("readback")] == [0, 1, 2]
    assert names.index("readback") > names.index("dispatch", names.index("feed", 1))
