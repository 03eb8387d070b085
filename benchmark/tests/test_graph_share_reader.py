"""The reader of ``train_graph_share.train`` works its share out from the
program's ``graph.replay`` and ``graph.capture`` counters, and reads None
where there are none: a run without a trace, or a program without the
recorder or without a captured train step."""

from __future__ import annotations

import types
from pathlib import Path

import pytest

from benchmark import harness
from madtp_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[2]


def _count(rid, name, value):
    return dict(kind="count", id=rid, name=name, item=None, parent=None, at_ns=0, value=value)


def _run():
    cell = harness.load_cell(ROOT, "nlvr-train-p50")
    return types.SimpleNamespace(cell=cell, stretch=object(),
                                 readings={"capacities": {"vision": [577] * 12, "text": None}})


def test_graph_share_of_the_train_steps_reads_their_replays(monkeypatch):
    """Four traced steps: two replays and two captures of the train step,
    and another step's replay, which is not counted."""
    held = [_count(0, "graph.capture", "nlvr_train"), _count(1, "graph.replay", "nlvr_train"),
            _count(2, "graph.replay", "nlvr_eval"), _count(3, "graph.replay", "nlvr_train"),
            _count(4, "graph.capture", "nlvr_train")]
    monkeypatch.setattr(profiling, "records", lambda: held)
    reader = harness.load_module("metrics", "train_graph_share.train")
    run = _run()
    assert run.cell.mix["trace_steps"] == 4
    assert reader.read(run) == pytest.approx(50.0)
    monkeypatch.setattr(profiling, "records", lambda: held[:1])
    assert reader.read(run) == 0.0


@pytest.mark.parametrize("records", [
    [],
    [_count(0, "kept.vision", [300] * 12), _count(1, "graph.replay", "nlvr_eval")],
], ids=["no_records", "no_train_graph"])
def test_graph_share_reads_none_without_the_train_steps_counters(monkeypatch, records):
    reader = harness.load_module("metrics", "train_graph_share.train")
    monkeypatch.setattr(profiling, "records", lambda: records)
    assert reader.read(_run()) is None


def test_graph_share_reads_none_without_the_recorder(monkeypatch):
    reader = harness.load_module("metrics", "train_graph_share.train")
    for name in ("records", "span_ms"):
        monkeypatch.delattr(profiling, name)
    assert reader.read(_run()) is None
