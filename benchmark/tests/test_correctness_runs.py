"""Whole runs of each cell at a tiny size on the CPU, the harness's look for
a card skipped: a sound run reads ``correct``, and a run with the timed path
broken underneath reads not correct, once for each fault the cell can
have.  The cells run on one card, so no fault leaves out an exchange
between cards; the eval cells hold no state that a step could leave
unchanged."""

from __future__ import annotations

import pytest
import torch

from benchmark import harness, readings
from benchmark.roofline import STEP_PEAK_FP32
from benchmark.tests import tiny


def _half(images, ids, mask, B):
    h = B // 2
    return torch.cat([images[:h], images[B:B + h]]), ids[:h], mask[:h]


class _Stretch:
    """A traced stretch's totals as the metric readers take them."""

    window_s, busy_s = 2.0, 1.5

    def kernel_s(self, names):
        return 1e-3


@pytest.mark.parametrize("name", ["nlvr-eval-p50", "clip-eval-p50", "nlvr-train-p50"])
def test_a_sound_run_is_correct(name):
    """A sound run reads correct, and every per-layer metric of the cell
    works its value out from the raw readings the run recorded."""
    run = tiny.run(name)
    assert run.correct, run.checks
    assert run.attempted > 0 and run.failed == 0
    r = run.readings
    assert r["capacities"]["vision"] and r["batches"]
    for b in r["batches"]:
        assert b["rows"] > 0 and (b.get("v_kept") or b.get("t_kept"))
        b["traced"] = True
    run.stretch = _Stretch()
    run.trace = True
    metrics = harness.read_per_layer(run)
    assert set(metrics) == {m["name"] for m in run.cell.per_layer}
    mfu = next(m for m in metrics if "mfu" in m)
    ops = (3 if "train" in name else 1) * sum(readings.batch_flops(run.cell.config, b)
                                              for b in r["batches"])
    assert metrics[mfu]["value"] == pytest.approx(100.0 * ops / 2.0 / STEP_PEAK_FP32)


def _nlvr_answer_altered(monkeypatch):
    from madtp_tpu_torch.models.blip import NLVRModel

    forward = NLVRModel.forward

    def altered(self, *a, **k):
        out = forward(self, *a, **k)
        if k.get("targets") is not None:
            return out
        # every answer off by 0.1%, as a wrong scale somewhere would leave it
        return out._replace(logits=out.logits * 1.001)
    monkeypatch.setattr(NLVRModel, "forward", altered)


def _nlvr_half_batch(monkeypatch):
    from madtp_tpu_torch.models.blip import NLVRModel

    forward = NLVRModel.forward

    def half(self, images, ids, mask, **k):
        B = ids.shape[0]
        if k.get("targets") is not None:
            targets = k.pop("targets")[:B // 2]
            return forward(self, *_half(images, ids, mask, B), targets=targets, **k)
        out = forward(self, *_half(images, ids, mask, B), **k)
        return out._replace(logits=out.logits.repeat(2, 1)[:B])
    monkeypatch.setattr(NLVRModel, "forward", half)


def _clip_answer_altered(monkeypatch):
    from madtp_tpu_torch.models.clip import CLIPModel

    encode = CLIPModel.encode_image

    def altered(self, images, **k):
        out = encode(self, images, **k)
        f = out.features
        return out._replace(features=f + 1e-3 * f.roll(1, dims=-1))
    monkeypatch.setattr(CLIPModel, "encode_image", altered)


def _clip_half_batch(monkeypatch):
    from madtp_tpu_torch.models.clip import CLIPModel

    encode = CLIPModel.encode_image

    def half(self, images, **k):
        h = -(-images.shape[0] // 2)
        out = encode(self, images[:h], **k)
        return out._replace(features=out.features.repeat(2, 1)[:images.shape[0]])
    monkeypatch.setattr(CLIPModel, "encode_image", half)


def _clip_ranking_altered(monkeypatch):
    from madtp_tpu_torch.eval import metrics

    itm_eval = metrics.itm_eval

    def altered(*a, **k):
        out = itm_eval(*a, **k)
        return dict(out, txt_r1=out["txt_r1"] + 0.02)  # one image's rank off in 5,000
    monkeypatch.setattr(metrics, "itm_eval", altered)


def _train_state_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, *a, **k: None)


def _train_loss_altered(monkeypatch):
    from madtp_tpu_torch.models import blip

    ce = blip.cross_entropy
    monkeypatch.setattr(blip, "cross_entropy", lambda *a, **k: 1.01 * ce(*a, **k))


FAULTS = [
    ("nlvr-eval-p50", _nlvr_answer_altered),
    ("nlvr-eval-p50", _nlvr_half_batch),
    ("clip-eval-p50", _clip_answer_altered),
    ("clip-eval-p50", _clip_half_batch),
    ("clip-eval-p50", _clip_ranking_altered),
    ("nlvr-train-p50", _train_state_unchanged),
    ("nlvr-train-p50", _nlvr_half_batch),
    ("nlvr-train-p50", _train_loss_altered),
]


@pytest.mark.parametrize("name,fault", FAULTS, ids=[f"{n}-{f.__name__[1:]}" for n, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    run = tiny.run(name)
    assert not run.correct, run.checks
