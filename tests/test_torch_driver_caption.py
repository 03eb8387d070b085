"""The port's COCO caption driver (``madtp_tpu_torch/cli/compress_caption.py``,
``--device cpu``) against the JAX package's on ``tools/make_fixture.py``'s
fixture (``vit: tiny``, 96 px, ``--epoch 2``, the fixture's caption ground
truth scored each epoch), both from one ``--pretrained`` ``.pth``: equal
GFLOPs and scores each epoch, losses within 1e-4 relative, the same best
checkpoint (tensors within 2e-4 of their largest value or of the run's Adam
reach), equal captions from ``--evaluate`` on it, which reproduces the best
epoch's GFLOPs; and a programmatic preemption resumed exactly once, whose
finished run equals an uninterrupted one."""

import json
import os

import pytest
import torch

from tests.test_torch_driver_common import few_threads  # noqa: F401  (a fixture)
from tests.test_torch_driver_common import (assert_checkpoints_match, assert_logs_match,
                                            make_setup, read_log, run_jax, run_port)

LR = 3e-4  # the yaml's init_lr; cosine over 2 epochs: 3e-4, 1.5e-4
pytestmark = pytest.mark.usefixtures("few_threads")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    return make_setup(tmp_path_factory.mktemp("caption"), "caption")


def test_caption_driver_matches_jax(setup, tmp_path, monkeypatch):
    yaml_path, pth, _ = setup
    argv = ["--config", yaml_path, "--pretrained", pth, "--epoch", "2"]
    run_jax("caption", [*argv, "--output_dir", str(tmp_path / "jax")], monkeypatch)
    run_port("caption", [*argv, "--output_dir", str(tmp_path / "port")])
    want, got = read_log(tmp_path / "jax" / "log.txt"), read_log(tmp_path / "port" / "log.txt")
    assert [e["epoch"] for e in got] == [0, 1] and "CIDEr" in got[0]
    assert_logs_match(want, got)
    assert_checkpoints_match(tmp_path / "jax" / "checkpoint_best.pth",
                             tmp_path / "port" / "checkpoint_best.pth", pth, 2 * LR + 2 * LR / 2)
    captions = {}
    for who, run, kw in (("jax", run_jax, dict(monkeypatch=monkeypatch)), ("port", run_port, {})):
        out = tmp_path / who
        run("caption", ["--config", yaml_path, "--evaluate", "--output_dir",
                        str(out / "evaluate"), "--pretrained", str(out / "checkpoint_best.pth")],
            **kw)
        with open(out / "evaluate" / "test_epoch_eval.json") as f:
            captions[who] = json.load(f)
    assert captions["port"] == captions["jax"] and len(captions["port"]) == 8
    best = got[int(torch.load(tmp_path / "port" / "checkpoint_best.pth")["epoch"])]
    assert read_log(tmp_path / "port" / "evaluate" / "evaluate.txt")[0] == \
        {"Cur_Gflops": best["Cur_Gflops"]}


def test_caption_preempt_resume_equals_uninterrupted(setup, tmp_path, monkeypatch, capsys):
    """Stopped after batch 0 of epoch 1 (2 batches an epoch), ``--resume``
    skips that batch and finishes; epoch 1's log (its train loss covers one
    batch), the resume state and the best checkpoint equal an
    uninterrupted run's, bit for bit."""
    from madtp_tpu_torch.utils import preempt

    yaml_path, pth, _ = setup
    argv = ["--config", yaml_path, "--pretrained", pth, "--epoch", "2"]
    real = preempt.PreemptionGuard

    class FakeGuard(real):
        polls = 0

        def should_stop(self):
            FakeGuard.polls += 1
            if FakeGuard.polls == 3:
                self.request_stop()
            return super().should_stop()

    monkeypatch.setattr(preempt, "PreemptionGuard", FakeGuard)
    run_port("caption", [*argv, "--output_dir", str(tmp_path / "o1")])
    assert [e["epoch"] for e in read_log(tmp_path / "o1" / "log.txt")] == [0]
    monkeypatch.setattr(preempt, "PreemptionGuard", real)
    capsys.readouterr()
    run_port("caption", [*argv, "--output_dir", str(tmp_path / "o2"),
                         "--resume", str(tmp_path / "o1" / "resume_ckpt")])
    assert "skipping 1 trained batches" in capsys.readouterr().out
    run_port("caption", [*argv, "--output_dir", str(tmp_path / "full")])
    full, resumed = read_log(tmp_path / "full" / "log.txt"), read_log(tmp_path / "o2" / "log.txt")
    assert [e["epoch"] for e in resumed] == [1]
    # epoch 1's train loss covers one batch in the resumed run, two in the other
    assert {k: v for k, v in resumed[0].items() if k != "train_loss"} == \
        {k: v for k, v in full[1].items() if k != "train_loss"}
    for name in ("resume_ckpt", "checkpoint_best.pth"):
        a = torch.load(tmp_path / "full" / name)
        b = torch.load(tmp_path / "o2" / name)
        for key, t in a["model"].items():
            assert torch.equal(b["model"][key], t), (name, key)
    assert os.path.exists(tmp_path / "o2" / "config.yaml")
