"""The port's NLVR2 driver (``madtp_tpu_torch/cli/compress_nlvr.py``, ``--device
cpu``) against the JAX package's on ``tools/make_fixture.py``'s fixture
(``vit: tiny``, 96 px, ``--epoch 2``), both from one ``--pretrained``
``.pth``: equal temperatures, GFLOPs and accuracies each epoch, losses within
1e-4 relative, the same best checkpoint (tensors within 2e-4 of their
largest value or of the run's Adam reach), ``--evaluate`` reproducing the
best epoch; ``--fast_train``
and ``--evaluate --fast_eval`` likewise; and a programmatic preemption
resumed exactly once, on the port alone."""

import os

import pytest

from tests.test_torch_driver_common import few_threads  # noqa: F401  (a fixture)
from tests.test_torch_driver_common import (assert_checkpoints_match, assert_logs_match,
                                            in_line_loaders, make_setup, read_log, run_jax,
                                            run_port)

LR = 3e-4  # the yaml's init_lr; cosine over 2 epochs: 3e-4, 1.5e-4
pytestmark = pytest.mark.usefixtures("few_threads")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    return make_setup(tmp_path_factory.mktemp("nlvr"), "nlvr")


def _train_both(setup, tmp_path, monkeypatch, *flags):
    yaml_path, pth, _ = setup
    argv = ["--config", yaml_path, "--pretrained", pth, "--epoch", "2", *flags]
    with in_line_loaders("nlvr"):
        run_jax("nlvr", [*argv, "--output_dir", str(tmp_path / "jax")], monkeypatch)
        run_port("nlvr", [*argv, "--output_dir", str(tmp_path / "port")])
    want, got = read_log(tmp_path / "jax" / "log.txt"), read_log(tmp_path / "port" / "log.txt")
    assert [e["epoch"] for e in got] == [0, 1]
    assert_logs_match(want, got)
    assert_checkpoints_match(tmp_path / "jax" / "checkpoint_best.pth",
                             tmp_path / "port" / "checkpoint_best.pth", pth, 2 * LR + 2 * LR / 2)
    return got


def _evaluate(setup, out, *flags, run=run_port, **kw):
    yaml_path = setup[0]
    with in_line_loaders("nlvr"):
        run("nlvr", ["--config", yaml_path, "--evaluate", "--output_dir", str(out / "evaluate"),
                     "--pretrained", str(out / "checkpoint_best.pth"), *flags], **kw)
    return read_log(out / "evaluate" / "evaluate.txt")[0]


def test_nlvr_driver_matches_jax(setup, tmp_path, monkeypatch):
    log = _train_both(setup, tmp_path, monkeypatch)
    best = max(log, key=lambda e: (float(e["test_acc"]), -e["epoch"]))
    got = _evaluate(setup, tmp_path / "port")
    assert (got["test_acc"], got["val_acc"], got["Cur_Gflops"]) == \
        (best["test_acc"], best["val_acc"], best["Cur_Gflops"])


def test_nlvr_fast_train_and_fast_eval_match_jax(setup, tmp_path, monkeypatch):
    _train_both(setup, tmp_path, monkeypatch, "--fast_train")
    want = _evaluate(setup, tmp_path / "jax", "--fast_eval", run=run_jax,
                     monkeypatch=monkeypatch)
    assert _evaluate(setup, tmp_path / "port", "--fast_eval") == want


def test_nlvr_preempt_then_resume(setup, tmp_path, monkeypatch, capsys):
    """``tests/test_preempt.py:74``'s design: stopped after batch 0 of epoch 1
    (2 batches an epoch), ``--resume`` restarts epoch 1, skips its one
    trained batch, re-derives its temperature and finishes.  (The NLVR
    dataset's image swap draws from a stream that restarts with each
    epoch's loader, so the skipped batch changes the swaps of the next: the
    finished run's equality to an uninterrupted one is held on the caption
    driver, ``tests/test_torch_driver_caption.py``.)"""
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
    with in_line_loaders("nlvr"):
        run_port("nlvr", [*argv, "--output_dir", str(tmp_path / "o1")])
        assert os.path.isfile(tmp_path / "o1" / "resume_ckpt")
        assert [e["epoch"] for e in read_log(tmp_path / "o1" / "log.txt")] == [0]
        monkeypatch.setattr(preempt, "PreemptionGuard", real)
        capsys.readouterr()
        run_port("nlvr", [*argv, "--output_dir", str(tmp_path / "o2"),
                          "--resume", str(tmp_path / "o1" / "resume_ckpt")])
        assert "skipping 1 trained batches" in capsys.readouterr().out
        run_port("nlvr", [*argv, "--output_dir", str(tmp_path / "full")])
    full, resumed = read_log(tmp_path / "full" / "log.txt"), read_log(tmp_path / "o2" / "log.txt")
    assert [e["epoch"] for e in resumed] == [1]
    assert resumed[0]["train_temperature"] == full[1]["train_temperature"]
