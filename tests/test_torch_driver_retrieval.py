"""The port's BLIP retrieval driver (``madtp_tpu_torch/cli/compress_retrieval.py``,
``--device cpu``) against the JAX package's on ``tools/make_fixture.py``'s
fixture (``vit: tiny``, 96 px, COCO-Karpathy: 8 train pairs in batches of 4,
8 test images with 16 captions, ``k_test`` 4, ``--epoch 2``), both from one
``--pretrained`` ``.pth``: equal ``evaluate.txt`` (the dense first eval),
equal GFLOPs and recalls each epoch, the same best checkpoint (tensors within
2e-4 of their largest value or of the run's Adam reach), and ``--evaluate``
on it reproducing the best epoch's recalls; the same with ``--fast_train``,
then ``--evaluate --fast_eval`` on that best checkpoint equal to the JAX
driver's; a programmatic preemption resumed exactly once equals an
uninterrupted run.

The two packages draw random numbers apart, so the port's driver is fed the
JAX driver's: its hard negatives take the JAX step's Gumbel noise in step
order (``PRNGKey(seed)`` split per step, then into the two draws, as
``tests/test_torch_train_retrieval.py`` ``_noise`` rebuilds it) through the
port's ``train/losses.py`` ``gumbel``, and its feature queue starts as
``init_queue`` draws it.  Both are patched here; neither package changes.

Adam's eps regime: an element whose gradient, at a step before the best
checkpoint, is not zero but below both ``EPS_REGIME`` (1e-6, 100x AdamW's
eps) and 1e-4 of its tensor's median (terms that cancel) takes the update
``lr g / (|g| + 1e-8)``, which turns the packages' last-bit disagreement on
``g`` into a difference of order the learning rate, as for the attention
key biases.  Such elements (on this fixture one of the text encoder's FFN
biases, its step-1 gradient -1.3e-7 against a median of 7.3e-3, ended
2.3e-7 apart, 2.6e-4 of the reach) are held, in both packages, to the
steps' reach from the start, like the key biases; every other element to
``CKPT_TOL``.  They may be at most ``EPS_REGIME_SHARE`` of the weights
(about 170 of 4.1 million here, 64 of them key biases)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_driver_common import few_threads  # noqa: F401  (a fixture)
from tests.test_torch_driver_common import (assert_checkpoints_match, assert_logs_match,
                                            make_setup, read_log, run_jax, run_port)

LR = 3e-4  # the yaml's init_lr; cosine over 2 epochs: 3e-4, 1.5e-4, 2 steps each
B, SEED = 4, 42  # the yaml's batch_size_train, the drivers' default --seed
EPS_REGIME, EPS_REGIME_SHARE = 1e-6, 1e-4
pytestmark = pytest.mark.usefixtures("few_threads")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    return make_setup(tmp_path_factory.mktemp("retrieval"), "retrieval")


@pytest.fixture
def jax_draws(monkeypatch):
    """The port's driver draws the JAX driver's Gumbel noise and queue."""
    import madtp_tpu_torch.cli.compress_retrieval as driver
    from madtp_tpu.train.momentum import init_queue
    from madtp_tpu_torch.train import losses

    key, noise = jax.random.PRNGKey(SEED), []
    for _ in range(4):  # 2 epochs of 2 steps
        key, sub = jax.random.split(key)
        noise += [torch.from_numpy(np.asarray(jax.random.gumbel(k, (B, B), jnp.float32)))
                  for k in jax.random.split(sub)]

    def gumbel(shape, *, generator=None, device=None):
        t = noise.pop(0)
        assert tuple(t.shape) == tuple(shape)
        return t.to(device)

    real = driver.init_retrieval_train_state

    def init_state_jax_queue(model, **kw):
        state = real(model, **kw)
        q = init_queue(*state.queue.image.shape)
        state.queue.image.copy_(torch.from_numpy(np.asarray(q.image)))
        state.queue.text.copy_(torch.from_numpy(np.asarray(q.text)))
        return state

    grads = []  # per step: {parameter name: |gradient|}
    names = {}

    def init_state(model, **kw):
        names.update({id(p): n for n, p in model.named_parameters()})
        return _init_state(model, **kw)

    _init_state = init_state_jax_queue
    real_step = torch.optim.AdamW.step

    def step(self, *a, **k):
        grads.append({names[id(p)]: p.grad.detach().abs().clone()
                      for g in self.param_groups for p in g["params"] if p.grad is not None})
        return real_step(self, *a, **k)

    monkeypatch.setattr(losses, "gumbel", gumbel)
    monkeypatch.setattr(driver, "init_retrieval_train_state", init_state)
    monkeypatch.setattr(torch.optim.AdamW, "step", step)
    yield grads
    assert not noise  # every step drew its two


RECALLS = ("txt_r1", "txt_r5", "txt_r10", "img_r1", "img_r5", "img_r10", "txt_r_mean",
           "img_r_mean", "r_mean")


def _eps_regime_held(want_path, got_path, start_path, grads, reach, out_dir):
    """The two checkpoints with their Adam-eps-regime elements checked
    against the steps' reach from the start and then set to the JAX value,
    written under ``out_dir``; returns their paths."""
    want, got = torch.load(want_path, weights_only=False), torch.load(got_path)
    start = torch.load(start_path, weights_only=False)["model"]
    n_small, n_all = 0, 0
    for name, t in got["model"].items():
        n_all += t.numel()
        if name not in grads[0]:
            continue
        g = torch.stack([g[name] for g in grads])
        typical = g.flatten(1).median(1).values.view(-1, *[1] * (g.dim() - 1))
        # an unused weight's 0 is exact in both packages
        small = ((g > 0) & (g < EPS_REGIME) & (g < 1e-4 * typical)).any(0)
        if not small.any():
            continue
        n_small += int(small.sum())
        w, s = want["model"][name], start[name].float()
        for x in (w, t):
            assert float((x.float() - s)[small].abs().max()) <= reach * 1.001, name
        t[small] = w[small].to(t.dtype)
    assert n_small <= EPS_REGIME_SHARE * n_all, (n_small, n_all)
    paths = (out_dir / "want.pth", out_dir / "got.pth")
    torch.save(want, paths[0])
    torch.save(got, paths[1])
    return paths


def _train_both(setup, tmp_path, monkeypatch, grads, *extra):
    yaml_path, pth, _ = setup
    argv = ["--config", yaml_path, "--pretrained", pth, "--epoch", "2", *extra]
    run_jax("retrieval", [*argv, "--output_dir", str(tmp_path / "jax")], monkeypatch)
    run_port("retrieval", [*argv, "--output_dir", str(tmp_path / "port")])
    for name in ("evaluate.txt", "log.txt"):
        want, got = read_log(tmp_path / "jax" / name), read_log(tmp_path / "port" / name)
        assert_logs_match(want, got)
    got = read_log(tmp_path / "port" / "log.txt")
    assert [e["epoch"] for e in got] == [0, 1] and set(RECALLS) <= set(got[0])
    epoch = int(torch.load(tmp_path / "port" / "checkpoint_best.pth")["epoch"])
    steps = 2 * (epoch + 1)  # the steps before the best checkpoint
    assert len(grads) == 4
    reach = sum(LR * (1 if i < 2 else 0.5) for i in range(steps))
    assert_checkpoints_match(*_eps_regime_held(
        tmp_path / "jax" / "checkpoint_best.pth", tmp_path / "port" / "checkpoint_best.pth",
        pth, grads[:steps], reach, tmp_path), pth, reach)
    return got[epoch]


@pytest.mark.parametrize("fast", [False, True], ids=["mask", "fast"])
def test_retrieval_driver_matches_jax(setup, tmp_path, monkeypatch, jax_draws, fast):
    """Mask-mode training, or ``--fast_train`` (gather mode at capacities
    recalibrated each epoch on mask-mode probes of the three passes), then
    ``--evaluate`` on the port's best checkpoint, with ``--fast_eval`` in the
    fast case (its capacities from four image batches and 32 texts)."""
    yaml_path = setup[0]
    best = _train_both(setup, tmp_path, monkeypatch, jax_draws,
                       *(["--fast_train"] if fast else []))
    argv = ["--config", yaml_path, "--evaluate", *(["--fast_eval"] if fast else [])]
    run_port("retrieval", [*argv, "--output_dir", str(tmp_path / "port_eval"),
                           "--pretrained", str(tmp_path / "port" / "checkpoint_best.pth")])
    got = read_log(tmp_path / "port_eval" / "evaluate.txt")
    assert got == [{k: best[k] for k in RECALLS}]
    if fast:
        run_jax("retrieval", [*argv, "--output_dir", str(tmp_path / "jax_eval"),
                              "--pretrained", str(tmp_path / "jax" / "checkpoint_best.pth")],
                monkeypatch)
        assert read_log(tmp_path / "jax_eval" / "evaluate.txt") == got


def test_retrieval_scores_dump_and_synthetic(tmp_path, monkeypatch):
    """``MADTP_DUMP_SCORES`` writes both score matrices (-100 where not
    reranked, ``k_test`` 4 of 6 per row); ``--synthetic`` evaluates its
    corpus of 6 in batches of 3."""
    monkeypatch.setenv("MADTP_DUMP_SCORES", "1")
    run_port("retrieval", ["--synthetic", "--output_dir", str(tmp_path)])
    scores = np.load(tmp_path / "scores.npz")
    for name in ("i2t", "t2i"):
        s = scores[name]
        assert s.shape == (6, 6) and ((s != -100.0).sum(axis=1) == 4).all()
    assert set(read_log(tmp_path / "evaluate.txt")[0]) == set(RECALLS)


def test_retrieval_preempt_resume_equals_uninterrupted(setup, tmp_path, monkeypatch, capsys):
    """Stopped after batch 0 of epoch 1 (2 batches an epoch), ``--resume``
    skips that batch and finishes; epoch 1's log, the resume state (model,
    momentum towers, queue, ``temp``, the hard negatives' generator) and the
    best checkpoint equal an uninterrupted run's, bit for bit."""
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
    run_port("retrieval", [*argv, "--output_dir", str(tmp_path / "o1")])
    assert [e["epoch"] for e in read_log(tmp_path / "o1" / "log.txt")] == [0]
    monkeypatch.setattr(preempt, "PreemptionGuard", real)
    capsys.readouterr()
    run_port("retrieval", [*argv, "--output_dir", str(tmp_path / "o2"),
                           "--resume", str(tmp_path / "o1" / "resume_ckpt")])
    assert "skipping 1 trained batches" in capsys.readouterr().out
    run_port("retrieval", [*argv, "--output_dir", str(tmp_path / "full")])
    full, resumed = read_log(tmp_path / "full" / "log.txt"), read_log(tmp_path / "o2" / "log.txt")
    assert resumed == full[1:]
    a, b = torch.load(tmp_path / "full" / "resume_ckpt"), torch.load(tmp_path / "o2" / "resume_ckpt")
    for part in ("model", "extra"):
        assert set(a[part]) == set(b[part]) and len(a[part]) > 4
        for key, t in a[part].items():
            assert torch.equal(b[part][key], t), (part, key)
    a = torch.load(tmp_path / "full" / "checkpoint_best.pth")
    # the resumed run writes one only when epoch 1 is the best
    assert os.path.exists(tmp_path / "o2" / "checkpoint_best.pth") == (a["epoch"] == 1)
    if a["epoch"] == 1:
        b = torch.load(tmp_path / "o2" / "checkpoint_best.pth")
        for key, t in a["model"].items():
            assert torch.equal(b["model"][key], t), key
    assert os.path.exists(tmp_path / "o2" / "config.yaml")
