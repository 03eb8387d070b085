"""What the port's driver tests share
(``tests/test_torch_driver_{nlvr,caption,vqa,retrieval,clip}.py``):
``tools/make_fixture.py``'s fixture with a ``vit: tiny`` 96-px yaml, one
``--pretrained`` ``.pth`` per BLIP family written by the JAX package's
``ckpt/export.py`` from seeded parameters, the two drivers' runs, and the
comparisons of their logs and checkpoints.  The tests here: under ``--num_processes 2``
every driver refuses NCCL on the CPU; each driver,
without a card, runs only when given ``--device cpu``; the preemption guard
and the metric logger against the JAX package's."""

import contextlib
import functools
import importlib
import json
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ("nlvr", "caption", "vqa", "retrieval", "retrieval_clip")
# checkpoint tensors, relative to their scale: a ViT LayerNorm bias that starts at zero
# ends 4 Adam steps 1.02e-4 of its largest value apart (caption), its gradient agreeing
# between the packages to about 1e-4 (sums of terms of both signs)
CKPT_TOL = 2e-4


@pytest.fixture
def few_threads():
    """Two intra-op threads while a test runs the drivers: the tiny models
    gain nothing from more, and the test workers share the host's cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def make_setup(root, family):
    """The fixture under ``root``, the family's yaml and its pretrained
    ``.pth``; returns ``(yaml path, pth path, config)``."""
    import jax
    import yaml

    sys.path.insert(0, os.path.join(REPO, "tools"))
    import make_fixture
    from madtp_tpu.ckpt.export import export_med, export_vit, save_torch_checkpoint
    from madtp_tpu.cli.common import build_blip_cfg, init_blip_params

    make_fixture.make(str(root))
    images, ann = os.path.join(str(root), "images"), os.path.join(str(root), "annotation")
    config = {"image_root": images, "vqa_root": images, "ann_root": ann, "pretrained": "",
              "coco_gt_root": ann, "bert_vocab": os.path.join(str(root), "vocab.txt"),
              "vit": "tiny", "batch_size_train": 4, "batch_size_test": 4, "batch_size": 4,
              "sd_dim": 64, "sd_num": 10, "image_size": 96, "k_test": 4,
              "train_files": ["vqa_train", "vqa_val", "vg_qa"],
              "weight_decay": 0.05, "init_lr": 3e-4, "min_lr": 0.0}
    if family == "retrieval":
        config["dataset"] = "coco"
    yaml_path = os.path.join(str(root), f"{family}.yaml")
    with open(yaml_path, "w") as f:
        yaml.safe_dump(config, f)
    cfg = build_blip_cfg(config, 96, twin_cross=family == "nlvr")
    kw = dict(nlvr=dict(), caption=dict(heads=(), with_encoder=False, with_decoder=True),
              vqa=dict(heads=(), with_decoder=True), retrieval=dict(heads=("retrieval",)))[family]
    params = jax.tree.map(np.asarray, init_blip_params(cfg, 0, **kw))
    sd = export_vit(params["visual_encoder"], patch_size=16)
    if "text_encoder" in params:
        sd.update(export_med(params["text_encoder"], "text_encoder.",
                             twin_cross=family == "nlvr"))
    if "text_decoder" in params:
        sd.update(export_med(params["text_decoder"], "text_decoder.", has_lm_head=True))
    sd["space_dict"] = params["space_dict"]
    for name in ("vision_proj", "text_proj", "itm_head"):
        if name in params:
            sd[f"{name}.weight"] = params[name]["kernel"].T
            sd[f"{name}.bias"] = params[name]["bias"]
    if family == "nlvr":
        for i, fc in ((0, "fc1"), (2, "fc2")):
            sd[f"cls_head.{i}.weight"] = params["cls_head"][fc]["kernel"].T
            sd[f"cls_head.{i}.bias"] = params["cls_head"][fc]["bias"]
    pth = os.path.join(str(root), f"{family}_pretrained.pth")
    save_torch_checkpoint(pth, sd)
    return yaml_path, pth, config


@contextlib.contextmanager
def in_line_loaders(family):
    """Both drivers' loaders fetch in line (no worker threads).  The NLVR
    dataset draws its image swap from one ``random.Random`` in fetch order
    (``madtp_tpu/data/datasets.py:70``), so only an in-line fetch gives both
    packages the same swaps."""
    import madtp_tpu.data.loader as jloader

    port = importlib.import_module(f"madtp_tpu_torch.cli.compress_{family}")
    saved = (jloader.batched_loader, port.batched_loader)
    jloader.batched_loader = functools.partial(saved[0], num_workers=0)
    port.batched_loader = functools.partial(saved[1], num_workers=0)
    try:
        yield
    finally:
        jloader.batched_loader, port.batched_loader = saved


def run_jax(family, argv, monkeypatch):
    import jax

    jax.config.update("jax_platforms", "cpu")
    monkeypatch.setattr(sys, "argv", ["x", *argv, "--dp", "off"])
    importlib.import_module(f"madtp_tpu.cli.compress_{family}").main()


def run_port(family, argv):
    importlib.import_module(f"madtp_tpu_torch.cli.compress_{family}").main(
        [*argv, "--device", "cpu"])


def read_log(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _number(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return None


def assert_logs_match(want, got):
    """Equal keys and epochs; temperatures, learning rates, GFLOPs and
    accuracies equal; losses within 1e-4 relative (plus one unit of the
    logs' 4th decimal)."""
    assert len(got) == len(want)
    for w, g in zip(want, got):
        assert set(g) == set(w), (sorted(g), sorted(w))
        for k, v in w.items():
            if "loss" in k:
                a, b = _number(v), _number(g[k])
                assert abs(a - b) <= 1e-4 * abs(a) + 1e-4, (k, v, g[k])
            else:
                assert g[k] == v, (k, v, g[k])


def _key_bias(name, width):
    """The entries of an attention key bias: softmax over keys is
    shift-invariant, so their gradient is zero but for rounding, which Adam
    scales up to steps of about the learning rate in signs of its own in
    either package."""
    if name.endswith(("attn.qkv.bias", "attn.in_proj_bias")):  # BLIP's ViT, CLIP's towers
        return slice(width // 3, 2 * width // 3)
    if name.endswith("self.key.bias"):
        return slice(None)
    return None


def assert_checkpoints_match(want_path, got_path, start_path, reach):
    """The port's checkpoint against the JAX driver's: epoch and temperature
    equal; every tensor of the port's within ``CKPT_TOL`` of the larger of
    its largest value and ``reach`` (the run's summed learning rates: Adam
    moves a weight about the learning rate a step whatever its gradient, so
    a bias that starts at zero is held to the steps' reach); attention key
    biases only each within ``reach`` of the start.  The JAX export's
    extra ``position_ids`` and pooler are not in the port's."""
    want, got = torch.load(want_path, weights_only=False), torch.load(got_path)
    start = torch.load(start_path, weights_only=False)["model"]
    assert (got["epoch"], got["temperature"]) == (want["epoch"], want["temperature"])
    w, g = want["model"], got["model"]
    assert set(g) <= set(w)
    assert {k for k in set(w) - set(g) if "position_ids" not in k and "pooler" not in k} == set()
    for name, t in g.items():
        a, b = w[name].float().numpy().copy(), t.float().numpy().copy()
        kb = _key_bias(name, b.shape[-1]) if b.ndim else None  # 0-d: CLIP's logit_scale
        if kb is not None:
            s = start[name].float().numpy()
            for x in (a, b):
                assert np.abs(x[kb] - s[kb]).max() <= reach * 1.001, name
                x[kb] = 0.0
        scale = max(float(np.abs(a).max()), reach)
        assert float(np.abs(a - b).max()) <= CKPT_TOL * scale, (name, float(np.abs(a - b).max()),
                                                                scale)


@pytest.mark.parametrize("family", FAMILIES)
def test_num_processes_two_raises(family, tmp_path):
    """Under ``--num_processes 2`` every driver refuses NCCL on the CPU,
    before a process group forms."""
    with pytest.raises(ValueError, match="nccl"):
        run_port(family, ["--synthetic", "--output_dir", str(tmp_path), "--num_processes", "2",
                          "--dist_backend", "nccl"])


@pytest.mark.parametrize("family", FAMILIES)
def test_driver_refuses_without_card(family, tmp_path, monkeypatch):
    """Without a card the default ``--device cuda`` raises; ``--device cpu``
    runs (a synthetic evaluation)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = importlib.import_module(f"madtp_tpu_torch.cli.compress_{family}").main
    argv = ["--synthetic", "--evaluate", "--epoch", "1", "--synthetic_batches", "1",
            "--output_dir", str(tmp_path)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)
    main([*argv, "--device", "cpu"])
    assert os.path.exists(tmp_path / "evaluate.txt")


def test_preemption_guard():
    """``tests/test_preempt.py``'s guard tests on the port's guard: a signal
    stops at the next poll, the handler installed before still runs,
    ``request_stop`` stops too."""
    import signal

    from madtp_tpu_torch.utils.preempt import PreemptionGuard

    seen = []
    prev = signal.signal(signal.SIGUSR1, lambda s, f: seen.append(s))
    try:
        g = PreemptionGuard(signals=(signal.SIGUSR1,))
        assert not g.should_stop() and not g.triggered
        os.kill(os.getpid(), signal.SIGUSR1)
        assert seen == [signal.SIGUSR1]
        assert g.should_stop() and g.triggered and g.sync_now()
        g2 = PreemptionGuard(signals=(signal.SIGUSR1,))
        assert not g2.sync_now()
        g2.request_stop()
        assert g2.sync_now() and g2.should_stop()
    finally:
        signal.signal(signal.SIGUSR1, prev)


def test_metric_logger_matches_jax():
    from madtp_tpu.utils.logging import MetricLogger as JLogger
    from madtp_tpu.utils.logging import SmoothedValue as JValue
    from madtp_tpu_torch.utils.logging import MetricLogger, SmoothedValue

    values = [0.5, 2.0, 1.25, 7.0, 3.5, 0.125]
    a, b = SmoothedValue(window_size=4), JValue(window_size=4)
    for i, v in enumerate(values):
        a.update(v, n=i + 1)
        b.update(v, n=i + 1)
        assert (a.median, a.avg, a.global_avg, a.max, a.value, str(a)) == \
            (b.median, b.avg, b.global_avg, b.max, b.value, str(b))
    lines, jlines = [], []
    got, want = MetricLogger(print_fn=lines.append), JLogger(print_fn=jlines.append)
    assert list(got.log_every(range(5), 2, "h")) == list(range(5))
    list(want.log_every(range(5), 2, "h"))
    assert len(lines) == len(jlines) == 4 and lines[0].startswith("h [0/5]")
    for logger in (got, want):
        logger.update(loss=1.5, acc=0.25)
        logger.update(loss=0.5, acc=0.75)
    assert (str(got), got.global_avg()) == (str(want), want.global_avg())
