"""The port's CLIP retrieval driver (``madtp_tpu_torch/cli/compress_retrieval_clip.py``,
``--device cpu``) against the JAX package's on ``tools/make_fixture.py``'s
fixture (Flickr30k layout: 8 train pairs in batches of 4, 8 test images with
16 captions), from one ``--pretrained`` ``.pth`` of
``tests/test_driver_clip_train.py``'s tiny CLIP (64 px, 2 + 2 layers of
width 64, the real BPE tokenizer's 49,408 ids, context 32, a codebook of
10, a queue of 8, temperature 0): equal ``evaluate.txt``, equal GFLOPs and
recalls each epoch of ``--epoch 2`` (mask mode, and ``--fast_train``), the
same best checkpoint (tensors within 2e-4 of their largest value or of the
run's Adam reach), ``--evaluate`` on it reproducing the best epoch, and
``--evaluate --fast_eval`` equal to the JAX driver's; the ``--synthetic``
run equal; a preemption resumed exactly once equal to an uninterrupted run.

The ModifiedResNet tower, on a tiny RN ``.pth`` built as
``tests/test_clip.py:143-201`` builds one (stages of 1, 2, 1, 1 blocks,
width 16, the tiny CLIP's text tower): ``infer_clip_config`` equal to the
JAX driver's, the tower's features within 1e-5 of ``modified_resnet_forward``
(and its GFLOPs equal), ``--evaluate`` equal in both drivers, and training
refused by both: the JAX driver fails at its first checkpoint write
(``export_clip`` has no RN branch), the port's raises before its first step.

The port's feature queue starts as the JAX ``init_queue`` draws it (patched
here; neither package changes)."""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_driver_common import few_threads  # noqa: F401  (a fixture)
from tests.test_torch_driver_common import (REPO, assert_checkpoints_match, assert_logs_match,
                                            read_log, run_jax, run_port)

LR = 1e-4  # the yaml's init_lr; cosine over 2 epochs: 1e-4, 5e-5, 2 steps each
pytestmark = pytest.mark.usefixtures("few_threads")
FAMILY = "retrieval_clip"
BNK = (("weight", "scale"), ("bias", "bias"), ("running_mean", "mean"), ("running_var", "var"))


def _tiny_cfg():
    from madtp_tpu.core.config import CLIPConfig

    # heads as --evaluate's shape inference derives them (width // 64)
    return CLIPConfig(embed_dim=16, image_resolution=64, vision_layers=2, vision_width=64,
                      vision_patch_size=16, context_length=32, vocab_size=49408,
                      transformer_width=64, transformer_heads=1, transformer_layers=2,
                      sd_dim=64)


def rn_state_dict(rng, layers=(1, 2, 1, 1), width=16, resolution=64, out_dim=16):
    """A reference-layout RN CLIP state dict: ``init_modified_resnet_params``'
    visual tower under the tiny CLIP's text tower."""
    from madtp_tpu.ckpt.export import export_clip
    from madtp_tpu.models.clip import init_clip_params
    from madtp_tpu.models.clip_resnet import init_modified_resnet_params

    sd = {k: v for k, v in export_clip(init_clip_params(_tiny_cfg(), rng)).items()
          if not k.startswith("visual.")}
    vp = init_modified_resnet_params(layers, width, resolution, out_dim, rng)
    for i in (1, 2, 3):
        sd[f"visual.conv{i}.weight"] = vp["stem"][f"conv{i}"]
        for nm, k in BNK:
            sd[f"visual.bn{i}.{nm}"] = vp["stem"][f"bn{i}"][k]
    for li in range(1, 5):
        for bi, bp in enumerate(vp[f"layer{li}"]):
            b = f"visual.layer{li}.{bi}."
            for ci in (1, 2, 3):
                sd[b + f"conv{ci}.weight"] = bp[f"conv{ci}"]
                for nm, k in BNK:
                    sd[b + f"bn{ci}.{nm}"] = bp[f"bn{ci}"][k]
            if "downsample" in bp:
                sd[b + "downsample.0.weight"] = bp["downsample"]["conv"]
                for nm, k in BNK:
                    sd[b + f"downsample.1.{nm}"] = bp["downsample"]["bn"][k]
    sd["visual.attnpool.positional_embedding"] = vp["attnpool"]["positional_embedding"]
    for nm in ("q_proj", "k_proj", "v_proj", "c_proj"):
        sd[f"visual.attnpool.{nm}.weight"] = vp["attnpool"][nm]["kernel"].T
        sd[f"visual.attnpool.{nm}.bias"] = vp["attnpool"][nm]["bias"]
    return sd


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The fixture, the yaml, the ViT ``.pth`` and the RN ``.pth``."""
    from madtp_tpu.ckpt.export import export_clip, save_torch_checkpoint
    from madtp_tpu.models.clip import init_clip_params

    root = tmp_path_factory.mktemp("clip")
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import make_fixture

    make_fixture.make(str(root))
    rng = np.random.RandomState(3)
    sd = export_clip(init_clip_params(_tiny_cfg(), rng))
    sd["space_dict"] = rng.randn(10, 64).astype(np.float32)
    pth = str(root / "pretrained.pth")
    save_torch_checkpoint(pth, sd, temperature=0.0)
    rn = rn_state_dict(np.random.RandomState(4))
    rn["space_dict"] = sd["space_dict"]
    rn_pth = str(root / "rn.pth")
    save_torch_checkpoint(rn_pth, rn, temperature=0.0)
    yaml_path = str(root / "clip.yaml")
    with open(yaml_path, "w") as f:
        f.write(f"image_root: {root}/images\nann_root: {root}/annotation\ndataset: flickr\n"
                "sd_dim: 64\nbatch_size_train: 4\nbatch_size_test: 4\nqueue_size: 8\n"
                f"init_lr: {LR}\nmin_lr: 0\nweight_decay: 0.2\nalpha: 0.4\n")
    return yaml_path, pth, rn_pth, rn


@pytest.fixture
def jax_queue(monkeypatch):
    import madtp_tpu_torch.cli.compress_retrieval_clip as driver
    from madtp_tpu.train.momentum import init_queue

    real = driver.init_clip_train_state

    def init_state(model, **kw):
        state = real(model, **kw)
        q = init_queue(*state.queue.image.shape)
        state.queue.image.copy_(torch.from_numpy(np.asarray(q.image)))
        state.queue.text.copy_(torch.from_numpy(np.asarray(q.text)))
        return state

    monkeypatch.setattr(driver, "init_clip_train_state", init_state)


RECALLS = ("txt_r1", "txt_r5", "txt_r10", "img_r1", "img_r5", "img_r10", "txt_r_mean",
           "img_r_mean", "r_mean")


@pytest.mark.parametrize("fast", [False, True], ids=["mask", "fast"])
def test_clip_driver_matches_jax(setup, tmp_path, monkeypatch, jax_queue, fast):
    yaml_path, pth = setup[:2]
    argv = ["--config", yaml_path, "--pretrained", pth, "--epoch", "2", "--p", "0.5",
            *(["--fast_train"] if fast else [])]
    run_jax(FAMILY, [*argv, "--output_dir", str(tmp_path / "jax")], monkeypatch)
    run_port(FAMILY, [*argv, "--output_dir", str(tmp_path / "port")])
    for name in ("evaluate.txt", "log.txt"):
        assert_logs_match(read_log(tmp_path / "jax" / name), read_log(tmp_path / "port" / name))
    got = read_log(tmp_path / "port" / "log.txt")
    assert [e["epoch"] for e in got] == [0, 1] and set(RECALLS) <= set(got[0])
    epoch = int(torch.load(tmp_path / "port" / "checkpoint_best.pth")["epoch"])
    reach = sum(LR * (1 if i < 2 else 0.5) for i in range(2 * (epoch + 1)))
    assert_checkpoints_match(tmp_path / "jax" / "checkpoint_best.pth",
                             tmp_path / "port" / "checkpoint_best.pth", pth, reach)
    best = got[epoch]
    ev = ["--config", yaml_path, "--evaluate", *(["--fast_eval"] if fast else [])]
    run_port(FAMILY, [*ev, "--output_dir", str(tmp_path / "port_eval"),
                      "--pretrained", str(tmp_path / "port" / "checkpoint_best.pth")])
    mine = read_log(tmp_path / "port_eval" / "evaluate.txt")[0]
    if not fast:  # the best epoch's eval, mask mode at its temperature
        assert {k: mine[k] for k in RECALLS} == {k: best[k] for k in RECALLS}
        assert round(mine["Cur_Gflops"], 2) == best["Cur_Gflops"]
    else:
        run_jax(FAMILY, [*ev, "--output_dir", str(tmp_path / "jax_eval"),
                         "--pretrained", str(tmp_path / "jax" / "checkpoint_best.pth")],
                monkeypatch)
        assert read_log(tmp_path / "jax_eval" / "evaluate.txt") == [mine]


def test_clip_synthetic_equal(tmp_path, monkeypatch):
    """``--synthetic``: the JAX driver's seeded model and corpus, its
    ``evaluate.txt``; ``MADTP_DUMP_SCORES`` writes the similarity matrix."""
    monkeypatch.setenv("MADTP_DUMP_SCORES", "1")
    run_jax(FAMILY, ["--synthetic", "--output_dir", str(tmp_path / "jax")], monkeypatch)
    run_port(FAMILY, ["--synthetic", "--output_dir", str(tmp_path / "port")])
    assert read_log(tmp_path / "port" / "evaluate.txt") == \
        read_log(tmp_path / "jax" / "evaluate.txt")
    want = np.load(tmp_path / "jax" / "clip_sims_r0.npz")["sims"]
    got = np.load(tmp_path / "port" / "clip_sims_r0.npz")["sims"]
    assert got.shape == (6, 6) and np.abs(got - want).max() < 1e-5


def test_clip_resnet_tower_matches_jax(setup):
    """The RN branch: the architecture read from the checkpoint, the tower's
    features against ``modified_resnet_forward`` through ``clip_encode_image``,
    the RN GFLOPs, no kept counts."""
    import jax.numpy as jnp

    from madtp_tpu.ckpt.remap import remap_clip
    from madtp_tpu.cli.compress_retrieval_clip import infer_clip_config as j_infer
    from madtp_tpu.models.clip import clip_encode_image
    from madtp_tpu.prune.flops import clip_gflops as j_clip_gflops
    from madtp_tpu_torch.ckpt.convert import load_clip_state_dict
    from madtp_tpu_torch.core.config import CLIPConfig, infer_clip_config
    from madtp_tpu_torch.prune.flops import clip_gflops

    sd = setup[3]
    want_cfg, cfg = j_infer(sd, 64), infer_clip_config(sd, 64)
    assert cfg == CLIPConfig(**{f: getattr(want_cfg, f) for f in (
        "embed_dim", "image_resolution", "vision_layers", "vision_width", "vision_patch_size",
        "context_length", "vocab_size", "transformer_width", "transformer_heads",
        "transformer_layers", "sd_dim", "resnet_layers")})
    assert cfg.is_resnet and cfg.resnet_layers == (1, 2, 1, 1)
    images = np.random.RandomState(5).randn(3, 3, 64, 64).astype(np.float32)
    want = np.asarray(clip_encode_image(jax.tree.map(jnp.asarray, remap_clip(sd)),
                                        jnp.asarray(images), want_cfg)[0])
    model = load_clip_state_dict(sd, cfg, device="cpu")
    with torch.no_grad():
        out = model.encode_image(torch.from_numpy(images), temperature=1.0, prune_active=True)
    assert out.sd_ft is None and out.kept_counts.numel() == 0
    assert np.abs(out.features.numpy() - want).max() <= 1e-5 * max(1.0, np.abs(want).max())
    assert clip_gflops(cfg, [], [30, 20]) == j_clip_gflops(want_cfg, [], [30, 20])


def test_clip_resnet_driver_evaluates_and_refuses_training(setup, tmp_path, monkeypatch):
    yaml_path, _, rn_pth, _ = setup
    argv = ["--config", yaml_path, "--pretrained", rn_pth]
    run_jax(FAMILY, [*argv, "--evaluate", "--output_dir", str(tmp_path / "jax")], monkeypatch)
    run_port(FAMILY, [*argv, "--evaluate", "--output_dir", str(tmp_path / "port")])
    got = read_log(tmp_path / "port" / "evaluate.txt")
    assert got == read_log(tmp_path / "jax" / "evaluate.txt") and got[0]["Cur_Gflops"] > 0
    train = [*argv, "--epoch", "1", "--p", "0.5"]
    with pytest.raises(KeyError, match="conv1"):  # export_clip of an RN tree
        run_jax(FAMILY, [*train, "--output_dir", str(tmp_path / "jax_train")], monkeypatch)
    assert not os.path.exists(tmp_path / "jax_train" / "checkpoint_best.pth")
    with pytest.raises(NotImplementedError, match="ModifiedResNet"):
        run_port(FAMILY, [*train, "--output_dir", str(tmp_path / "port_train")])
    assert not os.path.exists(tmp_path / "port_train" / "resume_ckpt")


def test_clip_preempt_resume_equals_uninterrupted(setup, tmp_path, monkeypatch, capsys):
    """Stopped after batch 0 of epoch 1, ``--resume`` skips that batch and
    finishes; epoch 1's log and the resume state (model, momentum copies,
    queue) equal an uninterrupted run's, bit for bit."""
    from madtp_tpu_torch.utils import preempt

    yaml_path, pth = setup[:2]
    argv = ["--config", yaml_path, "--pretrained", pth, "--epoch", "2", "--p", "0.5"]
    real = preempt.PreemptionGuard

    class FakeGuard(real):
        polls = 0

        def should_stop(self):
            FakeGuard.polls += 1
            if FakeGuard.polls == 3:
                self.request_stop()
            return super().should_stop()

    monkeypatch.setattr(preempt, "PreemptionGuard", FakeGuard)
    run_port(FAMILY, [*argv, "--output_dir", str(tmp_path / "o1")])
    assert [e["epoch"] for e in read_log(tmp_path / "o1" / "log.txt")] == [0]
    monkeypatch.setattr(preempt, "PreemptionGuard", real)
    capsys.readouterr()
    run_port(FAMILY, [*argv, "--output_dir", str(tmp_path / "o2"),
                      "--resume", str(tmp_path / "o1" / "resume_ckpt")])
    assert "skipping 1 trained batches" in capsys.readouterr().out
    run_port(FAMILY, [*argv, "--output_dir", str(tmp_path / "full")])
    full, resumed = read_log(tmp_path / "full" / "log.txt"), read_log(tmp_path / "o2" / "log.txt")
    assert resumed == full[1:]
    a, b = torch.load(tmp_path / "full" / "resume_ckpt"), torch.load(tmp_path / "o2" / "resume_ckpt")
    for part in ("model", "extra"):
        assert set(a[part]) == set(b[part]) and len(a[part]) > 4
        for key, t in a[part].items():
            assert torch.equal(b[part][key], t), (part, key)
