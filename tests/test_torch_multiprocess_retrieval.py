"""The port's multi-process BLIP retrieval and CLIP training on the CPU over
gloo, against the JAX package's step on the global batch (the semantics
``tests/test_spmd.py:260-356`` states for the JAX package: a sharded step is
the one-device step on the same global batch), and the reference
checkpoint's momentum towers.

* One train step on 2 ranks (``torch_mp_retrieval_worker.py``, 4 pairs a
  rank) against ``make_retrieval_train_step(..., data_shards=2)`` on the
  global batch of 8, for ``negative_all_rank`` True (negatives from every
  rank's rows, the negative image's encoder states with their gradient) and
  False (each rank's own rows), and against ``make_clip_train_step``: every
  logged loss within 1e-4, the gradients within atol 1e-5 + rtol 1e-3, the
  momentum towers after the EMA within 1e-6, the queue's features within
  1e-5 with equal ids and pointer, the ``temp`` clamp; both ranks'
  parameters, momentum towers and queues bit-equal.  The JAX noise is
  ``jax.random.gumbel`` of the step's split keys over the global batch,
  which each rank slices (``tests/test_torch_train_retrieval.py`` ``_noise``).
  The ids repeat across the ranks, so the cross-rank id mask shows.
* The control: each rank's ITC, mining and enqueue over its own rows alone
  (a plain data-parallel port) misses the JAX step; and the two values of
  ``negative_all_rank`` give the JAX step other gradients.
* ``batch_rows`` refuses unequal row counts on every rank.
* Both drivers, 2 ranks training ``--epoch 1`` on ``tools/make_fixture.py``'s
  fixture (``--synthetic`` only evaluates, in both packages): the same
  ``LOG:`` lines on both ranks, only rank 0 writes, and both end with
  bit-equal parameters, optimizer state, momentum towers, queue and (BLIP)
  hard-negative generator.
* ``load_retrieval_momentum`` against ``load_blip_retrieval(...,
  load_momentum=True)``: a checkpoint with ``*_m`` towers and ``temp``, and
  one without (copies of the online towers, ``temp`` 0.07).

Every process runs one intra-op thread, so a rank and the references add in
the same order where they can."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madtp_tpu.ckpt.export import export_clip, export_med, export_vit, save_torch_checkpoint
from madtp_tpu.cli.common import init_blip_params
from madtp_tpu.core.config import CLIPConfig as JCLIPConfig
from madtp_tpu.core.config import MedConfig as JMedConfig
from madtp_tpu.core.config import ViTConfig as JViTConfig
from madtp_tpu.data import tokenizer_clip as JTok
from madtp_tpu.data.tokenizer_bert import BertWordPieceTokenizer as JTokenizer
from madtp_tpu.models.blip import BlipConfig as JBlipConfig
from madtp_tpu.models.blip import load_blip_retrieval
from madtp_tpu.models.clip import init_clip_params
from madtp_tpu.train import momentum as JMo
from madtp_tpu.train import optim as JO
from madtp_tpu.train.loops import CLIP_MOMENTUM_KEYS as J_CLIP_MOMENTUM_KEYS
from madtp_tpu.train.loops import MOMENTUM_KEYS as J_MOMENTUM_KEYS
from madtp_tpu.train.loops import ClipTrainState as JClipState
from madtp_tpu.train.loops import RetrievalTrainState as JState
from madtp_tpu.train.loops import make_clip_train_step as j_clip_step
from madtp_tpu.train.loops import make_retrieval_train_step as j_retrieval_step
from madtp_tpu_torch.ckpt.convert import (clip_train_state_from_jax, load_retrieval_momentum,
                                          load_retrieval_state_dict,
                                          retrieval_train_state_from_jax)
from madtp_tpu_torch.cli.common import read_checkpoint
from madtp_tpu_torch.core.config import BlipConfig, CLIPConfig, MedConfig, ViTConfig
from madtp_tpu_torch.data.tokenizer_bert import BertWordPieceTokenizer
from madtp_tpu_torch.train.loops import init_retrieval_train_state
from madtp_tpu_torch.train.momentum import enqueue, init_queue
from tests.test_torch_driver_common import make_setup
from tests.test_torch_multiprocess import REPO, TIMEOUT, _finish, _free_port

ENV = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO}
ENV.pop("MADTP_DUMP_SCORES", None)
WORKER = os.path.join(REPO, "tests", "torch_mp_retrieval_worker.py")
LR, WD, CLIP_WD = 1e-5, 0.05, 0.2
TEMPERATURE, ALPHA = 2.0, 0.3
BG, Q, E = 8, 16, 16  # the global batch (4 pairs a rank), the queue, the features
WORDS = ("a dog cat man woman sitting on the table with red blue in front of street "
         "car").split()
J_TOKENIZER = JTokenizer.toy(WORDS)
TOKENIZER = BertWordPieceTokenizer.toy(WORDS)
ENC = TOKENIZER.enc_token_id
VIT = dict(image_size=64, patch_size=16, embed_dim=64, depth=2, num_heads=4, sd_dim=64)
MED = dict(vocab_size=len(TOKENIZER.vocab), hidden_size=64, num_hidden_layers=2,
           num_attention_heads=4, intermediate_size=128, max_position_embeddings=40,
           encoder_width=64, sd_dim=64)
JCFG = JBlipConfig(JViTConfig(**VIT), JMedConfig(**MED), sd_num=8, sd_dim=64)
TCFG = BlipConfig(ViTConfig(**VIT), MedConfig(**MED), sd_num=8, sd_dim=64)
CLIP = dict(embed_dim=E, image_resolution=64, vision_layers=2, vision_width=64,
            vision_patch_size=16, vision_heads_override=2, context_length=32,
            vocab_size=49408, transformer_width=64, transformer_heads=2, transformer_layers=2,
            sd_dim=64)
J_CLIP, T_CLIP = JCLIPConfig(**CLIP), CLIPConfig(**CLIP)
CAPTIONS = ["a dog on the table", "a man in front of the red car",
            "the man sitting in front of a car", "a woman with a blue cat", "a cat",
            "a red car on the street", "a woman sitting on the table",
            "the dog in front of the street with a man"]
IDX = np.array([0, 1, 1, 2, 3, 2, 4, 3])  # id 2 on both ranks, 1 and 3 twice on one
QUEUE_IDX = np.array([-100, 2, -100, 7, 0, -100, 3, -100] * 2, np.int32)
KEY = jax.random.PRNGKey(7)
CASES = ("retrieval_all_rank", "retrieval_own_rank", "clip")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _perturbed(tree, rng):
    """Momentum copies that differ from the online weights, so the EMA shows."""
    return jax.tree.map(lambda a: a + 0.01 * rng.randn(*a.shape).astype(np.float32), _np(tree))


def _queue(rng):
    return JMo.FeatureQueue(*(rng.randn(E, Q).astype(np.float32) for _ in range(2)),
                            QUEUE_IDX.copy(), np.int32(0))


def _grads(mu):
    """Adam's first moment after one step is 0.1 g."""
    return jax.tree.map(lambda a: np.asarray(a) / np.float32(1 - 0.9), mu)


def _retrieval_jobs():
    rng = np.random.RandomState(5)
    params = _np(init_blip_params(JCFG, 0, heads=("retrieval",)))
    params_m = {k: _perturbed(params[k], rng) for k in J_MOMENTUM_KEYS}
    queue = _queue(rng)
    images = rng.randn(BG, 3, 64, 64).astype(np.float32)
    tok = J_TOKENIZER(CAPTIONS, padding="max_length", max_length=12)
    ids, mask = np.asarray(tok["input_ids"]), np.asarray(tok["attention_mask"])
    k1, k2 = jax.random.split(KEY)
    noise = tuple(torch.from_numpy(np.array(jax.random.gumbel(k, (BG, BG), jnp.float32)))
                  for k in (k1, k2))
    batches = [(images[r * 4:(r + 1) * 4], ids[r * 4:(r + 1) * 4], mask[r * 4:(r + 1) * 4],
                IDX[r * 4:(r + 1) * 4]) for r in range(2)]
    jobs, want = {}, {}
    for name, all_rank in (("retrieval_all_rank", True), ("retrieval_own_rank", False)):
        jobs[name] = dict(family="retrieval", negative_all_rank=all_rank, batches=batches,
                          noise=noise, temperature=TEMPERATURE, alpha=ALPHA, lr=LR, wd=WD,
                          enc=ENC, state=retrieval_train_state_from_jax(
                              params, params_m, queue, 0.6, TCFG, device="cpu"))
        tx = JO.make_adamw_injectable(WD)
        jp = jax.tree.map(jnp.asarray, params)
        state = JState(jp, jax.tree.map(jnp.asarray, params_m), tx.init(jp),
                       JMo.FeatureQueue(*map(jnp.asarray, queue)), jnp.float32(0.6))
        state.opt_state.hyperparams["learning_rate"] = jnp.float32(LR)
        step = j_retrieval_step(JCFG, tx, enc_token_id=ENC, negative_all_rank=all_rank,
                                data_shards=2)
        st, m = step(state, KEY, jnp.asarray(images), jnp.asarray(ids), jnp.asarray(mask),
                     jnp.asarray(IDX), jnp.float32(TEMPERATURE), jnp.float32(ALPHA))
        conv = retrieval_train_state_from_jax(_grads(st.opt_state.inner_state[0].mu),
                                              _np(st.params_m), _np(st.queue), _np(st.temp),
                                              TCFG, device="cpu")
        want[name] = dict(metrics={k: float(v) for k, v in m.items()},
                          grads=conv.model.state_dict(), params_m=conv.params_m,
                          queue=conv.queue, temp=float(st.temp))
    return jobs, want


def _clip_jobs():
    rng = np.random.RandomState(0)
    params = _np(init_clip_params(J_CLIP, rng))
    space = rng.randn(10, J_CLIP.sd_dim).astype(np.float32)
    params_m = {k: _perturbed(params[k], rng) for k in J_CLIP_MOMENTUM_KEYS}
    queue = _queue(rng)
    images = rng.randn(BG, 3, 64, 64).astype(np.float32)
    text = JTok.clip_tokenize(JTok.ClipBPETokenizer(), CAPTIONS, J_CLIP.context_length)
    batches = [(images[r * 4:(r + 1) * 4], text[r * 4:(r + 1) * 4].astype(np.int64),
                IDX[r * 4:(r + 1) * 4]) for r in range(2)]
    job = dict(family="clip", batches=batches, temperature=TEMPERATURE, alpha=ALPHA, lr=LR,
               wd=CLIP_WD, state=clip_train_state_from_jax(params, params_m, queue, space,
                                                           T_CLIP, device="cpu"))
    tx = JO.make_adamw_injectable(CLIP_WD)
    jp, js = jax.tree.map(jnp.asarray, params), jnp.asarray(space)
    opt_state = tx.init({"params": jp, "space_dict": js})
    opt_state.hyperparams["learning_rate"] = jnp.float32(LR)
    state = JClipState(jp, jax.tree.map(jnp.asarray, params_m), opt_state,
                       JMo.FeatureQueue(*map(jnp.asarray, queue)), js)
    st, m = j_clip_step(J_CLIP, tx)(state, jnp.asarray(images), jnp.asarray(text),
                                   jnp.asarray(IDX), jnp.float32(TEMPERATURE),
                                   jnp.float32(ALPHA))
    mu = st.opt_state.inner_state[0].mu
    conv = clip_train_state_from_jax(_grads(mu["params"]), _np(st.params_m), _np(st.queue),
                                     _grads(mu["space_dict"]), T_CLIP, device="cpu")
    want = dict(metrics={k: float(v) for k, v in m.items()}, grads=conv.model.state_dict(),
                params_m=conv.params_m, queue=conv.queue)
    return job, want


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Both ranks' results (``torch_mp_retrieval_worker.py step``) and the JAX
    steps on the global batch, computed while the ranks run."""
    root = tmp_path_factory.mktemp("mp_retrieval")
    jobs, want = _retrieval_jobs()
    jobs["clip"], want["clip"] = _clip_jobs()
    torch.save(jobs, root / "job.pt")
    coord = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen([sys.executable, WORKER, "step", str(r), "2", coord,
                               str(root / "job.pt"), str(root)], cwd=REPO, env=ENV,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(2)]
    try:
        for r, p in enumerate(procs):
            out = p.communicate(timeout=TIMEOUT)[0].decode()
            assert p.returncode == 0, f"rank {r}:\n{out[-3000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    got = [torch.load(root / f"rank{r}.pt", weights_only=False) for r in range(2)]
    return dict(got=got, want=want)


def _misses(metrics, grads, want):
    return (max(abs(metrics[k] - v) for k, v in want["metrics"].items()) > 1e-4
            or not all(np.allclose(g.numpy(), want["grads"][n].numpy(), atol=1e-5, rtol=1e-3)
                       for n, g in grads.items()))


@pytest.mark.parametrize("case", CASES)
def test_two_rank_step_matches_jax_global_batch(two_ranks, case):
    r0, r1 = (g[case] for g in two_ranks["got"])
    want = two_ranks["want"][case]
    assert r0["metrics"] == r1["metrics"]
    for k, v in want["metrics"].items():
        assert r0["metrics"][k] == pytest.approx(v, abs=1e-4), (k, r0["metrics"], want)
    assert r0["grads"].keys() == want["grads"].keys()
    for name, g in r0["grads"].items():
        assert torch.equal(g, r1["grads"][name]), name
        np.testing.assert_allclose(g.numpy(), want["grads"][name].numpy(), atol=1e-5,
                                   rtol=1e-3, err_msg=name)
    for key in ("params", "params_m"):
        for name, t in r0[key].items():
            assert torch.equal(t, r1[key][name]), (key, name)
    for name, t in r0["params_m"].items():
        np.testing.assert_allclose(t.numpy(), want["params_m"][name].numpy(), atol=1e-6,
                                   rtol=1e-6, err_msg=name)
    q0, q1, qw = r0["queue"], r1["queue"], want["queue"]
    assert all(torch.equal(a, b) for a, b in zip(q0, q1))
    # the queue took the global batch: ids and pointer the JAX step's
    assert torch.equal(q0[2], qw.idx) and int(q0[3]) == int(qw.ptr) == BG
    assert torch.equal(q0[2][:BG], torch.from_numpy(IDX))
    for got, w in zip(q0[:2], qw[:2]):
        np.testing.assert_allclose(got.numpy(), w.numpy(), atol=1e-5)
    if case != "clip":
        assert float(r0["temp"]) == float(r1["temp"]) == want["temp"] == 0.5


@pytest.mark.parametrize("case", CASES)
def test_two_rank_step_needs_the_cross_rank_rows(two_ranks, case):
    """The control: each rank's ITC and mining over its own rows alone (a
    plain data-parallel port) misses the JAX step, which the 2-rank step
    meets."""
    want = two_ranks["want"][case]
    for got in two_ranks["got"]:
        ctl = got[case]["control"]
        assert _misses(ctl["metrics"], ctl["grads"], want)
        assert not _misses(got[case]["metrics"], got[case]["grads"], want)


def test_negative_all_rank_changes_the_step(two_ranks):
    """Mining over every rank's rows and over each rank's own picks other
    negatives here: the JAX steps for the knob's two values differ by more
    than the 2-rank steps are allowed to miss them (their gradients; the
    ITM loss of these random weights stays near ln 2 either way), so the
    checks above tell the values apart."""
    a, b = (two_ranks["want"][c] for c in CASES[:2])
    assert _misses(a["metrics"], a["grads"], b)


def test_unequal_rank_rows_refused(two_ranks):
    for got in two_ranks["got"]:
        assert "[1, 2]" in got["unequal"] and "same count" in got["unequal"]


def test_enqueue_refuses_a_batch_the_queue_size_does_not_hold():
    q = init_queue(E, 12, seed=0, device="cpu")
    feats = torch.zeros(8, E)
    with pytest.raises(ValueError, match="multiple of the global batch 8"):
        enqueue(q, feats, feats, torch.arange(8))
    enqueue(q, feats[:4], feats[:4], torch.arange(4))
    assert int(q.ptr) == 4


# --- the drivers on 2 ranks ---------------------------------------------------------


def _clip_setup(root):
    """A tiny CLIP ``.pth`` and a Flickr yaml on the fixture
    (``tests/test_torch_driver_clip.py``'s, with ``make_setup``'s fixture)."""
    from tests.test_torch_driver_clip import _tiny_cfg

    rng = np.random.RandomState(3)
    sd = export_clip(init_clip_params(_tiny_cfg(), rng))
    sd["space_dict"] = rng.randn(10, 64).astype(np.float32)
    pth = str(root / "clip.pth")
    save_torch_checkpoint(pth, sd, temperature=0.0)
    yaml_path = str(root / "clip.yaml")
    with open(yaml_path, "w") as f:
        f.write(f"image_root: {root}/images\nann_root: {root}/annotation\ndataset: flickr\n"
                "sd_dim: 64\nbatch_size_train: 4\nbatch_size_test: 4\nqueue_size: 8\n"
                "init_lr: 1e-4\nmin_lr: 0\nweight_decay: 0.2\nalpha: 0.4\n")
    return yaml_path, pth


@pytest.mark.parametrize("module", ["compress_retrieval", "compress_retrieval_clip"])
def test_driver_trains_on_two_ranks(tmp_path, module):
    """2 ranks, one compression epoch on the fixture's 8 train pairs (one
    batch of 4 a rank): the same ``LOG:`` lines, only rank 0 writes the
    config, the log, the checkpoints and the resume file, and both ranks end
    with the same parameters, optimizer state, momentum towers, queue and
    generator, bit for bit."""
    yaml_path, pth, _ = make_setup(tmp_path, "retrieval")
    if module == "compress_retrieval":
        with open(yaml_path, "a") as f:
            f.write("negative_all_rank: true\n")
    else:
        yaml_path, pth = _clip_setup(tmp_path)
    dirs = [str(tmp_path / f"o{r}") for r in range(2)]
    coord = f"127.0.0.1:{_free_port()}"
    procs, logs = [], []
    for r in range(2):
        logs.append(open(tmp_path / f"rank{r}.log", "wb"))
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, "driver", module, str(tmp_path), "--config", yaml_path,
             "--pretrained", pth, "--epoch", "1", "--p", "0.5", "--device", "cpu",
             "--num_processes", "2", "--process_id", str(r), "--coordinator", coord,
             "--dist_backend", "gloo", "--output_dir", dirs[r]],
            cwd=REPO, env=ENV, stdout=logs[r], stderr=subprocess.STDOUT))
    outs = _finish(procs, logs)
    lines = [[ln for ln in out.splitlines() if ln.startswith("LOG:")] for out in outs]
    assert lines[0] == lines[1] and any("epoch" in ln for ln in lines[0]), lines
    assert {"config.yaml", "log.txt", "resume_ckpt", "evaluate.txt"} <= set(os.listdir(dirs[0]))
    assert os.listdir(dirs[1]) == []
    states = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]
    for key in ("model", "extra"):
        assert states[0][key].keys() == states[1][key].keys()
        for name, t in states[0][key].items():
            assert torch.equal(t, states[1][key][name]), (key, name)
    assert any(k.startswith("params_m.") for k in states[0]["extra"])
    assert ("generator" in states[0]["extra"]) == (module == "compress_retrieval")
    o0, o1 = (s["optimizer"]["state"] for s in states)
    assert o0.keys() == o1.keys() and all(
        torch.equal(o0[i][k], o1[i][k]) for i in o0 for k in o0[i])


# --- the reference checkpoint's momentum towers ---------------------------------------


@pytest.mark.parametrize("with_momentum", [True, False], ids=["momentum", "online"])
def test_momentum_towers_load_like_jax(tmp_path, with_momentum):
    """``load_retrieval_momentum`` into ``init_retrieval_train_state`` against
    ``load_blip_retrieval(path, cfg, load_momentum=True)``: the ``*_m``
    towers and ``temp`` when the checkpoint has them, else copies of the
    online towers and 0.07."""
    rng = np.random.RandomState(9)
    params = _np(init_blip_params(JCFG, 0, heads=("retrieval",)))
    sd = {**export_vit(params["visual_encoder"], patch_size=16),
          **export_med(params["text_encoder"], "text_encoder."),
          "space_dict": params["space_dict"]}
    for name in ("vision_proj", "text_proj", "itm_head"):
        sd[f"{name}.weight"] = params[name]["kernel"].T
        sd[f"{name}.bias"] = params[name]["bias"]
    if with_momentum:
        m = {k: _perturbed(params[k], rng) for k in J_MOMENTUM_KEYS}
        sd.update(export_vit(m["visual_encoder"], "visual_encoder_m.", patch_size=16))
        sd.update(export_med(m["text_encoder"], "text_encoder_m."))
        for name in ("vision_proj", "text_proj"):
            sd[f"{name}_m.weight"] = m[name]["kernel"].T
            sd[f"{name}_m.bias"] = m[name]["bias"]
        sd["temp"] = np.asarray(0.05, np.float32)
    path = str(tmp_path / "retrieval.pth")
    save_torch_checkpoint(path, sd)
    jparams, jparams_m, jtemp, _ = load_blip_retrieval(path, JCFG, load_momentum=True)
    want = retrieval_train_state_from_jax(_np(jparams), _np(jparams_m), _queue(rng), jtemp,
                                          TCFG, device="cpu")
    ck, _ = read_checkpoint(path)
    model = load_retrieval_state_dict(ck, TCFG, device="cpu")
    params_m, temp = load_retrieval_momentum(ck, TCFG, device="cpu")
    assert (params_m is None) == (not with_momentum)
    state = init_retrieval_train_state(model, queue_size=Q, temp=temp, params_m=params_m)
    assert temp == pytest.approx(jtemp) and float(state.temp) == pytest.approx(
        0.05 if with_momentum else 0.07)
    assert state.params_m.keys() == want.params_m.keys()
    online = dict(model.named_parameters())
    for n, t in state.params_m.items():
        assert torch.equal(t, want.params_m[n]) and not t.requires_grad, n
        assert torch.equal(t, online[n]) is not with_momentum, n
