"""The port's multi-process runs on the CPU over gloo, against its own
one-process runs and the JAX package's one-process step (the counterpart of
``tests/test_multiprocess.py``, whose JAX cases stay as they are).

* ``reference_row_shard`` covers every row once, empty and start > end
  shards included.
* The drivers as real processes (``--synthetic --device cpu``): the 2-process
  BLIP retrieval eval and the 4-process one on degenerate shards, the
  2-process CLIP eval with the sharded tower encode, all bit-equal to one
  process on every rank; caption and VQA results merged by rank 0 in a
  shared directory, on the synthetic batches and on the fixture's test split
  (against one process); the NLVR driver's identical ``LOG:`` lines with only
  rank 0 writing; SIGTERM to one rank stops both on the same batch.
* One train step of NLVR, caption and VQA on 2 ranks (``torch_mp_worker.py``)
  against the JAX package's step on the global batch: every logged loss
  within 1e-4, the gradients within atol 1e-5 + rtol 1e-3 (fp32, summed in
  another order), the parameters after one AdamW step at the config's
  learning rate within ``CKPT_TOL`` of their scale beyond what the
  gradients' difference moves Adam's first step (an element whose gradient
  is near Adam's eps, such as an attention key bias's, steps by a share of
  the learning rate set by the gradient's last bits).  The
  ranks' own DTP maxima differ on these batches (asserted), and with each
  rank's own max the NLVR step misses the JAX one: the cross-rank max is
  what makes them agree.  The caption and VQA ranks hold unequal token and
  answer counts.
* ``all_gather_with_grad`` against a one-process concat, and the other
  helpers' values.

Every process runs one intra-op thread, so a sharded run and its one-process
reference add in the same order."""

import dataclasses
import json
import os
import signal
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _nlvr_setup
from madtp_tpu.cli.common import init_blip_params
from madtp_tpu.core.config import MedConfig as JMedConfig
from madtp_tpu.core.config import ViTConfig as JViTConfig
from madtp_tpu.models.blip import BlipConfig as JBlipConfig
from madtp_tpu.train import optim as JO
from madtp_tpu.train.loops import make_caption_train_step as j_caption_step
from madtp_tpu.train.loops import make_nlvr_train_step as j_nlvr_step
from madtp_tpu.train.loops import make_vqa_train_step as j_vqa_step
from madtp_tpu_torch.ckpt.convert import (caption_from_jax_params, nlvr_from_jax_params,
                                          vqa_from_jax_params)
from madtp_tpu_torch.core.config import BlipConfig, MedConfig, ViTConfig
from madtp_tpu_torch.data.tokenizer_bert import BertWordPieceTokenizer
from madtp_tpu_torch.parallel.dist import reference_row_shard
from madtp_tpu_torch.tasks import caption as TC
from madtp_tpu_torch.tasks import vqa as TV
from tests.test_torch_driver_common import CKPT_TOL, make_setup

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO, "MADTP_DUMP_SCORES": "1"}
TIMEOUT = 300
FAMILIES = ("nlvr", "caption", "vqa")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn(cmd, n, out_dirs, log_dir):
    coord = f"127.0.0.1:{_free_port()}"
    procs, logs = [], []
    for r in range(n):
        log = open(os.path.join(log_dir, f"rank{r}.log"), "wb")
        logs.append(log)
        procs.append(subprocess.Popen(
            cmd + ["--num_processes", str(n), "--process_id", str(r), "--coordinator", coord,
                   "--output_dir", out_dirs[r]],
            cwd=REPO, env=ENV, stdout=log, stderr=subprocess.STDOUT))
    return procs, logs


def _finish(procs, logs):
    outs = []
    try:
        for r, p in enumerate(procs):
            p.wait(timeout=TIMEOUT)
            logs[r].close()
            with open(logs[r].name, errors="replace") as f:
                outs.append(f.read())
            assert p.returncode == 0, f"rank {r} rc={p.returncode}:\n{outs[-1][-3000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs


def _driver(family):
    return [sys.executable, "-m", f"madtp_tpu_torch.cli.compress_{family}", "--device", "cpu"]


def _launch(family, args, n, out_dirs, log_dir, single_dir=None):
    """``n`` ranks of a driver, and with ``single_dir`` its one-process run
    beside them; returns the ranks' outputs."""
    procs, logs = _spawn(_driver(family) + args, n, out_dirs, log_dir)
    if single_dir is not None:
        one = subprocess.run(_driver(family) + args + ["--output_dir", single_dir], cwd=REPO,
                             env=ENV, capture_output=True, timeout=TIMEOUT)
        assert one.returncode == 0, one.stdout.decode()[-3000:] + one.stderr.decode()[-2000:]
    return _finish(procs, logs)


def _read(path):
    with open(path) as f:
        return f.read()


def test_global_batch_scope_is_inert_in_one_process():
    """Without a process group the scope changes nothing: no step spans
    ranks and the DTP counts pass through as they are."""
    from madtp_tpu_torch.parallel import data

    counts = (torch.tensor(3), torch.tensor(5))
    with data.global_batch():
        assert not data.spans()
        got = data.batch_max(*counts)
        assert len(got) == 2 and all(a is b for a, b in zip(got, counts))


def test_reference_row_shard_coverage_unit():
    """The ``n // world + 1`` stepping gives empty and start > end shards
    when world is large against n (n=4, world=4: rank 2 [4, 4), rank 3 [6,
    4)); every (n, world) still covers [0, n) once."""
    assert reference_row_shard(4, 4, 2) == (4, 4) and reference_row_shard(4, 4, 3) == (6, 4)
    for n in (1, 2, 3, 4, 5, 6, 10, 17, 100):
        for world in (1, 2, 3, 4, 5, 8, 16):
            seen = []
            for rank in range(world):
                lo, hi = reference_row_shard(n, world, rank)
                seen.extend(range(lo, max(lo, hi)))
            assert seen == list(range(n)), (n, world, seen)


@pytest.mark.parametrize("n,corpus", [(2, 6), (4, 10), (4, 4)])
def test_retrieval_eval_scores_bitexact(tmp_path, n, corpus):
    """The BLIP retrieval ``--evaluate`` on ``n`` ranks: the merged score
    matrices on every rank and rank 0's metrics equal one process's bit for
    bit.  4 ranks over 10 texts shard the rerank rows [0, 3), [3, 6), [6,
    9), [9, 10); over 4 they give an empty and a start > end shard, and the
    4 image batches' blocks of 2 (3 + 1 images) leave two ranks empty."""
    dirs = [str(tmp_path / f"r{r}") for r in range(n)]
    single = str(tmp_path / "single")
    _launch("retrieval", ["--synthetic", "--evaluate", "--synthetic_corpus", str(corpus)], n,
            dirs, str(tmp_path), single)
    want = np.load(os.path.join(single, "scores.npz"))
    for r in range(n):
        got = np.load(os.path.join(dirs[r], f"scores_r{r}.npz"))
        assert np.array_equal(got["i2t"], want["i2t"]), r
        assert np.array_equal(got["t2i"], want["t2i"]), r
    assert _read(os.path.join(dirs[0], "evaluate.txt")) == _read(
        os.path.join(single, "evaluate.txt"))
    assert not any(os.path.exists(os.path.join(d, "evaluate.txt")) for d in dirs[1:])


def test_clip_eval_sharded_encode_bitexact(tmp_path):
    """2 ranks of the CLIP ``--evaluate`` at 2 images a batch: 3 batches a
    tower, so each rank encodes a block of both towers; the gathered
    similarities on every rank and rank 0's metrics and GFLOPs equal one
    process's."""
    dirs = [str(tmp_path / f"c{r}") for r in range(2)]
    single = str(tmp_path / "single")
    outs = _launch("retrieval_clip", ["--synthetic", "--evaluate", "--batch_size_test", "2"], 2,
                   dirs, str(tmp_path), single)
    want = np.load(os.path.join(single, "clip_sims_r0.npz"))["sims"]
    for r in range(2):
        assert np.array_equal(np.load(os.path.join(dirs[r], f"clip_sims_r{r}.npz"))["sims"],
                              want), r
    assert _read(os.path.join(dirs[0], "evaluate.txt")) == _read(
        os.path.join(single, "evaluate.txt"))
    assert outs[0].count("LOG:") == outs[1].count("LOG:") == 1


@pytest.mark.parametrize("family,name,key", [("caption", "test_epoch_eval", "image_id"),
                                             ("vqa", "vqa_result", "question_id")])
def test_eval_results_merged_by_rank0(tmp_path, family, name, key):
    """2 ranks in one shared output directory: each writes its JSON, rank 0
    merges them after the barrier and drops the duplicates (the synthetic
    loaders give both ranks the same batches, so the merge is rank 0's)."""
    shared = str(tmp_path / "shared")
    outs = _launch(family, ["--synthetic"], 2, [shared, shared], str(tmp_path))
    rank0, rank1, merged = (json.loads(_read(os.path.join(shared, f"{name}{s}.json")))
                            for s in ("_rank0", "_rank1", ""))
    assert rank0 and rank0 == rank1
    assert merged == rank0 and len({r[key] for r in merged}) == len(merged)
    logs = [[line for line in out.splitlines() if line.startswith("LOG:")] for out in outs]
    assert logs[0] == logs[1] and logs[0]


@pytest.fixture(scope="module")
def fixture_split(tmp_path_factory):
    """``tools/make_fixture.py``'s split with the family's yaml and
    pretrained ``.pth`` (``make_setup``), built once a family."""
    built = {}

    def get(family):
        if family not in built:
            built[family] = make_setup(tmp_path_factory.mktemp(family), family)
        return built[family]
    return get


@pytest.mark.parametrize("family,name,key,n", [("caption", "test_epoch_eval", "image_id", 2),
                                               ("vqa", "vqa_result", "question_id", 2),
                                               ("vqa", "vqa_result", "question_id", 3)])
def test_eval_split_merged_equals_one_process(fixture_split, tmp_path, family, name, key, n):
    """``--evaluate`` on the fixture's 8-item test split, ``n`` ranks in one
    shared directory: the loader strides the split over the ranks (3 ranks
    pad it to 9, so one item is evaluated twice), and rank 0's merged JSON
    holds each item once and equals one process's results.  One item a
    batch, so a sharded item is computed as in the one-process run."""
    yaml_path, pth, _ = fixture_split(family)
    shared, single = str(tmp_path / "shared"), str(tmp_path / "single")
    _launch(family, ["--config", yaml_path, "--evaluate", "--pretrained", pth,
                     "--batch_size_test", "1"], n, [shared] * n, str(tmp_path), single)
    parts = [json.loads(_read(os.path.join(shared, f"{name}_rank{r}.json"))) for r in range(n)]
    merged = json.loads(_read(os.path.join(shared, f"{name}.json")))
    want = json.loads(_read(os.path.join(single, f"{name}.json")))
    ids = [res[key] for res in merged]
    assert len(want) == 8 and len(ids) == len(set(ids)) == 8
    assert sum(map(len, parts)) == -(-8 // n) * n
    assert {res[key] for res in parts[1]} - {res[key] for res in parts[0]}
    assert sorted(merged, key=lambda res: res[key]) == sorted(want, key=lambda res: res[key])
    assert not os.path.exists(os.path.join(single, f"{name}_rank1.json"))


def test_nlvr_driver_trains_on_two_ranks(tmp_path):
    """The NLVR driver, 2 ranks, one compression epoch: both print the same
    ``LOG:`` lines (global train losses, summed eval totals), and only rank
    0 writes the config, the logs and the checkpoints."""
    dirs = [str(tmp_path / f"n{r}") for r in range(2)]
    outs = _launch("nlvr", ["--synthetic", "--epoch", "1"], 2, dirs, str(tmp_path))
    logs = [[line for line in out.splitlines() if line.startswith("LOG:")] for out in outs]
    assert logs[0] == logs[1] and len(logs[0]) == 3, logs
    assert sorted(os.listdir(dirs[0])) == ["checkpoint_best.pth", "config.yaml", "log.txt",
                                           "resume_ckpt"]
    assert os.listdir(dirs[1]) == []


def test_sigterm_to_one_rank_stops_both(tmp_path):
    """SIGTERM to rank 1 alone: the flag is OR-reduced over the ranks, so
    both leave the step loop after the same batch, rank 0 saves the resume
    checkpoint, and both exit 0."""
    dirs = [str(tmp_path / f"p{r}") for r in range(2)]
    procs, logs = _spawn(_driver("nlvr") + ["--synthetic", "--epoch", "500"], 2, dirs,
                         str(tmp_path))
    try:
        deadline = time.time() + TIMEOUT
        while "preemption guard armed" not in _read(logs[1].name):
            assert procs[1].poll() is None and time.time() < deadline, _read(logs[1].name)
            time.sleep(0.2)
        time.sleep(1.0)  # into the step loop
        procs[1].send_signal(signal.SIGTERM)
    finally:
        outs = _finish(procs, logs)
    stops = [[line for line in out.splitlines() if "preempted" in line] for out in outs]
    assert stops[0] == stops[1] and len(stops[0]) == 1, stops
    assert os.path.exists(os.path.join(dirs[0], "resume_ckpt"))
    assert not os.path.exists(os.path.join(dirs[1], "resume_ckpt"))


# --- one train step on 2 ranks against the JAX step on the global batch -------

LR, WD = 1e-5, 0.05
WORDS = ("a picture of dog cat man woman sitting on the table with red blue in front street "
         "car what is color yes no two").split()
TOKENIZER = BertWordPieceTokenizer.toy(WORDS)
V = len(TOKENIZER.vocab)
VIT = dict(image_size=64, patch_size=16, embed_dim=64, depth=2, num_heads=4, sd_dim=64)
MED = dict(vocab_size=V, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
           intermediate_size=128, max_position_embeddings=40, encoder_width=64, sd_dim=64)
JCFG = JBlipConfig(JViTConfig(**VIT), JMedConfig(**MED), sd_num=8, sd_dim=64)
TCFG = BlipConfig(ViTConfig(**VIT), MedConfig(**MED), sd_num=8, sd_dim=64)
CAPTIONS = [["a picture of a dog sitting on the table with a red car in front of the man",
             "a picture of the woman sitting in front of a blue car on the street"],
            ["a picture of a cat", "a picture of a man"]]  # 24 tokens to predict against 4
QUESTIONS = [(["what is the man sitting on", "what color is the car"],
              ["table", "the table", "street", "red", "blue"], [0.5, 0.3, 0.2, 0.7, 0.3],
              [3, 2]),
             (["is the dog on the car", "what is the woman sitting on"],
              ["yes", "two", "no", "car", "the car", "red table"], [1.0, 0.4, 0.3, 0.2, 0.1, 0.5],
              [1, 5])]  # 5 answers a rank against 6, split 3 + 2 against 1 + 5


def _nlvr_job():
    """NLVR as tests/test_torch_train.py sets it up (96 px, 3 + 3 layers,
    T=20, a padded caption), one pair a rank."""
    jcfg, params, images, ids, mask, targets = _nlvr_setup(
        image_size=96, B=2, text_len=12,
        vit_kw=dict(embed_dim=64, depth=3, num_heads=4),
        med_kw=dict(hidden_size=64, num_hidden_layers=3, num_attention_heads=4,
                    intermediate_size=128, merge_start_layer=1, vocab_size=500,
                    max_position_embeddings=64))
    tcfg = BlipConfig(ViTConfig(**dataclasses.asdict(jcfg.vit)),
                      MedConfig(**dataclasses.asdict(jcfg.med)), jcfg.sd_num, jcfg.sd_dim)
    images, ids, mask = (np.asarray(a).copy() for a in (images, ids, mask))
    mask[1, 9:] = 0
    ids[:, 0] = 2
    targets = np.array([0, 1])
    tree = jax.tree.map(np.asarray, params)
    batches = [(images[[r, 2 + r]], ids[r:r + 1], mask[r:r + 1], targets[r:r + 1])
               for r in range(2)]
    return dict(family="nlvr", temperature=20.0, jcfg=jcfg, tree=tree,
                model=nlvr_from_jax_params(tree, tcfg, device="cpu"), batches=batches,
                glob=(images, ids, mask, targets),
                convert=lambda t: nlvr_from_jax_params(t, tcfg, device="cpu"),
                jstep=lambda tx: j_nlvr_step(jcfg, tx))


def _caption_job():
    tree = jax.tree.map(np.asarray, init_blip_params(JCFG, 0, heads=(), with_encoder=False,
                                                     with_decoder=True))
    rng = np.random.RandomState(2)
    images = rng.randn(4, 3, 64, 64).astype(np.float32)
    prompt = len(TOKENIZER.encode(TC.PROMPT)) - 1
    parts = [TC.train_batch(TOKENIZER, c, prompt, fixed=True) for c in CAPTIONS]
    batches = [(images[2 * r:2 * r + 2], *parts[r]) for r in range(2)]
    return dict(family="caption", temperature=2.0, jcfg=JCFG, tree=tree,
                model=caption_from_jax_params(tree, TCFG, device="cpu"), batches=batches,
                glob=(images, *(np.concatenate(a) for a in zip(*parts))),
                convert=lambda t: caption_from_jax_params(t, TCFG, device="cpu"),
                jstep=lambda tx: j_caption_step(JCFG, tx))


def _vqa_job():
    tree = jax.tree.map(np.asarray, init_blip_params(JCFG, 0, heads=(), with_decoder=True))
    rng = np.random.RandomState(3)
    images = rng.randn(4, 3, 64, 64).astype(np.float32)
    parts = [TV.train_batch(TOKENIZER, *q, fixed=True) for q in QUESTIONS]
    batches = [(images[2 * r:2 * r + 2], *parts[r]) for r in range(2)]
    return dict(family="vqa", temperature=2.0, jcfg=JCFG, tree=tree,
                model=vqa_from_jax_params(tree, TCFG, device="cpu"), batches=batches,
                glob=(images, *(np.concatenate(a) for a in zip(*parts))),
                convert=lambda t: vqa_from_jax_params(t, TCFG, device="cpu"),
                jstep=lambda tx: j_vqa_step(JCFG, tx, TV.MAX_A))


def _jax_step(job):
    """The JAX step on the global batch: its metrics, the parameters after it
    and the gradients (Adam's first moment after one step is 0.1 g), in the
    port's names."""
    tx = JO.make_adamw_injectable(WD)
    params = jax.tree.map(jnp.asarray, job["tree"])
    state = tx.init(params)
    state.hyperparams["learning_rate"] = jnp.float32(LR)
    params, state, metrics = job["jstep"](tx)(params, state, *map(jnp.asarray, job["glob"]),
                                             jnp.float32(job["temperature"]))
    grads = jax.tree.map(lambda m: np.asarray(m) / 0.1, state.inner_state[0].mu)
    return ({k: float(v) for k, v in metrics.items()},
            job["convert"](grads).state_dict(),
            job["convert"](jax.tree.map(np.asarray, params)).state_dict())


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Both ranks' results (``torch_mp_worker.py``) and the JAX steps."""
    root = tmp_path_factory.mktemp("mp_steps")
    jobs = {f: make() for f, make in zip(FAMILIES, (_nlvr_job, _caption_job, _vqa_job))}
    rng = np.random.RandomState(5)
    gather = {k: [torch.from_numpy(rng.randn(n, 3).astype(np.float32)) for _ in range(2)]
              for k, n in (("x", 2), ("w", 4))}
    torch.save({**{f: {k: j[k] for k in ("family", "model", "batches", "temperature")}
                   | {"lr": LR, "wd": WD} for f, j in jobs.items()}, "gather": gather},
               root / "job.pt")
    coord = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen([sys.executable, os.path.join(REPO, "tests", "torch_mp_worker.py"),
                               str(r), "2", coord, str(root / "job.pt"), str(root)],
                              cwd=REPO, env=ENV, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for r in range(2)]
    want = {f: _jax_step(j) for f, j in jobs.items()}  # while the ranks run
    try:
        for r, p in enumerate(procs):
            out = p.communicate(timeout=TIMEOUT)[0].decode()
            assert p.returncode == 0, f"rank {r}:\n{out[-3000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    got = [torch.load(root / f"rank{r}.pt", weights_only=False) for r in range(2)]
    return dict(got=got, want=want, jobs=jobs, gather=gather)


def _grads_match(got, want):
    return all(np.allclose(g.numpy(), want[n].numpy(), atol=1e-5, rtol=1e-3)
               for n, g in got.items())


@pytest.mark.parametrize("family", FAMILIES)
def test_two_rank_step_matches_jax_global_batch(two_ranks, family):
    got, (jm, jgrads, jparams) = two_ranks["got"], two_ranks["want"][family]
    r0, r1 = got[0][family], got[1][family]
    # the ranks' own batch maxima differ somewhere: alone they would prune apart
    assert not torch.equal(r0["counts"], r1["counts"]), (r0["counts"], r1["counts"])
    assert r0["metrics"] == r1["metrics"]
    for k, v in jm.items():
        assert r0["metrics"][k] == pytest.approx(v, abs=1e-4), (k, r0["metrics"], jm)
    for name, g in r0["grads"].items():
        assert torch.equal(g, r1["grads"][name]), name
        np.testing.assert_allclose(g.numpy(), jgrads[name].numpy(), atol=1e-5, rtol=1e-3,
                                   err_msg=name)
    for name, p in r0["state"].items():
        assert torch.equal(p, r1["state"][name]), name
        a, b = jparams[name].numpy(), p.numpy()
        # beyond CKPT_TOL of the tensor's scale, what the two gradients'
        # difference (held above) moves AdamW's first update lr g / (|g| + eps):
        # up to the step itself where |g| is near eps
        gj, gp = jgrads[name].numpy(), r0["grads"][name].numpy()
        moved = LR * np.abs(gj / (np.abs(gj) + 1e-8) - gp / (np.abs(gp) + 1e-8))
        scale = max(float(np.abs(a).max()), LR)
        over = np.abs(a - b) - moved - CKPT_TOL * scale
        assert over.max() <= 0, (name, float(np.abs(a - b).max()), float(over.max()))


def test_two_rank_step_needs_the_cross_rank_max(two_ranks):
    """The control: the same NLVR step with each rank's own count max (a
    plain data-parallel port) misses the JAX step on the global batch."""
    jm, jgrads, _ = two_ranks["want"]["nlvr"]
    metrics, grads, _ = two_ranks["got"][0]["nlvr"]["control"]
    assert (max(abs(metrics[k] - v) for k, v in jm.items()) > 1e-4
            or not _grads_match(grads, jgrads))
    assert _grads_match(two_ranks["got"][0]["nlvr"]["grads"], jgrads)


def test_all_gather_with_grad_matches_one_process_concat(two_ranks):
    """Forward: both ranks' rows in rank order.  Backward: rank r's gradient
    is its slice of the gradient of every rank's loss, as when one process
    concatenates both and sums the losses."""
    x, w = two_ranks["gather"]["x"], two_ranks["gather"]["w"]
    cat = torch.cat(x).requires_grad_(True)
    sum((cat * wr).sum() for wr in w).backward()
    for r in range(2):
        y, g = two_ranks["got"][r]["gather"]
        assert torch.equal(y, torch.cat(x))
        lo = sum(len(t) for t in x[:r])
        torch.testing.assert_close(g, cat.grad[lo:lo + len(x[r])], rtol=1e-6, atol=1e-6)


def test_dist_helpers_over_gloo(two_ranks):
    for r in range(2):
        h = two_ranks["got"][r]["helpers"]
        assert (h["index"], h["count"], h["main"]) == (r, 2, r == 0)
        assert h["row_shard"] == reference_row_shard(10, 2, r)
        np.testing.assert_array_equal(h["allgather"], [[0, 1, 2], [10, 11, 12]])
        np.testing.assert_array_equal(h["allgather_bool"], [[True, True], [False, True]])
        np.testing.assert_array_equal(h["sum"], np.array([1.5, 2.0 ** -30])
                                      + np.array([2.5, 2.0 ** -30]))
        want = np.full((3, 3), -100.0, np.float32)
        want[0], want[1] = [-250.0, 0.5, 0.0], [-251.0, 0.5, 1.0]
        np.testing.assert_array_equal(h["merge"], want)
        assert torch.equal(h["rows"], torch.tensor([[0.0, 0.0], [1.0, 1.0], [2.0, 2.0]]))
        assert torch.equal(h["concat"], torch.tensor([0.0, 0.0, 1.0, 1.0]))
        assert not h["concat"].requires_grad
        assert torch.equal(h["max"], torch.tensor([1, 5]))
