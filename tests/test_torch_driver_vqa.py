"""The port's VQAv2 driver (``madtp_tpu_torch/cli/compress_vqa.py``, ``--device
cpu``) against the JAX package's on ``tools/make_fixture.py``'s fixture
(``vit: tiny``, 96 px, ``--epoch 2``, 4 answer candidates), both from one
``--pretrained`` ``.pth``: equal GFLOPs each epoch, losses within 1e-4
relative, equal answers, the per-epoch checkpoints' tensors within
tolerance, and ``--evaluate`` on the last one reproducing that epoch's
answers and GFLOPs; and, on the port alone, a question with more than
``MAX_A`` = 10 answers keeps its first 10 without shifting the next
question's (the JAX driver's misalignment, ROADMAP C2)."""

import json
import os

import numpy as np
import pytest

from tests.test_torch_driver_common import few_threads  # noqa: F401  (a fixture)
from tests.test_torch_driver_common import (assert_checkpoints_match, assert_logs_match,
                                            make_setup, read_log, run_jax, run_port)

LR = 3e-4  # the yaml's init_lr; cosine over 2 epochs: 3e-4, 1.5e-4
MANY = [f"{a} {b}" for a in ("red", "blue", "cat") for b in ("dog", "two", "one", "no")]
pytestmark = pytest.mark.usefixtures("few_threads")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    return make_setup(tmp_path_factory.mktemp("vqa"), "vqa")


def _json(path):
    with open(path) as f:
        return json.load(f)


def test_vqa_driver_matches_jax(setup, tmp_path, monkeypatch):
    yaml_path, pth, _ = setup
    argv = ["--config", yaml_path, "--pretrained", pth, "--epoch", "2"]
    run_jax("vqa", [*argv, "--output_dir", str(tmp_path / "jax")], monkeypatch)
    run_port("vqa", [*argv, "--output_dir", str(tmp_path / "port")])
    jax_out, port_out = tmp_path / "jax", tmp_path / "port"
    got = read_log(port_out / "log.txt")
    assert [e["epoch"] for e in got] == [0, 1]
    assert_logs_match(read_log(jax_out / "log.txt"), got)
    for epoch in (0, 1):
        name = f"vqa_result_epoch{epoch}.json"
        assert _json(port_out / name) == _json(jax_out / name)
        assert len(_json(port_out / name)) == 8
        assert_checkpoints_match(jax_out / f"checkpoint_{epoch:02d}.pth",
                                 port_out / f"checkpoint_{epoch:02d}.pth", pth,
                                 2 * LR + (2 * LR / 2 if epoch else 0))
    run_port("vqa", ["--config", yaml_path, "--evaluate", "--output_dir",
                     str(port_out / "evaluate"), "--pretrained",
                     str(port_out / "checkpoint_01.pth")])
    assert _json(port_out / "evaluate" / "vqa_result.json") == \
        _json(port_out / "vqa_result_epoch1.json")
    assert read_log(port_out / "evaluate" / "evaluate.txt")[0] == \
        {"Cur_Gflops": got[1]["Cur_Gflops"]}


def test_vqa_generate_evaluate_matches_jax(setup, tmp_path, monkeypatch):
    """``inference: 'generate'``: ``--evaluate`` from the pretrained ``.pth``
    decodes the same answers and GFLOPs in both packages."""
    yaml_path, pth, _ = setup
    with open(yaml_path) as f:
        (tmp_path / "vqa.yaml").write_text(f.read() + "inference: generate\n")
    argv = ["--config", str(tmp_path / "vqa.yaml"), "--evaluate", "--pretrained", pth]
    run_jax("vqa", [*argv, "--output_dir", str(tmp_path / "jax")], monkeypatch)
    run_port("vqa", [*argv, "--output_dir", str(tmp_path / "port")])
    got = _json(tmp_path / "port" / "vqa_result.json")
    assert got == _json(tmp_path / "jax" / "vqa_result.json") and len(got) == 8
    assert read_log(tmp_path / "port" / "evaluate.txt") == read_log(tmp_path / "jax" /
                                                                   "evaluate.txt")


def test_vqa_more_than_ten_answers(setup, tmp_path, monkeypatch):
    """Question 0 of the train split gets 12 distinct answers: its training
    row holds the first 10 (weights 1/12 each), and question 1's row its own
    answers, as the driver's train step receives them."""
    import madtp_tpu_torch.tasks.vqa as tvqa
    from madtp_tpu_torch.data.tokenizer_bert import BertWordPieceTokenizer

    yaml_path, pth, config = setup
    ann = tmp_path / "annotation"
    os.makedirs(ann)
    for name in os.listdir(config["ann_root"]):
        data = _json(os.path.join(config["ann_root"], name))
        if name == "vqa_train.json":
            data = [dict(data[0], answer=MANY)] + data[1:]
        with open(ann / name, "w") as f:
            json.dump(data, f)
    with open(yaml_path) as f:
        text = f.read().replace(config["ann_root"], str(ann))
    (tmp_path / "vqa.yaml").write_text(text)
    seen = []
    real = tvqa.train_batch

    def record(tokenizer, questions, answers, weights, counts):
        out = real(tokenizer, questions, answers, weights, counts)
        seen.append(((list(questions), list(answers), np.asarray(weights), list(counts)), out))
        return out

    monkeypatch.setattr(tvqa, "train_batch", record)
    run_port("vqa", ["--config", str(tmp_path / "vqa.yaml"), "--pretrained", pth, "--epoch", "1",
                     "--output_dir", str(tmp_path / "out")])
    tok = BertWordPieceTokenizer(config["bert_vocab"])
    hits = 0
    for (questions, answers, weights, counts), (q_ids, q_mask, ids, msk, w) in seen:
        flat_ids, flat_mask = tvqa.tokenize_answers(tok, answers)
        pos = 0
        for b, n in enumerate(counts):
            k = min(n, 10)
            np.testing.assert_array_equal(ids[b, :k], flat_ids[pos:pos + k])
            np.testing.assert_array_equal(msk[b, :k], flat_mask[pos:pos + k])
            np.testing.assert_array_equal(w[b, :k], weights[pos:pos + k])
            assert not ids[b, k:].any() and not w[b, k:].any()
            if n > 10:
                hits += 1
                assert answers[pos:pos + n] == MANY
                np.testing.assert_allclose(w[b, :10], 1 / 12)
            pos += n
        assert pos == len(answers)
    assert hits == 1

