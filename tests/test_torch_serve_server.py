"""The port's HTTP serving (``madtp_tpu_torch/serve/server.py``) on the CPU:
the counterparts of ``tests/test_serve_server.py`` on artifacts the port's
exporter writes from a tiny seeded NLVR model (64 px, two layers).

Held: the wire codec is exact for float32, integers and bfloat16, and
byte-compatible with the JAX package's in both directions (a JAX client
against the port's server, the port's client against a JAX server); the
error paths 400, 404, 413 and 503; sub-batch padding; merging on a
row-independent artifact and never on a coupled one; capacity overflow in
``/stats``; the retrieval pipeline of three units over HTTP; ``python -m
madtp_tpu_torch.cli.serve --device cpu`` in a subprocess.  Replies equal the
artifact's own call bit for bit."""

import concurrent.futures
import http.client
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from madtp_tpu_torch.cli import export_serving
from madtp_tpu_torch.serve import load_artifact
from madtp_tpu_torch.serve.server import (ArtifactServer, ServingClient, _Pending,
                                          decode_arrays, decode_tensors, encode_arrays)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, T = 2, 12


def _yaml(root):
    path = os.path.join(root, "tiny.yaml")
    with open(path, "w") as f:
        f.write("vit: tiny\nimage_size: 64\n")
    return path


def _export(root, name, *extra, task="nlvr"):
    out = os.path.join(root, name)
    export_serving.main(["--task", task, "--config", _yaml(root), "--output_dir", out,
                         "--batch", str(B), "--device", "cpu", *extra])
    return out


def _batch(seed, n=B):
    rng = np.random.RandomState(seed)
    images = rng.randn(2 * n, 3, 64, 64).astype(np.float32)
    ids = rng.randint(1, 30000, size=(n, T)).astype(np.int32)
    mask = np.ones((n, T), np.int32)
    mask[-1, 9:] = 0
    return images, ids, mask


def _pair(images, j, n=B):
    """Sample j's image pair as a one-sample request (two one-row blocks)."""
    return np.stack([images[j], images[n + j]])


def _args(root, name, *extra, task="nlvr"):
    return export_serving.build_parser().parse_args(
        ["--task", task, "--config", _yaml(root), "--output_dir", os.path.join(root, name),
         "--batch", str(B), "--device", "cpu", *extra])


@pytest.fixture(scope="module")
def arts(tmp_path_factory):
    """Coupled and row-independent fp32 artifacts through the CLI, and a
    bfloat16 one from a bfloat16 model through the exporter's function."""
    from madtp_tpu_torch.cli.common import build_blip_cfg
    from madtp_tpu_torch.models.blip import init_nlvr_model

    root = str(tmp_path_factory.mktemp("arts"))
    model = init_nlvr_model(build_blip_cfg({"vit": "tiny", "image_size": 64}, 64,
                                           twin_cross=True),
                            seed=0, device="cpu", dtype=torch.bfloat16)
    export_serving.export_nlvr(_args(root, "bf16", "--text_len", str(T), "--temperature", "1.0"),
                               {}, torch.device("cpu"), model=model)
    return {"coupled": _export(root, "coupled", "--text_len", str(T)),
            "rowind": _export(root, "rowind", "--text_len", str(T), "--row_independent"),
            "bf16": os.path.join(root, "bf16")}


@pytest.fixture(scope="module")
def coupled(arts):
    srv = ArtifactServer(arts["coupled"], device="cpu")
    srv.start_background()
    yield srv
    srv.shutdown()


@pytest.fixture(scope="module")
def rowind(arts):
    srv = ArtifactServer(arts["rowind"], device="cpu")
    srv.start_background()
    yield srv
    srv.shutdown()


# ---------------------------------------------------------------- the codec


def test_wire_codec_exact():
    bf = torch.linspace(-2, 2, 8).to(torch.bfloat16).reshape(2, 4)
    arrays = [np.arange(6, dtype=np.float32).reshape(2, 3), np.asarray(3, np.int64),
              np.arange(4, dtype=np.int32), bf, np.zeros((), np.float32),
              np.array([True, False])]
    back = decode_tensors(encode_arrays(arrays))
    assert len(back) == len(arrays)
    for a, b in zip(arrays, back):
        a = torch.as_tensor(a)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                           b.view(torch.int16) if b.dtype == torch.bfloat16 else b)
    as_np = decode_arrays(encode_arrays(arrays))
    assert as_np[3].dtype == np.float32 and np.array_equal(as_np[3], bf.float().numpy())


def test_wire_codec_matches_jax_both_ways():
    """The same npz members and sidecar as the JAX codec; each package
    decodes the other's bytes to the same dtypes and bits."""
    import ml_dtypes

    from madtp_tpu.serve.server import decode_arrays as j_decode
    from madtp_tpu.serve.server import encode_arrays as j_encode

    values = np.linspace(-3, 3, 12, dtype=np.float32).reshape(3, 4)
    j_arrays = [values, np.arange(5, dtype=np.int32), values.astype(ml_dtypes.bfloat16)]
    t_arrays = [values, np.arange(5, dtype=np.int32), torch.from_numpy(values).bfloat16()]
    j_bytes, t_bytes = j_encode(j_arrays), encode_arrays(t_arrays)
    with np.load(__import__("io").BytesIO(j_bytes)) as zj, \
            np.load(__import__("io").BytesIO(t_bytes)) as zt:
        assert zj.files == zt.files
        for k in zj.files:
            assert zj[k].dtype == zt[k].dtype and np.array_equal(zj[k], zt[k]), k
    got = decode_tensors(j_bytes)
    assert got[2].dtype == torch.bfloat16
    assert np.array_equal(got[2].view(torch.int16).numpy(),
                          j_arrays[2].view(np.int16))
    back = j_decode(t_bytes)
    assert back[2].dtype == ml_dtypes.bfloat16
    assert np.array_equal(back[2].view(np.int16), j_arrays[2].view(np.int16))


# ---------------------------------------------------------------- a coupled artifact


def test_server_predict_parity(coupled):
    """A full batch over HTTP equals the artifact's own call bit for bit;
    the temperature is a live input."""
    client = ServingClient(coupled.url)
    assert client.healthy() and client.meta["task"] == "nlvr"
    images, ids, mask = _batch(0)
    got = client.predict(images, ids, mask, np.float32(1.0))
    want = coupled.model(images, ids, mask, np.float32(1.0))
    for g, w in zip(got, want):
        assert np.array_equal(g, w.numpy())
    alt = client.predict(images, ids, mask, np.float32(8.0))
    assert not np.array_equal(alt[1], got[1])


def test_server_rejects_bad_requests(coupled):
    client = ServingClient(coupled.url)
    images, ids, mask = _batch(1)
    t = np.float32(1.0)
    with pytest.raises(RuntimeError, match=r"\(400\).*expected 4 input arrays"):
        client.predict(images)
    with pytest.raises(RuntimeError, match=r"\(400\).*disagrees"):
        client.predict(images[:2], ids, mask, t)  # images say n=1, ids carry 2
    with pytest.raises(RuntimeError, match=r"\(400\).*not castable"):
        client.predict(images, ids, mask, np.asarray(3, np.int32))
    with pytest.raises(RuntimeError, match=r"\(400\).*trailing dims"):
        client.predict(images[:, :, :8], ids, mask, t)
    with pytest.raises(RuntimeError, match=r"\(404\).*unknown artifact"):
        client.predict(images, ids, mask, t, name="nope")


def _post(srv, body: bytes, claim_len=None, path="/predict"):
    host, port = srv.server_address
    conn = http.client.HTTPConnection(host, port, timeout=30)
    try:
        conn.putrequest("POST", path)
        conn.putheader("Content-Length", str(len(body) if claim_len is None else claim_len))
        conn.endheaders()
        if body:
            conn.send(body)
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def test_server_rejects_malformed_and_oversized_bodies(coupled):
    """400 for a body that is not an npz and for an empty one, 413 for a
    Content-Length over the budget before it is read, 404 off the routes."""
    code, body = _post(coupled, b"this is not an npz archive")
    assert code == 400 and b"npz" in body
    assert _post(coupled, b"")[0] == 400
    code, body = _post(coupled, b"x", claim_len=coupled.default.max_body_bytes() + 1)
    assert code == 413 and b"budget" in body
    assert _post(coupled, b"x", path="/nowhere")[0] == 404


def test_server_sub_batch(coupled):
    """A one-sample request is padded with its own rows: it equals the
    artifact's call on the self-padded batch, row for row."""
    client = ServingClient(coupled.url)
    images, ids, mask = _batch(2)
    sub = client.predict(_pair(images, 0), ids[:1], mask[:1], np.float32(1.0))
    assert sub[0].shape == (1, 2)
    padded = np.concatenate([np.repeat(images[:1], B, 0), np.repeat(images[B:B + 1], B, 0)])
    want = coupled.model(padded, np.repeat(ids[:1], B, 0), np.repeat(mask[:1], B, 0),
                         np.float32(1.0))
    assert np.array_equal(sub[0][0], want[0][0].numpy())
    assert sub[1].shape == tuple(want[1].shape)  # unbatched outputs pass whole


def test_coupled_artifact_never_merges(coupled):
    rt = coupled.default
    assert not rt._aggregate and rt._dispatcher is None
    client = ServingClient(coupled.url)
    images, ids, mask = _batch(3)

    def one(j):
        return client.predict(_pair(images, j), ids[j:j + 1], mask[j:j + 1], np.float32(1.0))

    solo = [one(0), one(1)]
    with concurrent.futures.ThreadPoolExecutor(4) as ex:
        outs = list(ex.map(one, [0, 1, 0, 1]))
    for got, j in zip(outs, [0, 1, 0, 1]):
        assert np.array_equal(got[0], solo[j][0])
    assert rt.stats["merged"] == 0


# ---------------------------------------------------------------- interoperation


def test_jax_client_against_port_server(arts):
    """The JAX package's client against the port's server, on a bfloat16
    artifact: float32 images cast to the bfloat16 spec, bfloat16 logits
    back as ``ml_dtypes`` bits."""
    import ml_dtypes

    from madtp_tpu.serve.server import ServingClient as JClient

    srv = ArtifactServer(arts["bf16"], device="cpu")
    srv.start_background()
    try:
        client = JClient(srv.url)
        assert client.healthy() and client.meta["inputs"][0][1] == "bfloat16"
        images, ids, mask = _batch(4)
        got = client.predict(images, ids, mask, np.float32(1.0))
        want = srv.model(images, ids, mask, np.float32(1.0))
        assert got[0].dtype == ml_dtypes.bfloat16 and want[0].dtype == torch.bfloat16
        assert np.array_equal(got[0].view(np.int16), want[0].view(torch.int16).numpy())
        for g, w in zip(got[1:], want[1:]):
            assert g.dtype == np.int32 and np.array_equal(g, w.numpy())
    finally:
        srv.shutdown()


def test_port_client_against_jax_server(tmp_path, monkeypatch):
    """The port's client against the JAX package's server on a JAX
    artifact of the same task."""
    import jax

    from madtp_tpu.cli import export_serving as j_export
    from madtp_tpu.serve.server import ArtifactServer as JServer

    out = str(tmp_path / "jax_nlvr")
    monkeypatch.setattr(sys, "argv", ["x", "--task", "nlvr", "--config", _yaml(str(tmp_path)),
                                      "--output_dir", out, "--batch", str(B),
                                      "--text_len", str(T)])
    j_export.main()
    srv = JServer(out)
    srv.start_background()
    try:
        client = ServingClient(srv.url)
        images, ids, mask = _batch(5)
        got = client.predict(images, ids, mask, np.float32(1.0))
        want = jax.tree.leaves(srv.model(images, ids, mask, np.float32(1.0)))
        for g, w in zip(got, want):
            assert np.array_equal(g, np.asarray(w))
        sub = client.predict(_pair(images, 1), ids[1:], mask[1:], np.float32(1.0))
        assert sub[0].shape == (1, 2)
    finally:
        srv.shutdown()


# ---------------------------------------------------------------- row-independent


def test_row_independent_rows_do_not_depend_on_the_batch(rowind):
    """Each row of a full batch equals the same sample served alone."""
    client = ServingClient(rowind.url)
    images, ids, mask = _batch(6)
    full = client.predict(images, ids, mask, np.float32(1.0))
    assert client.meta["batching"]["outputs"] == [1, 2, 1]
    assert full[1].shape[0] == 2 * B and full[2].shape[0] == B  # per-row kept counts
    for j in range(B):
        solo = client.predict(_pair(images, j), ids[j:j + 1], mask[j:j + 1], np.float32(1.0))
        np.testing.assert_allclose(solo[0][0], full[0][j], rtol=0, atol=1e-5)
        assert np.array_equal(solo[1], full[1][[j, B + j]])
        assert np.array_equal(solo[2][0], full[2][j])


def test_dispatcher_merges_compatible_requests(rowind):
    """Two one-sample requests with equal unbatched inputs pack into one
    device call whose outputs equal their solo runs; a request at another
    temperature does not merge."""
    rt = rowind.default
    assert rt._aggregate
    images, ids, mask = _batch(7)

    def one(j, t):
        return _Pending(*rt._validate_cast([_pair(images, j), ids[j:j + 1], mask[j:j + 1],
                                            np.float32(t)]))

    p0, p1, p2 = one(0, 1.0), one(1, 1.0), one(0, 8.0)
    with rt._cond:
        rt._queue.extend([p0, p1, p2])
        group = rt._take_group_locked()
    assert group == [p0, p1] and rt._queue == [p2]
    rt._queue.clear()
    calls = rt.stats["calls"]
    merged = rt._run_padded(group)
    assert rt.stats["calls"] == calls + 1
    for j, got in enumerate(merged):
        solo = rt._run_padded([one(j, 1.0)])[0]
        for g, s in zip(got, solo):
            torch.testing.assert_close(g, s, rtol=0, atol=1e-5)
            if not g.is_floating_point():
                assert torch.equal(g, s)


def _hold_and_queue(srv, fns, queued, hold=0.0):
    """Run ``fns`` in threads while the device lock is held: the first
    request blocks in the device call, the others queue behind it; the lock
    is held ``hold`` seconds more once they are queued."""
    rt = srv.default
    ex = concurrent.futures.ThreadPoolExecutor(len(fns))
    srv._lock.acquire()
    try:
        req0 = rt.stats["requests"]
        futs = [ex.submit(fns[0])]
        deadline = time.time() + 20
        while not (rt.stats["requests"] > req0 and not rt._queue) and time.time() < deadline:
            time.sleep(0.02)
        futs += [ex.submit(f) for f in fns[1:]]
        while len(rt._queue) < queued and time.time() < deadline:
            time.sleep(0.02)
        time.sleep(hold)
    finally:
        srv._lock.release()
    return ex, futs


def test_live_merging_under_load(rowind):
    client = ServingClient(rowind.url)
    images, ids, mask = _batch(8)

    def one(j):
        return client.predict(_pair(images, j), ids[j:j + 1], mask[j:j + 1], np.float32(1.0))

    solo = [one(0), one(1)]
    merged0 = rowind.stats["merged"]
    ex, futs = _hold_and_queue(rowind, [lambda: one(0), lambda: one(0), lambda: one(1)], 2)
    outs = [f.result(timeout=60) for f in futs]
    ex.shutdown()
    for got, j in zip(outs, (0, 0, 1)):
        np.testing.assert_allclose(got[0], solo[j][0], rtol=0, atol=1e-5)
        assert all(np.array_equal(g, s) for g, s in zip(got[1:], solo[j][1:]))
    assert rowind.stats["merged"] >= merged0 + 1


def test_queue_timeout_and_shutdown_are_503(arts):
    srv = ArtifactServer(arts["rowind"], device="cpu", request_timeout=0.3)
    srv.start_background()
    client = ServingClient(srv.url)
    images, ids, mask = _batch(9)

    def one():
        return client.predict(_pair(images, 0), ids[:1], mask[:1], np.float32(1.0))

    try:
        # both wait past the timeout: the one queued and the one blocked in its call
        ex, futs = _hold_and_queue(srv, [one, one], 1, hold=0.6)
        for f in futs:
            with pytest.raises(RuntimeError, match=r"\(503\).*timed out"):
                f.result(timeout=60)
        ex.shutdown()
    finally:
        srv.shutdown()
    srv.default._closing = True
    with pytest.raises(Exception, match="shutting down"):
        srv.predict([_pair(images, 0), ids[:1], mask[:1], np.float32(1.0)])
    srv.server_close()


def test_overflow_shows_in_stats(tmp_path):
    """A row-independent gather caption export at a capacity schedule made
    too tight: the per-row decisions exceed it, and ``/stats`` counts it."""
    args = _args(str(tmp_path), "cap", "--prompt_len", "3", "--max_length", "6",
                 "--min_length", "2", "--eos_id", "90", "--temperature", "0.2",
                 "--row_independent", task="caption")
    export_serving.export_caption(args, export_serving.load_export_config(args),
                                  torch.device("cpu"), capacities=((6, 6),))
    out = args.output_dir
    srv = ArtifactServer(out, device="cpu", warmup=False, aggregate=False)
    try:
        assert srv.model.meta["capacities_vision"] == [6, 6]
        rng = np.random.RandomState(13)
        _, vk = srv.predict([rng.randn(1, 3, 64, 64).astype(np.float32),
                             rng.randint(1, 80, (1, 3)).astype(np.int32), np.float32(0.2)])
        assert int(vk.max()) > 5
        assert srv.stats["overflow_rows"] >= 1
        assert srv.stats["overflow_max"] >= int(vk.max()) - 5
    finally:
        srv.server_close()


# ---------------------------------------------------------------- pipelines and the CLI


def test_retrieval_pipeline_over_http(tmp_path):
    """Three retrieval units from one export served by one process: ITC
    features from both towers, each text's best image, that image's state
    through the ITM unit; equal to the same pipeline on the loaded units."""
    out = _export(str(tmp_path), "ret", "--text_len", "10", "--rerank_batch", str(B),
                  task="retrieval")
    rng = np.random.RandomState(11)
    images = rng.randn(B, 3, 64, 64).astype(np.float32)
    ids = rng.randint(1, 30000, (B, 10)).astype(np.int32)
    mask = np.ones((B, 10), np.int32)
    t = np.float32(1.0)
    srv = ArtifactServer(out, device="cpu")
    srv.start_background()
    try:
        assert sorted(srv.runtimes) == ["image_encoder", "itm_rerank", "text_encoder"]
        client = ServingClient(srv.url)
        assert client.meta["itm_rerank"]["task"] == "retrieval_itm_rerank"
        ifeat, sx, sa = client.predict(images, t, name="image_encoder")
        tfeat, _ = client.predict(ids, mask, t, name="text_encoder")
        top1 = (tfeat @ ifeat.T).argmax(axis=1)
        scores = client.predict(ids, mask, sx[top1], sa[top1], t, name="itm_rerank")[0]
        assert scores.shape == (B,) and np.isfinite(scores).all()
        with pytest.raises(RuntimeError, match=r"\(404\).*POST /predict/<name>"):
            client.predict(images, t)
        units = {n: load_artifact(os.path.join(out, n), "cpu")
                 for n in ("image_encoder", "text_encoder", "itm_rerank")}
        i2, x2, a2 = units["image_encoder"](images, t)
        t2 = units["text_encoder"](ids, mask, t)[0]
        best = (t2 @ i2.T).argmax(dim=1)
        assert np.array_equal(top1, best.numpy())
        want = units["itm_rerank"](ids, mask, x2[best], a2[best], t)[0]
        assert np.array_equal(scores, want.numpy())
        assert client.stats("itm_rerank")["requests"] == 1
    finally:
        srv.shutdown()


def test_serve_cli_end_to_end(arts):
    """``python -m madtp_tpu_torch.cli.serve --device cpu`` in a subprocess."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "madtp_tpu_torch.cli.serve", "--artifact", arts["coupled"],
         "--port", str(port), "--device", "cpu"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        client = ServingClient(f"http://127.0.0.1:{port}", timeout=30)
        deadline = time.time() + 120
        while time.time() < deadline and not client.healthy():
            if proc.poll() is not None:
                raise AssertionError("server died:\n" + proc.stdout.read().decode())
            time.sleep(0.3)
        assert client.healthy(), "server never became healthy"
        images, ids, mask = _batch(10)
        got = client.predict(images, ids, mask, np.float32(1.0))
        want = load_artifact(arts["coupled"], "cpu")(images, ids, mask, np.float32(1.0))
        assert all(np.array_equal(g, w.numpy()) for g, w in zip(got, want))
    finally:
        proc.terminate()
        proc.wait(timeout=30)
