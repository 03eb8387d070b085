"""HTTP server and client for serving artifacts
(counterpart of ``madtp_tpu/serve/server.py``), on the standard library.

One server hosts many artifacts: one process owns the card while a task's
pipeline spans several units (retrieval: image_encoder, text_encoder and
itm_rerank; CLIP: two towers).  All models share one device lock; each gets
its own dispatch queue.

Wire protocol (``<name>`` may be omitted when one artifact is served), the
JAX server's, so that a client of either package talks to a server of
either:

``GET /healthz``
    ``{"ok": true}`` once every model is warmed up: each unit's step was
    called once at its exported shapes, which on the card builds the
    kernels and captures its CUDA graph, so no request ever captures.
``GET /meta[/<name>]``
    the artifact's ``meta.json``, whose ``inputs`` spec (per-input shape
    and dtype) a client needs to build requests; with several artifacts and
    no name, ``{name: meta}``.
``GET /stats[/<name>]``
    request, device-call and merge counters (per model, or
    ``{name: stats}``); row-independent gather artifacts add
    ``overflow_rows`` / ``overflow_max`` (see :class:`_ModelRuntime`).
``POST /predict[/<name>]``
    body: an ``.npz`` whose arrays, in file order, are the call inputs
    (``meta["inputs"]``'s order).  Arrays are cast to the exported dtype
    when the kind matches (float32 for a bfloat16 input); a kind mismatch is
    a 400.  With a ``batching`` spec (every exported task has one) a request
    may carry any sub-batch n <= the exported batch: batched inputs are
    padded to the exported shape by replicating the request's last row
    (exact: replicas cannot change the batch-max keep counts that couple
    DTP rows) and batched outputs sliced back to n.  Response: an ``.npz``
    of the outputs in order, dtype-exact.  Errors: 400 (malformed or
    mismatched request), 404 (route or artifact), 413 (a body over
    :meth:`_ModelRuntime.max_body_bytes`), 503 (a request that waited in the
    queue past ``request_timeout``, or a server shutting down), 500 (the
    step failed: a kernel that does not build or launch is reported, never
    replaced by the plain path).

The codec stores bfloat16 as its raw bits (``uint8``) with the JSON sidecar
key ``__ml_dtypes_json__``, byte for byte the JAX package's layout
(``madtp_tpu/ckpt/export.py`` ``encode_ml_dtypes``), without ``ml_dtypes``:
the bits are viewed as ``torch.bfloat16``.

Requests on artifacts whose ``batching`` spec declares
``row_independent: true`` go through a per-model dispatcher thread that
packs whatever is queued into one device call, but only requests whose
unbatched inputs (the temperature, a VQA answer list) are equal.  Artifacts
without the flag (batch-coupled DTP, the reference's semantics) never merge
distinct requests: each gets its own padded call, so its outputs are what
it would get served alone.

Device work happens in the handler or dispatcher threads, always under the
device lock, which :class:`~madtp_tpu_torch.serve.artifact.ServingModel`
takes around the inputs' upload, the replay and the read-back of the
outputs.
"""

from __future__ import annotations

import io
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from madtp_tpu_torch.serve.artifact import (META_FILE, WEIGHTS_FILE, MeshServingModel,
                                            dtype_name, load_artifact, torch_dtype)

ML_DTYPES_KEY = "__ml_dtypes_json__"  # madtp_tpu/ckpt/export.py ML_DTYPES_KEY


def _wire(a):
    """``(array for the npz, [dtype, shape] or None)``: a bfloat16 tensor,
    or an ``ml_dtypes`` numpy array (numpy kind ``'V'``), as its raw bits."""
    if torch.is_tensor(a):
        t = a.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.reshape(-1).view(torch.uint8).numpy(), ["bfloat16", list(t.shape)]
        return t.numpy(), None
    a = np.asarray(a)
    if a.dtype.kind == "V":
        return np.ascontiguousarray(a).reshape(-1).view(np.uint8), [str(a.dtype), list(a.shape)]
    return a, None


def encode_arrays(arrays: Sequence) -> bytes:
    """Positional arrays (numpy arrays, tensors on any device, numbers) ->
    npz bytes with keys ``a0000``, ``a0001``, ...; bfloat16 as uint8 bits
    plus the sidecar key, as the JAX codec writes it."""
    flat, sidecar = {}, {}
    for i, a in enumerate(arrays):
        key = f"a{i:04d}"
        flat[key], tag = _wire(a)
        if tag is not None:
            sidecar[key] = tag
    if sidecar:
        flat[ML_DTYPES_KEY] = np.frombuffer(json.dumps(sidecar).encode(), np.uint8)
    buf = io.BytesIO()
    np.savez(buf, **flat)
    return buf.getvalue()


def decode_tensors(data: bytes) -> List[torch.Tensor]:
    """Inverse of :func:`encode_arrays` as CPU tensors, file order kept;
    bfloat16 comes back as ``torch.bfloat16`` bit for bit.  Raises
    ``ValueError`` for another ``ml_dtypes`` type (fp8)."""
    with np.load(io.BytesIO(data), allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    tags = {}
    if ML_DTYPES_KEY in flat:
        tags = json.loads(flat.pop(ML_DTYPES_KEY).tobytes().decode())
    out = []
    for k in sorted(flat):
        a = torch.from_numpy(np.array(flat[k], order="C"))  # a writable copy; 0-d stays 0-d
        if k in tags:
            name, shape = tags[k]
            if name != "bfloat16":
                raise ValueError(f"{k}: dtype {name} is not supported (bfloat16 is)")
            a = a.view(torch.bfloat16).reshape(shape)
        out.append(a)
    return out


def decode_arrays(data: bytes) -> List[np.ndarray]:
    """Inverse of :func:`encode_arrays` as numpy arrays (numpy has no
    bfloat16 without ``ml_dtypes``, so bfloat16 comes back as float32, which
    holds every bfloat16 value exactly; :func:`decode_tensors` keeps it)."""
    return [(t.float() if t.dtype == torch.bfloat16 else t).numpy()
            for t in decode_tensors(data)]


class _Handler(BaseHTTPRequestHandler):
    server: "ArtifactServer"

    def log_message(self, fmt, *args):  # quiet by default
        if self.server.verbose:
            super().log_message(fmt, *args)

    def _send(self, code: int, body: bytes, ctype: str):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, obj):
        self._send(code, json.dumps(obj).encode(), "application/json")

    def _route(self, prefix: str) -> Optional["_ModelRuntime"]:
        """Resolve /prefix or /prefix/<name>; None means 'all' for GETs."""
        rest = self.path[len(prefix):]
        if rest in ("", "/"):
            return self.server.default  # None with several artifacts
        name = rest.lstrip("/")
        rt = self.server.runtimes.get(name)
        if rt is None:
            raise _BadRoute(f"unknown artifact {name!r}; serving {sorted(self.server.runtimes)}")
        return rt

    def do_GET(self):
        try:
            if self.path == "/healthz":
                self._send_json(200, {"ok": self.server.ready})
            elif self.path.startswith("/meta"):
                rt = self._route("/meta")
                self._send_json(200, rt.model.meta if rt else {
                    n: r.model.meta for n, r in self.server.runtimes.items()})
            elif self.path.startswith("/stats"):
                rt = self._route("/stats")
                self._send_json(200, rt.stats if rt else {
                    n: r.stats for n, r in self.server.runtimes.items()})
            else:
                self._send_json(404, {"error": f"no route {self.path}"})
        except _BadRoute as e:
            self._send_json(404, {"error": str(e)})

    def do_POST(self):
        if not self.path.startswith("/predict"):
            self._send_json(404, {"error": f"no route {self.path}"})
            return
        try:
            rt = self._route("/predict")
            if rt is None:
                raise _BadRoute("several artifacts are served — POST /predict/<name>, "
                                f"one of {sorted(self.server.runtimes)}")
        except _BadRoute as e:
            self._send_json(404, {"error": str(e)})
            return
        try:
            n = int(self.headers.get("Content-Length", "0"))
            if n <= 0:
                raise _BadRequest("empty body (Content-Length required; chunked encoding is "
                                  "not supported — send the npz with a length)")
            cap = rt.max_body_bytes()
            if n > cap:
                self._send_json(413, {"error": (
                    f"body of {n} bytes exceeds this artifact's input budget ({cap} bytes) — "
                    "the process that owns the accelerator refuses to buffer it")})
                return
            try:
                arrays = decode_tensors(self.rfile.read(n))
            except Exception as e:  # noqa: BLE001 — the client's malformed payload
                raise _BadRequest(
                    f"body is not a decodable npz: {type(e).__name__}: {e}") from None
            out = rt.predict(arrays)
        except _BadRequest as e:
            self._send_json(400, {"error": str(e)})
        except _Unavailable as e:
            self._send_json(503, {"error": str(e)})
        except Exception as e:  # the step failed: tell the client
            self._send_json(500, {"error": f"{type(e).__name__}: {e}"})
        else:
            self._send(200, encode_arrays(out), "application/octet-stream")


class _BadRequest(ValueError):
    pass


class _BadRoute(ValueError):
    pass


class _Unavailable(RuntimeError):
    """HTTP 503: a queue timeout under overload, or shutdown."""


class _Pending:
    """One queued request awaiting the dispatcher."""

    __slots__ = ("arrays", "n", "event", "result", "error")

    def __init__(self, arrays, n):
        self.arrays, self.n = arrays, n
        self.event = threading.Event()
        self.result = self.error = None


def _kind(dtype: torch.dtype) -> str:
    """numpy's kind letter of a torch dtype, bfloat16 counted as a float."""
    if dtype.is_floating_point:
        return "f"
    if dtype == torch.bool:
        return "b"
    return "u" if dtype == torch.uint8 else "i"


class _ModelRuntime:
    """One loaded artifact and its dispatch queue; the device lock is the
    server's, shared by all its runtimes (one process, one card).

    Merging requests is sound only when the exporter declared the step
    row-independent (``batching.row_independent``): DTP keep counts are
    batch-coupled otherwise (the batch max, the reference's semantics), so
    merging two requests would change both.  Padding a request with
    replicas of its own rows stays exact either way.

    Row-independent gather exports report each row's DTP decision as its
    kept count; compared with the calibrated capacities
    (``batching.kept_outputs`` names the schedule), ``/stats`` counts
    ``overflow_rows`` (served rows whose decision exceeded some layer's
    capacity, their extra tokens folded into the merge token) and
    ``overflow_max`` (the largest excess seen)."""

    def __init__(self, art_dir: str, device_lock: threading.Lock, *, aggregate: bool,
                 request_timeout: float, device="cuda", name: str = ""):
        self.model = load_artifact(art_dir, device, lock=device_lock, name=name)
        self._inputs = [(shape, torch_dtype(d)) for shape, d in self.model.meta["inputs"]]
        self._bat = self.model.meta.get("batching")
        self._aggregate = bool(aggregate and self._bat and any(self._bat["inputs"])
                               and self._bat.get("row_independent"))
        self._request_timeout = request_timeout
        self.stats = {"requests": 0, "calls": 0, "merged": 0}
        self._overflow_checks = []
        if self._bat and self._bat.get("row_independent"):
            for idx, which in (self._bat.get("kept_outputs") or {}).items():
                caps = self.model.meta.get(f"capacities_{which}")
                if caps:  # mask and dense exports have no capacities
                    self._overflow_checks.append((int(idx), torch.tensor(caps) - 1))
        if self._overflow_checks:
            self.stats.update({"overflow_rows": 0, "overflow_max": 0})
        self._queue: List[_Pending] = []
        self._cond = threading.Condition()
        self._closing = False
        self._dispatcher = None

    def warmup(self):
        self._call([torch.zeros(s, dtype=d) for s, d in self._inputs])

    def start(self):
        if self._aggregate:
            self._dispatcher = threading.Thread(target=self._dispatch_loop, daemon=True)
            self._dispatcher.start()

    def close(self):
        with self._cond:
            if self._closing:
                return
            self._closing = True
            self._cond.notify_all()
        if self._dispatcher is not None:
            self._dispatcher.join(timeout=30)

    # ---- request path ------------------------------------------------

    def max_body_bytes(self) -> int:
        """The largest body taken: twice the exported inputs' bytes (at
        least 4 a value, so float32 for a bfloat16 input fits) plus 64 KiB
        of headers — one oversized Content-Length must not exhaust the
        memory of the process that owns the card."""
        total = sum(int(np.prod(s)) * max(4, torch.empty((), dtype=d).element_size())
                    for s, d in self._inputs)
        return 2 * total + 65536

    def predict(self, arrays: Sequence) -> List[torch.Tensor]:
        """One request: validated, cast, padded, run, sliced back.  Returns
        CPU tensors (bfloat16 outputs stay bfloat16)."""
        cast, n = self._validate_cast(arrays)
        with self._cond:  # counters share the dispatch lock
            if self._closing:
                raise _Unavailable("server shutting down")
            self.stats["requests"] += 1
        if not self._aggregate:
            return self._run_padded([_Pending(cast, n)])[0]
        p = _Pending(cast, n)
        with self._cond:
            self._queue.append(p)
            self._cond.notify()
        if not p.event.wait(self._request_timeout):
            with self._cond:
                try:  # still queued: withdraw it
                    self._queue.remove(p)
                except ValueError:
                    pass
            raise _Unavailable(f"predict timed out after {self._request_timeout}s in the "
                               "dispatch queue (server overloaded)")
        if p.error is not None:
            raise p.error
        return p.result

    def _validate_cast(self, arrays):
        """Shape and dtype checks and the cast; batched inputs keep their
        sub-batch n (padding happens at dispatch).  Returns ``(cast, n)``,
        ``n`` None without a batching spec (exact shapes)."""
        if len(arrays) != len(self._inputs):
            raise _BadRequest(f"expected {len(self._inputs)} input arrays (meta['inputs']), "
                              f"got {len(arrays)}")
        bat = self._bat
        cast, n = [], None
        for i, (a, (shape, dtype)) in enumerate(zip(arrays, self._inputs)):
            a = a if torch.is_tensor(a) else torch.as_tensor(np.asarray(a))
            mult = bat["inputs"][i] if bat else 0
            if mult:
                if a.dim() != len(shape) or list(a.shape[1:]) != list(shape[1:]):
                    raise _BadRequest(f"input {i}: trailing dims {list(a.shape)} != "
                                      f"exported {list(shape)}")
                rows, rem = divmod(a.shape[0], mult)
                if rem or not 1 <= rows <= bat["batch"]:
                    raise _BadRequest(f"input {i}: leading dim {a.shape[0]} must be n*{mult} "
                                      f"with 1 <= n <= {bat['batch']} (exported batch)")
                if n is not None and rows != n:
                    raise _BadRequest(f"input {i}: sub-batch {rows} disagrees with {n} "
                                      "from earlier inputs")
                n = rows
            elif list(a.shape) != list(shape):
                raise _BadRequest(f"input {i}: shape {list(a.shape)} != exported "
                                  f"{list(shape)} (the artifact is fixed-shape; re-export "
                                  "for a different batch)")
            if a.dtype != dtype:
                if _kind(a.dtype) != _kind(dtype):
                    raise _BadRequest(f"input {i}: dtype {dtype_name(a.dtype)} is not "
                                      f"castable to exported {dtype_name(dtype)}")
                a = a.to(dtype)
            cast.append(a)
        return cast, n

    # ---- dispatch ------------------------------------------------------

    def _dispatch_loop(self):
        while True:
            with self._cond:
                while not self._queue and not self._closing:
                    self._cond.wait()
                if self._closing:
                    for p in self._queue:
                        p.error = _Unavailable("server shutting down")
                        p.event.set()
                    self._queue.clear()
                    return
                group = self._take_group_locked()
            try:
                for p, r in zip(group, self._run_padded(group)):
                    p.result = r
            except Exception as e:  # noqa: BLE001 — delivered to the clients
                for p in group:
                    p.error = e
            finally:
                for p in group:
                    p.event.set()

    def _take_group_locked(self) -> List[_Pending]:
        """Pop the head request and every queued request that fits the
        remaining batch rows and carries equal unbatched inputs."""
        bat = self._bat
        group = [self._queue.pop(0)]
        rows = group[0].n
        i = 0
        while i < len(self._queue):
            q = self._queue[i]
            if rows + q.n <= bat["batch"] and all(
                    m or torch.equal(a, b)
                    for m, a, b in zip(bat["inputs"], q.arrays, group[0].arrays)):
                group.append(self._queue.pop(i))
                rows += q.n
            else:
                i += 1
        self.stats["merged"] += len(group) - 1
        return group

    def _run_padded(self, group: List[_Pending]) -> List[List[torch.Tensor]]:
        """Pack the group's rows into one exported-shape call, padded with
        replicas of the last real row, and split the outputs back per
        request."""
        bat = self._bat
        if bat is None or group[0].n is None:
            return [self._call(group[0].arrays)]
        B = bat["batch"]
        rows = sum(p.n for p in group)
        packed = []
        for i, mult in enumerate(bat["inputs"]):
            if not mult:
                packed.append(group[0].arrays[i])
                continue
            blocks = []
            for j in range(mult):
                parts = [p.arrays[i][j * p.n:(j + 1) * p.n] for p in group]
                if rows < B:
                    parts.append(parts[-1][-1:].expand(B - rows, *parts[-1].shape[1:]))
                blocks.append(torch.cat(parts))
            packed.append(torch.cat(blocks))
        leaves = self._call(packed)
        if self._overflow_checks:
            ovf_rows = ovf_max = 0
            for idx, cap1 in self._overflow_checks:
                for j in range(bat["outputs"][idx]):
                    ex = leaves[idx][j * B:j * B + rows].long() - cap1[None, :]
                    ovf_rows += int((ex > 0).any(dim=1).sum())
                    ovf_max = max(ovf_max, int(ex.max()) if ex.numel() else 0)
            if ovf_rows:
                with self._cond:
                    self.stats["overflow_rows"] += ovf_rows
                    self.stats["overflow_max"] = max(self.stats["overflow_max"], ovf_max)
        results, off = [], 0
        for p in group:
            out = []
            for o, m in zip(leaves, bat["outputs"]):
                if not m:
                    out.append(o)
                else:
                    out.append(torch.cat([o[j * B + off:j * B + off + p.n] for j in range(m)]))
            results.append(out)
            off += p.n
        return results

    def _call(self, arrays) -> List[torch.Tensor]:
        out = self.model(*arrays)  # under the device lock
        with self._cond:
            self.stats["calls"] += 1
        return out


def discover_artifacts(path: str) -> Dict[str, str]:
    """``path`` is one artifact directory (it holds ``meta.json`` and
    ``weights.pt``: its basename maps to it) or a parent whose immediate
    subdirectories are artifacts (what the exporter writes for CLIP and
    retrieval): one entry each."""
    def is_artifact(d):
        return all(os.path.exists(os.path.join(d, f)) for f in (META_FILE, WEIGHTS_FILE))

    if is_artifact(path):
        return {os.path.basename(os.path.normpath(path)): path}
    subs = {d: os.path.join(path, d) for d in sorted(os.listdir(path))
            if is_artifact(os.path.join(path, d))}
    if not subs:
        raise ValueError(f"{path} is neither an artifact directory ({META_FILE} and "
                         f"{WEIGHTS_FILE}) nor a parent of artifact directories")
    return subs


class ArtifactServer(ThreadingHTTPServer):
    """Serve one or more artifact directories on ``device`` (the card by
    default; without one it raises).  ``artifacts`` is one path (an
    artifact directory or a parent of them) or an explicit ``{name: dir}``.
    Every model is warmed up here, before any request: on the card that
    captures each unit's graph, and a capture fails if another thread
    touches the card meanwhile.  ``serve_forever()`` blocks; tests use
    ``start_background()`` and ``shutdown()``."""

    daemon_threads = True

    def __init__(self, artifacts: Union[str, Dict[str, str]], host: str = "127.0.0.1",
                 port: int = 0, *, warmup: bool = True, verbose: bool = False,
                 aggregate: bool = True, request_timeout: float = 600.0, device="cuda"):
        if isinstance(artifacts, str):
            artifacts = discover_artifacts(artifacts)
        self.verbose = verbose
        self.ready = False
        self._lock = threading.Lock()  # one card, one call stream
        self.runtimes = {
            name: _ModelRuntime(d, self._lock, aggregate=aggregate,
                                request_timeout=request_timeout, device=device, name=name)
            for name, d in artifacts.items()}
        self.default = next(iter(self.runtimes.values())) if len(self.runtimes) == 1 else None
        super().__init__((host, port), _Handler)
        for rt in self.runtimes.values():
            if warmup:
                rt.warmup()
            rt.start()
        self.ready = True

    @property
    def url(self) -> str:
        return f"http://{self.server_address[0]}:{self.server_address[1]}"

    @property
    def model(self):
        return self.default.model

    @property
    def stats(self):
        return self.default.stats

    def predict(self, arrays: Sequence, name: Optional[str] = None) -> List[torch.Tensor]:
        """The request path without HTTP; returns CPU tensors."""
        rt = self.runtimes[name] if name else self.default
        if rt is None:
            raise ValueError(f"several artifacts are served — pass name=, one of "
                             f"{sorted(self.runtimes)}")
        return rt.predict(arrays)

    def shutdown(self):
        for rt in self.runtimes.values():
            rt.close()
        super().shutdown()

    def server_close(self):
        """Close the socket and release the other ranks of mesh artifacts
        (:func:`~madtp_tpu_torch.serve.artifact.follow`)."""
        super().server_close()
        for rt in self.runtimes.values():
            rt.close()
        meshes = [rt.model for rt in self.runtimes.values()
                  if isinstance(rt.model, MeshServingModel)]
        if meshes:
            meshes[0].close()

    def start_background(self) -> threading.Thread:
        t = threading.Thread(target=self.serve_forever, daemon=True)
        t.start()
        return t


class ServingClient:
    """Standard-library client of an artifact server, the port's or the JAX
    package's.  ``name`` selects an artifact on a server of several (or per
    call: ``predict(*arrays, name="itm_rerank")``).  Replies come back as
    numpy arrays, bfloat16 as float32 (:func:`decode_arrays`)."""

    def __init__(self, url: str, timeout: float = 120.0, name: Optional[str] = None):
        self.url = url.rstrip("/")
        self.timeout = timeout
        self.name = name
        self._meta: Dict[str, dict] = {}

    def _get(self, path: str) -> bytes:
        import urllib.request

        with urllib.request.urlopen(self.url + path, timeout=self.timeout) as r:
            return r.read()

    def _suffix(self, name: Optional[str]) -> str:
        name = name or self.name
        return f"/{name}" if name else ""

    def meta_for(self, name: Optional[str] = None) -> dict:
        key = name or self.name or ""
        if key not in self._meta:
            self._meta[key] = json.loads(self._get("/meta" + self._suffix(name)))
        return self._meta[key]

    @property
    def meta(self) -> dict:
        return self.meta_for(None)

    def stats(self, name: Optional[str] = None) -> dict:
        return json.loads(self._get("/stats" + self._suffix(name)))

    def healthy(self) -> bool:
        try:
            return json.loads(self._get("/healthz")).get("ok", False)
        except OSError:
            return False

    def predict(self, *arrays, name: Optional[str] = None) -> List[np.ndarray]:
        import urllib.error
        import urllib.request

        req = urllib.request.Request(self.url + "/predict" + self._suffix(name),
                                     data=encode_arrays(arrays),
                                     headers={"Content-Type": "application/octet-stream"})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                return decode_arrays(r.read())
        except urllib.error.HTTPError as e:
            body = e.read()
            try:
                detail = json.loads(body).get("error", "")
            except ValueError:  # a body that is not JSON
                detail = body[:500].decode(errors="replace")
            raise RuntimeError(f"predict failed ({e.code}): {detail}") from None
