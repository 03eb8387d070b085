"""Serve exported artifacts over HTTP (counterpart of ``madtp_tpu/cli/serve.py``).

    python -m madtp_tpu_torch.cli.serve --artifact artifacts/nlvr_p0.5 \\
        [--host 0.0.0.0] [--port 8765] [--no_warmup] [-v] [--device cuda]

The process loads each artifact (:mod:`madtp_tpu_torch.serve.artifact`: the
port's model code, the unit's weights), warms every unit up once at its
exported shapes (on the card: the kernels' build and the capture of its CUDA
graph, so no request pays either) and answers ``POST /predict`` with npz
batches (protocol in :mod:`madtp_tpu_torch.serve.server`).  ``--device cuda``
(the default) raises without a card; ``--device cpu`` serves the plain
PyTorch path.

A mesh artifact (``nr_devices`` N > 1, exported with ``--mesh``) runs in N
processes, one a device: rank 0 is the HTTP server and ranks 1..N-1 run the
step beside it (:func:`madtp_tpu_torch.serve.artifact.follow`).  This
command is rank 0 and starts the other ranks itself, as copies of its own
command line with ``--num_processes N --process_id r --coordinator
127.0.0.1:<a free port>`` (flags of that hand-off only); it stops them when
it stops.  The group runs NCCL when the host has a card for every rank, else
gloo (several ranks share a card, or the CPU).
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Sequence


def _mesh_devices(artifacts: Dict[str, str]) -> int:
    """The process count the artifacts' meshes need (1 without a mesh)."""
    from madtp_tpu_torch.serve.artifact import META_FILE

    counts = set()
    for d in artifacts.values():
        with open(os.path.join(d, META_FILE)) as f:
            meta = json.load(f)
        if meta.get("mesh") or int(meta.get("nr_devices", 1)) > 1:
            counts.add(int(meta.get("nr_devices", 1)))
    if len(counts) > 1:
        raise ValueError(f"the artifacts need meshes of {sorted(counts)} devices: serve them "
                         "apart")
    return counts.pop() if counts else 1


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


PARENT_ENV = "MADTP_SERVE_PARENT"  # set in the ranks this command starts: its pid


def _start_ranks(argv: Sequence[str], n: int):
    """Ranks 1..n-1 as copies of this command, started before this process
    touches the card; returns them and the flags with which this process
    joins as rank 0."""
    coord = f"127.0.0.1:{_free_port()}"
    flags = ["--num_processes", str(n), "--coordinator", coord]
    env = {**os.environ, PARENT_ENV: str(os.getpid())}
    procs = [subprocess.Popen([sys.executable, "-m", "madtp_tpu_torch.cli.serve", *argv,
                               *flags, "--process_id", str(r)], env=env) for r in range(1, n)]
    return procs, [*flags, "--process_id", "0"]


def _exit_with_parent() -> None:
    """In a rank this command started: end the process when rank 0's is gone
    (it would otherwise wait for rank 0's next message until the group's
    timeout)."""
    parent = int(os.environ.get(PARENT_ENV, "0") or 0)
    if not parent:
        return

    def watch():
        while os.getppid() == parent:
            time.sleep(1.0)
        os._exit(1)
    threading.Thread(target=watch, daemon=True).start()


def main(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--artifact", required=True,
                   help="artifact directory from cli/export_serving — one artifact or a "
                        "parent whose subdirectories are artifacts (clip/retrieval exports); "
                        "several artifacts route as POST /predict/<name>")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", default=8765, type=int)
    p.add_argument("--no_warmup", action="store_true",
                   help="skip the start-up call (the first request then builds and captures)")
    p.add_argument("--no_aggregate", action="store_true",
                   help="disable request aggregation (each request runs its own padded call)")
    p.add_argument("-v", "--verbose", action="store_true", help="log one line per request")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the models run: the card (raises without one) or the CPU")
    # set by this command on the mesh ranks it starts (_start_ranks), not by hand
    p.add_argument("--num_processes", default=0, type=int, help=argparse.SUPPRESS)
    p.add_argument("--process_id", default=-1, type=int, help=argparse.SUPPRESS)
    p.add_argument("--coordinator", default="", help=argparse.SUPPRESS)
    raw = list(sys.argv[1:] if argv is None else argv)
    args = p.parse_args(raw)

    from madtp_tpu_torch.serve.server import ArtifactServer, discover_artifacts

    artifacts = discover_artifacts(args.artifact)
    n = _mesh_devices(artifacts)
    procs: List[subprocess.Popen] = []
    if n > 1 and args.num_processes <= 1:
        procs, flags = _start_ranks(raw, n)
        args = p.parse_args([*raw, *flags])

    import torch

    from madtp_tpu_torch.core.device import resolve_device
    from madtp_tpu_torch.parallel import dist

    dev = resolve_device(args.device)
    if n > 1:  # every rank decides alike
        args.dist_backend = ("nccl" if dev.type == "cuda" and torch.cuda.device_count() >= n
                             else "gloo")
        dev = dist.init_from_args(args, dev)
    if n > 1 and not dist.is_main_process():
        from madtp_tpu_torch.serve.artifact import follow, load_artifact

        _exit_with_parent()
        models = {}
        for name, d in artifacts.items():
            m = load_artifact(d, dev, name=name)
            if hasattr(m, "follow"):
                models[name] = m
        follow(models)
        return
    if n > 1:  # a terminated rank 0 still releases the other ranks
        signal.signal(signal.SIGTERM, lambda *_: sys.exit(0))
    try:
        srv = ArtifactServer(artifacts, args.host, args.port, warmup=not args.no_warmup,
                             verbose=args.verbose, aggregate=not args.no_aggregate,
                             device=dev)
        names = ", ".join(f"{nm}={rt.model.meta.get('task', '?')}"
                          for nm, rt in srv.runtimes.items())
        where = f" over {n} processes" if n > 1 else ""
        print(f"SERVING {names} ready on {srv.url}{where}", flush=True)
        try:
            srv.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            srv.server_close()
    finally:
        for proc in procs:
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()


if __name__ == "__main__":
    main()
