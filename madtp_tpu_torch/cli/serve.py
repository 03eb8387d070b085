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
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence


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
    args = p.parse_args(argv)

    from madtp_tpu_torch.serve.server import ArtifactServer

    srv = ArtifactServer(args.artifact, args.host, args.port, warmup=not args.no_warmup,
                         verbose=args.verbose, aggregate=not args.no_aggregate,
                         device=args.device)
    names = ", ".join(f"{n}={rt.model.meta.get('task', '?')}" for n, rt in srv.runtimes.items())
    print(f"SERVING {names} ready on {srv.url}", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()


if __name__ == "__main__":
    main()
