"""The benchmark of madtp_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout on a machine with the cell's cards.  It
builds the cell's model and traffic from the seed, warms every shape the
traffic uses (the set-up), measures for ``--seconds``, then checks what the
timed path produced against the plain reference under ``benchmark/reference``.
The last line of standard output is the result as one JSON object; the last
lines of standard error are the numbers compared, each with its limit.

``--control tf32`` runs the correctness control instead: the reference
itself in TF32 in the program's place, judged as the program is (no timing).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path.cwd()
sys.path.insert(0, str(ROOT))
# the port's nvcc builds go to build/ in the checkout (madtp_tpu_torch/kernels/
# build.py); every other cache a library might keep goes there too
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ.setdefault(var, str(ROOT / "build" / sub))
os.environ.setdefault("USE_FLAX", "0")  # no library of the port may load JAX by itself


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("tf32",), default=None)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from benchmark import harness

    cell = harness.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA card(s); this machine has {n}",
              file=sys.stderr)
        return 2
    run = harness.Run(cell=cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                      device=torch.device("cuda", 0), t_start=T_START, control=args.control)
    harness.driver(cell.mix).run(run)
    found = harness.loaded_forbidden()
    if found:
        print(f"the run loaded {', '.join(found)}: the benchmark measures madtp_tpu_torch "
              "alone", file=sys.stderr)
        return 3
    for name, value, limit in run.checks:
        state = "ok" if value <= limit else "FAILED"
        print(f"check {name} {value!r} limit {limit!r} {state}", file=sys.stderr)
    sys.stderr.flush()
    if run.control:
        print(json.dumps({"control": run.control, "correct": run.correct,
                          "checks": {n: {"value": v, "limit": lim}
                                     for n, v, lim in run.checks}}), flush=True)
    else:
        print(json.dumps(harness.result(run)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
