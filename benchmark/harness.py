"""What every cell shares: finding a cell's files by name, the run's record,
the traced stretch and its digest, the per-layer metric readers, the check
that the run loaded no JAX, and the result line."""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "madtp_tpu")


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with the files it names."""

    name: str
    chips: int
    config: dict  # configs/<config>.json
    mix: dict  # traffic/<traffic>.json
    limits: dict  # limits/<workload>.json
    end_to_end: List[dict]  # the end-to-end metrics this cell reports
    per_layer: List[dict]  # the per-layer metrics this cell reports


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(root: Path, name: str) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``, its configuration file,
    its traffic mix (``traffic/<traffic>.json``) and its correctness limits
    (``limits/<workload>.json``)."""
    spec = read_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    cfg = read_json(root / configs[w["config"]]["file"])
    return Cell(name=name, chips=int(w["chips"]), config=cfg,
                mix=read_json(HERE / "traffic" / f"{w['traffic']}.json"),
                limits=read_json(HERE / "limits" / f"{name}.json"),
                end_to_end=[m for m in spec["end_to_end"] if _reports(m, name)],
                per_layer=[m for m in spec["per_layer"] if _reports(m, name)])


def load_module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` as a module (a name may hold dots)."""
    path = HERE / kind / f"{name}.py"
    mod_name = f"benchmark.{kind}.{name.replace('.', '_').replace('-', '_')}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or not path.exists():
        raise SystemExit(f"no {kind[:-1]} file {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def driver(mix: dict):
    """The driver module a traffic mix names (``drivers/<driver>.py``)."""
    return importlib.import_module(f"benchmark.drivers.{mix['driver']}")


@dataclasses.dataclass
class Run:
    """One run of a cell: what the driver is given and what it records."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float  # the process's start on the host clock
    control: Optional[str] = None  # "tf32": the reference in TF32 in the program's place
    setup_s: Optional[float] = None
    e2e: Dict[str, float] = dataclasses.field(default_factory=dict)
    readings: dict = dataclasses.field(default_factory=dict)  # raw facts (readings.py)
    checks: List[tuple] = dataclasses.field(default_factory=list)  # (name, value, limit)
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    stretch: Optional["Stretch"] = None
    _mark: Optional[float] = None

    def log(self, *msg):
        """A line of the run's own account, on standard error."""
        print(f"[{self.cell.name}]", *msg, file=sys.stderr, flush=True)

    def mark(self, phase: str):
        """Log the host seconds since the last mark (the process's start)."""
        t = time.perf_counter()
        self.log(f"{phase}: {t - (self._mark or self.t_start):.3f} s")
        self._mark = t

    def check(self, name: str, value: float) -> bool:
        """Record ``value`` against this cell's limit ``name``; True if
        within it.  A value that is not a number (no output) fails."""
        limit = self.cell.limits[name]
        value = float(value)
        self.checks.append((name, value, limit))
        return value == value and value <= limit

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(v == v and v <= lim for _, v, lim in self.checks)


class Stretch:
    """A stretch of the window traced with ``torch.profiler``: the device's
    busy time (the union of its kernels', copies' and sets' intervals)
    within the host's span named ``stretch``, the device time of each
    kernel by name, and the idle gaps labelled by the harness span the host
    was in.  The harness's own spans are ``torch.profiler.record_function``
    ranges (:meth:`span`), cheap when no profiler runs."""

    LABEL = "stretch"
    SPANS = ("feed", "dispatch", "readback", "rank")

    def __init__(self):
        self.prof = None
        self.range = None
        self.busy_s = self.window_s = None
        self.kernels: Dict[str, float] = {}
        self.gaps: List[list] = []

    @staticmethod
    def span(name: str):
        return torch.profiler.record_function(name)

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        # a trace can miss the first device activities after it starts: spins
        # take those places, and the stretch opens after them
        for _ in range(32):
            torch.cuda._sleep(100_000)
        torch.cuda.synchronize()
        self.range = torch.profiler.record_function(self.LABEL)
        self.range.__enter__()

    def stop(self):
        torch.cuda.synchronize()
        self.range.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        events = self.prof.profiler.kineto_results.events()
        cpu, dev = [], []
        for e in events:
            start, end = e.start_ns(), e.end_ns()
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if not e.is_user_annotation() and "spin_kernel" not in e.name():
                    dev.append((start, end, e.name()))
            elif e.name() == self.LABEL or e.name() in self.SPANS:
                cpu.append((start, end, e.name()))
        window = [c for c in cpu if c[2] == self.LABEL]
        if not window or not dev:
            raise RuntimeError("the trace holds no device activity in the stretch")
        w0, w1 = window[0][0], window[0][1]
        self.window_s = (w1 - w0) / 1e9
        dev = sorted((max(s, w0), min(t, w1), n) for s, t, n in dev if t > w0 and s < w1)
        busy, merged = 0, []
        for s, t, _ in dev:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t)
            else:
                merged.append([s, t])
        busy = sum(t - s for s, t in merged)
        self.busy_s = busy / 1e9
        for s, t, n in dev:
            self.kernels[n] = self.kernels.get(n, 0.0) + (t - s) / 1e9
        spans = [c for c in cpu if c[2] != self.LABEL]
        edges = [w0] + [x for iv in merged for x in iv] + [w1]
        longest = sorted(((b - a, a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a),
                         reverse=True)[:10]
        self.gaps = []
        for length, a, b in longest:
            mid = (a + b) / 2
            inner = [c for c in spans if c[0] <= mid <= c[1]]
            label = min(inner, key=lambda c: c[1] - c[0])[2] if inner else "host"
            self.gaps.append([label, length / 1e9])
        self.prof = None

    def kernel_s(self, names) -> float:
        """Device seconds of the kernels whose name holds any of ``names``."""
        return sum(s for n, s in self.kernels.items() if any(k in n for k in names))

    def breakdown(self) -> dict:
        top = sorted(self.kernels.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:160], s] for n, s in top], "idle_gaps": self.gaps}


def read_per_layer(run: Run) -> Dict[str, dict]:
    """Each per-layer metric of the cell from its reader
    (``metrics/<name>.py``); a reader that finds nothing returns None and
    the metric is left out."""
    out = {}
    for m in run.cell.per_layer:
        value = load_module("metrics", m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def loaded_forbidden() -> List[str]:
    """Modules of JAX, Flax or the JAX package in this process, by whole
    top-level name."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def device_record(run: Run) -> dict:
    rec = {"platform": "gpu", "kind": torch.cuda.get_device_name(run.device),
           "count": run.cell.chips, "memory_peak_bytes": int(run.memory_peak_bytes)}
    if run.trace:
        rec["busy_s"] = run.stretch.busy_s
        rec["window_s"] = run.stretch.window_s
    return rec


def result(run: Run) -> dict:
    """The result line: the end-to-end metrics (``--trace 0``) or the
    per-layer ones (``--trace 1``), the device, and the numbers compared
    with their limits last."""
    units = {m["name"]: m["unit"] for m in run.cell.end_to_end}
    if run.trace:
        metrics = read_per_layer(run)
    else:
        metrics = {n: {"value": float(run.e2e[n]), "unit": units[n]} for n in units}
    line = {"correct": run.correct, "attempted": run.attempted, "failed": run.failed,
            "metrics": metrics, "device": device_record(run)}
    if run.trace:
        line["breakdown"] = run.stretch.breakdown()
    line["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in run.checks}
    return line

