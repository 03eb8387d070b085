"""The correctness control on the card: each cell's reference computed in
TF32 (the precision below the configuration's fp32 without TF32) in the
program's place, at the cell's own size, judged as the program is, must
come out not correct.  About a minute a cell on an H100."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["nlvr-eval-p50", "clip-eval-p50", "nlvr-train-p50"])
def test_the_tf32_control_is_not_correct(name, card):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", name, "--seed",
                          str(2 ** 31 + 101), "--seconds", "1", "--control", "tf32"],
                         cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is False, line["checks"]
