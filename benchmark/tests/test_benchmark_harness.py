"""The harness finds every cell's files by name, takes new files without
edits, loads no JAX, counts operations as the arithmetic says, draws the
same traffic from the same seed, and refuses to run without a card."""

from __future__ import annotations

import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import flops, harness, traffic

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_finds_its_files_by_name(workload):
    cell = harness.load_cell(ROOT, workload)
    assert cell.config and cell.mix and cell.limits
    harness.driver(cell.mix)
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        mod = harness.load_module("metrics", m["name"])
        assert (mod.LAYER, mod.UNIT, mod.SOURCE, mod.MOVES) == (
            m["layer"], m["unit"], m["source"], m["moves"])
        assert m["moves"] in names


def test_benchmark_json_keeps_to_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in SPEC[section]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for c in SPEC["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for w in SPEC["workloads"]:
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4) and len(w["why"]) <= 200


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(p.relative_to(BENCH).as_posix()
                                        for p in BENCH.rglob("*.py")))
def test_nothing_imports_jax_and_the_reference_nothing_of_the_program(path):
    tops = {m.split(".")[0] for m in _imports(BENCH / path)}
    assert not tops & {"jax", "jaxlib", "flax", "madtp_tpu"}
    if path.startswith("reference/"):
        assert "madtp_tpu_torch" not in tops


def test_flop_count_is_the_layer_arithmetic_at_dense_widths():
    cfg = harness.load_cell(ROOT, "nlvr-eval-p50").config
    vit = cfg["vit"]
    D, L = vit["embed_dim"], vit["depth"]
    P = (vit["image_size"] // vit["patch_size"]) ** 2
    n = P + 1
    per_layer = 12 * n * D ** 2 + 2 * n ** 2 * D
    extra = P * 3 * vit["patch_size"] ** 2 * D + L * n * 100 * D * 2
    assert flops.vit_macs(vit, [P] * L) == per_layer * L + extra
    assert flops.layer_macs(n, n, D, 4 * D) == per_layer
    clip = harness.load_cell(ROOT, "clip-eval-p50").config
    W = clip["vision_width"]
    Pc = (clip["image_resolution"] // clip["vision_patch_size"]) ** 2
    nc = Pc + 1
    want = (clip["vision_layers"] * (12 * nc * W ** 2 + 2 * nc ** 2 * W + nc * 100 * W * 2)
            + Pc * 3 * clip["vision_patch_size"] ** 2 * W + nc * W * clip["embed_dim"])
    assert flops.clip_image_flops(clip, [Pc] * clip["vision_layers"]) == 2 * want


def test_equal_seeds_draw_equal_traffic_and_every_seed_the_same_sizes():
    from benchmark.tests import tiny

    cell = tiny.cell("nlvr-eval-p50")
    dev = torch.device("cpu")
    a = traffic.nlvr_batches(cell.mix, cell.config, 2 ** 31 + 7, dev)
    b = traffic.nlvr_batches(cell.mix, cell.config, 2 ** 31 + 7, dev)
    c = traffic.nlvr_batches(cell.mix, cell.config, 5, dev)
    for x, y in zip(a, b):
        for u, v in zip(x, y):
            np.testing.assert_array_equal(u, v)
    assert sorted(x.mask.sum() for x in a) == sorted(x.mask.sum() for x in c)
    assert not np.array_equal(a[0].image0, c[0].image0)
    clip = tiny.cell("clip-eval-p50")
    t1 = traffic.clip_captions(clip.mix, clip.config, 11)
    np.testing.assert_array_equal(t1, traffic.clip_captions(clip.mix, clip.config, 11))
    t2 = traffic.clip_captions(clip.mix, clip.config, 12)
    assert sorted(t1.argmax(1)) == sorted(t2.argmax(1))


FFN_METRIC = '''"""The ViT FFN's least time over its device time: the rows its launches
carry (every image's slots at each layer) at 4 D F operations a row."""
from benchmark.readings import images, traced, vit_slots
from benchmark.roofline import PEAK_FP32_CUDA_CORES, bound_s

LAYER, UNIT, SOURCE, MOVES = "kernels", "%", "device_trace", "eval_samples_per_s"


def read(run):
    batches = traced(run)
    if not batches:
        return None
    cfg = run.cell.config
    D = cfg["vit"]["embed_dim"]
    F = int(D * cfg["vit"]["mlp_ratio"])
    rows = sum(images(b) for b in batches) * sum(
        vit_slots(cfg, run.readings["capacities"]["vision"]))
    return 100.0 * bound_s(4.0 * rows * D * F, 0.0, PEAK_FP32_CUDA_CORES) / run.stretch.kernel_s(
        ("ffn",))
'''

# a run's raw readings as the NLVR eval driver records them, and a traced
# stretch, handed to the new metric in the copy
READ_IN_COPY = """
import json, sys, time, torch
from pathlib import Path
from benchmark import harness
c = harness.load_cell(Path('.'), 'nlvr-long-eval')
r = harness.Run(cell=c, seed=1, seconds=1, trace=True, device=torch.device('cpu'),
                t_start=time.perf_counter())
r.readings.update(json.loads(sys.argv[1]))
class Stretch:
    window_s, busy_s = 2.0, 1.5
    def kernel_s(self, names):
        return 0.25
r.stretch = Stretch()
print(c.config['name'], c.mix['text_lengths']['mean'], [m['name'] for m in c.per_layer],
      harness.driver(c.mix).__name__, harness.load_module('metrics', 'ffn_roofline.eval').read(r))
"""


def test_files_added_in_a_copy_are_picked_up_without_edits(tmp_path):
    """A new configuration, traffic mix, metric and cell, as files and
    entries alone, in a copy of the benchmark; the new metric works its
    value out from a run's raw readings."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    (tmp_path / "benchmark/configs/blip-nlvr-b16-224.json").write_text(json.dumps(
        dict(json.loads((BENCH / "configs/blip-nlvr-b16-384.json").read_text()),
             name="blip-nlvr-b16-224")))
    mix = json.loads((BENCH / "traffic/nlvr2-test-fast-eval.json").read_text())
    (tmp_path / "benchmark/traffic/nlvr2-long.json").write_text(json.dumps(
        dict(mix, text_lengths={"mean": 40.0, "std": 8.0, "min": 6, "max": 64})))
    (tmp_path / "benchmark/limits/nlvr-long-eval.json").write_text(
        (BENCH / "limits/nlvr-eval-p50.json").read_text())
    (tmp_path / "benchmark/metrics/ffn_roofline.eval.py").write_text(FFN_METRIC)
    spec["configs"].append({"name": "blip-nlvr-b16-224", "source": "https://example.org",
                            "file": "benchmark/configs/blip-nlvr-b16-224.json",
                            "reduced": [], "why": "a copy"})
    spec["workloads"].append({"name": "nlvr-long-eval", "config": "blip-nlvr-b16-224",
                              "traffic": "nlvr2-long", "chips": 1, "why": "long sentences"})
    spec["per_layer"].append({"name": "ffn_roofline.eval", "unit": "%", "better": "higher",
                              "source": "device_trace", "layer": "kernels",
                              "moves": "eval_samples_per_s", "workloads": ["nlvr-long-eval"]})
    for m in spec["end_to_end"]:
        if m["name"] == "eval_samples_per_s":
            m["workloads"].append("nlvr-long-eval")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    caps = [384] + [320] * 11
    batch = {"tower": "nlvr", "rows": 32, "width": 24, "v_kept": [300] * 12,
             "t_kept": [20] * 12}
    readings = {"capacities": {"vision": caps, "text": [24] * 12},
                "batches": [dict(batch, traced=k in (1, 2)) for k in range(4)]}
    out = subprocess.run([sys.executable, "-c", READ_IN_COPY, json.dumps(readings)],
                         cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    # two traced batches of 64 images, 384 + 11 * 320 slots each, 4 D F a row
    want = 100.0 * 4.0 * (2 * 64 * (384 + 11 * 320)) * 768 * 3072 / 67e12 / 0.25
    words = out.stdout.split()
    assert words[:4] == ["blip-nlvr-b16-224", "40.0", "['ffn_roofline.eval']",
                         "benchmark.drivers.nlvr_eval"]
    assert float(words[4]) == pytest.approx(want)


def test_the_bisection_finds_the_temperature_of_the_target():
    from benchmark import calibrate

    t = calibrate.bisect_temperature(lambda t: 100.0 / t, 100.0 / 4.47)
    assert t == pytest.approx(4.47, rel=0.01)


def test_the_harness_fails_without_a_card_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "nlvr-eval-p50",
                          "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr
