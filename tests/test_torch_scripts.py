"""The port's launch scripts (``scripts/torch/*.sh``): one for each of the JAX
package's ``scripts/*.sh``, running the same driver of ``madtp_tpu_torch.cli``
with the same flags, one process a card, and its flags parse with that
driver's own parser."""

import glob
import importlib
import os
import re
import shlex
import subprocess

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SCRIPTS = sorted(os.path.basename(p) for p in glob.glob(os.path.join(REPO, "scripts", "*.sh")))


def _command(path, package):
    """``(driver, flags)`` of the script's ``python -m <package>.cli.<driver>``
    line, its continuation lines joined."""
    code = " ".join(line.strip().rstrip("\\") for line in open(path).read().splitlines()
                    if line.strip() and not line.lstrip().startswith("#"))
    m = re.search(rf"python -m {re.escape(package)}\.cli\.(\w+)\s+([^&]*)", code)
    assert m, f"{path} runs no {package}.cli driver"
    return m.group(1), shlex.split(m.group(2))


def test_one_port_script_for_each():
    assert len(JAX_SCRIPTS) == 34
    port = sorted(os.path.basename(p)
                  for p in glob.glob(os.path.join(REPO, "scripts", "torch", "*.sh")))
    assert port == JAX_SCRIPTS


@pytest.mark.parametrize("name", JAX_SCRIPTS)
def test_port_script_runs_the_same_driver_and_flags(name):
    path = os.path.join(REPO, "scripts", "torch", name)
    assert os.access(path, os.X_OK)
    assert subprocess.run(["bash", "-n", path]).returncode == 0
    driver, flags = _command(path, "madtp_tpu_torch")
    jax_driver, jax_flags = _command(os.path.join(REPO, "scripts", name), "madtp_tpu")
    assert driver == jax_driver
    rank = flags.index("--num_processes")
    assert flags[rank:] == ["--num_processes", "$N", "--process_id", "$r", "--coordinator",
                            "127.0.0.1:$PORT"]
    assert flags[:rank] == jax_flags
    module = importlib.import_module(f"madtp_tpu_torch.cli.{driver}")
    args = module.build_parser().parse_args(
        flags[:rank] + ["--num_processes", "2", "--process_id", "1", "--coordinator",
                        "127.0.0.1:29500"])
    assert (args.num_processes, args.process_id) == (2, 1)
    assert args.output_dir == jax_flags[jax_flags.index("--output_dir") + 1]
