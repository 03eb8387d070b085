"""Build the CUDA sources under ``madtp_tpu_torch/csrc`` with ``nvcc`` and load
them with ``ctypes``.

Each source is compiled on its own, for ``sm_90a``, into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds).  The
library lands in ``build/`` at the repository root under a name that carries
a hash of the source and flags, so an edited source builds anew and an
unchanged one is loaded as it is.  Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


@dataclass
class Built:
    lib: ctypes.CDLL
    path: Path
    seconds: float  # 0.0 when an earlier build was reused
    log: str  # nvcc's output (ptxas registers and shared memory per kernel)


_LOADED: Dict[str, Built] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def _target(source: Path) -> Path:
    h = hashlib.sha256(source.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{source.stem}-{h.hexdigest()[:16]}.so"


def build(source_name: str) -> Built:
    """Compile ``csrc/<source_name>`` if needed and load it (once per process)."""
    if source_name in _LOADED:
        return _LOADED[source_name]
    source = CSRC_DIR / source_name
    target = _target(source)
    seconds, log = 0.0, ""
    if not target.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{log}")
        os.replace(tmp, target)  # atomic: a concurrent build sees all or nothing
    built = Built(ctypes.CDLL(str(target)), target, seconds, log)
    _LOADED[source_name] = built
    return built


def build_all(source_names: List[str]) -> Dict[str, Built]:
    """Build several sources with one ``nvcc`` each, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=max(1, len(source_names))) as pool:
        futures = {n: pool.submit(build, n) for n in source_names}
        return {n: f.result() for n, f in futures.items()}
