"""Builds a CUDA source of the port for the CPU emulator in ``cuda_emu.h``.

The source is turned into host C++: its PTX helpers (``cp_async16``,
``ldmatrix_x4``, ``mma_bf16``, ...) are dropped for the header's emulated
ones, ``extern __shared__`` arrays point at the block's emulated shared
memory, and ``kernel<<<grid, block, smem, stream>>>(args)`` becomes
``emu_launch`` (``cudaLaunchKernelEx`` with a cluster dimension runs the
cluster's blocks together).  g++ compiles it, with ``CUDA_EMULATOR`` defined
(``csrc/ffn.cu`` then builds its fp32 half alone), into a shared library
under ``build/emu`` at the repository root, loaded with ``ctypes``: the same
C entry point as the nvcc build, taking host pointers."""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

HERE = Path(__file__).resolve().parent
OUT = HERE.parent / "build" / "emu"
# -fsanitize=alignment: a misaligned vector access (a float4 off its 16 bytes)
# aborts here as it faults on the card
GXX_FLAGS = ("-std=c++17", "-O1", "-shared", "-fPIC", "-DCUDA_EMULATOR", "-Wno-unused",
             "-fsanitize=alignment", "-fno-sanitize-recover=alignment")
HELPERS = ("smem_addr", "cp_async16", "cp_async4", "cp_async_commit", "cp_async_wait",
           "ldmatrix_x4", "ldmatrix_x4_trans", "mma_bf16", "mma_tf32", "to_tf32", "ex2",
           "cluster_sync", "ld_cluster4")


def _drop_function(src: str, name: str) -> str:
    m = re.search(r"(template\s*<[^>]*>\s*)?__device__ __forceinline__ [\w:]+ " + name + r"\(",
                  src)
    if not m:
        return src
    depth, j = 0, src.index("{", m.end())
    while True:
        depth += {"{": 1, "}": -1}.get(src[j], 0)
        if depth == 0:
            return src[:m.start()] + src[j + 1:]
        j += 1


def _launches(src: str) -> str:
    out, pos = [], 0
    pat = re.compile(r"([\w:]+(?:<[^<>;]*>)?)<<<(.*?)>>>\(", re.S)
    for m in pat.finditer(src):
        out += [src[pos:m.start()], f"emu_launch(EMU_CFG({m.group(2)}), {m.group(1)}, "]
        pos = m.end()
    return "".join(out) + src[pos:]


def host_source(src: str) -> str:
    src = src.replace("#include <cuda_bf16.h>", '#include "cuda_emu.h"')
    src = src.replace("#include <cuda_runtime.h>", "")
    for name in HELPERS:
        src = _drop_function(src, name)
    src = re.sub(r"extern __shared__ (?:__align__\(\d+\) )?([\w ]+) (\w+)\[\];",
                 r"\1* \2 = (\1*)emu_dyn_smem();", src)
    return _launches(src)


def available() -> bool:
    return shutil.which("g++") is not None


def build(source: Path) -> ctypes.CDLL:
    """Compiles ``source`` (if its text or the header changed) and loads it."""
    text = host_source(source.read_text())
    key = hashlib.sha256((text + (HERE / "cuda_emu.h").read_text()
                          + " ".join(GXX_FLAGS)).encode()).hexdigest()[:16]
    lib = OUT / f"{source.stem}-{key}.so"
    if not lib.exists():
        OUT.mkdir(parents=True, exist_ok=True)
        cpp = lib.with_suffix(f".{os.getpid()}.cpp")
        cpp.write_text(text)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run(["g++", *GXX_FLAGS, f"-I{HERE}", "-o", str(tmp), str(cpp)], check=True,
                       capture_output=True, text=True)
        tmp.replace(lib)
    return ctypes.CDLL(str(lib))
