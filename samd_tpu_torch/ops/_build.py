"""Build the port's CUDA kernels with nvcc and load them with ctypes.

A kernel is one source ``samd_tpu_torch/csrc/<name>.cu`` with a plain C
interface.  At first use a source is compiled for ``sm_90a`` into
``samd_tpu_torch/csrc/build/`` (listed in ``.gitignore``) under a name that
carries a hash of the source and flags, so an edited source is never served
a stale library.  ``build_all`` compiles every source, one nvcc per source,
all started together.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
SOURCES = ("flash_block_attention", "int4_matmul")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build only where the CUDA "
            "toolkit is installed")
    return path


def _paths(name: str) -> Tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return src, BUILD_DIR / f"lib{name}_{digest}.so"


def _compile(name: str) -> float:
    """Compile ``name`` unless it is built already; the seconds nvcc took
    (0.0 for a library already built)."""
    src, lib = _paths(name)
    if lib.exists():
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    log = lib.with_suffix(".log")
    t0 = time.perf_counter()
    with open(log, "w") as fh:
        rc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                            stdout=fh, stderr=subprocess.STDOUT).returncode
    if rc != 0:
        raise RuntimeError(
            f"nvcc failed for {name} (rc {rc}):\n{log.read_text()[-4000:]}")
    os.replace(tmp, lib)
    return time.perf_counter() - t0


def build_all() -> Dict[str, float]:
    """Compile every kernel source not built yet, all nvcc processes at
    once.  Returns each source's nvcc seconds (0.0 where already built);
    raises with nvcc's output if any build fails."""
    _nvcc()
    with ThreadPoolExecutor(max_workers=len(SOURCES)) as pool:
        futures = {name: pool.submit(_compile, name) for name in SOURCES}
        return {name: f.result() for name, f in futures.items()}


def build_log(name: str) -> str:
    """nvcc's output (ptxas register and shared-memory report) for the
    current build of ``name``; empty if it has not been built here."""
    log = _paths(name)[1].with_suffix(".log")
    return log.read_text() if log.exists() else ""


def sass_counts(name: str, ops: Tuple[str, ...] = ("HMMA",)
                ) -> Dict[str, Dict[str, int]]:
    """Each kernel function (mangled name) of the built library ``name``
    and how many instructions of each opcode in ``ops`` its SASS holds,
    from ``cuobjdump -sass``; builds the library first if needed."""
    _compile(name)
    cuobjdump = Path(_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(_paths(name)[1])],
                          capture_output=True, text=True, check=True).stdout
    counts: Dict[str, Dict[str, int]] = {}
    fn = None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = dict.fromkeys(ops, 0)
        elif fn is not None:
            for op in ops:
                if f" {op}" in line or f"\t{op}" in line:
                    counts[fn][op] += 1
    return counts


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library of ``name`` (built first if needed)."""
    if name not in SOURCES:
        raise ValueError(f"unknown kernel source {name!r}")
    _compile(name)
    return ctypes.CDLL(str(_paths(name)[1]))
