"""Builds the port's CUDA sources into shared libraries at first use.

Each ``csrc/*.cu`` file has a plain C interface. It is compiled with
``nvcc`` for ``sm_90a`` into ``kernels/_build/`` (listed in
``.gitignore``), under a name that carries a hash of the source, the
shared headers (``csrc/*.cuh``) and the flags, so an edited source is
rebuilt and an unchanged one is reused.
The library is then loaded with ``ctypes``. Nothing here runs at import
time: a machine without CUDA imports the package and never builds. Each
build or load is a set-up span, ``kernels.build`` (``utils.tracing``),
whose ``built`` says whether nvcc ran.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

from ..utils.tracing import setup_span

__all__ = ["BuiltLibrary", "build_library"]

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class BuiltLibrary(NamedTuple):
    """A loaded kernel library and how it was obtained."""

    lib: ctypes.CDLL
    path: Path
    seconds: float   # nvcc wall time; 0.0 when the cached build was reused
    log: str         # nvcc/ptxas output (registers, shared memory, spills)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build on a "
                       "machine with the CUDA toolkit")


def build_library(source_name: str) -> BuiltLibrary:
    """Compiles ``csrc/<source_name>`` (if not built yet) and loads it."""
    with setup_span("kernels.build", source=source_name) as built:
        library = _build_library(source_name)
        built.set(built=library.seconds > 0.0)
    return library


def _build_library(source_name: str) -> BuiltLibrary:
    source = CSRC_DIR / source_name
    content = source.read_bytes() + b"".join(
        header.read_bytes() for header in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(content
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    stem = source_name.rsplit(".", 1)[0]
    target = BUILD_DIR / f"{stem}_{digest}.so"
    seconds = 0.0
    log = f"reused {target.name}"
    if not target.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        partial = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        start = time.perf_counter()
        done = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(partial), str(source)],
            capture_output=True, text=True, check=False)
        seconds = time.perf_counter() - start
        log = (done.stdout + done.stderr).strip()
        if done.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source_name} "
                               f"(exit {done.returncode}):\n{log}")
        os.replace(partial, target)
    return BuiltLibrary(ctypes.CDLL(str(target)), target, seconds, log)
