"""Builds and loads the native octree library.

The counterpart of ``fourier_feature_nets_tpu/octree/build.py``:
``csrc/octree.cpp`` (a plain C interface) is compiled with ``g++`` at
first use into ``octree/_build/`` (listed in ``.gitignore``), under a
name that carries a hash of the source, the flags, the compiler's
version and the host (``-march=native`` code runs only where it was
built), and is loaded with ``ctypes``. Unlike the JAX package there is
no NumPy fallback: a failed build raises ``RuntimeError`` with the
compiler's output. Nothing here runs at import time.
"""

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
from pathlib import Path

__all__ = ["load_library"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "octree.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
# the JAX package's flags (its build.py), so both libraries compute the
# same floats
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_LIBRARY = None


def _compiler() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found: the octree library is built "
                           "with a host C++ compiler")
    return found


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64 = ctypes.c_int64
    f32 = ctypes.c_float
    p_i64 = ctypes.POINTER(ctypes.c_int64)
    p_i32 = ctypes.POINTER(ctypes.c_int32)
    p_f32 = ctypes.POINTER(ctypes.c_float)
    p_f64 = ctypes.POINTER(ctypes.c_double)

    lib.octree_build.restype = i64
    lib.octree_build.argtypes = [p_f32, i64, p_f64, i64,
                                 ctypes.c_int, i64, f32]
    lib.octree_counts.restype = None
    lib.octree_counts.argtypes = [i64, p_i64, p_i64, p_i64]
    lib.octree_export.restype = None
    lib.octree_export.argtypes = [i64, p_i64, p_i64, p_f64]
    lib.octree_release.restype = None
    lib.octree_release.argtypes = [i64]
    lib.octree_batch_query.restype = None
    lib.octree_batch_query.argtypes = [f32, p_i64, i64, p_i64, i64,
                                       p_f32, i64, p_i64]
    lib.octree_batch_intersect.restype = None
    lib.octree_batch_intersect.argtypes = [f32, p_i64, i64, p_i64, i64,
                                           p_f32, p_f32, i64, i64,
                                           p_f32, p_i64]
    lib.octree_decode_ids.restype = None
    lib.octree_decode_ids.argtypes = [p_i64, i64, f32, p_f32, p_i32]
    return lib


def load_library() -> ctypes.CDLL:
    """The native library, compiled on first use; raises
    ``RuntimeError`` with the compiler's output when the build fails."""
    global _LIBRARY
    if _LIBRARY is not None:
        return _LIBRARY
    compiler = _compiler()
    version = subprocess.run([compiler, "--version"], capture_output=True,
                             text=True, check=False).stdout
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()
        + version.encode() + platform.node().encode()).hexdigest()[:16]
    # ".so.lib": loadable by ctypes, never mistaken for a Python module
    target = BUILD_DIR / f"octree_{digest}.so.lib"
    if not target.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        partial = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        done = subprocess.run(
            [compiler, *CXX_FLAGS, str(SOURCE), "-o", str(partial)],
            capture_output=True, text=True, check=False)
        if done.returncode != 0:
            raise RuntimeError(
                f"g++ failed on {SOURCE.name} (exit {done.returncode}):\n"
                + (done.stdout + done.stderr).strip())
        os.replace(partial, target)
    _LIBRARY = _declare(ctypes.CDLL(str(target)))
    return _LIBRARY
