"""ctypes binding of the native BVH builder (csrc/bvh.cpp).

The library builds at first use with the system C++ compiler into
`build/native/` at the root of the checkout (listed in .gitignore), named
by a hash of the source and flags, so a changed source rebuilds and an
unchanged one loads.  The flags are those of the JAX package's native
Makefile, so on one machine both packages build the same tree.  Where no
compiler is found or the build fails, `bvh_build_native` returns None and
the caller takes the numpy builder.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from functools import lru_cache
from pathlib import Path

import numpy as np

from mc_path_tracer_tpu_torch.utils.profiling import spanned

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "bvh.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-march=native", "-shared"]

SAH = 0
MIDDLE = 1
EQUAL_COUNTS = 2
LBVH = 3


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libmcpt_native_{digest.hexdigest()[:16]}.so"


def _compile(out: Path) -> bool:
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build to a private name, then rename: concurrent builders never load
    # a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, timeout=300)
    except (OSError, subprocess.SubprocessError):
        os.unlink(tmp)
        return False
    if proc.returncode != 0:
        os.unlink(tmp)
        return False
    os.replace(tmp, out)
    return True


@lru_cache(maxsize=1)
@spanned("mcpt::native.load", keep=True)
def load_native():
    """Load (building if necessary) the native library; None if unavailable."""
    out = library_path()
    if not out.exists() and not _compile(out):
        return None
    try:
        lib = ctypes.CDLL(str(out))
    except OSError:
        return None
    fp, ip = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)
    lib.mcpt_bvh_build.restype = ctypes.c_int
    lib.mcpt_bvh_build.argtypes = [
        fp, fp,                           # tri_bmin, tri_bmax
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # n, max_leaf, method
        ip,                               # prim_order
        fp, fp,                           # node_bmin, node_bmax
        ip, ip, ip,                       # node_first, node_count, node_skip
    ]
    return lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))


def bvh_build_native(tri_bmin: np.ndarray, tri_bmax: np.ndarray,
                     max_leaf: int = 4, method: int = SAH):
    """Build a threaded BVH with the native builder.

    Returns (bmin [N,3], bmax [N,3], first [N], count [N], skip [N],
    prim_order [T]) as numpy arrays, or None if the library is unavailable.
    """
    lib = load_native()
    if lib is None:
        return None
    n = int(tri_bmin.shape[0])
    tri_bmin = np.ascontiguousarray(tri_bmin, dtype=np.float32)
    tri_bmax = np.ascontiguousarray(tri_bmax, dtype=np.float32)
    cap = 2 * n
    node_bmin = np.empty((cap, 3), np.float32)
    node_bmax = np.empty((cap, 3), np.float32)
    node_first = np.empty(cap, np.int32)
    node_count = np.empty(cap, np.int32)
    node_skip = np.empty(cap, np.int32)
    prim_order = np.empty(n, np.int32)
    n_nodes = lib.mcpt_bvh_build(
        _fptr(tri_bmin), _fptr(tri_bmax), n, max_leaf, method,
        _iptr(prim_order), _fptr(node_bmin), _fptr(node_bmax),
        _iptr(node_first), _iptr(node_count), _iptr(node_skip),
    )
    if n_nodes < 0:
        return None
    return (
        node_bmin[:n_nodes].copy(),
        node_bmax[:n_nodes].copy(),
        node_first[:n_nodes].copy(),
        node_count[:n_nodes].copy(),
        node_skip[:n_nodes].copy(),
        prim_order,
    )
