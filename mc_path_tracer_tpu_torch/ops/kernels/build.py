"""nvcc build of the package's CUDA sources into shared libraries with a
plain C interface, loaded with ctypes.

A library builds at first use into `build/kernels/` at the root of the
checkout (listed in .gitignore), named by a hash of its source and flags,
so a changed source rebuilds and an unchanged one loads.  Only sources in
this repository are compiled: no library kernels, no torch headers.
A failed nvcc raises with its stderr.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

CSRC_DIR = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# --fmad=false keeps every multiply and add separately rounded, as the
# plain PyTorch versions round them, so kernel and plain agree on the card
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "--fmad=false", "-Xptxas=-v",
              "-shared", "-Xcompiler", "-fPIC"]


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def library_path(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{source.stem}_{digest.hexdigest()[:16]}.so"


def nvcc_command(source: Path, output: Path, nvcc: str = "nvcc") -> list[str]:
    return [nvcc, *NVCC_FLAGS, "-o", str(output), str(source)]


class BuildInfo(NamedTuple):
    """What loading a library took: its path, the nvcc seconds and nvcc's
    resource report (0 and empty when the library was already built)."""

    path: Path
    seconds: float
    log: str


_LOADED: dict[str, tuple[ctypes.CDLL, BuildInfo]] = {}


def load(name: str) -> tuple[ctypes.CDLL, BuildInfo]:
    """Build (if needed) and load csrc/<name>.cu; cached per process."""
    if name in _LOADED:
        return _LOADED[name]
    source = CSRC_DIR / f"{name}.cu"
    out = library_path(source)
    seconds, log = 0.0, ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # build to a private name, then rename: concurrent builders never
        # load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        proc = subprocess.run(nvcc_command(source, Path(tmp), nvcc_path()),
                              capture_output=True, text=True, timeout=600)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed on {source} (exit {proc.returncode}):\n{proc.stderr}"
            )
        os.replace(tmp, out)
        log = proc.stderr
    lib = ctypes.CDLL(str(out))
    _LOADED[name] = (lib, BuildInfo(out, seconds, log))
    return _LOADED[name]
