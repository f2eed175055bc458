"""nvcc build of the package's CUDA sources into shared libraries with a
plain C interface, loaded with ctypes.

A library builds at first use into `build/kernels/` at the root of the
checkout (listed in .gitignore), named by a hash of its source, of every
csrc header it includes (`#include "x.cuh"`, followed recursively) and of
the flags, so a changed source or header rebuilds and an unchanged one
loads.  Only sources in this repository are compiled: no library kernels,
no torch headers.  A failed nvcc raises with its stderr.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

from mc_path_tracer_tpu_torch.utils.profiling import span

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


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def included_headers(source: Path) -> list[Path]:
    """The local headers `source` includes, directly or through another
    header, in first-seen order."""
    seen: list[Path] = []
    todo = [source]
    while todo:
        including = todo.pop(0)
        for name in _INCLUDE.findall(including.read_bytes()):
            header = (including.parent / name.decode()).resolve()
            if header not in seen:
                seen.append(header)
                todo.append(header)
    return seen


def library_path(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes())
    for header in included_headers(source):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
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


def load_all(names) -> dict[str, tuple[ctypes.CDLL, BuildInfo]]:
    """Build (where needed) and load csrc/<name>.cu for each name, cached
    per process.  The missing libraries build in parallel: one nvcc per
    source, all started together; each builds to a private name and is
    then renamed, so concurrent builders never load a half-written
    library.  A call that loads anything runs inside the kept span
    `mcpt::kernels.load` (utils/profiling), whose ident holds each loaded
    library's (name, nvcc seconds): 0 where its hash was already built."""
    todo = [n for n in dict.fromkeys(names) if n not in _LOADED]
    if todo:
        with span("mcpt::kernels.load", keep=True) as sp:
            _build_and_load(todo)
            sp.ident = tuple((name, _LOADED[name][1].seconds) for name in todo)
    return {name: _LOADED[name] for name in names}


def _build_and_load(todo: list[str]) -> None:
    """load_all's work for the libraries not loaded yet."""
    jobs = []
    try:
        for name in todo:
            source = CSRC_DIR / f"{name}.cu"
            out = library_path(source)
            if out.exists():
                jobs.append((name, source, out, None, None, 0.0))
                continue
            nvcc = nvcc_path()
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                proc = subprocess.Popen(nvcc_command(source, Path(tmp), nvcc),
                                        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                        text=True)
            except OSError:
                os.unlink(tmp)
                raise
            jobs.append((name, source, out, proc, tmp, time.perf_counter()))
        built = {}
        for name, source, out, proc, tmp, t0 in jobs:
            seconds, log = 0.0, ""
            if proc is not None:
                _, log = proc.communicate(timeout=600)
                seconds = time.perf_counter() - t0
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed on {source} (exit {proc.returncode}):\n{log}")
                os.replace(tmp, out)
            built[name] = (out, seconds, log)
    finally:
        for _, _, _, proc, tmp, _ in jobs:
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
            if tmp is not None and os.path.exists(tmp):
                os.unlink(tmp)
    for name, (out, seconds, log) in built.items():
        _LOADED[name] = (ctypes.CDLL(str(out)), BuildInfo(out, seconds, log))


def load(name: str) -> tuple[ctypes.CDLL, BuildInfo]:
    """Build (if needed) and load csrc/<name>.cu; cached per process."""
    return load_all([name])[name]


def bind(name: str, argtypes: dict[str, list]) -> ctypes.CDLL:
    """load(name) with each entry point of `argtypes` bound to its ctypes
    argument list and an int (cudaError_t) result, once per process."""
    lib, _ = load(name)
    if not getattr(lib, "_mcpt_bound", False):
        for fn, args in argtypes.items():
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = ctypes.c_int
        lib._mcpt_bound = True
    return lib
