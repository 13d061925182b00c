"""Builds the port's native libraries from the sources in the checkout.

Every library goes into `build/` at the repository root (listed in
.gitignore), never next to its source. A library is rebuilt when it is
missing or older than any of its sources. A file lock serializes the build
across processes (pytest workers, several runs on one checkout), and the
compiler writes to a temporary name that is renamed into place, so a reader
never loads a half-written library.

Two toolchains:
- `nvcc` for the CUDA kernels (csrc/*.cu), a plain C interface loaded with
  ctypes. There is no fallback: a caller that needs a kernel gets an error
  when nvcc is missing or the build fails.
- `g++` for the host map operations (native/mapops.cpp).
"""
from __future__ import annotations

import fcntl
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent
BUILD_DIR = PKG_DIR.parent / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

# seconds spent compiling in this process, by library name (chip_smoke.py
# reports it as the build time)
build_seconds: dict[str, float] = {}


def _stale(lib: Path, sources: list[Path]) -> bool:
    if not lib.exists():
        return True
    t = lib.stat().st_mtime
    return any(s.stat().st_mtime > t for s in sources)


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and Path("/usr/local/cuda/bin/nvcc").exists():
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return nvcc


def build_library(name: str, sources: list[Path], compiler: str,
                  headers: tuple[Path, ...] = ()) -> Path:
    """Return the path of lib<name>.so, compiling it first if needed.

    compiler: "nvcc" or "g++". headers: files the sources include, which
    make the library stale like a source but are not given to the compiler.
    Raises RuntimeError (with the compiler's output) when the build fails."""
    if compiler not in ("nvcc", "g++"):
        raise ValueError(f"unknown compiler {compiler!r}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = BUILD_DIR / f"lib{name}.so"
    inputs = [*sources, *headers]
    if not _stale(lib, inputs):
        return lib
    with open(BUILD_DIR / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not _stale(lib, inputs):  # another process built it meanwhile
                return lib
            tmp = BUILD_DIR / f".lib{name}.{os.getpid()}.so"
            if compiler == "nvcc":
                cmd = [_find_nvcc(), *NVCC_FLAGS]
            else:
                cmd = ["g++", *GXX_FLAGS]
            cmd += ["-o", str(tmp), *map(str, sources)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=600)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"building lib{name}.so failed ({' '.join(cmd)}):\n"
                    f"{proc.stdout}\n{proc.stderr}")
            os.replace(tmp, lib)
            build_seconds[name] = time.perf_counter() - t0
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return lib
