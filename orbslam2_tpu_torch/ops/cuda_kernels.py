"""Hand-written CUDA kernels and their plain PyTorch versions.

Counterpart of orbslam2_tpu/ops/pallas_kernels.py. The JAX package has one
Pallas TPU kernel, the tiled XOR-popcount Hamming matrix
(`hamming_matrix_pallas`); here it is `csrc/hamming.cu`, built for sm_90a
with nvcc into `build/` on first use (_build.py) and bound with ctypes.

`hamming_matrix` is the wrapper every matcher calls. On a CUDA tensor it
launches the kernel (or raises); on a CPU tensor it runs the plain version
`hamming_matrix_ref`, which is also what tests and chip_smoke.py compare the
kernel with. `hamming_matrix.launches` counts kernel launches, and
`hamming_matrix.launches_by` splits them by caller: the launches a thread
makes inside `launches_counted_as(name)` count under `name`, the others
under "tracker".

Descriptors are [N, 8] int32 tensors holding the bit patterns of the 8
uint32 words (PyTorch has no popcount and no uint32 shifts on the CPU); the
kernel reinterprets them as uint32.
"""
from __future__ import annotations

import contextlib
import ctypes
import threading

import numpy as np
import torch

from .._build import PKG_DIR, build_library
from ..utils.device import constant

DESC_WORDS = 8
# element budget of the plain version's [rows, B, 32] byte intermediate:
# 256 rows a chunk at B = 1024
_REF_CHUNK_ELEMS = 1 << 23
_HAMMING_SRC = PKG_DIR / "csrc" / "hamming.cu"
_lib = None
_count_lock = threading.Lock()
_caller = threading.local()


def _popcount8() -> np.ndarray:
    """Popcount of every byte value, indexed by the descriptors' uint8 view
    (a device constant: a fresh upload per call would wait for its copy)."""
    return np.array([bin(i).count("1") for i in range(256)], np.int32)


def _load_lib():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library("hamming", [_HAMMING_SRC], "nvcc")))
        lib.hamming_matrix_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.hamming_matrix_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def build_kernels() -> None:
    """Compile (if stale) and load every CUDA kernel of the package."""
    _load_lib()


def _check_desc(name: str, d: torch.Tensor) -> None:
    if d.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32 descriptor words, got {d.dtype}")
    if d.dim() != 2 or d.shape[1] != DESC_WORDS:
        raise ValueError(f"{name}: expected shape [N, {DESC_WORDS}], "
                         f"got {tuple(d.shape)}")
    if not d.is_contiguous():
        raise ValueError(f"{name}: descriptors must be contiguous")


def hamming_matrix_ref(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """Plain version: XOR on int32, uint8 view, popcount table, sum.

    Chunked over A so that the [rows, B, 32] byte intermediate stays below
    _REF_CHUNK_ELEMS elements ([4096, 1024] would otherwise need 1 GB)."""
    A, B = desc_a.shape[0], desc_b.shape[0]
    out = torch.empty((A, B), dtype=torch.int32, device=desc_a.device)
    table = constant("popcount8", _popcount8, desc_a.device)
    rows = max(1, _REF_CHUNK_ELEMS // max(1, B * 4 * DESC_WORDS))
    for s in range(0, A, rows):
        x = torch.bitwise_xor(desc_a[s:s + rows, None, :], desc_b[None, :, :])
        bytes_ = x.contiguous().view(torch.uint8).to(torch.int32)
        out[s:s + rows] = table[bytes_].sum(-1, dtype=torch.int32)
    return out


def hamming_matrix(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """[A, 8] int32 x [B, 8] int32 -> [A, B] int32 Hamming distances."""
    _check_desc("desc_a", desc_a)
    _check_desc("desc_b", desc_b)
    if desc_a.device != desc_b.device:
        raise ValueError(f"descriptors on different devices: "
                         f"{desc_a.device} and {desc_b.device}")
    if desc_a.device.type == "cpu":
        return hamming_matrix_ref(desc_a, desc_b)
    if desc_a.device.type != "cuda":
        raise ValueError(f"no Hamming kernel for device {desc_a.device}")
    A, B = desc_a.shape[0], desc_b.shape[0]
    out = torch.empty((A, B), dtype=torch.int32, device=desc_a.device)
    if A == 0 or B == 0:
        return out  # nothing to compute: no launch
    lib = _load_lib()
    with torch.cuda.device(desc_a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.hamming_matrix_launch(desc_a.data_ptr(), desc_b.data_ptr(),
                                        out.data_ptr(), A, B, stream)
    if err != 0:
        raise RuntimeError(f"hamming kernel launch failed: CUDA error {err}")
    with _count_lock:
        hamming_matrix.launches += 1
        who = getattr(_caller, "name", "tracker")
        hamming_matrix.launches_by[who] = hamming_matrix.launches_by.get(who, 0) + 1
    return out


def reset_launch_counts() -> None:
    with _count_lock:
        hamming_matrix.launches = 0
        hamming_matrix.launches_by = {}


@contextlib.contextmanager
def launches_counted_as(name: str):
    """Count this thread's kernel launches under `name` inside the block."""
    prev = getattr(_caller, "name", "tracker")
    _caller.name = name
    try:
        yield
    finally:
        _caller.name = prev


reset_launch_counts()
