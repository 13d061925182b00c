"""Hand-written CUDA kernels and their plain PyTorch versions.

Counterpart of orbslam2_tpu/ops/pallas_kernels.py. The JAX package has one
Pallas TPU kernel, the tiled XOR-popcount Hamming matrix
(`hamming_matrix_pallas`); the port has it in two forms, both on the tensor
cores' single-bit mma (csrc/hamming_tile.cuh), and a third kernel for the
one Hamming computation the JAX package does outside it. All are built for
sm_90a with nvcc into `build/` on first use (_build.py) and bound with
ctypes:

- `hamming_matrix` (csrc/hamming.cu): the same function, [A, 8] x [B, 8] ->
  [A, B] int32. Plain version `hamming_matrix_ref`.
- `hamming_best2` (csrc/hamming_best2.cu): the matrix fused with the masked
  best / second-best reduction that every matcher applies to it, so the
  [A, B] distances never reach device memory. Plain version
  `hamming_best2_ref`.
- `bow_assign` (csrc/bow_assign.cu): the vocabulary-tree descent of
  orbslam2_tpu/ops/bow.py `assign_words` (an XLA program with an inline
  XOR-popcount over gathered children, no Pallas source), one warp a
  descriptor. Plain version `bow_assign_ref`.

On a CUDA tensor a wrapper launches its kernel (or raises); on a CPU tensor
it runs its plain version, which is also what tests and chip_smoke.py compare
the kernel with. `<wrapper>.launches` counts kernel launches, and
`<wrapper>.launches_by` splits them by caller: the launches a thread makes
inside `launches_counted_as(name)` count under `name`, the others under
"tracker".

Descriptors are [N, 8] int32 tensors holding the bit patterns of the 8
uint32 words (PyTorch has no popcount and no uint32 shifts on the CPU); the
kernels reinterpret them as uint32.
"""
from __future__ import annotations

import contextlib
import ctypes
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .._build import PKG_DIR, build_library
from ..utils.device import constant

DESC_WORDS = 8
# element budget of the plain version's [rows, B, 32] byte intermediate:
# 256 rows a chunk at B = 1024
_REF_CHUNK_ELEMS = 1 << 23
BIG = 1 << 20  # the "no match" distance of every matcher
# most descriptors in desc_b: hamming_best2 packs a column into 22 bits of a
# key, and hamming.cu puts the 64-column tiles on the grid's y axis
MAX_COLUMNS = 1 << 22
_CSRC = PKG_DIR / "csrc"
_TILE_HEADER = _CSRC / "hamming_tile.cuh"
_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# library name -> (source, headers it includes, launch function, its
# argument types)
_KERNELS = {
    "hamming": (_CSRC / "hamming.cu", (_TILE_HEADER,), "hamming_matrix_launch",
                [_PTR, _PTR, _PTR, _INT, _INT, _PTR]),
    "hamming_best2": (_CSRC / "hamming_best2.cu", (_TILE_HEADER,),
                      "hamming_best2_launch",
                      [_PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _INT, _INT, _PTR]),
    "bow_assign": (_CSRC / "bow_assign.cu", (), "bow_assign_launch",
                   [_PTR] * 8 + [_INT] * 4 + [_PTR]),
}
_launchers: dict = {}
_load_lock = threading.Lock()
_count_lock = threading.Lock()
_caller = threading.local()


def _popcount8() -> np.ndarray:
    """Popcount of every byte value, indexed by the descriptors' uint8 view
    (a device constant: a fresh upload per call would wait for its copy)."""
    return np.array([bin(i).count("1") for i in range(256)], np.int32)


def _library(name: str):
    """Path of library `name`, compiled first if it is stale."""
    source, headers = _KERNELS[name][:2]
    return build_library(name, [source], "nvcc", headers=headers)


def _launcher(name: str):
    """The launch function of library `name`, built and loaded on first use."""
    with _load_lock:
        if name not in _launchers:
            _, _, fn_name, argtypes = _KERNELS[name]
            fn = getattr(ctypes.CDLL(str(_library(name))), fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _launchers[name] = fn
        return _launchers[name]


def build_kernels() -> None:
    """Compile (if stale) and load every CUDA kernel of the package, one
    nvcc per source, all started together."""
    with ThreadPoolExecutor(len(_KERNELS)) as pool:
        list(pool.map(_library, _KERNELS))
    for name in _KERNELS:
        _launcher(name)


def _check_desc(name: str, d: torch.Tensor) -> None:
    if d.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32 descriptor words, got {d.dtype}")
    if d.dim() != 2 or d.shape[1] != DESC_WORDS:
        raise ValueError(f"{name}: expected shape [N, {DESC_WORDS}], "
                         f"got {tuple(d.shape)}")
    if not d.is_contiguous():
        raise ValueError(f"{name}: descriptors must be contiguous")
    if d.data_ptr() % 8 != 0:
        raise ValueError(f"{name}: descriptors must be 8-byte aligned")


def _check_pair(desc_a: torch.Tensor, desc_b: torch.Tensor) -> None:
    _check_desc("desc_a", desc_a)
    _check_desc("desc_b", desc_b)
    if desc_a.device != desc_b.device:
        raise ValueError(f"descriptors on different devices: "
                         f"{desc_a.device} and {desc_b.device}")
    if desc_a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no Hamming kernel for device {desc_a.device}")
    if desc_b.shape[0] > MAX_COLUMNS:
        raise ValueError(f"desc_b: at most {MAX_COLUMNS} descriptors, "
                         f"got {desc_b.shape[0]}")


def _launch(wrapper, name: str, device: torch.device, *args) -> None:
    """Launch library `name`'s kernel on `device`'s current stream, raise on
    a refused launch, and count the launch on `wrapper`."""
    fn = _launcher(name)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    with _count_lock:
        wrapper.launches += 1
        who = getattr(_caller, "name", "tracker")
        wrapper.launches_by[who] = wrapper.launches_by.get(who, 0) + 1


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
    _check_pair(desc_a, desc_b)
    if desc_a.device.type == "cpu":
        return hamming_matrix_ref(desc_a, desc_b)
    A, B = desc_a.shape[0], desc_b.shape[0]
    out = torch.empty((A, B), dtype=torch.int32, device=desc_a.device)
    if A == 0 or B == 0:
        return out  # nothing to compute: no launch
    _launch(hamming_matrix, "hamming", desc_a.device, desc_a.data_ptr(),
            desc_b.data_ptr(), out.data_ptr(), A, B)
    return out


def masked_best2(dist: torch.Tensor, cand: torch.Tensor):
    """Best and second-best of every row of a given [A, B] distance matrix
    over the candidate columns: BIG outside the mask, argmin (first index
    among ties, as jnp.argmin), and the minimum with the best column set to
    BIG. Returns (idx, best, second), each [A] int32."""
    d = torch.where(cand, dist, BIG)
    idx = torch.argmin(d, dim=1, keepdim=True)
    best = d.gather(1, idx)[:, 0]
    second = d.scatter(1, idx, BIG).amin(dim=1)
    return idx[:, 0].to(torch.int32), best, second


def hamming_best2_ref(desc_a: torch.Tensor, desc_b: torch.Tensor,
                      cand: torch.Tensor):
    """Plain version of `hamming_best2`: the dense matrix, then its masked
    reduction."""
    return masked_best2(hamming_matrix_ref(desc_a, desc_b), cand)


def hamming_best2(desc_a: torch.Tensor, desc_b: torch.Tensor,
                  cand: torch.Tensor):
    """Best and second-best Hamming match of every row of desc_a among the
    candidate columns of desc_b, without the [A, B] distances in memory.

    desc_a: [A, 8] int32; desc_b: [B, 8] int32, B >= 1; cand: [A, B] bool.
    Returns (idx, best, second), each [A] int32: the lowest distance over the
    row's candidates, the lowest column that attains it, and the lowest
    distance over all other columns (equal to best on a tie). A row without
    a candidate gives idx 0 and best = second = BIG; a row with one candidate
    second = BIG."""
    _check_pair(desc_a, desc_b)
    A, B = desc_a.shape[0], desc_b.shape[0]
    if cand.dtype != torch.bool:
        raise TypeError(f"cand: expected a bool mask, got {cand.dtype}")
    if tuple(cand.shape) != (A, B):
        raise ValueError(f"cand: expected shape [{A}, {B}], got {tuple(cand.shape)}")
    if cand.device != desc_a.device:
        raise ValueError(f"cand on {cand.device}, descriptors on {desc_a.device}")
    if not cand.is_contiguous():
        raise ValueError("cand: the mask must be contiguous")
    if B == 0:
        raise ValueError("desc_b: no best match among 0 descriptors")
    if desc_a.device.type == "cpu":
        return hamming_best2_ref(desc_a, desc_b, cand)
    if B % 16 == 0 and cand.data_ptr() % 16 != 0:
        raise ValueError("cand: the mask must be 16-byte aligned")
    idx, best, second = torch.empty((3, A), dtype=torch.int32,
                                    device=desc_a.device).unbind(0)
    if A == 0:
        return idx, best, second  # nothing to compute: no launch
    _launch(hamming_best2, "hamming_best2", desc_a.device, desc_a.data_ptr(),
            desc_b.data_ptr(), cand.data_ptr(), idx.data_ptr(),
            best.data_ptr(), second.data_ptr(), A, B)
    return idx, best, second


def bow_assign_ref(node_desc: torch.Tensor, node_children: torch.Tensor,
                   node_word: torch.Tensor, desc: torch.Tensor,
                   valid: torch.Tensor, levels: int, gate_depth: int):
    """Plain version of `bow_assign`: the level loop of
    orbslam2_tpu/ops/bow.py assign_words, with the byte popcount table of
    `hamming_matrix_ref` in place of a popcount instruction."""
    M = desc.shape[0]
    dev = desc.device
    table = constant("popcount8", _popcount8, dev)
    nid = torch.zeros(M, dtype=torch.int64, device=dev)
    gate = nid
    for lv in range(levels):
        ch = node_children[nid]                                  # [M, k]
        ch_desc = node_desc[ch.clamp(min=0).long()]              # [M, k, 8]
        x = torch.bitwise_xor(ch_desc, desc[:, None, :])
        bytes_ = x.contiguous().view(torch.uint8).to(torch.int32)
        dist = table[bytes_].sum(-1, dtype=torch.int32)
        dist = torch.where(ch >= 0, dist, BIG)
        best = ch.gather(1, dist.argmin(dim=1, keepdim=True))[:, 0].long()
        step = (ch >= 0).any(dim=1) & (node_word[nid] < 0)
        nid = torch.where(step, best, nid)
        if lv == gate_depth - 1:
            gate = nid
    w = node_word[nid]
    ok = valid & (w >= 0)
    return (torch.where(ok, w, 0), ok,
            torch.where(ok, gate.to(torch.int32), -1))


def bow_assign(node_desc: torch.Tensor, node_children: torch.Tensor,
               node_word: torch.Tensor, desc: torch.Tensor, valid: torch.Tensor,
               levels: int, gate_depth: int):
    """Vocabulary-tree descent of every descriptor.

    node_desc: [N, 8] int32 bit-views; node_children: [N, k] int32 (-1 =
    none), k <= 32; node_word: [N] int32 (word of a leaf, else -1); desc:
    [M, 8] int32; valid: [M] bool. Returns (words [M] int32, 0 where not ok;
    ok [M] bool; gate [M] int32, the node after `gate_depth` steps, -1 where
    not ok). At each level the first child of lowest Hamming distance wins
    (argmin's tie rule)."""
    _check_desc("node_desc", node_desc)
    _check_desc("desc", desc)
    N, M = node_desc.shape[0], desc.shape[0]
    if N < 1:
        raise ValueError("node_desc: a vocabulary has at least its root")
    if node_children.dtype != torch.int32 or node_children.dim() != 2 \
            or node_children.shape[0] != N:
        raise ValueError(f"node_children: expected int32 [{N}, k], got "
                         f"{node_children.dtype} {tuple(node_children.shape)}")
    k = node_children.shape[1]
    if not 1 <= k <= 32:
        raise ValueError(f"node_children: branching factor {k} is outside 1..32 "
                         "(one lane of a warp takes one child)")
    if node_word.dtype != torch.int32 or tuple(node_word.shape) != (N,):
        raise ValueError(f"node_word: expected int32 [{N}], got "
                         f"{node_word.dtype} {tuple(node_word.shape)}")
    if valid.dtype != torch.bool or tuple(valid.shape) != (M,):
        raise ValueError(f"valid: expected bool [{M}], got {valid.dtype} "
                         f"{tuple(valid.shape)}")
    tensors = (node_desc, node_children, node_word, desc, valid)
    if any(t.device != desc.device for t in tensors):
        raise ValueError("bow_assign: tensors on different devices: "
                         + ", ".join(str(t.device) for t in tensors))
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("bow_assign: every tensor must be contiguous")
    if desc.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no bow_assign kernel for device {desc.device}")
    if desc.device.type == "cpu":
        return bow_assign_ref(node_desc, node_children, node_word, desc, valid,
                              levels, gate_depth)
    if node_desc.data_ptr() % 16 != 0 or desc.data_ptr() % 16 != 0:
        raise ValueError("bow_assign: descriptors must be 16-byte aligned")
    words, gate = torch.empty((2, M), dtype=torch.int32, device=desc.device).unbind(0)
    ok = torch.empty(M, dtype=torch.bool, device=desc.device)
    if M == 0:
        return words, ok, gate  # nothing to compute: no launch
    _launch(bow_assign, "bow_assign", desc.device, node_desc.data_ptr(),
            node_children.data_ptr(), node_word.data_ptr(), desc.data_ptr(),
            valid.data_ptr(), words.data_ptr(), ok.data_ptr(), gate.data_ptr(),
            M, k, int(levels), int(gate_depth))
    return words, ok, gate


_WRAPPERS = (hamming_matrix, hamming_best2, bow_assign)


def reset_launch_counts() -> None:
    with _count_lock:
        for wrapper in _WRAPPERS:
            wrapper.launches = 0
            wrapper.launches_by = {}


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
