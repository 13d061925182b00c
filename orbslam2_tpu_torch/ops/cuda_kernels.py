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
- `seg_sum` (csrc/seg_sum.cu): the order-fixed segment sum of float rows
  that assembles the BA's and the pose graph's normal equations, in place
  of `jax.ops.segment_sum` (an XLA op, no Pallas source). Each segment adds
  its rows in increasing row order from a plan built once a problem
  (`seg_plan`), which is the order of the plain
  version `seg_sum_ref` (`index_add_` on the CPU): the card's sums equal
  the CPU's bit for bit, and repeat run to run as the JAX package's do.
- `bow_assign` (csrc/bow_assign.cu): the vocabulary-tree descent of
  orbslam2_tpu/ops/bow.py `assign_words` (an XLA program with an inline
  XOR-popcount over gathered children, no Pallas source), one warp a
  descriptor, over the tree's children-block table
  (io/vocabulary.pack_child_blocks): one dependent load a level. Plain
  versions `bow_assign_blocks_ref` (the same table) and `bow_assign_ref`
  (the JAX package's layout).

On a CUDA tensor a wrapper launches its kernel (or raises); on a CPU tensor
it runs its plain version, which is also what tests and chip_smoke.py compare
the kernel with. `<wrapper>.launches` counts kernel launches, and
`<wrapper>.launches_by` splits them by caller: the launches a thread makes
inside `launches_counted_as(name)` count under `name`, the others under
"tracker". Every wrapper takes `out=`, tensors to write its results into
(chip_smoke.py puts guard rows around them), checked like its inputs.

Descriptors are [N, 8] int32 tensors holding the bit patterns of the 8
uint32 words (PyTorch has no popcount and no uint32 shifts on the CPU); the
kernels reinterpret them as uint32.
"""
from __future__ import annotations

import contextlib
import ctypes
import math
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np
import torch

from .._build import PKG_DIR, build_library
from ..io.vocabulary import (BLOCK_ROW, ROW_BLOCK, ROW_NODE, ROW_WORD,
                             ChildBlocks, pack_child_blocks)
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
# most rows of the children-block table that bow_assign stages in shared
# memory (48 KB)
MAX_TOP_ROWS = 1024
# library name -> (source, headers it includes, launch function, its
# argument types)
_KERNELS = {
    "hamming": (_CSRC / "hamming.cu", (_TILE_HEADER,), "hamming_matrix_launch",
                [_PTR, _PTR, _PTR, _INT, _INT, _PTR]),
    "hamming_best2": (_CSRC / "hamming_best2.cu", (_TILE_HEADER,),
                      "hamming_best2_launch",
                      [_PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _INT, _INT, _PTR]),
    "bow_assign": (_CSRC / "bow_assign.cu", (), "bow_assign_launch",
                   [_PTR] * 6 + [_INT] * 7 + [_PTR]),
    "seg_sum": (_CSRC / "seg_sum.cu", (), "seg_sum_launch",
                [_PTR] * 4 + [_INT] * 3 + [_PTR]),
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


def _outputs(name: str, out, specs, device: torch.device, align: int = 4):
    """The output tensors of a wrapper: new ones, or the caller's `out`
    after checking each against its (shape, dtype) in `specs`: on `device`,
    contiguous and `align`-byte aligned."""
    if out is None:
        return [torch.empty(shape, dtype=dtype, device=device) for shape, dtype in specs]
    out = list(out) if isinstance(out, (tuple, list)) else [out]
    if len(out) != len(specs):
        raise ValueError(f"{name}: out= takes {len(specs)} tensors, got {len(out)}")
    for t, (shape, dtype) in zip(out, specs):
        if t.dtype != dtype or tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: out= expected {dtype} {tuple(shape)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"{name}: out= must be contiguous on {device}")
        if device.type == "cuda" and t.data_ptr() % align != 0:
            raise ValueError(f"{name}: out= must be {align}-byte aligned")
    return out


def _plain_into(out, results) -> tuple:
    """The plain version's results written into the outputs."""
    return tuple(o.copy_(r) for o, r in zip(out, results))


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


def hamming_matrix(desc_a: torch.Tensor, desc_b: torch.Tensor,
                   out: torch.Tensor | None = None) -> torch.Tensor:
    """[A, 8] int32 x [B, 8] int32 -> [A, B] int32 Hamming distances (into
    `out`, 16-byte aligned on a card, when given)."""
    _check_pair(desc_a, desc_b)
    A, B = desc_a.shape[0], desc_b.shape[0]
    (out,) = _outputs("hamming_matrix", out, [((A, B), torch.int32)],
                      desc_a.device, align=16)
    if desc_a.device.type == "cpu":
        return out.copy_(hamming_matrix_ref(desc_a, desc_b))
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
                  cand: torch.Tensor, out=None):
    """Best and second-best Hamming match of every row of desc_a among the
    candidate columns of desc_b, without the [A, B] distances in memory.

    desc_a: [A, 8] int32; desc_b: [B, 8] int32, B >= 1; cand: [A, B] bool.
    Returns (idx, best, second), each [A] int32: the lowest distance over the
    row's candidates, the lowest column that attains it, and the lowest
    distance over all other columns (equal to best on a tie). A row without
    a candidate gives idx 0 and best = second = BIG; a row with one candidate
    second = BIG. `out`: three [A] int32 tensors to write them into."""
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
    if out is None:
        out = torch.empty((3, A), dtype=torch.int32, device=desc_a.device).unbind(0)
    idx, best, second = _outputs("hamming_best2", out, [((A,), torch.int32)] * 3,
                                 desc_a.device)
    if desc_a.device.type == "cpu":
        return _plain_into([idx, best, second], hamming_best2_ref(desc_a, desc_b, cand))
    if B % 16 == 0 and cand.data_ptr() % 16 != 0:
        raise ValueError("cand: the mask must be 16-byte aligned")
    if A == 0:
        return idx, best, second  # nothing to compute: no launch
    _launch(hamming_best2, "hamming_best2", desc_a.device, desc_a.data_ptr(),
            desc_b.data_ptr(), cand.data_ptr(), idx.data_ptr(),
            best.data_ptr(), second.data_ptr(), A, B)
    return idx, best, second


def _popcount_dist(a: torch.Tensor, desc: torch.Tensor) -> torch.Tensor:
    """Hamming distances of [M, k, 8] descriptor words to the [M, 8] rows of
    `desc`, by the byte popcount table of `hamming_matrix_ref`: [M, k]."""
    table = constant("popcount8", _popcount8, desc.device)
    x = torch.bitwise_xor(a, desc[:, None, :])
    return table[x.contiguous().view(torch.uint8).to(torch.int32)].sum(
        -1, dtype=torch.int32)


def bow_assign_ref(node_desc: torch.Tensor, node_children: torch.Tensor,
                   node_word: torch.Tensor, desc: torch.Tensor,
                   valid: torch.Tensor, levels: int, gate_depth: int):
    """Plain version of `bow_assign` on the JAX package's layout of the
    tree: the level loop of orbslam2_tpu/ops/bow.py assign_words, with the
    byte popcount table of `hamming_matrix_ref` in place of a popcount
    instruction."""
    M = desc.shape[0]
    nid = torch.zeros(M, dtype=torch.int64, device=desc.device)
    gate = nid
    for lv in range(levels):
        ch = node_children[nid]                                  # [M, k]
        dist = _popcount_dist(node_desc[ch.clamp(min=0).long()], desc)
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


def bow_assign_blocks_ref(blocks: ChildBlocks, desc: torch.Tensor,
                          valid: torch.Tensor, levels: int, gate_depth: int):
    """Plain version of `bow_assign` on the children-block table, the
    kernel's own walk: at each level the rows of the current block, the
    first row of lowest distance (an empty row at BIG), and that row's
    block, word and node id; a descent whose block is -1 stays where it is."""
    M = desc.shape[0]
    dev = desc.device
    blk = torch.full((M,), blocks.root_block, dtype=torch.int64, device=dev)
    word = torch.full((M,), blocks.root_word, dtype=torch.int32, device=dev)
    node = torch.zeros(M, dtype=torch.int32, device=dev)
    gate = node
    for lv in range(levels):
        rows = blocks.table[blk.clamp(min=0)]                    # [M, k, 12]
        dist = torch.where(rows[..., ROW_NODE] >= 0,
                           _popcount_dist(rows[..., :8], desc), BIG)
        win = rows.gather(1, dist.argmin(dim=1)[:, None, None].expand(
            -1, 1, BLOCK_ROW))[:, 0]                             # [M, 12]
        step = blk >= 0
        blk = torch.where(step, win[:, ROW_BLOCK].long(), blk)
        word = torch.where(step, win[:, ROW_WORD], word)
        node = torch.where(step, win[:, ROW_NODE], node)
        if lv == gate_depth - 1:
            gate = node
    ok = valid & (word >= 0)
    return torch.where(ok, word, 0), ok, torch.where(ok, gate, -1)


def top_rows(blocks: ChildBlocks, k: int) -> int:
    """Rows of the table that the kernel stages in shared memory: the
    blocks of depth 0 and 1, up to MAX_TOP_ROWS."""
    return min(blocks.n_top * k, MAX_TOP_ROWS)


def _check_blocks(blocks: ChildBlocks, k: int, device: torch.device) -> None:
    t = blocks.table
    if not isinstance(t, torch.Tensor) or t.dtype != torch.int32 or t.dim() != 3 \
            or tuple(t.shape[1:]) != (k, BLOCK_ROW):
        raise ValueError(f"blocks: expected an int32 tensor [n_blocks, {k}, "
                         f"{BLOCK_ROW}], got {getattr(t, 'dtype', type(t))} "
                         f"{tuple(getattr(t, 'shape', ()))}")
    if t.device != device or not t.is_contiguous():
        raise ValueError(f"blocks: the table must be contiguous on {device}")
    if not -1 <= blocks.root_block < t.shape[0] or not 0 <= blocks.n_top <= t.shape[0]:
        raise ValueError(f"blocks: root block {blocks.root_block} outside [-1, "
                         f"{t.shape[0]}) or {blocks.n_top} top blocks of {t.shape[0]}")
    if device.type == "cuda" and t.data_ptr() % 16 != 0:
        raise ValueError("blocks: the table must be 16-byte aligned")


def bow_assign(node_desc: torch.Tensor, node_children: torch.Tensor,
               node_word: torch.Tensor, desc: torch.Tensor, valid: torch.Tensor,
               levels: int, gate_depth: int, blocks: ChildBlocks | None = None,
               out=None):
    """Vocabulary-tree descent of every descriptor.

    node_desc: [N, 8] int32 bit-views; node_children: [N, k] int32 (-1 =
    none), k <= 32; node_word: [N] int32 (word of a leaf, else -1); desc:
    [M, 8] int32; valid: [M] bool. Returns (words [M] int32, 0 where not ok;
    ok [M] bool; gate [M] int32, the node after `gate_depth` steps, -1 where
    not ok). At each level the first child of lowest Hamming distance wins
    (argmin's tie rule).

    blocks: the same tree's children-block table on desc's device
    (Vocabulary.child_blocks_on), which the kernel descends. Without it a
    CPU call runs the plain version on the JAX layout, and a card call packs
    the table from the three arrays first (reading them back; counted in
    `bow_assign.packed_on_the_fly`): for tests and foreign tables only.
    out: (words, ok, gate) tensors to write into."""
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
    if out is None:
        words, gate = torch.empty((2, M), dtype=torch.int32, device=desc.device).unbind(0)
        out = (words, torch.empty(M, dtype=torch.bool, device=desc.device), gate)
    words, ok, gate = _outputs("bow_assign", out, [((M,), torch.int32),
                                                   ((M,), torch.bool),
                                                   ((M,), torch.int32)], desc.device)
    if blocks is not None:
        _check_blocks(blocks, k, desc.device)
    if desc.device.type == "cpu":
        plain = (bow_assign_ref(node_desc, node_children, node_word, desc, valid,
                                levels, gate_depth) if blocks is None else
                 bow_assign_blocks_ref(blocks, desc, valid, levels, gate_depth))
        return _plain_into((words, ok, gate), plain)
    if desc.data_ptr() % 16 != 0:
        raise ValueError("bow_assign: descriptors must be 16-byte aligned")
    if M == 0:
        return words, ok, gate  # nothing to compute: no launch
    if blocks is None:
        host = pack_child_blocks(*(t.cpu().numpy() for t in tensors[:3]))
        blocks = host._replace(table=torch.from_numpy(host.table).to(desc.device))
        with _count_lock:
            bow_assign.packed_on_the_fly += 1
    _launch(bow_assign, "bow_assign", desc.device, blocks.table.data_ptr(),
            desc.data_ptr(), valid.data_ptr(), words.data_ptr(), ok.data_ptr(),
            gate.data_ptr(), M, k, int(levels), int(gate_depth),
            blocks.root_block, blocks.root_word, top_rows(blocks, k))
    return words, ok, gate


class SegPlan(NamedTuple):
    """The order of one segment sum, built once for an index that many sums
    share (a BA problem's edges, a pose graph's): row i of x goes to
    segment idx[i]; perm lists the rows segment by segment, each segment's
    rows in increasing order (the stable sort of idx), and segment s owns
    perm[offsets[s]:offsets[s + 1]]."""

    idx: torch.Tensor      # [E] int64, each in [0, n): the plain version's index
    perm: torch.Tensor     # [E] int32
    offsets: torch.Tensor  # [n + 1] int32
    n: int


def seg_plan(idx: torch.Tensor, n: int) -> SegPlan:
    """The plan of an index on its device, without a readback: a stable
    sort and a search of the sorted index for each segment's first row.
    Every index must lie in [0, n), as `index_add_` requires; an index
    outside it is not checked here (that would read it back) and the kernel
    leaves its row out."""
    idx = idx.long()
    order = torch.sort(idx, stable=True)
    bounds = torch.arange(n + 1, dtype=torch.int64, device=idx.device)
    offsets = torch.searchsorted(order.values, bounds)
    return SegPlan(idx, order.indices.to(torch.int32), offsets.to(torch.int32), n)


def seg_sum_ref(x: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """Plain version of `seg_sum`: [n, ...] rows of zeros, then x's rows
    added at idx (on the CPU one row after the other, in row order)."""
    out = torch.zeros((n,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    return out.index_add_(0, idx, x)


def seg_sum(x: torch.Tensor, plan: SegPlan, out: torch.Tensor | None = None):
    """out[s] = the sum of x[i] over the rows i with plan.idx[i] == s, added
    in increasing i from 0.0: [E, ...] float32 or float64 -> [n, ...].
    out: a contiguous tensor of that shape to write into."""
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"seg_sum: expected float32 or float64 rows, got {x.dtype}")
    if x.dim() < 1 or x.shape[0] != plan.perm.shape[0]:
        raise ValueError(f"seg_sum: {tuple(x.shape)} rows for a plan of "
                         f"{plan.perm.shape[0]}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no seg_sum kernel for device {x.device}")
    if any(t.device != x.device for t in plan[:3]):
        raise ValueError(f"seg_sum: the plan is on {plan.perm.device}, the rows "
                         f"on {x.device}")
    shape = (plan.n,) + tuple(x.shape[1:])
    (out,) = _outputs("seg_sum", out, [(shape, x.dtype)], x.device)
    if x.device.type == "cpu":
        return out.copy_(seg_sum_ref(x, plan.idx, plan.n))
    d = math.prod(x.shape[1:])
    if plan.n * d == 0:
        return out  # nothing to compute: no launch
    rows = x.contiguous()
    _launch(seg_sum, "seg_sum", x.device, rows.data_ptr(), plan.perm.data_ptr(),
            plan.offsets.data_ptr(), out.data_ptr(), plan.n, d, x.element_size())
    return out


_WRAPPERS = (hamming_matrix, hamming_best2, bow_assign, seg_sum)


def reset_launch_counts() -> None:
    with _count_lock:
        for wrapper in _WRAPPERS:
            wrapper.launches = 0
            wrapper.launches_by = {}
        bow_assign.packed_on_the_fly = 0


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
