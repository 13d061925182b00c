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
  Three paths, chosen from the shapes (`seg_sum_path`), bring the rows to
  the adder by other routes and add in that one order.
- `schur_matvec` (csrc/schur_matvec.cu): the BA solver's CG matvec, the
  reduced camera system's product (the mask, gathers, batched products and
  two `jax.ops.segment_sum`s of the JAX package's `_pcg`), as a pair of
  kernels, one pass by point and one by camera, that keep the per-edge
  products on chip and add in `seg_sum`'s order. Plain version
  `schur_matvec_ref`: the card's products round otherwise, so the two
  agree within float32 rounding, and each repeats itself bit for bit.
- `ba_edges` (csrc/ba_edges.cu): the BA solver's per-edge linearization,
  in place of the JAX package's orbslam2_tpu/ops/ba.py `_edge_terms` and
  the block products of its `_lm_iteration` (XLA ops, no Pallas source),
  which the port ran as gathers and cuBLAS batched gemms and gemvs over a
  million tiny matrices. One thread an edge keeps the residual, the
  Jacobians and the weights in registers and writes only the edge's blocks
  of the normal equations (Hcc, bc, Hpp, bp, W, the weight m, the cost
  term: mode "blocks"), or its cost term, or chi2 and z, with no Jacobian
  (modes "cost", "chi2"). What bounds it is the bytes: 34 read and 296
  written an edge in "blocks", 103 us at the global BA's 1M edges at 3.35
  TB/s. Plain version `ba_edges_ref`, the former composition: the card's
  products round otherwise, so the two agree within `ba_edges_bound`, and
  each repeats itself bit for bit.
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
"tracker"; the block is also a span `name` (utils/metrics.py). A CUDA
graph's kernels count at its capture; `pcg_graph` counts the captures and
replays of the BA solver's CG loop by caller the same way. Every
wrapper takes `out=`, tensors to write its results into (chip_smoke.py puts
guard rows around them), checked like its inputs.

Descriptors are [N, 8] int32 tensors holding the bit patterns of the 8
uint32 words (PyTorch has no popcount and no uint32 shifts on the CPU); the
kernels reinterpret them as uint32.
"""
from __future__ import annotations

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
from ..utils import metrics as M
from ..utils.device import constant
from . import ba_core as BC

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
                [_PTR] * 5 + [_INT] * 5 + [_PTR]),
    "schur_matvec": (_CSRC / "schur_matvec.cu", (), "schur_matvec_launch",
                     [_INT] + [_PTR] * 8 + [_INT, _PTR]),
    "ba_edges": (_CSRC / "ba_edges.cu", (), "ba_edges_launch",
                 [_INT] + [_PTR] * 8 + [ctypes.POINTER(ctypes.c_float)] * 2 + [_INT]
                 + [_PTR] * 9 + [_INT, _PTR]),
}
_launchers: dict = {}
_load_lock = threading.Lock()
_count_lock = threading.Lock()


def _popcount8() -> np.ndarray:
    """Popcount of every byte value, indexed by the descriptors' uint8 view
    (a device constant: a fresh upload per call would wait for its copy)."""
    return np.array([bin(i).count("1") for i in range(256)], np.int32)


def _library(name: str):
    """Path of library `name`, compiled first if it is stale."""
    source, headers = _KERNELS[name][:2]
    return build_library(name, [source], "nvcc", headers=headers)


def _function(name: str, fn_name: str, argtypes: list):
    """Function `fn_name` of library `name` (returning an int), built and
    loaded on first use."""
    with _load_lock:
        if (name, fn_name) not in _launchers:
            fn = getattr(ctypes.CDLL(str(_library(name))), fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _launchers[name, fn_name] = fn
        return _launchers[name, fn_name]


def _launcher(name: str):
    """The launch function of library `name`."""
    return _function(name, *_KERNELS[name][2:])


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
        who = M.current_caller("tracker")
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
    rows in increasing order (the stable sort of idx), segment s owns
    perm[offsets[s]:offsets[s + 1]], and seg[k] is the segment of row
    perm[k] (the sorted index, for the sparse path)."""

    idx: torch.Tensor      # [E] int64, each in [0, n): the plain version's index
    perm: torch.Tensor     # [E] int32
    offsets: torch.Tensor  # [n + 1] int32
    seg: torch.Tensor      # [E] int32, non-decreasing
    n: int


def seg_plan(idx: torch.Tensor, n: int) -> SegPlan:
    """The plan of an index on its device, without a readback: a stable
    sort and a search of the sorted index for each segment's first row.
    Every index must lie in [0, n), as `index_add_` requires; an index
    outside it is not checked here (that would read it back) and the kernel
    leaves its row out (`seg` holds it as -1 or n)."""
    idx = idx.long()
    order = torch.sort(idx, stable=True)
    bounds = torch.arange(n + 1, dtype=torch.int64, device=idx.device)
    offsets = torch.searchsorted(order.values, bounds)
    return SegPlan(idx, order.indices.to(torch.int32), offsets.to(torch.int32),
                   order.values.clamp(-1, n).to(torch.int32), n)


# the kernel's paths, in csrc/seg_sum.cu's numbering
SEG_PATHS = ("short", "sparse", "long")
LONG_ROWS = 64  # rows a segment on average from which a sum takes the long path


def seg_sum_path(rows: int, n: int) -> str:
    """The kernel's path for `rows` rows in `n` segments, from the shapes
    alone: "sparse" when segments outnumber rows (most are empty: zero the
    output, then sum from each segment's first row), "long" from LONG_ROWS
    rows a segment on average (a block a segment, the rows staged in shared
    memory), else "short" (a thread a segment and column)."""
    if rows < n:
        return "sparse"
    return "long" if rows >= LONG_ROWS * n else "short"


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
    if any(t.device != x.device for t in plan[:4]):
        raise ValueError(f"seg_sum: the plan is on {plan.perm.device}, the rows "
                         f"on {x.device}")
    shape = (plan.n,) + tuple(x.shape[1:])
    (out,) = _outputs("seg_sum", out, [(shape, x.dtype)], x.device)
    if x.device.type == "cpu":
        return out.copy_(seg_sum_ref(x, plan.idx, plan.n))
    return _seg_sum_launch(x, plan, out, seg_sum_path(x.shape[0], plan.n))


def _seg_sum_launch(x: torch.Tensor, plan: SegPlan, out: torch.Tensor, path: str):
    """The kernel's launch on `path` (any path sums any shape; `seg_sum`
    takes the one `seg_sum_path` chooses, utils/probe_seg_sum.py forces
    each), for rows, plan and out on the card as `seg_sum` checks them."""
    d = math.prod(x.shape[1:])
    if plan.n * d == 0:
        return out  # nothing to compute: no launch
    rows = x.contiguous()
    _launch(seg_sum, "seg_sum", x.device, rows.data_ptr(), plan.perm.data_ptr(),
            plan.offsets.data_ptr(), plan.seg.data_ptr(), out.data_ptr(), plan.n, d,
            x.shape[0], x.element_size(), SEG_PATHS.index(path))
    return out


def seg_sum_grid(x: torch.Tensor, out: torch.Tensor) -> tuple[int, int]:
    """(blocks, threads a block) of the launch `seg_sum(x, plan, out=out)`
    makes on the card, from the kernel's own grid arithmetic
    (csrc/seg_sum.cu `seg_sum_grid`); (0, threads) where it launches
    nothing."""
    blocks, threads = ctypes.c_int64(), ctypes.c_int()
    fn = _function("seg_sum", "seg_sum_grid", [_PTR] + [_INT] * 4 + [_PTR] * 2)
    path = seg_sum_path(x.shape[0], out.shape[0])
    err = fn(out.data_ptr(), out.shape[0], math.prod(x.shape[1:]), x.element_size(),
             SEG_PATHS.index(path), ctypes.byref(blocks), ctypes.byref(threads))
    if err != 0:
        raise ValueError(f"seg_sum_grid: CUDA error {err}")
    return blocks.value, threads.value


class SchurPlan(NamedTuple):
    """The order of the CG matvec's two passes over a BA problem's edges,
    built once a solve: the segment-sum plans by camera and by point, and
    each edge's other index in each plan's order."""

    cam: SegPlan
    pt: SegPlan
    cam_pt: torch.Tensor  # [E] int32: the point of the edge at cam.perm[k]
    pt_cam: torch.Tensor  # [E] int32: the camera of the edge at pt.perm[k]


def schur_plan(cam: SegPlan, pt: SegPlan) -> SchurPlan:
    """The matvec's plan from the plans by camera and by point of the same
    edges, on their device without a readback."""
    return SchurPlan(cam, pt, pt.idx[cam.perm.long()].to(torch.int32),
                     cam.idx[pt.perm.long()].to(torch.int32))


class SchurTerms(NamedTuple):
    """An LM iteration's terms of the matvec, the couplings W [E, 6, 3] and
    the point blocks' inverses Hpp_inv [P, 3, 3], as the kernels read them:
    on a card Hpp_inv contiguous (linalg.inv_ex returns each matrix
    column-major) and W's rows copied into the camera plan's and the point
    plan's order, so that each pass reads its rows in the order it adds
    them; on the CPU as given, for the plain version (by_cam, by_pt None)."""

    W: torch.Tensor
    Hpp_inv: torch.Tensor
    by_cam: torch.Tensor | None
    by_pt: torch.Tensor | None


def schur_terms(W: torch.Tensor, Hpp_inv: torch.Tensor, plan: SchurPlan,
                out: tuple | None = None) -> SchurTerms:
    """The matvec's terms for the CG steps of one LM iteration (three copies
    on a card, none on the CPU). out: on a card, the three tensors to copy
    Hpp_inv and W's rows by camera and by point into (a CUDA graph's
    buffers, ops/ba.py `_CGGraph`)."""
    if W.device.type == "cpu":
        return SchurTerms(W, Hpp_inv, None, None)
    if out is None:
        return SchurTerms(W, Hpp_inv.contiguous(), W.index_select(0, plan.cam.perm),
                          W.index_select(0, plan.pt.perm))
    rows = (W.shape[0], 6, 3)
    hinv, by_cam, by_pt = _outputs("schur_terms", out, [
        ((Hpp_inv.shape[0], 3, 3), torch.float32), (rows, torch.float32),
        (rows, torch.float32)], W.device)
    return SchurTerms(W, hinv.copy_(Hpp_inv),
                      torch.index_select(W, 0, plan.cam.perm, out=by_cam),
                      torch.index_select(W, 0, plan.pt.perm, out=by_pt))


def schur_matvec_ref(x: torch.Tensor, W: torch.Tensor, Hpp_inv: torch.Tensor,
                     e_cam: torch.Tensor, e_pt: torch.Tensor, free: torch.Tensor,
                     Hcc: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of `schur_matvec`: the mask, the edge gathers, the
    batched products and two segment sums (`seg_sum_ref`)."""
    x = x * free
    u = torch.einsum("eij,ei->ej", W, x[e_cam])                       # [E, 3]
    wp = torch.einsum("pij,pj->pi", Hpp_inv,
                      seg_sum_ref(u, e_pt, Hpp_inv.shape[0]))         # [P, 3]
    ze = torch.einsum("eij,ej->ei", W, wp[e_pt])                      # [E, 6]
    s = seg_sum_ref(ze, e_cam, x.shape[0])
    return s if Hcc is None else (torch.einsum("cij,cj->ci", Hcc, x) - s) * free


def schur_matvec(x: torch.Tensor, terms: SchurTerms, plan: SchurPlan, free: torch.Tensor,
                 Hcc: torch.Tensor | None = None, out: torch.Tensor | None = None
                 ) -> torch.Tensor:
    """The reduced camera system's product, S x = (Hcc x - s) free, with
    x masked to the free cameras (x free) first; without Hcc, its coupling
    part s alone, which the ranks of a sharded solve add up before the
    rest. s [C, 6]: s[c] = the sum over the edges e of camera c of W_e
    wp[p(e)], where wp[p] = Hpp_inv[p] (the sum over the edges e of point p
    of W_e^T x[c(e)]). x: [C, 6]; terms: `schur_terms` of W [E, 6, 3] and
    Hpp_inv [P, 3, 3]; free: [C, 1], 1 for a free camera, else 0; Hcc:
    [C, 6, 6]; all float32, contiguous on a card; plan: the edges'
    SchurPlan. Every sum adds in increasing edge order within its segment.
    out: a contiguous [C, 6] float32 tensor to write into."""
    C, P, E = plan.cam.n, plan.pt.n, plan.cam.perm.shape[0]
    on_card = x.device.type == "cuda"
    named = [("x", x, (C, 6)), ("W", terms.W, (E, 6, 3)),
             ("Hpp_inv", terms.Hpp_inv, (P, 3, 3)), ("free", free, (C, 1))]
    if Hcc is not None:
        named.append(("Hcc", Hcc, (C, 6, 6)))
    if on_card:
        named += [("terms.by_cam", terms.by_cam, (E, 6, 3)),
                  ("terms.by_pt", terms.by_pt, (E, 6, 3))]
    for name, t, shape in named:
        if t is None or t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"schur_matvec: {name} expected float32 {shape}, got "
                             f"{getattr(t, 'dtype', None)} {tuple(getattr(t, 'shape', ()))}")
        if t.device != x.device:
            raise ValueError(f"schur_matvec: {name} on {t.device}, x on {x.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no schur_matvec kernel for device {x.device}")
    if any(t.device != x.device for t in (*plan.cam[:4], *plan.pt[:4], *plan[2:])):
        raise ValueError(f"schur_matvec: the plan is on {plan.cam.perm.device}, x on "
                         f"{x.device}")
    (out,) = _outputs("schur_matvec", out, [((C, 6), torch.float32)], x.device)
    if not on_card:
        return out.copy_(schur_matvec_ref(x, terms.W, terms.Hpp_inv, plan.cam.idx,
                                          plan.pt.idx, free, Hcc))
    # a copy here would be a launch a CG step: schur_terms makes its copies
    # once an LM iteration
    if not all(t.is_contiguous() for name, t, _ in named if name != "W"):
        raise ValueError("schur_matvec: the tensors on the card must be contiguous")
    if any(t.data_ptr() % 8 for t in (x, terms.by_cam, terms.by_pt)):
        raise ValueError("schur_matvec: x and W's rows must be 8-byte aligned")
    wp = torch.empty((P, 3), dtype=torch.float32, device=x.device)
    if P:  # the point pass (no launch where there is nothing to compute)
        _launch(schur_matvec, "schur_matvec", x.device, 0, terms.by_pt.data_ptr(),
                plan.pt.offsets.data_ptr(), plan.pt_cam.data_ptr(), x.data_ptr(),
                free.data_ptr(), terms.Hpp_inv.data_ptr(), 0, wp.data_ptr(), P)
    if C:  # the camera pass
        _launch(schur_matvec, "schur_matvec", x.device, 1, terms.by_cam.data_ptr(),
                plan.cam.offsets.data_ptr(), plan.cam_pt.data_ptr(), x.data_ptr(),
                free.data_ptr(), 0 if Hcc is None else Hcc.data_ptr(), wp.data_ptr(),
                out.data_ptr(), C)
    return out


# ba_edges: each mode's outputs, in the order it returns them, and the
# shape of an edge's row of each
BA_EDGE_OUTPUTS = {"blocks": ("Hcc", "bc", "Hpp", "bp", "W", "m", "cost"),
                   "cost": ("cost",), "chi2": ("chi2", "z")}
_EDGE_ROWS = {"Hcc": (6, 6), "bc": (6,), "Hpp": (3, 3), "bp": (3,), "W": (6, 3), "m": (),
              "cost": (), "chi2": (), "z": ()}
BA_MIN_DEPTH = 0.05  # meters; below this J ~ 1/z^2 risks f32 overflow
BA_CHI2_TRIM = 1e5   # edges beyond this are excluded from the normal system


def ba_edges_ref(mode: str, cam_T, pts, e_cam, e_pt, e_obs, e_stereo, e_info, e_active,
                 intr: tuple, robust: bool) -> tuple:
    """Plain version of `ba_edges`: the BA solver's former composition (the
    edge gathers, ops/ba_core.py's residual Jacobians and weights, the
    batched products of the block assembly)."""
    fx, fy, cx, cy, bf = intr
    Te = cam_T[e_cam]                        # [E, 3, 4]
    Xe = pts[e_pt]                           # [E, 3]
    R, t = Te[..., :3], Te[..., 3]
    pc = torch.einsum("eij,ej->ei", R, Xe) + t
    z = pc[:, 2]
    iz = 1.0 / torch.where(z.abs() > 1e-6, z, 1e-6)
    u = fx * pc[:, 0] * iz + cx
    v = fy * pc[:, 1] * iz + cy
    ur = u - bf * iz
    res = torch.stack(
        [u - e_obs[:, 0], v - e_obs[:, 1],
         torch.where(e_stereo, ur - e_obs[:, 2], 0.0)], dim=-1)
    chi2, w = BC.chi2_and_weight(res, e_stereo, e_info, robust)
    if mode == "chi2":
        return chi2, z
    # the accept/reject objective is the (robust) cost the step models
    rho = BC.robust_cost(chi2, e_stereo, robust)
    cost = torch.where(e_active & (z > BA_MIN_DEPTH),
                       torch.clamp(rho, max=BA_CHI2_TRIM), 0.0)
    if mode == "cost":
        return (cost,)
    Jp, Jpc = BC.residual_jacobians(pc, e_stereo, fx, fy, bf)
    Jpt = Jpc @ R                            # world-point Jacobian [E, 3, 3]
    # depth floor + hopeless-outlier trim: near-zero depth makes J ~ 1/z^2
    # overflow f32 in the H assembly
    usable = e_active & (z > BA_MIN_DEPTH) & (chi2 < BA_CHI2_TRIM)
    m = usable.to(torch.float32) * w * e_info
    Jpm = Jp * m[:, None, None]
    Jptm = Jpt * m[:, None, None]
    return (Jpm.transpose(1, 2) @ Jp, -torch.einsum("eri,er->ei", Jpm, res),
            Jptm.transpose(1, 2) @ Jpt, -torch.einsum("eri,er->ei", Jptm, res),
            Jpm.transpose(1, 2) @ Jpt, m, cost)


_EPS32 = 2.0 ** -24  # float32's unit roundoff


def ba_edges_bound(mode: str, cam_T, pts, e_cam, e_pt, e_obs, e_stereo, e_info, e_active,
                   intr: tuple, robust: bool, units: float) -> list:
    """How far float32 rounding of `units` units of 2^-24 can move each
    output of `ba_edges`, in float64 (tests and chip_smoke.py hold the kernel
    to the plain version within it): `units` 2^-24 times the output's
    absolute terms (its last products and sums over absolute values), plus
    the largest change of the float64 plain version when the camera-frame
    point's coordinate i moves by `units` 2^-24 (|R_i| |X| + |t_i|), the
    size of its rounding, or an observation's by `units` 2^-24 2 |obs|, that
    of the residual's difference, either way, each in turn, the changes
    added up. A threshold within that reach (the Huber weight's kink, the
    depth floor, the chi2 trim) shows in the change."""
    f64 = [a.double() if a.is_floating_point() else a
           for a in (cam_T, pts, e_cam, e_pt, e_obs, e_stereo, e_info, e_active)]
    # each edge its own pose, so that its camera-frame point moves alone
    edges = torch.arange(e_cam.shape[0], device=e_cam.device)
    base = [f64[0][e_cam], f64[1], edges, *f64[3:]]
    ref = ba_edges_ref(mode, *base, intr, robust)
    R, t, X = base[0][..., :3], base[0][..., 3], base[1][e_pt]
    pc_abs = torch.einsum("eij,ej->ei", R.abs(), X.abs()) + t.abs()
    bound = [units * _EPS32 * a for a in _edge_abs_terms(mode, base, ref, pc_abs, intr)]
    for i in range(6):  # camera-frame coordinates, then observation coordinates
        k, col = (0, i) if i < 3 else (4, i - 3)
        step = units * _EPS32 * (pc_abs[:, i] if i < 3 else 2 * base[4][:, col].abs())
        changes = []
        for sign in (1.0, -1.0):
            moved = list(base)
            moved[k] = base[k].clone()
            if k == 0:
                moved[0][:, col, 3] += sign * step
            else:
                moved[4][:, col] += sign * step
            changes.append([(d - r).abs() for d, r in
                            zip(ba_edges_ref(mode, *moved, intr, robust), ref)])
        bound = [b + torch.maximum(up, down) for b, up, down in zip(bound, *changes)]
    return bound


def _edge_abs_terms(mode: str, inputs: tuple, ref: tuple, pc_abs, intr: tuple) -> list:
    """Each output of `ba_edges` over the absolute values of its terms, at
    the float64 values `ref`: the Jacobians, residual and weight it is made
    of, and the products and sums that make it."""
    if mode == "chi2":  # chi2 is a sum of squares; z = pc's depth
        return [ref[0].abs(), pc_abs[:, 2]]
    if mode == "cost":
        return [ref[0].abs()]
    fx, fy, cx, cy, bf = intr
    cam_T, pts, e_cam, e_pt, e_obs, e_stereo = inputs[:6]
    R = cam_T[e_cam][..., :3]
    pc = torch.einsum("eij,ej->ei", R, pts[e_pt]) + cam_T[e_cam][..., 3]
    iz = 1.0 / pc[:, 2].abs()
    iz2, zero, st = iz * iz, torch.zeros_like(iz), e_stereo.double()
    J = torch.stack([torch.stack([fx * iz, zero, fx * pc[:, 0].abs() * iz2], -1),
                     torch.stack([zero, fy * iz, fy * pc[:, 1].abs() * iz2], -1),
                     st[:, None] * torch.stack(
                         [fx * iz, zero, (fx * pc[:, 0].abs() + bf) * iz2], -1)], 1)
    skew = torch.stack([torch.stack([zero, pc_abs[:, 2], pc_abs[:, 1]], -1),
                        torch.stack([pc_abs[:, 2], zero, pc_abs[:, 0]], -1),
                        torch.stack([pc_abs[:, 1], pc_abs[:, 0], zero], -1)], 1)
    m = ref[5].abs()[:, None, None]
    Jp, Jpt = torch.cat([J, J @ skew], -1), J @ R.abs()
    u = fx * pc[:, 0] / pc[:, 2] + cx
    res = torch.stack([u - e_obs[:, 0], fy * pc[:, 1] / pc[:, 2] + cy - e_obs[:, 1],
                       st * (u - bf / pc[:, 2] - e_obs[:, 2])], -1).abs()
    return [(Jp * m).mT @ Jp, torch.einsum("eri,er->ei", Jp * m, res), (Jpt * m).mT @ Jpt,
            torch.einsum("eri,er->ei", Jpt * m, res), (Jp * m).mT @ Jpt, m[:, 0, 0],
            ref[6].abs()]


def ba_edges(mode: str, cam_T: torch.Tensor, pts: torch.Tensor, e_cam: torch.Tensor,
             e_pt: torch.Tensor, e_obs: torch.Tensor, e_stereo: torch.Tensor,
             e_info: torch.Tensor, e_active: torch.Tensor, intr: tuple, robust: bool,
             out=None) -> tuple:
    """The BA solver's per-edge linearization: each edge's projection of
    point pts[e_pt] by pose cam_T[e_cam] [3, 4] against its observation
    e_obs (u, v, u_r; the third row for stereo edges alone), at
    intr = (fx, fy, cx, cy, bf), with the Huber weight and cost where
    `robust`. Returns BA_EDGE_OUTPUTS[mode], each [E, ...] float32 in edge
    order:

    - "blocks": the edge's terms of the normal equations, Hcc = (Jp m)^T
      Jp [6, 6], bc = -(Jp m)^T res [6], Hpp = (Jpt m)^T Jpt [3, 3],
      bp = -(Jpt m)^T res [3], W = (Jp m)^T Jpt [6, 3] (Jp, Jpt the pose
      and point Jacobians), the weight m (0 for an edge not active, at a
      depth up to BA_MIN_DEPTH or with chi2 from BA_CHI2_TRIM), and the
      edge's term of the cost (0 for an edge not active or not in front);
    - "cost": that term alone, and no Jacobian;
    - "chi2": chi2 and the depth z alone.

    cam_T [C, 3, 4], pts [P, 3], e_obs [E, 3], e_info [E] float32; e_cam,
    e_pt int64 [E], each in range (not checked on a card: that would read
    back); e_stereo, e_active bool [E]; contiguous on a card. out: tensors
    of those shapes to write into."""
    if mode not in BA_EDGE_OUTPUTS:
        raise ValueError(f"ba_edges: mode {mode!r} is not one of {tuple(BA_EDGE_OUTPUTS)}")
    E = e_cam.shape[0] if e_cam.dim() == 1 else -1
    named = [("cam_T", cam_T, torch.float32, (cam_T.shape[0], 3, 4)),
             ("pts", pts, torch.float32, (pts.shape[0], 3)),
             ("e_cam", e_cam, torch.int64, (E,)), ("e_pt", e_pt, torch.int64, (E,)),
             ("e_obs", e_obs, torch.float32, (E, 3)),
             ("e_stereo", e_stereo, torch.bool, (E,)),
             ("e_info", e_info, torch.float32, (E,)),
             ("e_active", e_active, torch.bool, (E,))]
    for name, t, dtype, shape in named:
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"ba_edges: {name} expected {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != cam_T.device:
            raise ValueError(f"ba_edges: {name} on {t.device}, cam_T on {cam_T.device}")
    device = cam_T.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no ba_edges kernel for device {device}")
    names = BA_EDGE_OUTPUTS[mode]
    outs = _outputs("ba_edges", out, [((E, *_EDGE_ROWS[k]), torch.float32) for k in names],
                    device)
    args = (cam_T, pts, e_cam, e_pt, e_obs, e_stereo, e_info, e_active)
    if device.type == "cpu":
        return _plain_into(outs, ba_edges_ref(mode, *args, intr, robust))
    if not all(t.is_contiguous() for t in args) or cam_T.data_ptr() % 16:
        raise ValueError("ba_edges: the inputs on the card must be contiguous, cam_T "
                         "16-byte aligned")
    got = dict(zip(names, outs))
    if ("Hcc" in got and got["Hcc"].data_ptr() % 16
            or any(k in got and got[k].data_ptr() % 8 for k in ("bc", "W"))):
        raise ValueError("ba_edges: out= Hcc must be 16-byte aligned, bc and W 8-byte")
    if E:
        consts = (BA_MIN_DEPTH, BA_CHI2_TRIM, BC.CHI2_MONO, BC.CHI2_STEREO)
        ptrs = [got[k].data_ptr() if k in got else None for k in _EDGE_ROWS]
        _launch(ba_edges, "ba_edges", device, 0 if mode == "blocks" else 1,
                *(t.data_ptr() for t in args), (ctypes.c_float * 5)(*intr),
                (ctypes.c_float * 4)(*consts), int(robust), *ptrs, E)
    return tuple(outs)


_WRAPPERS = (hamming_matrix, hamming_best2, bow_assign, seg_sum, schur_matvec, ba_edges)


class GraphCounts:
    """How often a CUDA graph was captured and replayed, in all and by
    caller (`captures_by`, `replays_by`), split as a wrapper's
    `launches_by` is. A replay launches the captured kernels without
    counting them on their wrappers: their launches count once, at the
    capture."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.captures = self.replays = 0
        self.captures_by, self.replays_by = {}, {}

    def count(self, what: str) -> None:
        """Count one of `what` ("captures" or "replays")."""
        with _count_lock:
            setattr(self, what, getattr(self, what) + 1)
            by = getattr(self, what + "_by")
            who = M.current_caller("tracker")
            by[who] = by.get(who, 0) + 1


pcg_graph = GraphCounts()  # the BA solver's CG loop (ops/ba.py `_CGGraph`)


def reset_launch_counts() -> None:
    with _count_lock:
        for wrapper in _WRAPPERS:
            wrapper.launches = 0
            wrapper.launches_by = {}
        bow_assign.packed_on_the_fly = 0
        pcg_graph.reset()


def launches_counted_as(name: str) -> M.caller_span:
    """Count this thread's kernel launches under `name` inside the block,
    which is a span `name` (utils/metrics.py)."""
    return M.caller_span(name)


reset_launch_counts()
