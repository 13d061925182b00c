"""ORB vocabulary: hierarchical binary-descriptor tree as dense arrays.

Counterpart of orbslam2_tpu/io/vocabulary.py (DBoW2's TemplatedVocabulary,
Thirdparty/DBoW2/DBoW2/TemplatedVocabulary.h): the pointer tree is flat
arrays (node descriptors [N, 8], children table [N, k]) so the greedy
descent (`transform`, TemplatedVocabulary.h:1241-1279) runs over all
keypoints at once: on the device in ops/bow.assign_words, on the host in
`assign_words_numpy`. Host numpy, apart from the uploads and the device
path of `train_vocabulary`; the port keeps its own copy so that it imports
nothing of the JAX package.

- `Vocabulary`: the arrays, with npz save/load. Node descriptors are stored
  as uint32 words (the file format of both packages); `device_tables` gives
  the int32 bit-views the port's device code takes, `device_tables_on`
  uploads them once per device.
- `pack_child_blocks`: the same tree as the children-block table that the
  `bow_assign` kernel descends (one 48-byte row per child of a node that
  steps, so that a level costs one dependent load); `Vocabulary.child_blocks`
  packs it once per vocabulary, `child_blocks_on` uploads it once per device.
- `default_vocabulary`: the vocabulary shipped with the package
  (data/vocab_default.npz, the same file as the JAX package's).
- `train_vocabulary`: hierarchical k-medians (k-means over Hamming space
  with majority-vote bit medians, k-means++ seeding), on the host or, with
  `device=`, on the `hamming_best2` and `bow_assign` kernels with the same
  draws and the same tree.
- `load_orbvoc_text`: parser for the public ORBvoc.txt format
  (TemplatedVocabulary.h:243-255 loadFromTextFile).

Every function takes descriptors as [N, 8] uint32 or int32 words of the
same bits.
"""
from __future__ import annotations

import functools
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, NamedTuple

import numpy as np
import torch

from ..utils.device import upload_and_wait

DEFAULT_VOCAB = Path(__file__).resolve().parent.parent / "data" / "vocab_default.npz"
# int32 words of one row of the children-block table: the child's 8
# descriptor words, then its block, its word, its node id and a pad word
BLOCK_ROW = 12
ROW_BLOCK, ROW_WORD, ROW_NODE = 8, 9, 10
# serializes every vocabulary's check-and-fill of its device uploads
_UPLOAD_LOCK = threading.Lock()


@functools.lru_cache(maxsize=1)
def default_vocabulary() -> "Vocabulary":
    """The vocabulary shipped with the package, loaded once per process
    (every System shares it: it is read-only)."""
    return Vocabulary.load(DEFAULT_VOCAB)


@dataclass
class Vocabulary:
    k: int                      # branching factor
    levels: int                 # depth
    node_desc: np.ndarray       # [N, 8] uint32
    node_children: np.ndarray   # [N, k] int32, -1 = none
    node_word: np.ndarray       # [N] int32 word id for leaves, -1 otherwise
    word_weight: np.ndarray     # [W] float32 idf weights
    word_node: np.ndarray       # [W] int32 leaf node of each word
    # the uploads of device_tables_on and child_blocks_on, by (what, device),
    # and the host children-block table
    _on_device: dict = field(default_factory=dict, repr=False, compare=False)
    _blocks: Any = field(default=None, repr=False, compare=False)

    @property
    def n_words(self) -> int:
        return len(self.word_weight)

    def device_tables(self):
        """(node_desc [N, 8] int32 bit-view, node_children [N, k] int32,
        node_word [N] int32) as contiguous host arrays, the form
        ops/bow.assign_words takes once they are on a device."""
        return (np.ascontiguousarray(self.node_desc, np.uint32).view(np.int32),
                np.ascontiguousarray(self.node_children, np.int32),
                np.ascontiguousarray(self.node_word, np.int32))

    def device_tables_on(self, device):
        """`device_tables()` as tensors on `device`, uploaded on the first
        call for that device and shared by every caller after it (they are
        read-only). The check and the upload hold a lock, and the tensors are
        published only once their copies have finished, so any thread and
        any stream may read them."""
        return self._uploaded("tables", device, lambda: tuple(
            upload_and_wait(a, device) for a in self.device_tables()))

    def child_blocks(self) -> "ChildBlocks":
        """The children-block table of this tree (`pack_child_blocks`, a
        numpy table), packed on the first call."""
        with _UPLOAD_LOCK:
            if self._blocks is None:
                self._blocks = pack_child_blocks(*self.device_tables())
            return self._blocks

    def child_blocks_on(self, device) -> "ChildBlocks":
        """`child_blocks()` with its table on `device`, uploaded once per
        device as `device_tables_on` does."""
        blocks = self.child_blocks()
        return self._uploaded("blocks", device, lambda: blocks._replace(
            table=upload_and_wait(blocks.table, device)))

    def _uploaded(self, what: str, device, make):
        key = (what, str(device))
        got = self._on_device.get(key)
        if got is None:
            with _UPLOAD_LOCK:
                got = self._on_device.get(key)
                if got is None:
                    got = self._on_device[key] = make()
        return got

    def save(self, path):
        np.savez_compressed(
            path, k=self.k, levels=self.levels, node_desc=self.node_desc,
            node_children=self.node_children, node_word=self.node_word,
            word_weight=self.word_weight, word_node=self.word_node)

    @staticmethod
    def load(path) -> "Vocabulary":
        z = np.load(path)
        return Vocabulary(int(z["k"]), int(z["levels"]), z["node_desc"],
                          z["node_children"], z["node_word"],
                          z["word_weight"], z["word_node"])


class ChildBlocks(NamedTuple):
    """The vocabulary tree as the `bow_assign` kernel descends it.

    Every node that steps in the descent (it has a child and no word: the
    stop rule of orbslam2_tpu/ops/bow.py assign_words) owns one block of k
    rows; row c describes the node's child c in BLOCK_ROW int32 words: the
    child's 8 descriptor words, the child's own block (-1 where the child
    would not step), its word (-1 for none) and its node id, and a pad
    word. A row whose node id is -1 is no child (all its words -1 but the
    zero descriptor). Blocks are numbered breadth-first from the root's,
    so the blocks of depth 0 and 1 are the first `n_top` ones."""
    table: Any          # [n_blocks, k, BLOCK_ROW] int32: numpy, or a tensor
    root_block: int     # the root's block, -1 if the root does not step
    root_word: int      # the root's word (-1 for none)
    n_top: int          # blocks of the root and of its children


def pack_child_blocks(node_desc, node_children, node_word) -> ChildBlocks:
    """Pack a tree given as the arrays of `Vocabulary.device_tables` (node
    descriptors [N, 8] as uint32 or int32 words, children [N, k] with -1
    pads, words [N] with -1 for inner nodes) into its children-block table.
    Only nodes reached from the root get a block; sibling ids need not be
    contiguous, and a tree with a cycle is refused."""
    desc = np.ascontiguousarray(node_desc).view(np.int32)
    children = np.asarray(node_children, np.int32)
    word = np.asarray(node_word, np.int32)
    n, k = children.shape
    if desc.shape != (n, 8) or word.shape != (n,):
        raise ValueError(f"tree arrays disagree: node_desc {desc.shape}, "
                         f"node_children {children.shape}, node_word {word.shape}")
    if ((children < -1) | (children >= n)).any():
        raise ValueError("node_children: ids outside [-1, N)")
    steps = (children >= 0).any(axis=1) & (word < 0)
    block_of = np.full(n, -1, np.int32)
    seen = np.zeros(n, bool)
    order, n_blocks, n_top = [], 0, 0
    frontier = np.zeros(1, np.int64)
    for depth in range(n + 1):  # a tree of n nodes is at most n deep
        if not frontier.size:
            break
        if seen[frontier].any() or len(np.unique(frontier)) < frontier.size:
            raise ValueError("node_children: not a tree (a node is reached twice)")
        seen[frontier] = True
        parents = frontier[steps[frontier]]
        block_of[parents] = np.arange(n_blocks, n_blocks + len(parents))
        n_blocks += len(parents)
        n_top += len(parents) if depth <= 1 else 0
        order.append(parents)
        ch = children[parents].ravel()
        frontier = ch[ch >= 0].astype(np.int64)
    parents = np.concatenate(order)
    ch = children[parents]                                   # [n_blocks, k]
    has = ch >= 0
    c = np.where(has, ch, 0)
    table = np.zeros((len(parents), k, BLOCK_ROW), np.int32)
    table[..., :8] = np.where(has[..., None], desc[c], 0)
    table[..., ROW_BLOCK] = np.where(has, block_of[c], -1)
    table[..., ROW_WORD] = np.where(has, word[c], -1)
    table[..., ROW_NODE] = ch
    return ChildBlocks(table, int(block_of[0]), int(word[0]), n_top)


def _unpack_bits(desc: np.ndarray) -> np.ndarray:
    """[N, 8] u32 (or int32 of the same bits) -> [N, 256] uint8 bits."""
    desc = np.ascontiguousarray(desc)
    if desc.dtype == np.int32:
        desc = desc.view(np.uint32)
    return np.unpackbits(
        desc.astype("<u4").view(np.uint8), axis=-1, bitorder="little")


def _pack_bits(bits: np.ndarray) -> np.ndarray:
    """[N, 256] bits -> [N, 8] u32."""
    return np.packbits(bits, axis=-1, bitorder="little").view("<u4").astype(np.uint32)


def _pack_u64(bits: np.ndarray) -> np.ndarray:
    """[N, 256] bits -> [N, 4] uint64 for popcount distance."""
    return np.packbits(bits, axis=-1, bitorder="little").view(np.uint64)


def _hamming(a_bits, b_bits):
    """[A, 256] x [B, 256] bit arrays -> [A, B] int (packed popcount)."""
    return _hamming_packed(_pack_u64(a_bits), _pack_u64(b_bits))


def _hamming_packed(a: np.ndarray, b: np.ndarray, chunk: int = 8192):
    """[A, 4] x [B, 4] uint64 -> [A, B] int32 XOR-popcount distances."""
    out = np.empty((len(a), len(b)), np.int32)
    for s in range(0, len(a), chunk):
        x = a[s:s + chunk, None, :] ^ b[None, :, :]
        out[s:s + chunk] = np.bitwise_count(x).sum(-1, dtype=np.int32)
    return out


def _kmedians_binary(bits, k, rng, iters=8, packed=None):
    """k-means over binary descriptors: majority-bit medians, k-means++ seed.
    bits: [N, 256]. Returns (centers [k, 256], assignment [N])."""
    n = len(bits)
    k = min(k, n)
    if packed is None:
        packed = _pack_u64(bits)
    # k-means++ seeding
    center_idx = [rng.integers(n)]
    d_min = None
    for _ in range(k - 1):
        d_new = _hamming_packed(packed, packed[center_idx[-1:]])[:, 0]
        d_min = d_new if d_min is None else np.minimum(d_min, d_new)
        tot = float(d_min.sum())
        if tot < 1e-9:
            center_idx.append(rng.integers(n))
        else:
            center_idx.append(rng.choice(n, p=d_min.astype(np.float64) / tot))
    centers = bits[np.array(center_idx)]
    assign = np.zeros(n, np.int64)
    for _ in range(iters):
        assign = _hamming_packed(packed, _pack_u64(centers)).argmin(-1)
        new_centers = centers.copy()
        for c in range(k):
            m = assign == c
            if m.sum() > 0:
                new_centers[c] = (bits[m].mean(0) > 0.5).astype(np.uint8)
        if (new_centers == centers).all():
            break
        centers = new_centers
    return centers, assign


def _grow_tree(root, root_desc, levels: int, split):
    """The breadth-first k-median split of TemplatedVocabulary::create:
    a node becomes a leaf at depth `levels`, with at most one descriptor,
    or when its cluster came out empty. `split(subset)` returns (the child
    centres, each child's subset in the parent's row order). Returns
    (node descriptors, node children, leaf nodes), the root's descriptor
    `root_desc`."""
    node_desc = [root_desc]
    node_children: list[list[int]] = [[]]
    node_level = [0]
    queue = [(0, root)]
    leaf_nodes = []
    while queue:
        nid, subset = queue.pop(0)
        if node_level[nid] == levels or len(subset) <= 1:
            leaf_nodes.append(nid)
            continue
        centers, subs = split(subset)
        for c in range(len(centers)):
            child = len(node_desc)
            node_desc.append(centers[c])
            node_children.append([])
            node_level.append(node_level[nid] + 1)
            node_children[nid].append(child)
            if len(subs[c]) == 0:
                leaf_nodes.append(child)
            else:
                queue.append((child, subs[c]))
    return node_desc, node_children, leaf_nodes


def _split_host(bits, k, rng):
    centers, assign = _kmedians_binary(bits, k, rng)
    return centers, [bits[assign == c] for c in range(len(centers))]


def _unpack_words(words: torch.Tensor) -> torch.Tensor:
    """[N, 8] int32 descriptor words -> [N, 256] int32 bits in the order of
    `_unpack_bits` (bit i of word w at 32 w + i)."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    return ((words[:, :, None] >> shifts) & 1).reshape(len(words), 256)


def _pack_words(bits: torch.Tensor) -> torch.Tensor:
    """[N, 256] int32 bits -> [N, 8] int32 words (`_unpack_words` undone;
    bit 31 makes the word negative, and the sum of the others stays below
    2^31, so the int32 sum does not wrap)."""
    shifts = torch.arange(32, dtype=torch.int32, device=bits.device)
    return (bits.reshape(len(bits), 8, 32) << shifts).sum(-1, dtype=torch.int32)


def _kmedians_on(words: torch.Tensor, k: int, rng, iters: int = 8):
    """`_kmedians_binary` on the device of `words` ([N, 8] int32 descriptor
    words), draw for draw: every distance comes from the `hamming_best2`
    kernel under an all-true mask, [N, 1] for a k-means++ seeding step
    (its best is the distance) and [N, k] for the assignment (its index is
    the lowest column at the least distance: numpy's argmin). The seeding's
    distances are read back once a draw, so that `rng.choice` runs on the
    host's integers. The majority medians count bits per cluster with an
    integer `index_add_`: a bit is set when 2 count > size, which is
    `mean > 0.5` exactly. Reads back nothing else but the convergence test.
    Returns (centres [k, 8] int32 words, assignment [N] int64, cluster
    sizes [k] int32), all on the device."""
    from ..ops.cuda_kernels import hamming_best2
    n, dev = len(words), words.device
    k = min(k, n)
    center_idx = [int(rng.integers(n))]
    one = torch.ones((n, 1), dtype=torch.bool, device=dev)
    d_min = None
    for _ in range(k - 1):
        c = center_idx[-1]
        d_new = hamming_best2(words, words[c:c + 1], one)[1]
        d_min = d_new if d_min is None else torch.minimum(d_min, d_new)
        d = d_min.cpu().numpy()
        tot = float(d.sum())
        if tot < 1e-9:
            center_idx.append(int(rng.integers(n)))
        else:
            center_idx.append(int(rng.choice(n, p=d.astype(np.float64) / tot)))
    bits = _unpack_words(words)
    centers = bits[torch.tensor(center_idx, device=dev)]
    every = torch.ones((n, k), dtype=torch.bool, device=dev)
    ones = torch.ones(n, dtype=torch.int32, device=dev)
    assign = torch.zeros(n, dtype=torch.int64, device=dev)
    sizes = torch.zeros(k, dtype=torch.int32, device=dev)
    for _ in range(iters):
        assign = hamming_best2(words, _pack_words(centers), every)[0].long()
        count = torch.zeros((k, 256), dtype=torch.int32, device=dev).index_add_(0, assign, bits)
        sizes = torch.zeros(k, dtype=torch.int32, device=dev).index_add_(0, assign, ones)
        new = torch.where(sizes[:, None] > 0, (2 * count > sizes[:, None]).int(), centers)
        if torch.equal(new, centers):
            break
        centers = new
    return _pack_words(centers), assign, sizes


def _split_on(words: torch.Tensor, k: int, rng):
    """`_split_host` on the device: the children's subsets by a stable sort
    of the assignment, each in the parent's row order (the next split's
    draws index into it). Reads back the centres and the sizes."""
    centers, assign, sizes = _kmedians_on(words, k, rng)
    order = torch.sort(assign, stable=True).indices
    return centers.cpu().numpy(), torch.split(words[order], sizes.cpu().tolist())


def train_vocabulary(descriptors: np.ndarray, k: int = 10, levels: int = 4,
                     seed: int = 0, max_train: int = 60000, device=None,
                     seconds: dict | None = None) -> Vocabulary:
    """Build a k^levels-leaf vocabulary from [N, 8] u32 descriptors
    (TemplatedVocabulary::create equivalent). Weights = idf over the
    training set.

    device=None: host numpy. With a device the split runs there
    (`_kmedians_on`: the same draws, the `hamming_best2` kernel for every
    distance) and the idf pass descends the new tree with the `bow_assign`
    kernel (ops/bow.assign_words); the tree is the host's exactly. The
    device's launches count under the caller "vocab". `seconds`, if given,
    receives the seconds of the split and of the idf pass."""
    rng = np.random.default_rng(seed)
    if len(descriptors) > max_train:
        descriptors = descriptors[rng.choice(len(descriptors), max_train,
                                             replace=False)]
    t0 = time.perf_counter()
    if device is None:
        node_desc, node_children, leaf_nodes = _grow_tree(
            _unpack_bits(descriptors), np.zeros(256, np.uint8), levels,
            functools.partial(_split_host, k=k, rng=rng))
        desc_arr = _pack_bits(np.stack(node_desc))
    else:
        from ..ops.cuda_kernels import launches_counted_as
        words = torch.from_numpy(np.ascontiguousarray(descriptors, np.uint32)
                                 .view(np.int32)).to(device)
        with launches_counted_as("vocab"):
            node_desc, node_children, leaf_nodes = _grow_tree(
                words, np.zeros(8, np.int32), levels,
                functools.partial(_split_on, k=k, rng=rng))
        desc_arr = np.stack(node_desc).view(np.uint32)
    t1 = time.perf_counter()

    N = len(node_desc)
    child_arr = np.full((N, k), -1, np.int32)
    for i, ch in enumerate(node_children):
        child_arr[i, :len(ch)] = ch
    node_word = np.full(N, -1, np.int32)
    word_node = np.array(sorted(leaf_nodes), np.int32)
    for w, nid in enumerate(word_node):
        node_word[nid] = w

    voc = Vocabulary(k, levels, desc_arr, child_arr, node_word,
                     np.ones(len(word_node), np.float32), word_node)
    # idf weights from the training set
    if device is None:
        words = assign_words_numpy(voc, descriptors)
    else:
        words = _assign_words_on(voc, descriptors, device)
    n_docs = max(len(descriptors) // 500, 1)  # pseudo-documents of 500 feats
    counts = np.bincount(words, minlength=voc.n_words).astype(np.float64)
    idf = np.log(max(len(descriptors), 1) / np.maximum(counts, 1.0))
    voc.word_weight = np.maximum(idf, 1e-3).astype(np.float32)
    if seconds is not None:
        seconds.update(split=t1 - t0, idf=time.perf_counter() - t1)
    return voc


def _assign_words_on(voc: Vocabulary, descriptors: np.ndarray, device) -> np.ndarray:
    """`assign_words_numpy` through ops/bow.assign_words (the `bow_assign`
    kernel over the tree's children-block table on `device`), counted
    under "vocab"."""
    from ..ops.bow import assign_words
    from ..ops.cuda_kernels import launches_counted_as
    desc = torch.from_numpy(np.ascontiguousarray(descriptors, np.uint32)
                            .view(np.int32)).to(device)
    valid = torch.ones(len(desc), dtype=torch.bool, device=desc.device)
    with launches_counted_as("vocab"):
        words, _, _ = assign_words(*voc.device_tables_on(device), desc, valid,
                                   voc.levels, blocks=voc.child_blocks_on(device))
    return words.cpu().numpy().astype(np.int64)


def assign_words_numpy(voc: Vocabulary, descriptors: np.ndarray) -> np.ndarray:
    """Host implementation of the tree descent, vectorized over descriptors
    exactly like the device function (ops/bow.assign_words). Returns word
    ids [N]."""
    packed = _pack_u64(_unpack_bits(descriptors))          # [N, 4]
    node_packed = _pack_u64(_unpack_bits(voc.node_desc))   # [Nn, 4]
    n = len(descriptors)
    nid = np.zeros(n, np.int64)
    for _ in range(voc.levels):
        ch = voc.node_children[nid]                        # [N, k]
        chd = node_packed[np.clip(ch, 0, None)]            # [N, k, 4]
        dist = np.bitwise_count(chd ^ packed[:, None, :]).sum(-1, dtype=np.int32)
        dist[ch < 0] = 1 << 20
        best = ch[np.arange(n), dist.argmin(-1)]
        has_child = (ch >= 0).any(-1)
        step = has_child & (voc.node_word[nid] < 0)
        nid = np.where(step, best, nid)
    return np.maximum(voc.node_word[nid], 0).astype(np.int64)


def load_orbvoc_text(path) -> Vocabulary:
    """Parse the public ORBvoc.txt format: first line `k L scoring weighting`,
    then one node per line: `parent_placeholder is_leaf 32_bytes weight`
    (DBoW2 TemplatedVocabulary::loadFromTextFile)."""
    lines = Path(path).read_text().split("\n")
    k, L = int(lines[0].split()[0]), int(lines[0].split()[1])
    nodes_desc = [np.zeros((8,), np.uint32)]
    parents = [-1]
    is_leaf = [False]
    weights = [0.0]
    for line in lines[1:]:
        parts = line.split()
        if len(parts) < 35:
            continue
        parents.append(int(parts[0]))
        is_leaf.append(bool(int(parts[1])))
        byts = np.array([int(x) for x in parts[2:34]], np.uint8)
        nodes_desc.append(byts.view("<u4").astype(np.uint32))
        weights.append(float(parts[34]))
    N = len(parents)
    child_arr = np.full((N, k), -1, np.int32)
    fill = np.zeros(N, np.int32)
    for i in range(1, N):
        p = parents[i]
        child_arr[p, fill[p]] = i
        fill[p] += 1
    node_word = np.full(N, -1, np.int32)
    leaf_ids = [i for i in range(N) if is_leaf[i]]
    word_node = np.array(leaf_ids, np.int32)
    ww = np.zeros(len(leaf_ids), np.float32)
    for w, nid in enumerate(leaf_ids):
        node_word[nid] = w
        ww[w] = weights[nid]
    return Vocabulary(k, L, np.stack(nodes_desc), child_arr, node_word, ww,
                      word_node)
