"""Vocabulary-tree descent and BoW vector construction on tensors.

Counterpart of orbslam2_tpu/ops/bow.py (DBoW2's per-feature `transform`,
Thirdparty/DBoW2/DBoW2/TemplatedVocabulary.h:1241-1279): all keypoints
descend the tree at once. The descent itself is the CUDA kernel `bow_assign`
(ops/cuda_kernels.py, csrc/bow_assign.cu; its plain version on CPU tensors).
The sparse BowVector becomes a dense [n_words] vector (a scatter-add of idf
weights, L1-normalized), which turns place-recognition scoring
(DBoW2/ScoringObject.cpp L1 scoring) into a matrix-vector form.

Descriptors and node descriptors are [*, 8] int32 bit-views
(io/vocabulary.Vocabulary.device_tables); the kernel descends the same tree
packed as a children-block table (Vocabulary.child_blocks_on).
"""
from __future__ import annotations

import torch

from .cuda_kernels import bow_assign

# Depth of the FeatureVector node gate (DBoW2 levelsup: ORB-SLAM2 stores
# nodes 4 levels above the leaves of its L=6 k=10 vocabulary: depth 2,
# about 100 groups; src/ORBmatcher.cpp:243-299 compares only descriptors
# under the same node). Same depth here: the default k=11 L=5 vocabulary has
# 121 depth-2 nodes.
GATE_DEPTH = 2


def assign_words(node_desc, node_children, node_word, desc, valid, levels: int,
                 blocks=None):
    """Tree descent for all descriptors at once.

    node_desc: [N, 8] int32; node_children: [N, k] int32 (-1 pad);
    node_word: [N] int32 (leaf word id or -1); desc: [M, 8] int32; valid:
    [M] bool. Returns (word ids [M] int32 (0 where invalid), ok [M] bool,
    gate node ids [M] int32: the node reached at depth GATE_DEPTH, the
    reference's FeatureVector entry used for node-gated SearchByBoW, -1
    where invalid). blocks: the tree's children-block table on desc's
    device (Vocabulary.child_blocks_on); the main path passes it, a call
    without it packs the table on the fly (cuda_kernels.bow_assign)."""
    return bow_assign(node_desc, node_children, node_word, desc, valid,
                      levels, GATE_DEPTH, blocks=blocks)


def bow_vector(words, wvalid, word_weight, n_words: int):
    """Dense L1-normalized tf-idf vector [n_words] from per-feature words.
    A scatter-add, not torch.bincount, which on a CUDA tensor reads the
    input's maximum back to the host."""
    w = words.clamp(0, n_words - 1).long()
    contrib = torch.where(wvalid, word_weight[w], 0.0)
    v = torch.zeros(n_words, dtype=word_weight.dtype, device=words.device)
    v = v.index_add(0, w, contrib)
    return v / torch.clamp(v.sum(), min=1e-9)


def l1_scores(query, kf_vectors):
    """DBoW2 L1 score s = 1 - 0.5 * |q - v|_1 for L1-normalized vectors.
    query: [V]; kf_vectors: [K, V]. Returns [K]."""
    return 1.0 - 0.5 * (kf_vectors - query[None, :]).abs().sum(dim=-1)
