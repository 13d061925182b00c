"""Place-recognition database over SPARSE BoW vectors.

Counterpart of orbslam2_tpu/map/keyframe_db.py (KeyFrameDatabase,
src/KeyFrameDatabase.cpp). Host numpy, as in the JAX package: the map it
indexes is host numpy, and a query touches a few hundred words.
The reference keeps an inverted file `mvInvertedFile[wordId] ->
list<KeyFrame*>` sized to the ~1M-word ORBvoc
(src/KeyFrameDatabase.cpp:33-38) so that scoring only touches keyframes
sharing at least one word. Here each keyframe stores its own sparse BoW
row — `word_ids [K, W]` + `weights [K, W]` with W = max distinct words per
keyframe (<= feature count, ~1-2k) — and a query is densified ONCE into an
[n_words] scratch vector; every per-keyframe quantity is then a gather over
the sparse rows:

- shared-word counts: `present(q)[word_ids]` summed per row
- L1 score: for L1-normalized vectors, 1 - 0.5*|q - v|_1 = sum_i min(q_i,
  v_i), which only involves shared words -> `min(q[word_ids], weights)`
  summed per row

Memory is O(K * W) independent of vocabulary size, and the sweep over all
keyframes is one vectorized gather, serving the same candidate logic:

- DetectLoopCandidates (:99): exclude covisible KFs, keep > 0.8 * max
  common words, L1 score >= min_score, covisibility-group score
  accumulation, return > 0.75 * best accumulated score
- DetectRelocalizationCandidates (:244): same without the covisibility
  exclusion / min score

`detect_loop_candidates` and `scores_for_kf` serve loop closing
(loop_closing.LoopCloser._detect).
"""
from __future__ import annotations

import numpy as np

from ..config import SlamConfig
from .mapstate import MapState


def to_sparse_bow(vec) -> tuple[np.ndarray, np.ndarray]:
    """Accept a (word_ids, weights) pair or a dense [n_words] vector and
    return the sparse pair (sorted word ids, L1-normalized weights)."""
    if isinstance(vec, tuple):
        words, weights = vec
        words = np.asarray(words, np.int64)
        weights = np.asarray(weights, np.float32)
    else:
        vec = np.asarray(vec)
        words = np.flatnonzero(vec > 0)
        weights = vec[words].astype(np.float32)
    s = weights.sum()
    if s > 0:
        weights = weights / s
    return words, weights


class KeyFrameDatabase:
    def __init__(self, cfg: SlamConfig, mp: MapState, n_words: int,
                 max_words_per_kf: int | None = None):
        self.cfg = cfg
        self.map = mp
        self.n_words = n_words
        K = cfg.max_keyframes
        # W bounds distinct words per keyframe: one word per feature before
        # dedup, so the frame feature capacity is a safe default
        W = max_words_per_kf if max_words_per_kf is not None else mp.n_feat
        self.word_ids = np.full((K, W), -1, np.int32)
        self.weights = np.zeros((K, W), np.float32)
        self.registered = np.zeros(K, bool)
        self._scratch = np.zeros(n_words, np.float32)  # query densify buffer

    def _fit(self):
        """Grow the rows to the map's keyframe capacity: MapState.alloc_kf
        doubles its keyframe arrays once cfg.max_keyframes ids are taken, and
        ids stay stable (ROADMAP F5: the JAX package's database keeps its
        first size and raises past it)."""
        pad = self.map.kf_valid.shape[0] - self.registered.shape[0]
        if pad > 0:
            self.word_ids = np.pad(self.word_ids, ((0, pad), (0, 0)), constant_values=-1)
            self.weights = np.pad(self.weights, ((0, pad), (0, 0)))
            self.registered = np.pad(self.registered, (0, pad))

    def add(self, kf: int, vec):
        self._fit()
        words, weights = to_sparse_bow(vec)
        W = self.word_ids.shape[1]
        if len(words) > W:  # keep the highest-weight words
            top = np.argsort(-weights)[:W]
            top = top[np.argsort(words[top])]
            words, weights = words[top], weights[top]
            weights = weights / max(weights.sum(), 1e-9)
        self.word_ids[kf] = -1
        self.weights[kf] = 0.0
        self.word_ids[kf, :len(words)] = words
        self.weights[kf, :len(words)] = weights
        self.registered[kf] = True

    def erase(self, kf: int):
        self.registered[kf] = False
        self.word_ids[kf] = -1
        self.weights[kf] = 0.0

    def _active(self):
        self._fit()
        return self.registered & self.map.kf_valid

    def _common_and_scores(self, words: np.ndarray, weights: np.ndarray):
        """Shared-word counts and L1 scores of the query against every
        keyframe row — one gather over the sparse table."""
        q = self._scratch
        q[words] = weights
        ids = np.clip(self.word_ids, 0, None)
        qw = np.where(self.word_ids >= 0, q[ids], 0.0)       # [K, W]
        common = ((qw > 0) & (self.weights > 0)).sum(axis=1)
        scores = np.minimum(qw, self.weights).sum(axis=1)
        q[words] = 0.0  # restore the scratch without an O(n_words) clear
        return common, scores

    def scores_for_kf(self, kf: int, others) -> np.ndarray:
        """L1 BoW scores of keyframe kf against the given keyframe ids
        (the DetectLoop min-score sweep, src/LoopClosing.cpp:143-157)."""
        row = self.word_ids[kf]
        m = row >= 0
        _, scores = self._common_and_scores(row[m], self.weights[kf][m])
        return scores[np.asarray(others, np.int64)]

    def detect_loop_candidates(self, kf: int, min_score: float) -> np.ndarray:
        """src/KeyFrameDatabase.cpp:99-242."""
        mp = self.map
        connected = set(int(x) for x in mp.covisible_kfs(kf, min_weight=15))
        active = self._active().copy()
        active[kf] = False
        for c in connected:
            active[c] = False
        if not active.any():
            return np.array([], np.int64)
        row = self.word_ids[kf]
        m = row >= 0
        common, scores = self._common_and_scores(row[m], self.weights[kf][m])
        common[~active] = 0
        max_common = common.max()
        if max_common == 0:
            return np.array([], np.int64)
        min_common = max(int(0.8 * max_common), 1)
        cand = np.flatnonzero(active & (common >= min_common) & (scores >= min_score))
        if len(cand) == 0:
            return cand
        # accumulate score over each candidate's top-10 covisible group
        # (src/KeyFrameDatabase.cpp:177-218). The group-best is restricted
        # to ACTIVE members: a candidate's covisibility group can contain
        # the query keyframe or its neighbors, and picking those as the
        # returned "best" produced SELF-loop closures (kf == kc) that
        # mass-merged the map onto itself.
        acc, best_of_group = [], []
        for c in cand:
            group = [int(c)] + [int(x) for x in mp.covisible_kfs(int(c), 10)]
            g_scores = [scores[g] for g in group
                        if active[g] and common[g] >= min_common] + [scores[c]]
            acc.append(float(np.sum(g_scores)))
            g_act = [g for g in group if active[g]]
            best_of_group.append(
                int(g_act[int(np.argmax([scores[g] for g in g_act]))])
                if g_act else int(c))
        acc = np.array(acc)
        keep = acc > 0.75 * acc.max()
        out = sorted(set(np.array(best_of_group)[keep].tolist()))
        return np.array(out, np.int64)

    def detect_reloc_candidates(self, vec) -> np.ndarray:
        """src/KeyFrameDatabase.cpp:244-369."""
        words, weights = to_sparse_bow(vec)
        active = self._active()
        if not active.any():
            return np.array([], np.int64)
        common, scores = self._common_and_scores(words, weights)
        common[~active] = 0
        max_common = common.max()
        if max_common == 0:
            return np.array([], np.int64)
        min_common = max(int(0.8 * max_common), 1)
        cand = np.flatnonzero(active & (common >= min_common))
        if len(cand) == 0:
            return cand
        acc = []
        for c in cand:
            group = [int(c)] + [int(x) for x in self.map.covisible_kfs(int(c), 10)]
            acc.append(float(np.sum([scores[g] for g in group if active[g]])))
        acc = np.array(acc)
        keep = acc > 0.75 * acc.max()
        # every candidate above the 0.75*best group-score cut, best first
        # (the reference returns the full set and Tracking iterates all of
        # them, src/KeyFrameDatabase.cpp:244-369; a fixed top-k cap could
        # drop the true pose on a large map with perceptual aliasing)
        return cand[keep][np.argsort(-scores[cand[keep]])]
