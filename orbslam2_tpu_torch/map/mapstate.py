"""The SLAM map as fixed-capacity structure-of-arrays (host-resident truth).

Copied from orbslam2_tpu/map/mapstate.py and adapted for the port: the host
arrays stay numpy, descriptors are stored as int32 bit-views of the uint32
words (the device layout, ops/cuda_kernels.py), and the native kernels come
from the port's own `native` package. `interop.map_from_numpy` builds one
from the JAX package's arrays.

Replacement for the reference's pointer-graph Map/KeyFrame/MapPoint
(src/Map.cpp, src/KeyFrame.cpp, src/MapPoint.cpp): every mutexed object field
becomes a slot in a capped numpy array with a validity mask; "SetBadFlag"
becomes a mask write + free-list push; the covisibility graph
(KeyFrame::UpdateConnections, src/KeyFrame.cpp:377-434) is recomputed from
the observation edge list by vectorized bincount instead of incremental
pointer surgery.

The host arrays are the single source of truth; device programs (tracking
matchers, BA) receive padded gathers of the relevant slices. Because updates
are plain array writes between device calls, the reference's whole locking
discipline (Map::mMutexMapUpdate + per-object mutexes, include/Map.h:62,
include/KeyFrame.h:250-252) disappears: tracking works on an immutable
snapshot gathered per frame.

Observation bookkeeping keeps two synchronized views:
- `kf_pt` [Kmax, N]: feature -> point index (-1 = none); the reference's
  Frame::mvpMapPoints / KeyFrame::mvpMapPoints
- per-point observation sets, derived on demand from kf_pt (vectorized)
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..config import SlamConfig


@dataclass
class MapState:
    cfg: SlamConfig
    n_feat: int  # padded per-frame feature capacity

    # --- keyframes ---
    kf_valid: np.ndarray = field(init=False)
    kf_pose: np.ndarray = field(init=False)       # [K, 3, 4] Tcw
    kf_timestamp: np.ndarray = field(init=False)
    kf_frame_id: np.ndarray = field(init=False)
    # per-keyframe features (copies of the frame at creation)
    kf_xy: np.ndarray = field(init=False)         # [K, N, 2] undistorted
    kf_octave: np.ndarray = field(init=False)
    kf_angle: np.ndarray = field(init=False)
    kf_desc: np.ndarray = field(init=False)       # [K, N, 8] int32 words
    kf_depth: np.ndarray = field(init=False)      # [K, N] stereo depth (-1 mono)
    kf_ur: np.ndarray = field(init=False)         # [K, N] right-u (-1 mono)
    kf_feat_valid: np.ndarray = field(init=False)
    kf_pt: np.ndarray = field(init=False)         # [K, N] -> point idx or -1
    kf_patch: np.ndarray = field(init=False)      # [K, N, 15, 15] uint8 photo
    #                                               windows (ops/refine.py)

    # --- map points ---
    pt_valid: np.ndarray = field(init=False)
    pt_xyz: np.ndarray = field(init=False)        # [P, 3]
    pt_desc: np.ndarray = field(init=False)       # [P, 8] medoid descriptor (int32)
    pt_normal: np.ndarray = field(init=False)     # [P, 3] mean viewing dir
    pt_min_dist: np.ndarray = field(init=False)   # scale-invariance band
    pt_max_dist: np.ndarray = field(init=False)
    pt_ref_kf: np.ndarray = field(init=False)
    pt_first_kf: np.ndarray = field(init=False)
    pt_visible: np.ndarray = field(init=False)    # IncreaseVisible counter
    pt_found: np.ndarray = field(init=False)      # IncreaseFound counter
    pt_patch: np.ndarray = field(init=False)      # [P, 11, 11] f32 anchor
    #                                               template (ops/refine.py)

    next_kf_id: int = 0

    def __post_init_extra__(self):
        # Map update lock — the reference's Map::mMutexMapUpdate
        # (include/Map.h:62). The tracker and the mapping worker hold it
        # around their host read and apply sections, never across a device
        # program. RLock: the staged path nests sections on one thread.
        import threading
        self.lock = threading.RLock()
        # culled-KF trajectory recovery: slot -> (parent_slot, T_this_wrt_parent)
        # (the reference's KeyFrame::mTcp spanning-tree chain,
        # include/KeyFrame.h:188-189, walked in SaveTrajectoryTUM)
        self.kf_retired: dict[int, tuple[int, np.ndarray]] = {}
        # Point-slot lifecycle. The reference relies on pointer identity +
        # CheckReplacedInLastFrame (src/Tracking.cpp:372) so stale MapPoint*
        # handles held by the last frame stay dereferenceable; with integer
        # slots we must not recycle a freed slot while any frame still holds
        # its id. Freed slots go to a QUARANTINE (_pt_pending) and only become
        # allocatable after the tracker has scrubbed its frame associations
        # (release_retired_points). Replacements are recorded in pt_redirect
        # so scrubbing can follow old id -> surviving id (local mapping culls
        # and fuses points; the tracker scrubs at the reference's places).
        self.next_pt_id: int = 0
        self._pt_free: list[int] = []
        self._pt_pending: list[int] = []
        # quarantine pipeline: stage i holds slots retired i release-calls
        # ago; a slot becomes allocatable only after PT_QUARANTINE_DEPTH
        # calls. Depth 16 (release is called once per tracked frame) covers
        # the block driver's in-flight device chain — one 6-frame block
        # dispatched on top of another still carries point ids from up to
        # ~2 blocks back.
        self._pt_stages: list[list[int]] = []
        self.pt_redirect = np.full(self.pt_xyz.shape[0], -1, np.int32)
        # point-geometry generation counter: bumped whenever pt_xyz/pt_desc/
        # pt_normal/pt_patch/dist bands/pt_valid change, so the tracker's
        # device mirror (tracking.Tracker._refresh_mirror) knows when to
        # re-upload. Code that writes those arrays DIRECTLY (BA writeback,
        # loop correction) must bump it too (mark_points_dirty).
        self.generation: int = 0
        # rows changed since the mirror last synced; None = everything
        # (the mirror falls back to a full upload)
        self._dirty_pts: list | None = []
        # prefix of _dirty_pts that is already consolidated (unique) — only
        # the appended TAIL counts toward the re-consolidation trigger, so a
        # large-but-stable dirty set doesn't re-run np.unique on every
        # mark_points_dirty call
        self._dirty_base = 0

    def mark_points_dirty(self, ids):
        """Record changed point rows for incremental mirror sync and bump
        the generation counter."""
        self.generation += 1
        if self._dirty_pts is None:
            return
        self._dirty_pts.append(np.asarray(ids, np.int64).ravel())
        if sum(len(a) for a in self._dirty_pts[self._dirty_base:]) > 8192:
            # A mapping event touches the same local points from several
            # stages (triangulate, fuse, BA writeback, stat refresh) — the
            # raw appended total overcounts heavily. Consolidate before
            # concluding the churn is real: a full mirror refresh re-uploads
            # the whole point table, patches included.
            u = np.unique(np.concatenate(self._dirty_pts))
            if len(u) > 16384:
                self._dirty_pts = None
                self._dirty_base = 0
            else:
                self._dirty_pts = [u]
                self._dirty_base = 1

    def drain_dirty_points(self):
        """Return (and clear) the changed-row set: an int64 array, or None
        meaning 'unknown / everything'."""
        d = self._dirty_pts
        self._dirty_pts = []
        self._dirty_base = 0
        if d is None:
            return None
        if not d:
            return np.zeros(0, np.int64)
        return np.unique(np.concatenate(d))

    def __post_init__(self):
        K, P, N = self.cfg.max_keyframes, self.cfg.max_points, self.n_feat
        self.kf_valid = np.zeros(K, bool)
        self.kf_pose = np.zeros((K, 3, 4), np.float32)
        self.kf_timestamp = np.zeros(K, np.float64)
        self.kf_frame_id = np.full(K, -1, np.int64)
        self.kf_xy = np.zeros((K, N, 2), np.float32)
        self.kf_octave = np.zeros((K, N), np.int32)
        self.kf_angle = np.zeros((K, N), np.float32)
        self.kf_desc = np.zeros((K, N, 8), np.int32)
        self.kf_depth = np.full((K, N), -1.0, np.float32)
        self.kf_ur = np.full((K, N), -1.0, np.float32)
        self.kf_feat_valid = np.zeros((K, N), bool)
        self.kf_pt = np.full((K, N), -1, np.int32)
        from ..ops.features import PATCH_WIN, TEMPLATE_WIN
        self.kf_patch = np.zeros((K, N, PATCH_WIN, PATCH_WIN), np.uint8)
        self.pt_patch = np.zeros((P, TEMPLATE_WIN, TEMPLATE_WIN), np.float32)
        # pristine detection measurements == the kf_patch window centers.
        # Refinement (ops/refine.py) writes kf_xy = kf_xy0 + delta ABSOLUTELY
        # so repeated refinement against changing templates never compounds.
        self.kf_xy0 = np.zeros((K, N, 2), np.float32)
        self.kf_ur0 = np.full((K, N), -1.0, np.float32)
        self.pt_valid = np.zeros(P, bool)
        self.pt_xyz = np.zeros((P, 3), np.float32)
        self.pt_desc = np.zeros((P, 8), np.int32)
        self.pt_normal = np.zeros((P, 3), np.float32)
        self.pt_min_dist = np.zeros(P, np.float32)
        self.pt_max_dist = np.zeros(P, np.float32)
        self.pt_ref_kf = np.full(P, -1, np.int32)
        self.pt_first_kf = np.full(P, -1, np.int32)
        self.pt_visible = np.ones(P, np.float32)
        self.pt_found = np.ones(P, np.float32)
        # spanning tree: parent = most covisible KF at insertion
        # (KeyFrame::ChangeParent/AddChild, include/KeyFrame.h:77-82)
        self.kf_parent = np.full(K, -1, np.int32)
        # per-feature depth-2 vocabulary node (the reference's FeatureVector,
        # filled at BoW registration; -1 = unassigned) — gates SearchByBoW
        self.kf_bow_node = np.full((K, N), -1, np.int32)
        self.__post_init_extra__()

    # ------------------------------------------------------------------ slots
    def _grow(self, fields: tuple, axis0_new: int):
        """Double the capacity of the given SoA arrays along axis 0,
        preserving each field's empty-slot fill value."""
        fills = {"kf_pt": -1, "kf_parent": -1, "kf_frame_id": -1,
                 "pt_ref_kf": -1, "pt_first_kf": -1, "pt_redirect": -1,
                 "kf_depth": -1.0, "kf_ur": -1.0, "kf_ur0": -1.0,
                 "kf_bow_node": -1, "pt_visible": 1.0, "pt_found": 1.0}
        for name in fields:
            a = getattr(self, name)
            extra = np.full((axis0_new - a.shape[0],) + a.shape[1:],
                            fills.get(name, 0), a.dtype)
            setattr(self, name, np.concatenate([a, extra]))

    _KF_FIELDS = ("kf_valid", "kf_pose", "kf_timestamp", "kf_frame_id",
                  "kf_xy", "kf_octave", "kf_angle", "kf_desc", "kf_depth",
                  "kf_ur", "kf_feat_valid", "kf_pt", "kf_parent", "kf_patch",
                  "kf_xy0", "kf_ur0", "kf_bow_node")
    _PT_FIELDS = ("pt_valid", "pt_xyz", "pt_desc", "pt_normal",
                  "pt_min_dist", "pt_max_dist", "pt_ref_kf", "pt_first_kf",
                  "pt_visible", "pt_found", "pt_patch", "pt_redirect")

    def alloc_kf(self) -> int:
        """Monotonic slot allocation — culled slots are NEVER reused.

        Slot reuse would silently corrupt everything keyed by slot id:
        kf_retired anchor chains, the tracker's frame_log reference-KF ids,
        and loop edges would all resolve through the NEW occupant's pose
        (the reference avoids this class of bug with pointer identity).
        max_keyframes is only the INITIAL capacity: when the monotonic
        counter reaches it, every [K, ...] array doubles (KITTI-scale runs
        create 1500+ keyframes). Doubling keeps ids stable."""
        k = self.next_kf_id
        if k >= self.kf_valid.shape[0]:
            self._grow(self._KF_FIELDS, 2 * self.kf_valid.shape[0])
        return k

    def alloc_points(self, n: int) -> np.ndarray:
        """Allocate n point slots: recycled (released) slots first, then
        fresh ones (capacity doubles when exhausted — ids stay stable).
        Slots in quarantine (_pt_pending) are NOT candidates."""
        take = min(n, len(self._pt_free))
        out = self._pt_free[:take]
        del self._pt_free[:take]
        fresh = n - take
        if self.next_pt_id + fresh > self.pt_valid.shape[0]:
            self._grow(self._PT_FIELDS, 2 * self.pt_valid.shape[0])
            # the device point mirror must be rebuilt at the new shape
            self.generation += 1
            self._dirty_pts = None
        if fresh:
            out = out + list(range(self.next_pt_id, self.next_pt_id + fresh))
            self.next_pt_id += fresh
        return np.asarray(out, np.int64)

    PT_QUARANTINE_DEPTH = 16

    def release_retired_points(self):
        """Advance the quarantine one stage: slots retired
        PT_QUARANTINE_DEPTH calls ago become allocatable. The depth covers
        every id still referenced by an in-flight device binding chain
        (block driver: up to ~2 six-frame blocks), so a recycled slot can
        never be observed under its old identity."""
        self._pt_stages.append(self._pt_pending)
        self._pt_pending = []
        if len(self._pt_stages) <= self.PT_QUARANTINE_DEPTH:
            return
        ready = self._pt_stages.pop(0)
        if not ready:
            return
        self.pt_redirect[ready] = -1
        self._pt_free.extend(ready)

    def resolve_point_ids(self, ids: np.ndarray) -> np.ndarray:
        """Map possibly-stale point ids to live ones: follow replacement
        redirects (MapPoint::GetReplaced semantics), then drop ids whose
        point is no longer valid. -1 entries pass through."""
        ids = np.asarray(ids)
        out = ids.copy()
        live = out >= 0
        for _ in range(4):  # redirect chains are short
            r = self.pt_redirect[np.clip(out, 0, None)]
            step = live & (r >= 0)
            if not step.any():
                break
            out = np.where(step, r, out)
        bad = live & ~self.pt_valid[np.clip(out, 0, None)]
        out[bad] = -1
        return out

    @property
    def kf_ids(self) -> np.ndarray:
        return np.flatnonzero(self.kf_valid)

    @property
    def n_keyframes(self) -> int:
        return int(self.kf_valid.sum())

    @property
    def n_points(self) -> int:
        return int(self.pt_valid.sum())

    # ------------------------------------------------------------- keyframes
    def add_keyframe(self, pose, timestamp, frame_id, xy, octave, angle, desc,
                     feat_valid, pt_idx, depth=None, ur=None,
                     patch=None, xy0=None, ur0=None) -> int:
        n = xy.shape[0]
        if n < self.n_feat:  # regular frames are smaller than mono-init frames
            pad = self.n_feat - n
            xy = np.pad(xy, ((0, pad), (0, 0)))
            octave = np.pad(octave, (0, pad))
            angle = np.pad(angle, (0, pad))
            desc = np.pad(desc, ((0, pad), (0, 0)))
            feat_valid = np.pad(feat_valid, (0, pad))
            pt_idx = np.pad(pt_idx, (0, pad), constant_values=-1)
            if depth is not None:
                depth = np.pad(depth, (0, pad), constant_values=-1.0)
            if ur is not None:
                ur = np.pad(ur, (0, pad), constant_values=-1.0)
            if patch is not None:
                patch = np.pad(patch, ((0, pad), (0, 0), (0, 0)))
            if xy0 is not None:
                xy0 = np.pad(xy0, ((0, pad), (0, 0)))
            if ur0 is not None:
                ur0 = np.pad(ur0, (0, pad), constant_values=-1.0)
        k = self.alloc_kf()
        self.kf_valid[k] = True
        self.kf_pose[k] = pose
        self.kf_timestamp[k] = timestamp
        self.kf_frame_id[k] = frame_id
        self.kf_xy[k] = xy
        self.kf_octave[k] = octave
        self.kf_angle[k] = angle
        self.kf_desc[k] = desc
        self.kf_feat_valid[k] = feat_valid
        # invariant at the source: a keyframe never observes a dead slot
        # (bindings may have been snapshotted before a concurrent cull)
        live = (pt_idx >= 0) & self.pt_valid[np.clip(pt_idx, 0, None)]
        self.kf_pt[k] = np.where(feat_valid & live, pt_idx, -1)
        if depth is not None:
            self.kf_depth[k] = depth
        if ur is not None:
            self.kf_ur[k] = ur
        if patch is not None:
            # uint8 storage: the blurred image is smooth, so 1-unit rounding
            # adds ~0.3 units of template noise (below the sensor noise floor)
            self.kf_patch[k] = np.clip(np.round(patch), 0, 255).astype(np.uint8)
        self.kf_xy0[k] = xy0 if xy0 is not None else xy
        self.kf_ur0[k] = (ur0 if ur0 is not None
                          else (ur if ur is not None else -1.0))
        self.next_kf_id = max(self.next_kf_id, k + 1)
        return k

    def remove_keyframe(self, k: int):
        """KeyFrame::SetBadFlag (src/KeyFrame.cpp:567): invalidate the slot
        and record the relative pose to a surviving anchor so frame
        trajectories referencing this KF stay recoverable. Children in the
        spanning tree are reparented before the slot dies (the reference's
        greedy loop, src/KeyFrame.cpp:581-660: each child adopts its most
        covisible candidate among the dead KF's parent and the already
        reparented siblings)."""
        children = np.flatnonzero(self.kf_valid & (self.kf_parent == k))
        if len(children):
            parent = int(self.kf_parent[k])
            candidates = [parent] if parent >= 0 and self.kf_valid[parent] \
                else []
            remaining = set(int(c) for c in children)
            while remaining:
                best = (-1, -1, -1)  # (weight, child, candidate)
                if candidates:
                    for c in list(remaining):
                        w = self.covisibility_weights(c)
                        for cand in candidates:
                            if w[cand] > best[0]:
                                best = (int(w[cand]), c, cand)
                if best[0] > 0:
                    _, c, cand = best
                    self.kf_parent[c] = cand
                    candidates.append(c)
                    remaining.discard(c)
                else:
                    # no covisibility link to any candidate: fall back to
                    # the dead KF's parent (src/KeyFrame.cpp:649-656)
                    for c in remaining:
                        self.kf_parent[c] = parent if parent >= 0 else -1
                    break
        anchor = self._anchor_for(k)
        if anchor >= 0:
            Tk = self.kf_pose[k]
            Ta = self.kf_pose[anchor]
            Ra, ta = Ta[:, :3], Ta[:, 3]
            Ta_inv = np.hstack([Ra.T, (-Ra.T @ ta)[:, None]])
            T_rel = np.hstack([
                Tk[:, :3] @ Ta_inv[:, :3],
                (Tk[:, :3] @ Ta_inv[:, 3] + Tk[:, 3])[:, None]]).astype(np.float32)
            self.kf_retired[k] = (anchor, T_rel)
        self.kf_valid[k] = False
        self.kf_pt[k] = -1
        self.kf_feat_valid[k] = False

    def _anchor_for(self, k: int) -> int:
        """Most covisible surviving keyframe (parent surrogate)."""
        w = self.covisibility_weights(k)
        if w.max() > 0:
            return int(np.argmax(w))
        alive = np.flatnonzero(self.kf_valid & (np.arange(len(self.kf_valid)) != k))
        return int(alive[-1]) if len(alive) else -1

    def resolve_kf_pose(self, k: int) -> np.ndarray | None:
        """Pose of keyframe k, chaining through retired anchors if culled."""
        T_acc = np.hstack([np.eye(3), np.zeros((3, 1))]).astype(np.float32)
        for _ in range(64):
            if self.kf_valid[k]:
                Tk = self.kf_pose[k]
                R = T_acc[:, :3] @ Tk[:, :3]
                t = T_acc[:, :3] @ Tk[:, 3] + T_acc[:, 3]
                return np.hstack([R, t[:, None]]).astype(np.float32)
            if k not in self.kf_retired:
                return None
            anchor, T_rel = self.kf_retired[k]
            R = T_acc[:, :3] @ T_rel[:, :3]
            t = T_acc[:, :3] @ T_rel[:, 3] + T_acc[:, 3]
            T_acc = np.hstack([R, t[:, None]]).astype(np.float32)
            k = anchor
        return None

    # ----------------------------------------------------------------- points
    def add_points(self, xyz, desc, ref_kf: int, first_kf: int,
                   patch=None) -> np.ndarray:
        ids = self.alloc_points(len(xyz))
        self.pt_valid[ids] = True
        self.pt_xyz[ids] = xyz
        self.pt_desc[ids] = desc
        self.pt_ref_kf[ids] = ref_kf
        self.pt_first_kf[ids] = first_kf
        self.pt_visible[ids] = 1.0
        self.pt_found[ids] = 1.0
        if patch is not None:
            self.pt_patch[ids] = patch
        else:
            self.pt_patch[ids] = 0.0  # no template: refinement is a no-op
        self.mark_points_dirty(ids)
        return ids

    def remove_points(self, ids: np.ndarray):
        """MapPoint::SetBadFlag (src/MapPoint.cpp:184): invalidate the points
        and erase every observation of them."""
        ids = np.asarray(ids)
        if len(ids) == 0:
            return
        self.pt_valid[ids] = False
        self.kf_pt[np.isin(self.kf_pt, ids)] = -1
        self._pt_pending.extend(int(i) for i in ids)
        self.mark_points_dirty(ids)

    def replace_point(self, old: int, new: int):
        """MapPoint::Replace (src/MapPoint.cpp:212): redirect observations of
        `old` to `new` (a keyframe that already sees `new` drops the
        observation instead), and keep the visibility counters. Scans only
        the live keyframe rows."""
        live = np.flatnonzero(self.kf_valid)
        sub = self.kf_pt[live]
        sees_new = (sub == new).any(axis=1)
        rows, cols = np.where(sub == old)
        self.kf_pt[live[rows], cols] = np.where(sees_new[rows], -1, new)
        self.pt_found[new] += self.pt_found[old]
        self.pt_visible[new] += self.pt_visible[old]
        self.pt_valid[old] = False
        self.pt_redirect[old] = new
        self._pt_pending.append(int(old))
        self.mark_points_dirty([old, new])

    # ------------------------------------------------------------ observations
    def observations_of(self, pt_ids: np.ndarray):
        """(kf, feat) pairs observing each of pt_ids. Returns (rows kf,
        cols feat, pt arrays) over all observations of the given points."""
        sub = np.isin(self.kf_pt, pt_ids) & self.kf_feat_valid & self.kf_valid[:, None]
        kf, feat = np.where(sub)
        return kf, feat, self.kf_pt[kf, feat]

    def point_obs_count(self) -> np.ndarray:
        """nObs per point (stereo observations count double, matching
        MapPoint::AddObservation, src/MapPoint.cpp:127-140)."""
        P = self.pt_xyz.shape[0]
        flat = self.kf_pt[self.kf_valid].ravel()
        w = np.where(self.kf_ur[self.kf_valid].ravel() >= 0, 2, 1)
        m = flat >= 0
        return np.bincount(flat[m], weights=w[m], minlength=P)

    # ------------------------------------------------------------ covisibility
    def covisibility_weights(self, k: int) -> np.ndarray:
        """Shared-point counts between keyframe k and all other keyframes
        (KeyFrame::UpdateConnections, src/KeyFrame.cpp:377). Uses the native
        C++ kernel when available (orbslam2_tpu/native)."""
        from .. import native
        w = native.covis_weights(self.kf_pt, self.kf_valid, k,
                                 self.pt_xyz.shape[0])
        if w is not None:
            w[k] = 0
            return w
        pts = self.kf_pt[k]
        pts = pts[pts >= 0]
        if len(pts) == 0:
            return np.zeros(self.kf_pose.shape[0], np.int64)
        seen = np.zeros(self.pt_xyz.shape[0], bool)
        seen[pts] = True
        shares = seen[np.clip(self.kf_pt, 0, None)] & (self.kf_pt >= 0)
        w = shares.sum(axis=1)
        w[k] = 0
        w[~self.kf_valid] = 0
        return w

    def covis_matrix(self) -> np.ndarray:
        """Full [K, K] shared-point counts in one pass (native kernel,
        incidence-matmul fallback): the pose-graph edge construction sweeps
        every keyframe pair, where per-keyframe covisibility_weights would
        cost O(K^2 N)."""
        from .. import native
        W = native.covis_matrix(self.kf_pt, self.kf_valid, self.pt_xyz.shape[0])
        if W is None:
            # incidence matmul fallback: [K, Pv] f32 against itself
            live = np.flatnonzero(self.pt_valid)
            slot = np.full(self.pt_xyz.shape[0] + 1, -1, np.int64)
            slot[live] = np.arange(len(live))
            idx = slot[np.where(self.kf_pt >= 0, self.kf_pt, self.pt_xyz.shape[0])]
            K = self.kf_pt.shape[0]
            B = np.zeros((K, len(live) + 1), np.float32)
            rows = np.repeat(np.arange(K), self.kf_pt.shape[1])
            B[rows, np.where(idx >= 0, idx, len(live)).ravel()] = 1.0
            B[:, -1] = 0.0
            B[~self.kf_valid] = 0.0
            W = (B @ B.T).astype(np.int32)
        np.fill_diagonal(W, 0)
        W[~self.kf_valid] = 0
        W[:, ~self.kf_valid] = 0
        return W

    def covisible_kfs(self, k: int, n: int | None = None, min_weight: int = 15
                      ) -> np.ndarray:
        """Best covisible keyframes ordered by weight (threshold 15, best
        always kept — src/KeyFrame.cpp:427); all of them when n is None."""
        w = self.covisibility_weights(k)
        order = np.argsort(-w)
        order = order[w[order] > 0]
        if len(order) == 0:
            return order
        keep = order[w[order] >= min_weight]
        if len(keep) == 0:
            keep = order[:1]
        return keep[:n] if n is not None else keep

    # ------------------------------------------------------------- checkpoint
    # the arrays of a map checkpoint, the JAX package's layout
    _ARRAY_FIELDS = (
        "kf_valid", "kf_pose", "kf_timestamp", "kf_frame_id", "kf_xy",
        "kf_octave", "kf_angle", "kf_desc", "kf_depth", "kf_ur",
        "kf_feat_valid", "kf_pt", "pt_valid", "pt_xyz", "pt_desc",
        "pt_normal", "pt_min_dist", "pt_max_dist", "pt_ref_kf",
        "pt_first_kf", "pt_visible", "pt_found", "kf_parent",
        "kf_patch", "pt_patch", "kf_xy0", "kf_ur0", "kf_bow_node",
    )
    # stored as int32 bit-views here, as the uint32 words in a checkpoint
    _DESC_FIELDS = ("kf_desc", "pt_desc")

    def save(self, path):
        """Checkpoint the whole map as one npz in the JAX package's layout
        and dtypes (descriptors as uint32 words), so that either package
        loads the other's file (the reference's SaveMap is a TODO,
        include/System.h:112-114)."""
        from ..interop import desc_i32_to_u32
        arrays = {k: getattr(self, k) for k in self._ARRAY_FIELDS}
        for k in self._DESC_FIELDS:
            arrays[k] = desc_i32_to_u32(arrays[k])
        retired_k = np.array(list(self.kf_retired.keys()), np.int64)
        retired_anchor = np.array([v[0] for v in self.kf_retired.values()], np.int64)
        retired_T = (np.stack([v[1] for v in self.kf_retired.values()])
                     if self.kf_retired else np.zeros((0, 3, 4), np.float32))
        np.savez_compressed(path, n_feat=self.n_feat, next_kf_id=self.next_kf_id,
                            next_pt_id=self.next_pt_id,
                            retired_k=retired_k, retired_anchor=retired_anchor,
                            retired_T=retired_T, **arrays)

    @classmethod
    def load(cls, path, cfg: SlamConfig) -> "MapState":
        """A map checkpoint of either package (MapState.save)."""
        with np.load(path) as z:
            return cls.from_arrays(z, cfg)

    @classmethod
    def from_arrays(cls, arrays, cfg: SlamConfig) -> "MapState":
        """The map of checkpoint arrays: an npz (np.load) or a dict with the
        same keys, the JAX package's dtypes (uint32 descriptor words). Each
        array sits in a map of the configured capacity: where the saved
        capacity differs, the overlap is copied. A field the arrays lack
        keeps its empty value; without next_kf_id / next_pt_id the next ids
        follow the highest used slot. Freed point slots are allocatable at
        once (no frame holds point ids across a load), and the point mirror
        uploads the whole table."""
        from ..interop import desc_u32_to_i32
        n_feat = int(arrays["n_feat"]) if "n_feat" in arrays else arrays["kf_xy"].shape[1]
        mp = cls(cfg, n_feat)
        for k in cls._ARRAY_FIELDS:
            if k not in arrays:
                continue
            arr = np.asarray(arrays[k])
            if k in cls._DESC_FIELDS:
                arr = desc_u32_to_i32(arr)
            tgt = getattr(mp, k)
            if arr.shape != tgt.shape:
                sl = tuple(slice(0, min(a, b)) for a, b in zip(arr.shape, tgt.shape))
                tgt[sl] = arr[sl]
            else:
                setattr(mp, k, arr.astype(tgt.dtype, copy=True))
        if "next_kf_id" in arrays:
            mp.next_kf_id = int(arrays["next_kf_id"])
        else:
            kfs = np.flatnonzero(mp.kf_valid)
            mp.next_kf_id = int(kfs[-1]) + 1 if len(kfs) else 0
        if "next_pt_id" in arrays:
            mp.next_pt_id = min(int(arrays["next_pt_id"]), mp.pt_valid.shape[0])
        else:
            used = np.flatnonzero(mp.pt_valid)
            mp.next_pt_id = int(used[-1]) + 1 if len(used) else 0
        mp._pt_free = [int(i) for i in np.flatnonzero(~mp.pt_valid[:mp.next_pt_id])]
        for k, a, T in zip(arrays.get("retired_k", ()), arrays.get("retired_anchor", ()),
                           arrays.get("retired_T", ())):
            mp.kf_retired[int(k)] = (int(a), np.asarray(T, np.float32))
        mp.generation += 1
        mp._dirty_pts = None
        return mp

    # ------------------------------------------------------- derived refreshes
    def refresh_point_stats(self, pt_ids: np.ndarray):
        """Recompute medoid descriptor, mean normal and scale band for the
        given points (MapPoint::ComputeDistinctiveDescriptors :306 +
        UpdateNormalAndDepth :422). Vectorized over the observation set."""
        pt_ids = np.asarray(pt_ids)
        pt_ids = pt_ids[self.pt_valid[pt_ids]] if len(pt_ids) else pt_ids
        if len(pt_ids) == 0:
            return
        kf, feat, pt = self.observations_of(pt_ids)
        if len(kf) == 0:
            return
        sf = self.cfg.orb.scale_factor
        n_levels = self.cfg.orb.n_levels
        # camera centers of observing KFs
        R = self.kf_pose[kf, :, :3]
        t = self.kf_pose[kf, :, 3]
        centers = -np.einsum("nij,nj->ni", R.transpose(0, 2, 1), t)

        # group observations by point (sorted), then every per-point stat is
        # a grouped reduction — no Python loop over points
        from .. import native
        order = np.argsort(pt, kind="stable")
        pt_s, kf_s, feat_s = pt[order], kf[order], feat[order]
        centers_s = centers[order]
        uniq, starts = np.unique(pt_s, return_index=True)
        offsets = np.concatenate([starts, [len(pt_s)]]).astype(np.int64)
        descs_s = self.kf_desc[kf_s, feat_s]

        # medoid descriptors over all groups at once (native kernel; packed
        # popcount fallback group-by-group)
        med = native.medoid_descriptors(descs_s, offsets)
        if med is not None:
            self.pt_desc[uniq] = descs_s[med]
        else:
            for g in range(len(uniq)):
                d = descs_s[starts[g]:offsets[g + 1]]
                x = d[:, None, :] ^ d[None, :, :]
                dist = np.unpackbits(x.view(np.uint8), axis=-1).sum(-1).sum(-1)
                self.pt_desc[uniq[g]] = d[np.argmin(dist)]

        # mean viewing direction (MapPoint::UpdateNormalAndDepth :422)
        vecs = self.pt_xyz[pt_s] - centers_s
        norms = np.linalg.norm(vecs, axis=-1)
        units = vecs / np.maximum(norms, 1e-9)[:, None]
        nsum = np.add.reduceat(units, starts, axis=0)
        self.pt_normal[uniq] = nsum / np.maximum(
            np.linalg.norm(nsum, axis=-1, keepdims=True), 1e-9)

        # distance band from the reference observation: first observation by
        # pt_ref_kf if present, else the group's first (grouped argmin trick)
        M = len(pt_s)
        pos = np.arange(M)
        is_ref = kf_s == self.pt_ref_kf[pt_s]
        key = np.where(is_ref, pos, pos + M)
        j = np.minimum.reduceat(key, starts)
        j = np.where(j >= M, j - M, j)
        dist_ref = norms[j]
        level = self.kf_octave[kf_s[j], feat_s[j]]
        self.pt_max_dist[uniq] = dist_ref * (sf ** level)
        self.pt_min_dist[uniq] = self.pt_max_dist[uniq] / (sf ** (n_levels - 1))
        self.mark_points_dirty(pt_ids)
