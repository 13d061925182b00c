"""Local mapping: per-keyframe map growth and refinement.

Counterpart of orbslam2_tpu/local_mapping.py (src/LocalMapping.cpp). The
reference's mapping thread becomes a stage run once per keyframe, inline
or on the mapping worker (system.py); each step is a batched device
function plus host bookkeeping on the structure-of-arrays map:

- MapPointCulling (:241)       -> `cull_recent_points` (vectorized rules)
- CreateNewMapPoints (:298)    -> `create_new_points`: epipolar-gated
  matching on the Hamming kernel, LK refinement and gated DLT
  triangulation over the 10 best covisible keyframes
  (engine_keyframe.map_new_points), one readback
- SearchInNeighbors (:611)     -> `fuse_neighbors` (engine_keyframe
  .fuse_targets, both directions, one readback)
- Optimizer::LocalBundleAdjustment (src/Optimizer.cpp:564) -> `local_ba`
  over bucketed shapes via ops/ba.ba_solve
- KeyFrameCulling (:832)       -> `cull_keyframes` (>= 90% redundancy)

Each stage takes the map lock around its host read and apply sections and
releases it while its device work runs, so the tracker's frames interleave
with the mapping but never see a half-applied update. With a keyframe
database and a BoW encoder (relocalization.Relocalizer.frame_bow) every
keyframe's BoW vector and gate nodes are registered in its prep
(ProcessNewKeyFrame's ComputeBoW + KeyFrameDatabase::add), and a culled
keyframe leaves the database. With a loop closer (loop_closing.LoopCloser,
which System sets) every keyframe ends with the loop stage, under the map
lock, on the thread that maps it.
"""
from __future__ import annotations

import threading
import time

import numpy as np
import torch

from . import engine_keyframe as EK
from .config import SlamConfig, Sensor
from .map.mapstate import MapState
from .ops import ba as BA
from .ops import cuda_kernels as CK
from .ops import features as F
from .ops import refine as RF
from .utils.device import upload
from .utils.metrics import log_event, span

STAGES = ("prep", "newpts", "fuse", "ba", "cull", "loop")


def _bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def build_ba_problem(mp: MapState, cfg: SlamConfig, sigma2: np.ndarray,
                     cams: list[int], fixed: list[int],
                     points: np.ndarray | None = None,
                     device: torch.device = torch.device("cpu")):
    """A bucketed fixed-shape BAProblem from map slices.

    Returns (prob, meta); meta carries what the writeback needs: cam_arr,
    points, kf_of_e, fi (feature index per edge), E_need, fixed_set, and
    n_dropped (edges beyond the largest bucket, subsampled out)."""
    cam_arr = np.asarray(cams, np.int32)
    if points is None:
        points = np.unique(mp.kf_pt[cam_arr])
        points = points[points >= 0]
        points = points[mp.pt_valid[points]]
    P = _bucket(len(points), cfg.ba_point_buckets)
    points = points[:P]

    # edge list: observations of selected points by selected cams
    pt_slot = np.full(mp.pt_xyz.shape[0], -1, np.int32)
    pt_slot[points] = np.arange(len(points))
    cam_slot = np.full(mp.kf_pose.shape[0], -1, np.int32)
    cam_slot[cam_arr] = np.arange(len(cam_arr))
    sub_pt = mp.kf_pt[cam_arr]                       # [C, N]
    e_mask = (sub_pt >= 0) & (pt_slot[np.clip(sub_pt, 0, None)] >= 0)
    ci, fi = np.where(e_mask)
    E_need = len(ci)
    E = _bucket(E_need, cfg.ba_edge_buckets)
    n_dropped = max(E_need - E, 0)
    if E_need > E:
        keep = np.random.default_rng(0).choice(E_need, E, replace=False)
        ci, fi = ci[keep], fi[keep]
        E_need = E
    kf_of_e = cam_arr[ci]
    pt_of_e = sub_pt[ci, fi]
    uv = mp.kf_xy[kf_of_e, fi]
    ur = mp.kf_ur[kf_of_e, fi]
    octv = mp.kf_octave[kf_of_e, fi]
    info = (1.0 / sigma2)[np.clip(octv, 0, len(sigma2) - 1)]

    C = _bucket(len(cam_arr), cfg.ba_cam_buckets)
    padC = C - len(cam_arr)
    padP = P - len(points)
    padE = E - E_need

    fixed_set = set(fixed)
    arrays = dict(
        cam_T=np.concatenate([mp.kf_pose[cam_arr],
                              np.tile(np.eye(3, 4, dtype=np.float32), (padC, 1, 1))]),
        cam_fixed=np.concatenate([np.array([c in fixed_set for c in cams], bool),
                                  np.ones(padC, bool)]),
        cam_valid=np.concatenate([np.ones(len(cam_arr), bool), np.zeros(padC, bool)]),
        pts=np.concatenate([mp.pt_xyz[points], np.zeros((padP, 3), np.float32)]),
        pt_valid=np.concatenate([np.ones(len(points), bool), np.zeros(padP, bool)]),
        e_cam=np.concatenate([cam_slot[kf_of_e], np.zeros(padE, np.int32)]),
        e_pt=np.concatenate([pt_slot[pt_of_e], np.zeros(padE, np.int32)]),
        e_obs=np.concatenate(
            [np.stack([uv[:, 0], uv[:, 1], np.maximum(ur, 0.0)], -1),
             np.zeros((padE, 3), np.float32)]).astype(np.float32),
        e_stereo=np.concatenate([ur >= 0, np.zeros(padE, bool)]),
        e_info=np.concatenate([info, np.zeros(padE)]).astype(np.float32),
        e_valid=np.concatenate([np.ones(E_need, bool), np.zeros(padE, bool)]),
    )
    meta = {"cam_arr": cam_arr, "points": points, "kf_of_e": kf_of_e,
            "fi": fi, "E_need": E_need, "fixed_set": fixed_set,
            "n_dropped": n_dropped}
    return BA.problem_from_numpy(arrays, device), meta


class KFStore:
    """Device cache of every keyframe's immutable feature tensors: the
    pristine undistorted positions kf_xy0, octaves, descriptors and
    photometric windows. CreateNewMapPoints and the fuse gather up to 11
    keyframes' full feature tables per keyframe; these four fields never
    change after add_keyframe, so each row is uploaded once and later steps
    gather it on the device. Mutable inputs (poses, free-slot masks,
    refined positions) come from the host every time.

    Each row remembers the kf_frame_id it was uploaded for and is uploaded
    again on a mismatch. The cache grows with the map's keyframe capacity
    (a larger table, the old rows copied in) and never evicts (ROADMAP.md
    queue 3). It belongs to the mapper: only the mapper's stream touches
    it."""

    def __init__(self, mp: MapState, device: torch.device):
        self.map = mp
        self.device = device
        self._arrs = None       # (xy0, octave, desc, patch) on the device
        self._sync_fid = np.zeros(0, np.int64)   # kf_frame_id at upload (-2 never)

    def ensure(self, ids) -> tuple:
        """Upload the missing or stale rows among `ids`; return the device
        tensors (xy0 [K,N,2] f32, octave [K,N] i32, desc [K,N,8] i32,
        patch [K,N,15,15] u8). Call under the map lock."""
        mp = self.map
        host = (mp.kf_xy0, mp.kf_octave, mp.kf_desc, mp.kf_patch)
        K = mp.kf_xy0.shape[0]
        cap = len(self._sync_fid)
        if K > cap:
            grown = tuple(torch.zeros(a.shape, dtype=torch.from_numpy(a).dtype,
                                      device=self.device) for a in host)
            if self._arrs is not None:
                for new, old in zip(grown, self._arrs):
                    new[:cap] = old
            self._arrs = grown
            self._sync_fid = np.concatenate(
                [self._sync_fid, np.full(K - cap, -2, np.int64)])
        ids = np.unique(np.asarray(ids, np.int64))
        stale = ids[self._sync_fid[ids] != mp.kf_frame_id[ids]]
        if len(stale):
            sid = upload(stale, self.device)
            for dev_arr, host_arr in zip(self._arrs, host):
                dev_arr.index_copy_(0, sid, upload(host_arr[stale], self.device))
            self._sync_fid[stale] = mp.kf_frame_id[stale]
        return self._arrs


class LocalMapper:
    def __init__(self, cfg: SlamConfig, mp: MapState, loop_closer=None,
                 kf_db=None, bow_encode=None,
                 device: torch.device | str = "cuda"):
        self.cfg = cfg
        self.loop_closer = loop_closer
        self.map = mp
        # place recognition: the keyframe database and the BoW encoder (the
        # Relocalizer: its frame_bow for a keyframe of an initial map, its
        # frame_bow_dispatch and frame_bow_finish for the keyframes that
        # pass through `process`); either None turns registration off
        self.kf_db = kf_db
        self.bow_encode = bow_encode
        self.device = torch.device(device)
        self.sf = F.scale_factors(cfg.orb)
        self.sigma2 = F.sigma2_per_octave(cfg.orb)
        self._sf_dev = self._dev(self.sf)
        self._sig2_dev = self._dev(self.sigma2)
        # recent points: pt_id -> (birth counter, birth keyframe). The birth
        # keyframe detects a recycled slot (pt_first_kf changed), so a stale
        # entry cannot kill a fresh point that reused the slot.
        self.recent: dict[int, tuple[int, int]] = {}
        self.kf_counter = 0
        self.kf_store = KFStore(mp, self.device)
        # InterruptBA (mbAbortBA): the tracker sets it when it wants to
        # insert a keyframe while the mapper is busy; local_ba then skips
        # its solve (the next keyframe's window covers the same region)
        self._interrupt_ba = threading.Event()
        # per keyframe: {"kf": k, stage: ms for each of STAGES}
        self.stage_ms: list[dict] = []
        self.counters = dict(keyframes=0, points_created=0, fuse_merges=0,
                             ba_solves=0, kfs_culled=0, kfs_registered=0)
        self.ba_solve_ms: list[float] = []

    def _dev(self, a) -> torch.Tensor:
        return upload(a, self.device)

    def interrupt_ba(self):
        """Skip the current or next local BA (InterruptBA, mbAbortBA)."""
        self._interrupt_ba.set()

    def register_keyframe(self, kf: int):
        """BoW transform + place-recognition index insert
        (ProcessNewKeyFrame's ComputeBoW + KeyFrameDatabase::add). Also
        stores the per-feature FeatureVector gate nodes for node-gated
        SearchByBoW (src/ORBmatcher.cpp:243-299). The tracker calls it for
        the keyframes of an initial map, which never pass through
        `process`."""
        if self.kf_db is not None and self.bow_encode is not None:
            vec, nodes = self.bow_encode.frame_bow(self.map.kf_desc[kf],
                                                   self.map.kf_feat_valid[kf])
            self._register(kf, vec, nodes)

    def _register(self, kf: int, vec, nodes):
        self.map.kf_bow_node[kf] = nodes
        self.kf_db.add(kf, vec)
        self.counters["kfs_registered"] += 1

    # ------------------------------------------------------------- refinement
    def _refine_windows(self, win, templates: np.ndarray):
        """LK offsets of the u8 windows `win` [M,15,15] (a device tensor)
        against host templates [M,11,11] (rounded to u8, as stored)."""
        tpl = np.clip(np.round(templates), 0, 255).astype(np.uint8)
        return RF.refine_offsets(win, self._dev(tpl),
                                 torch.ones(len(tpl), dtype=torch.bool,
                                            device=self.device))

    def _apply_refined(self, kfs, feats, delta, ok):
        """kf_xy = kf_xy0 + LK offset (absolute w.r.t. the stored window
        centre, so refinement against a new template never compounds); the
        right-u moves with u."""
        if not ok.any():
            return
        mp = self.map
        ko, fo = kfs[ok], feats[ok]
        lv = np.clip(mp.kf_octave[ko, fo], 0, len(self.sf) - 1)
        d = delta[ok] * self.sf[lv][:, None]
        mp.kf_xy[ko, fo] = mp.kf_xy0[ko, fo] + d
        ur0 = mp.kf_ur0[ko, fo]
        mp.kf_ur[ko, fo] = np.where(ur0 >= 0, ur0 + d[:, 0], ur0)

    def _refine_bound_dispatch(self, kf: int):
        """Device half of the new keyframe's observation refinement: every
        point-bound feature against its point's anchor template, so BA
        edges are template-consistent. The windows come from the device
        cache; only the templates (mutable under fuse) are uploaded. Call
        under the map lock."""
        mp = self.map
        feats = np.flatnonzero(mp.kf_pt[kf] >= 0)
        if len(feats) == 0:
            return None
        patch_d = self.kf_store.ensure([kf])[3]
        delta, ok = self._refine_windows(
            patch_d[kf][self._dev(feats.astype(np.int64))],
            mp.pt_patch[mp.kf_pt[kf, feats]])
        return feats, delta, ok

    def _refine_bound_apply(self, kf: int, feats, delta, ok):
        """Host half: apply the read-back offsets. Call under the map lock."""
        self._apply_refined(np.full(len(feats), kf), feats, delta, ok)

    def _refine_obs_multi(self, kfs: np.ndarray, feats: np.ndarray,
                          templates: np.ndarray):
        """Refine observation (kfs[i], feats[i]) against templates[i], all
        in one batch, and apply. Call under the map lock."""
        mp = self.map
        delta, ok = self._refine_windows(self._dev(mp.kf_patch[kfs, feats]),
                                         templates)
        self._apply_refined(kfs, feats, delta.cpu().numpy(), ok.cpu().numpy())

    @staticmethod
    def _fetch_prep(bow, refined):
        """One readback for a keyframe's prep: the (words, ok, nodes) tensors
        of the BoW dispatch and the (delta, ok) tensors of the refinement
        dispatch, either of which may be None, packed into one int32 tensor
        on the device (the offsets as their bit patterns) and split again on
        the host. Returns (bow, refined) as host arrays."""
        parts = []
        if bow is not None:
            parts += [t.to(torch.int32) for t in bow]
        if refined is not None:
            feats, delta, ok = refined
            parts += [delta.to(torch.float32).contiguous().view(torch.int32).reshape(-1),
                      ok.to(torch.int32)]
        if not parts:
            return None, None
        flat = torch.cat(parts).cpu().numpy()
        if bow is not None:
            n = len(bow[0])
            bow = flat[:n], flat[n:2 * n] != 0, flat[2 * n:3 * n]
            flat = flat[3 * n:]
        if refined is not None:
            m = len(feats)
            refined = (feats, flat[:2 * m].view(np.float32).reshape(m, 2),
                       flat[2 * m:] != 0)
        return bow, refined

    # ---------------------------------------------------------------- process
    def process(self, kf: int):
        """ProcessNewKeyFrame + the per-keyframe pipeline (LocalMapping::Run,
        src/LocalMapping.cpp:48-170). Records the stage times (ms, host
        clock around work that ends in a readback) in `stage_ms`."""
        with CK.launches_counted_as("mapper"):
            t = [time.perf_counter()]
            self.kf_counter += 1
            self.counters["keyframes"] += 1
            # a stale interrupt from before this keyframe entered the queue
            # must not cancel its BA (mbAbortBA is cleared per keyframe)
            self._interrupt_ba.clear()
            mp = self.map
            # the BoW word assignment and the observation refinement are
            # both dispatched under the lock and read back together outside
            # it; only this thread culls keyframes and points, so the
            # snapshot cannot go stale in between
            with mp.lock:
                t_bow = time.perf_counter()
                bow = (self.bow_encode.frame_bow_dispatch(
                    mp.kf_desc[kf], mp.kf_feat_valid[kf])
                    if self.kf_db is not None and self.bow_encode is not None else None)
                bow_ms = (time.perf_counter() - t_bow) * 1e3
                refined = self._refine_bound_dispatch(kf)
                # spanning-tree parent: the most covisible KF at insertion
                if mp.kf_parent[kf] < 0:
                    w = mp.covisibility_weights(kf)
                    if w.max() > 0:
                        mp.kf_parent[kf] = int(np.argmax(w))
            bow, refined = self._fetch_prep(bow, refined)
            with mp.lock:
                if bow is not None:
                    t_bow = time.perf_counter()
                    self._register(kf, *self.bow_encode.frame_bow_finish(*bow))
                    bow_ms += (time.perf_counter() - t_bow) * 1e3
                if refined is not None:
                    self._refine_bound_apply(kf, *refined)
                mp.refresh_point_stats(np.unique(mp.kf_pt[kf][mp.kf_pt[kf] >= 0]))
                self.cull_recent_points()
            t.append(time.perf_counter())
            self.create_new_points(kf)
            t.append(time.perf_counter())
            self.fuse_neighbors(kf)
            t.append(time.perf_counter())
            self.local_ba(kf)
            t.append(time.perf_counter())
            with mp.lock:
                self.cull_keyframes(kf)
                t.append(time.perf_counter())
                if self.loop_closer is not None:
                    with CK.launches_counted_as("loop"):
                        self.loop_closer.process(kf)
            t.append(time.perf_counter())
        # "bow" is the host time inside "prep" that place recognition adds:
        # dispatching the word assignment, then building and registering the
        # sparse vector (the wait for the card is shared with the refinement)
        self.stage_ms.append({"kf": kf, **{s: (t[i + 1] - t[i]) * 1e3
                                           for i, s in enumerate(STAGES)},
                              "bow": bow_ms})

    # ---------------------------------------------------------------- culling
    def cull_recent_points(self):
        """MapPointCulling (src/LocalMapping.cpp:241-296): kill points with
        found-ratio < 0.25, or too few observers after 2 keyframes; graduate
        after 3."""
        if not self.recent:
            return
        mp = self.map
        ids = np.fromiter(self.recent.keys(), np.int64)
        birth = np.array([v[0] for v in self.recent.values()], np.int64)
        birth_kf = np.array([v[1] for v in self.recent.values()], np.int64)
        stale = mp.pt_first_kf[ids] != birth_kf  # slot recycled: drop entry
        age = self.kf_counter - birth
        obs = mp.point_obs_count()[ids]
        found_ratio = mp.pt_found[ids] / np.maximum(mp.pt_visible[ids], 1.0)
        min_obs = 2 if self.cfg.sensor == Sensor.MONOCULAR else 3
        kill = ((found_ratio < 0.25) | ((age >= 2) & (obs <= min_obs))
                | ~mp.pt_valid[ids]) & ~stale
        graduate = (age >= 3) & ~kill
        mp.remove_points(ids[kill & mp.pt_valid[ids]])
        for p in ids[kill | graduate | stale]:
            self.recent.pop(int(p), None)

    def cull_keyframes(self, kf: int):
        """KeyFrameCulling (src/LocalMapping.cpp:832-921): discard a local
        covisible KF if >= 90% of its (close, for stereo/RGB-D) points are
        seen by >= 3 other keyframes at the same or finer scale
        (scaleLeveli <= scaleLevel + 1, :873-908)."""
        mp = self.map
        for k in mp.covisible_kfs(kf):
            k = int(k)
            if k == kf or mp.kf_frame_id[k] <= 1:
                continue
            feats = np.flatnonzero(mp.kf_pt[k] >= 0)
            pts = mp.kf_pt[k, feats]
            if self.cfg.sensor != Sensor.MONOCULAR:
                # only close, positive-depth points count (:861-866)
                d = mp.kf_depth[k, feats]
                keep = (d > 0) & (d < self.cfg.close_depth_threshold)
                feats, pts = feats[keep], pts[keep]
            n_pts = len(pts)
            if n_pts == 0:
                continue
            # every observation of this KF's points, with observer octave
            rows, cols, obs_pt = mp.observations_of(pts)
            lv_of_pt = np.full(mp.pt_xyz.shape[0], 0, np.int32)
            lv_of_pt[pts] = mp.kf_octave[k, feats]
            same_or_finer = (rows != k) & (
                mp.kf_octave[rows, cols] <= lv_of_pt[obs_pt] + 1)
            n_good_obs = np.bincount(obs_pt[same_or_finer],
                                     minlength=mp.pt_xyz.shape[0])
            if (n_good_obs[pts] >= 3).sum() > 0.9 * n_pts:
                mp.remove_keyframe(k)
                if self.kf_db is not None:
                    self.kf_db.erase(k)
                self.counters["kfs_culled"] += 1

    # ----------------------------------------------------------- new points
    def create_new_points(self, kf: int):
        """CreateNewMapPoints (src/LocalMapping.cpp:298-610): one device
        call over all neighbours (engine_keyframe.map_new_points), one
        readback, then slot allocation and writebacks on the host."""
        mp = self.map
        with mp.lock:
            dispatched = self._create_new_points_dispatch(kf)
        if dispatched is None:
            return
        neighbors, k_valid, out = dispatched
        idx, X, ok, delta, okr = (t.cpu().numpy() for t in out)
        with mp.lock:
            self._create_new_points_apply(kf, neighbors, k_valid,
                                          idx, X, ok, delta, okr)

    def _create_new_points_dispatch(self, kf: int):
        mp = self.map
        cfg = self.cfg
        n_neigh = 20 if cfg.sensor == Sensor.MONOCULAR else 10
        neighbors = [int(k) for k in mp.covisible_kfs(kf, n_neigh)]
        if not neighbors:
            return None
        cam = cfg.camera
        T1 = mp.kf_pose[kf]
        Ow1 = -T1[:, :3].T @ T1[:, 3]
        free1 = (mp.kf_pt[kf] < 0) & mp.kf_feat_valid[kf]

        # host-side per-neighbour gates (src/LocalMapping.cpp:349-365)
        k_valid = np.zeros(len(neighbors), bool)
        for i, kn in enumerate(neighbors):
            T2 = mp.kf_pose[kn]
            Ow2 = -T2[:, :3].T @ T2[:, 3]
            baseline = float(np.linalg.norm(Ow1 - Ow2))
            if cfg.sensor == Sensor.MONOCULAR:
                pts2 = mp.kf_pt[kn]
                vis = pts2 >= 0
                if vis.sum() < 20:
                    continue
                pc = mp.pt_xyz[pts2[vis]] @ T2[:, :3].T + T2[:, 3]
                med_depth = float(np.median(pc[:, 2]))
                if med_depth <= 0 or baseline / med_depth < 0.01:
                    continue
            elif baseline < cam.baseline:
                continue
            k_valid[i] = True
        if not k_valid.any():
            return None

        nb = np.asarray(neighbors, np.int64)
        free2 = (mp.kf_pt[nb] < 0) & mp.kf_feat_valid[nb]
        xy0_d, oct_d, desc_d, patch_d = self.kf_store.ensure([kf] + neighbors)
        nb_d = self._dev(nb)
        out = EK.map_new_points(
            self._dev(T1), xy0_d[kf], oct_d[kf], desc_d[kf],
            self._dev(free1), patch_d[kf],
            self._dev(mp.kf_pose[nb]), xy0_d[nb_d], oct_d[nb_d], desc_d[nb_d],
            self._dev(free2), patch_d[nb_d], self._dev(k_valid),
            self._sig2_dev, self._sf_dev,
            cam.fx, cam.fy, cam.cx, cam.cy, cfg.orb.scale_factor)
        return neighbors, k_valid, out

    def _create_new_points_apply(self, kf: int, neighbors, k_valid,
                                 idx, X, ok, delta, okr):
        mp = self.map
        anchor_tpl = None
        all_new: list = []
        for j, kn in enumerate(neighbors):
            if not k_valid[j]:
                continue
            i1 = np.flatnonzero(idx[j] >= 0)
            if len(i1) == 0:
                continue
            i2 = idx[j, i1]
            # the anchor observation is reset to the pristine detection (it
            # is the template centre); the neighbour observation adopts its
            # LK refinement
            mp.kf_xy[kf, i1] = mp.kf_xy0[kf, i1]
            mp.kf_ur[kf, i1] = mp.kf_ur0[kf, i1]
            ref = okr[j, i1]
            self._apply_refined(np.full(ref.sum(), kn), i2[ref],
                                delta[j, i1[ref]], np.ones(ref.sum(), bool))
            good = ok[j, i1]
            if not good.any():
                continue
            i1o, i2o, Xo = i1[good], i2[good], X[j, i1[good]]
            if anchor_tpl is None:
                anchor_tpl = RF.template_of(mp.kf_patch[kf]).astype(np.float32)
            pt_ids = mp.add_points(Xo.astype(np.float32), mp.kf_desc[kf, i1o],
                                   ref_kf=kf, first_kf=kf, patch=anchor_tpl[i1o])
            mp.kf_pt[kf, i1o] = pt_ids
            mp.kf_pt[kn, i2o] = pt_ids
            for p in pt_ids:
                self.recent[int(p)] = (self.kf_counter, kf)
            all_new.append(pt_ids)
            self.counters["points_created"] += len(pt_ids)
        if all_new:
            # one stat refresh for all neighbours' new points
            mp.refresh_point_stats(np.concatenate(all_new))

    # -------------------------------------------------------------------- fuse
    def fuse_neighbors(self, kf: int):
        """SearchInNeighbors (src/LocalMapping.cpp:611-721): project the new
        keyframe's points into its neighbours and the neighbours' points
        into the new keyframe, in one device call against the pre-fuse map,
        then merge duplicates on the host (keeping the most-observed point),
        following this fuse's own merge redirects."""
        mp = self.map
        with mp.lock:
            dispatched = self._fuse_dispatch(kf)
        if dispatched is None:
            return
        targets, a_lp, b_lp, obs_counts, (idx_a, idx_b) = dispatched
        idx_a, idx_b = idx_a.cpu().numpy(), idx_b.cpu().numpy()
        with mp.lock:
            self._fuse_apply(kf, targets, a_lp, b_lp, obs_counts, idx_a, idx_b)

    def _fuse_dispatch(self, kf: int):
        mp = self.map
        cam = self.cfg.camera
        targets = [int(k) for k in mp.covisible_kfs(kf, 10)]
        if not targets:
            return None
        obs_counts = mp.point_obs_count()
        tg = np.asarray(targets, np.int64)

        def point_set(kfs, cap):
            pts = mp.kf_pt[kfs]
            pids = np.unique(pts[pts >= 0])
            pids = pids[mp.pt_valid[pids]][:cap]
            pad = cap - len(pids)
            lp = np.concatenate([pids, np.zeros(pad, pids.dtype)])
            pv = np.concatenate([np.ones(len(pids), bool), np.zeros(pad, bool)])
            return lp, pv

        cap = self.cfg.local_points_cap
        a_lp, a_pv = point_set(np.asarray([kf]), min(cap, mp.kf_pt.shape[1]))
        b_lp, b_pv = point_set(tg, cap)
        if not a_pv.any() and not b_pv.any():
            return None

        # octaves/descriptors come from the device cache; the refined
        # positions (kf_xy/kf_ur), masks and the point table are mutable
        _, oct_d, desc_d, _ = self.kf_store.ensure([kf] + targets)
        tg_d = self._dev(tg)

        def points(lp, pv):
            return (self._dev(mp.pt_xyz[lp]), self._dev(pv),
                    self._dev(mp.pt_desc[lp]), self._dev(mp.pt_normal[lp]),
                    self._dev(mp.pt_min_dist[lp]), self._dev(mp.pt_max_dist[lp]))

        out = EK.fuse_targets(
            self._dev(mp.kf_pose[tg]), self._dev(mp.kf_xy[tg]),
            oct_d[tg_d], desc_d[tg_d], self._dev(mp.kf_feat_valid[tg]),
            self._dev(mp.kf_ur[tg]), *points(a_lp, a_pv),
            self._dev(mp.kf_pose[kf]), self._dev(mp.kf_xy[kf]),
            oct_d[kf], desc_d[kf], self._dev(mp.kf_feat_valid[kf]),
            self._dev(mp.kf_ur[kf]), *points(b_lp, b_pv),
            self._sf_dev, cam.fx, cam.fy, cam.cx, cam.cy, cam.bf,
            cam.width, cam.height, self.cfg.orb.n_levels,
            float(np.log(self.cfg.orb.scale_factor)))
        return targets, a_lp, b_lp, obs_counts, out

    def _fuse_apply(self, kf: int, targets, a_lp, b_lp, obs_counts,
                    idx_a, idx_b):
        mp = self.map
        touched: list[int] = []
        refine_kf, refine_feat, refine_pt = [], [], []
        jobs = [(targets[j], a_lp, idx_a[j]) for j in range(len(targets))]
        jobs.append((kf, b_lp, idx_b))
        redirects: dict[int, int] = {}  # merges applied within this fuse
        for dst_kf, lp, midx in jobs:
            lp_res = mp.resolve_point_ids(lp)
            for s in np.flatnonzero(midx >= 0):
                p = int(lp_res[s])
                while p in redirects:  # follow intra-fuse merge redirects
                    p = redirects[p]
                if p < 0 or not mp.pt_valid[p]:
                    continue
                feat = int(midx[s])
                existing = int(mp.kf_pt[dst_kf, feat])
                if existing == p:
                    continue
                if existing >= 0 and mp.pt_valid[existing]:
                    # merge: keep the point with more observations
                    # (ORBmatcher::Fuse, src/ORBmatcher.cpp:1091-1113)
                    self.counters["fuse_merges"] += 1
                    if obs_counts[existing] >= obs_counts[p]:
                        mp.replace_point(p, existing)
                        redirects[p] = existing
                        touched.append(existing)
                    else:
                        mp.replace_point(existing, p)
                        redirects[existing] = p
                        mp.kf_pt[dst_kf, feat] = p
                        touched.append(p)
                else:
                    mp.kf_pt[dst_kf, feat] = p
                    touched.append(p)
                    refine_kf.append(dst_kf)
                    refine_feat.append(feat)
                    refine_pt.append(p)
        if refine_feat:
            # template-align the fresh observations (merged features keep
            # their earlier refinement) in one batch across keyframes
            self._refine_obs_multi(np.asarray(refine_kf), np.asarray(refine_feat),
                                   mp.pt_patch[np.asarray(refine_pt)])
        if touched:
            mp.refresh_point_stats(np.unique(touched))

    # ---------------------------------------------------------------- local BA
    def local_ba(self, kf: int):
        """LocalBundleAdjustment window (src/Optimizer.cpp:564-941): local
        cams = current + covisible; local points = their points; fixed cams
        = other observers of those points."""
        if self._interrupt_ba.is_set():
            # aborted by the tracker (InterruptBA): skip this window's solve
            self._interrupt_ba.clear()
            return
        with self.map.lock:
            sel = self._local_ba_select(kf)
        if sel is None:
            return
        cams, fixed, lpts = sel
        self.run_ba(cams, fixed=fixed, points=lpts)

    def _local_ba_select(self, kf: int):
        mp = self.map
        local = [kf] + [int(k) for k in mp.covisible_kfs(kf)]
        local = local[:self.cfg.local_ba_cam_cap]
        lpts = np.unique(mp.kf_pt[local])
        lpts = lpts[(lpts >= 0)]
        lpts = lpts[mp.pt_valid[lpts]]
        if len(lpts) < 10:
            return None
        # fixed second ring: KFs observing local points but not in local set
        seen = np.zeros(mp.pt_xyz.shape[0], bool)
        seen[lpts] = True
        observers = np.flatnonzero(
            ((seen[np.clip(mp.kf_pt, 0, None)] & (mp.kf_pt >= 0)).any(axis=1))
            & mp.kf_valid)
        fixed = [int(k) for k in observers if int(k) not in local][:24]
        cams = local + fixed
        fixed_mask = np.zeros(len(cams), bool)
        fixed_mask[len(local):] = True
        global_oldest = mp.kf_frame_id[mp.kf_valid].min()
        if self.cfg.local_ba_gauge == "ref":
            for i, c in enumerate(cams):
                if mp.kf_frame_id[c] <= global_oldest:
                    fixed_mask[i] = True
            if not fixed_mask.any() and len(cams) >= mp.n_keyframes:
                # a gauge-free window that is the whole map: anchor it
                fixed_mask[int(np.argmin(mp.kf_frame_id[cams]))] = True
        else:
            if not fixed_mask.any():
                fixed_mask[int(np.argmin(mp.kf_frame_id[local]))] = True
            if mp.kf_frame_id[cams].min() <= global_oldest:
                fixed_mask[int(np.argmin(mp.kf_frame_id[cams]))] = True
        return cams, [cams[i] for i in np.flatnonzero(fixed_mask)], lpts

    def run_ba(self, cams: list[int], fixed: list[int],
               points: np.ndarray | None = None, iters=(5, 10)):
        """Build a bucketed BAProblem from map slices, solve, write back,
        and prune outlier observations. The solve runs outside the map lock
        on its own snapshot of the problem."""
        mp = self.map
        with mp.lock:
            prob, meta = build_ba_problem(mp, self.cfg, self.sigma2, cams,
                                          fixed, points, device=self.device)
        if meta["n_dropped"]:
            log_event("ba_edges_dropped", dropped=meta["n_dropped"],
                      kept=meta["E_need"])
        cam_p = self.cfg.camera
        with span("mapper.local_ba") as solve:
            res = BA.ba_solve(prob, cam_p.fx, cam_p.fy, cam_p.cx, cam_p.cy,
                              cam_p.bf, iters1=iters[0], iters2=iters[1])
            cam_arr, points = meta["cam_arr"], meta["points"]
            new_T = res.cam_T.cpu().numpy()[:len(cam_arr)]
            new_pts = res.pts.cpu().numpy()[:len(points)]
            inl = res.e_inlier.cpu().numpy()[:meta["E_need"]]
        self.ba_solve_ms.append(solve.elapsed_ms)
        self.counters["ba_solves"] += 1
        with mp.lock:
            fixed_set = meta["fixed_set"]
            kf_of_e, fi = meta["kf_of_e"], meta["fi"]
            for i, c in enumerate(cams):
                if c not in fixed_set:
                    mp.kf_pose[c] = new_T[i]
            mp.pt_xyz[points] = new_pts
            mp.mark_points_dirty(points)  # direct geometry write (mirror)
            # prune outlier observations (src/Optimizer.cpp:845-941)
            bad = ~inl
            if bad.any():
                mp.kf_pt[kf_of_e[bad], fi[bad]] = -1
            mp.refresh_point_stats(points)
