"""Loop closing: detect revisits, align with Sim(3), correct the map.

Counterpart of orbslam2_tpu/loop_closing.py (src/LoopClosing.cpp). The
reference's loop thread becomes a stage of the mapper: LocalMapper.process
calls `process` once per keyframe, under the map lock, on whatever thread
maps (inline, or the asynchronous mapping worker with its CUDA stream).
Each numeric step is a device function; the bookkeeping is host numpy:

- DetectLoop (:118): min-score gate against covisible BoW scores, database
  candidates, covisibility-consistency chaining across >= 3 consecutive
  keyframes (mnCovisibilityConsistencyTh=3, :43)
- ComputeSim3 (:289): per candidate, node-gated SearchByBoW
  (frontend/matcher.match_by_bow on the fused Hamming kernel, >= 20
  matches), Sim(3) RANSAC (ops/sim3_solver.sim3_ransac), the guided
  bidirectional SearchBySim3 (`_search_by_sim3`), the Gauss-Newton
  refinement (optimize_sim3) and the loop-neighbourhood projection check
  (>= 40 matches, :474-499)
- CorrectLoop (:512): Sim3 propagation to the covisible group, point
  remapping, loop-point fusion, the group-wide SearchAndFuse
  (engine_keyframe.fuse_scw), essential-graph optimization
  (ops/pose_graph.py), then the global BA in the background
  (global_ba.GlobalBA, which the System gives).

The caps of the JAX package are kept for parity: `candidates[:5]`, 512
matches into the Sim(3) solver, 1024 and `local_points_cap` projections and
a fusion group of 16 keyframes. `closures` records what each closed loop
did and how long each part took (host ms around work that ends in a
readback).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from . import engine_keyframe as EK
from .config import SlamConfig, Sensor
from .frontend import matcher as FM
from .geometry import se3_np
from .map.keyframe_db import KeyFrameDatabase
from .map.mapstate import MapState
from .ops import features as F
from .ops import matching as M
from .ops import pose_graph as PG
from .ops import sim3_solver as S3
from .utils.device import upload, upload_and_wait

COVISIBILITY_CONSISTENCY_TH = 3  # src/LoopClosing.cpp:43
SIM3_CAP = 512       # matches one Sim(3) solve takes
SEARCH_CAP = 1024    # points one SearchBySim3 direction projects
FUSE_GROUP = 16      # keyframes of the corrected group that SearchAndFuse visits


class LoopCloser:
    def __init__(self, cfg: SlamConfig, mp: MapState, kf_db: KeyFrameDatabase,
                 global_ba, device: torch.device | str = "cuda"):
        self.cfg = cfg
        self.map = mp
        self.kf_db = kf_db
        self.global_ba = global_ba  # background abortable GBA (global_ba.py)
        self.device = torch.device(device)
        self.sigma2 = F.sigma2_per_octave(cfg.orb)
        # built on the System's thread, read on the mapping thread's stream
        self._sf_dev = upload_and_wait(F.scale_factors(cfg.orb), self.device)
        # the minimal sets of the Sim(3) RANSAC are drawn from this generator
        self._rng = torch.Generator(device=self.device)
        self._rng.manual_seed(23)
        # tests replay another package's draws: a callable that is given the
        # valid mask of a sim3_ransac call and returns its [N_HYPOTHESES, 3]
        # index array, or None to draw
        self.minimal_sets = None
        self.prev_groups: list[tuple[set, int]] = []
        self.last_loop_counter = -100
        self.kf_counter = 0
        self.loop_edges: list[tuple[int, int]] = []
        self.n_loops_closed = 0
        self.n_loop_fused = 0       # SearchAndFuse merges at the last loop
        self.last_pgo_edges: dict = {}  # edge-set stats of the last PGO
        self._support_matches = None    # (loop points, kf features) of the last check
        self._correct_ms: dict = {}     # part times of the last _correct_loop
        # one dict per closed loop: keyframe pair, inliers, support, fused
        # points, PGO edges and ms per part (detect, compute, correct, fuse, pgo)
        self.closures: list[dict] = []

    def _dev(self, a) -> torch.Tensor:
        return upload(a, self.device)

    # ------------------------------------------------------------------ entry
    def process(self, kf: int) -> bool:
        # apply any finished background GBA on the mapping thread (the
        # reference applies results after LocalMapping stops,
        # src/LoopClosing.cpp:830-910)
        self.global_ba.poll()
        self.kf_counter += 1
        if self.kf_counter - self.last_loop_counter < 10:  # :131
            return False
        if self.map.n_keyframes < 6:
            return False
        t0 = time.perf_counter()
        candidates = self._detect(kf)
        t1 = time.perf_counter()
        if len(candidates) == 0:
            return False
        ok = self._compute_and_correct(kf, candidates)
        if ok:
            self.last_loop_counter = self.kf_counter
            self.n_loops_closed += 1
            part = self._correct_ms
            self.closures[-1]["ms"] = dict(
                detect=(t1 - t0) * 1e3,
                compute=(time.perf_counter() - t1) * 1e3 - part["total"],
                **{k: part[k] for k in ("correct", "fuse", "pgo")})
        return ok

    # ----------------------------------------------------------------- detect
    def _detect(self, kf: int) -> list[int]:
        mp = self.map
        covis = [int(k) for k in mp.covisible_kfs(kf, min_weight=15)]
        if covis:
            scores = self.kf_db.scores_for_kf(kf, covis)
            min_score = float(max(scores.min(), 0.0))  # :143-157
        else:
            min_score = 0.0
        cand = self.kf_db.detect_loop_candidates(kf, min_score)
        # covisibility-consistency chaining (:176-250)
        new_groups: list[tuple[set, int]] = []
        consistent_enough: list[int] = []
        for c in cand:
            group = {int(c)} | {int(x) for x in mp.covisible_kfs(int(c))}
            count = 0
            for prev_set, prev_count in self.prev_groups:
                if group & prev_set:
                    count = max(count, prev_count + 1)
            new_groups.append((group, count))
            if count >= COVISIBILITY_CONSISTENCY_TH - 1:
                consistent_enough.append(int(c))
        self.prev_groups = new_groups
        return consistent_enough

    # ----------------------------------------------------- sim3 + correction
    def _sim3_inputs(self, kf: int, kc: int, f1: np.ndarray, f2: np.ndarray):
        """The matched features' points in both camera frames, their pixel
        variances and the valid mask, zero-padded to SIM3_CAP rows (the
        padding's variance is 1)."""
        mp = self.map
        n = min(len(f1), SIM3_CAP)
        pad = SIM3_CAP - n
        T1, T2 = mp.kf_pose[kf], mp.kf_pose[kc]
        P1 = mp.pt_xyz[mp.kf_pt[kf, f1[:n]]] @ T1[:, :3].T + T1[:, 3]
        P2 = mp.pt_xyz[mp.kf_pt[kc, f2[:n]]] @ T2[:, :3].T + T2[:, 3]
        zeros = np.zeros((pad, 3), np.float32)
        P1p = np.concatenate([P1, zeros]).astype(np.float32)
        P2p = np.concatenate([P2, zeros]).astype(np.float32)
        ones = np.ones(pad, np.float32)
        s1 = np.concatenate([self.sigma2[np.clip(mp.kf_octave[kf, f1[:n]], 0, 7)], ones])
        s2 = np.concatenate([self.sigma2[np.clip(mp.kf_octave[kc, f2[:n]], 0, 7)], ones])
        vmask = np.arange(SIM3_CAP) < n
        return n, P1p, P2p, s1, s2, vmask

    def _pixels(self, P: np.ndarray) -> np.ndarray:
        cam = self.cfg.camera
        z = np.maximum(P[:, 2], 1e-6)
        return np.stack([cam.fx * P[:, 0] / z + cam.cx,
                         cam.fy * P[:, 1] / z + cam.cy], -1).astype(np.float32)

    def _next_minimal_sets(self, valid: np.ndarray):
        if self.minimal_sets is None:
            return None
        idx = self.minimal_sets(valid)
        return None if idx is None else self._dev(np.asarray(idx, np.int64))

    def _compute_and_correct(self, kf: int, candidates: list[int]) -> bool:
        mp = self.map
        cam = self.cfg.camera
        intr = (cam.fx, cam.fy, cam.cx, cam.cy)
        fix_scale = self.cfg.sensor != Sensor.MONOCULAR
        for kc in candidates[:5]:
            # a loop partner must be a DIFFERENT, live keyframe (guard: a
            # self- or neighbour-candidate would "correct" the map onto
            # itself; see keyframe_db.detect_loop_candidates)
            if kc == kf or not mp.kf_valid[kc]:
                continue
            # match features that carry map points in both keyframes (:327)
            # by node-gated SearchByBoW (src/ORBmatcher.cpp:243-299)
            res = FM.match_by_bow(
                self._dev(mp.kf_desc[kf]), self._dev(mp.kf_pt[kf] >= 0),
                self._dev(mp.kf_angle[kf]), self._dev(mp.kf_bow_node[kf]),
                self._dev(mp.kf_desc[kc]), self._dev(mp.kf_pt[kc] >= 0),
                self._dev(mp.kf_angle[kc]), self._dev(mp.kf_bow_node[kc]))
            midx = res.idx.cpu().numpy()
            i1 = np.flatnonzero(midx >= 0)
            if len(i1) < 20:  # :327-334
                continue
            i2 = midx[i1]
            n, P1p, P2p, s1, s2, vmask = self._sim3_inputs(kf, kc, i1, i2)
            sr = S3.sim3_ransac(
                self._dev(P1p), self._dev(P2p), self._dev(s1), self._dev(s2),
                self._dev(vmask), *intr, fix_scale=fix_scale,
                idx=self._next_minimal_sets(vmask), generator=self._rng)
            n_ransac = int(sr.n_inliers)
            if n_ransac < 20:  # :409-412
                continue
            # guided bidirectional Sim3 matching between the RANSAC and the
            # GN refinement (ORBmatcher::SearchBySim3, src/ORBmatcher.cpp:
            # 1305, called at src/LoopClosing.cpp:402): expand the
            # correspondence set the Sim3 is refined on
            ransac_inl = sr.inliers.cpu().numpy()
            e1, e2 = self._search_by_sim3(
                kf, kc, float(sr.s), sr.R.cpu().numpy(), sr.t.cpu().numpy(),
                i1[:n], i2[:n])
            if len(e1) > n:
                n2, P1p, P2p, s1, s2, vmask = self._sim3_inputs(kf, kc, e1, e2)
                inl_in = np.zeros(SIM3_CAP, bool)
                inl_in[:n] = ransac_inl[:n]
                inl_in[n:n2] = True  # new guided pairs start trusted; the
                #                      GN refinement re-classifies them
            else:
                inl_in = ransac_inl & vmask
            # GN refinement over the (expanded) correspondences
            # (Optimizer::OptimizeSim3, src/Optimizer.cpp:1281)
            s_o, R_o, t_o, _, n_o = S3.optimize_sim3(
                sr.s, sr.R, sr.t, self._dev(P1p), self._dev(P2p),
                self._dev(self._pixels(P1p)), self._dev(self._pixels(P2p)),
                self._dev(s1), self._dev(s2), self._dev(inl_in), *intr,
                fix_scale=fix_scale)
            n_opt = int(n_o)
            if n_opt < 20:
                continue
            # loop-neighbourhood support check (:440-499): project the loop
            # region's points into kf with the corrected pose and count
            # matches
            s12, R12, t12 = float(s_o), R_o.cpu().numpy(), t_o.cpu().numpy()
            n_support = self._loop_support(kf, kc, s12, R12, t12)
            if n_support < 40:
                continue
            self._correct_loop(kf, kc, s12, R12, t12)
            self.closures.append(dict(
                kf=kf, kc=kc, bow_matches=len(i1), ransac_inliers=n_ransac,
                guided_matches=len(e1), sim3_inliers=n_opt, support=n_support,
                scale=s12, fused=self.n_loop_fused, **self.last_pgo_edges))
            return True
        return False

    def _search_by_sim3(self, kf: int, kc: int, s12, R12, t12,
                        i1: np.ndarray, i2: np.ndarray):
        """Guided bidirectional Sim3 matching (ORBmatcher::SearchBySim3,
        src/ORBmatcher.cpp:1305-1560, called at src/LoopClosing.cpp:402):
        project kc's map points into kf through S12 and kf's into kc through
        S12^-1, match by descriptor within a scale-predicted radius (7.5 ·
        scale), and accept pairs that AGREE in both directions. Returns the
        (i1, i2) match set EXPANDED with the new mutual pairs."""
        mp = self.map
        cam = self.cfg.camera
        log_scale = float(np.log(self.cfg.orb.scale_factor))
        none = np.zeros(0, np.int64), np.zeros(0, np.int64)

        def project_and_match(src_kf, dst_kf, s, R, t, skip_src, skip_dst):
            """Project src_kf's bound points through the similarity into
            dst_kf's features; returns (src_feat, dst_feat) match arrays."""
            feats = np.flatnonzero((mp.kf_pt[src_kf] >= 0) & ~skip_src)
            pts = mp.kf_pt[src_kf, feats]
            live = mp.pt_valid[pts]
            feats, pts = feats[live], pts[live]
            if len(feats) == 0:
                return none
            T_src = mp.kf_pose[src_kf]
            Xc_src = mp.pt_xyz[pts] @ T_src[:, :3].T + T_src[:, 3]
            Xc_dst = s * (Xc_src @ R.T) + t
            z = Xc_dst[:, 2]
            u = cam.fx * Xc_dst[:, 0] / np.maximum(z, 1e-6) + cam.cx
            v = cam.fy * Xc_dst[:, 1] / np.maximum(z, 1e-6) + cam.cy
            dist = np.linalg.norm(Xc_dst, axis=-1) / s  # SE3-demoted depth
            band = ((dist >= 0.8 * mp.pt_min_dist[pts])
                    & (dist <= 1.2 * mp.pt_max_dist[pts]))
            ok = (z > 0.1) & (u >= 0) & (u < cam.width) & (v >= 0) \
                & (v < cam.height) & band
            sel = np.flatnonzero(ok)
            if len(sel) == 0:
                return none
            ratio = np.maximum(mp.pt_max_dist[pts[sel]], 1e-9) / \
                np.maximum(dist[sel], 1e-9)
            pred = np.clip(np.ceil(np.log(ratio) / log_scale), 0,
                           self.cfg.orb.n_levels - 1).astype(np.int32)
            sel = sel[:SEARCH_CAP]
            pad = SEARCH_CAP - len(sel)
            uvp = np.concatenate([np.stack([u[sel], v[sel]], -1),
                                  np.zeros((pad, 2))]).astype(np.float32)
            descp = np.concatenate([mp.pt_desc[pts[sel]], np.zeros((pad, 8), np.int32)])
            predp = np.concatenate([pred[:len(sel)], np.zeros(pad, np.int32)])
            pv = np.arange(SEARCH_CAP) < len(sel)
            res = M.search_by_projection(
                self._dev(uvp), self._dev(predp),
                torch.full((SEARCH_CAP,), 7.5, device=self.device),
                self._dev(descp), self._dev(pv),
                self._dev(mp.kf_xy[dst_kf]), self._dev(mp.kf_octave[dst_kf]),
                self._dev(mp.kf_desc[dst_kf]),
                self._dev(mp.kf_feat_valid[dst_kf] & ~skip_dst), self._sf_dev,
                max_dist=M.TH_HIGH, ratio=None, level_window=(-1, 0))
            midx = res.idx.cpu().numpy()[:len(sel)]
            got = midx >= 0
            return feats[sel[got]], midx[got].astype(np.int64)

        skip1 = np.zeros(mp.kf_pt.shape[1], bool)
        skip2 = np.zeros(mp.kf_pt.shape[1], bool)
        skip1[i1] = True
        skip2[i2] = True
        # direction 1->2 projects kf's points through S21 into kc; 2->1
        # projects kc's points through S12 into kf
        s21 = 1.0 / s12
        R21 = R12.T
        t21 = -s21 * (R12.T @ t12)
        a1, a2 = project_and_match(kf, kc, s21, R21, t21, skip1, skip2)
        b2, b1 = project_and_match(kc, kf, s12, R12, t12, skip2, skip1)
        # mutual agreement (:1520-1540)
        fwd = {int(x): int(y) for x, y in zip(a1, a2)}
        extra1, extra2 = [], []
        for f2, f1 in zip(b2, b1):
            if fwd.get(int(f1), -1) == int(f2):
                extra1.append(int(f1))
                extra2.append(int(f2))
        if not extra1:
            return i1, i2
        return (np.concatenate([i1, np.asarray(extra1, i1.dtype)]),
                np.concatenate([i2, np.asarray(extra2, i2.dtype)]))

    def _loop_points(self, kc: int) -> np.ndarray:
        mp = self.map
        region = [kc] + [int(x) for x in mp.covisible_kfs(kc, 10)]
        pts = np.unique(mp.kf_pt[region])
        pts = pts[pts >= 0]
        return pts[mp.pt_valid[pts]]

    def _loop_support(self, kf: int, kc: int, s12, R12, t12) -> int:
        """Project loop-region points into kf via the corrected similarity
        and count matches (ORBmatcher::SearchByProjection(Scw), + :474-499)."""
        mp = self.map
        cam = self.cfg.camera
        pts = self._loop_points(kc)
        if len(pts) == 0:
            return 0
        # corrected camera-from-world similarity: S_cw = S12 ∘ T2w
        T2 = mp.kf_pose[kc]
        Xc2 = mp.pt_xyz[pts] @ T2[:, :3].T + T2[:, 3]
        Xc1 = s12 * (Xc2 @ R12.T) + t12
        z = Xc1[:, 2]
        u = cam.fx * Xc1[:, 0] / np.maximum(z, 1e-6) + cam.cx
        v = cam.fy * Xc1[:, 1] / np.maximum(z, 1e-6) + cam.cy
        ok = (z > 0.1) & (u >= 0) & (u < cam.width) & (v >= 0) & (v < cam.height)
        if ok.sum() == 0:
            return 0
        # scale-aware search (SearchByProjection(Scw), src/ORBmatcher.cpp:
        # 370-497): predict the pyramid level from the world-space distance
        # to the SE3-demoted corrected camera center (PredictScale,
        # src/MapPoint.cpp:489-530), then gate at [pred-1, pred]
        S_R = R12 @ T2[:, :3]
        t_dem = (s12 * (R12 @ T2[:, 3]) + t12) / s12
        Ow = -S_R.T @ t_dem
        dist_w = np.linalg.norm(mp.pt_xyz[pts] - Ow[None], axis=-1)
        log_scale = float(np.log(self.cfg.orb.scale_factor))
        ratio = np.maximum(mp.pt_max_dist[pts], 1e-9) / np.maximum(dist_w, 1e-9)
        pred = np.ceil(np.log(ratio) / log_scale).astype(np.int32)
        pred = np.clip(pred, 0, self.cfg.orb.n_levels - 1)
        # scale-band gate as in the frustum check (:409-418)
        band = (dist_w >= 0.8 * mp.pt_min_dist[pts]) & \
               (dist_w <= 1.2 * mp.pt_max_dist[pts])
        ok = ok & band
        if ok.sum() == 0:
            return 0
        cap = self.cfg.local_points_cap
        sel = np.flatnonzero(ok)[:cap]
        pad = cap - len(sel)
        uv = np.concatenate([np.stack([u[sel], v[sel]], -1),
                             np.zeros((pad, 2))]).astype(np.float32)
        desc = np.concatenate([mp.pt_desc[pts[sel]], np.zeros((pad, 8), np.int32)])
        pvalid = np.arange(cap) < len(sel)
        pred_pad = np.concatenate([pred[sel], np.zeros(pad, np.int32)])
        res = M.search_by_projection(
            self._dev(uv), self._dev(pred_pad),
            torch.full((cap,), 10.0, device=self.device), self._dev(desc),
            self._dev(pvalid), self._dev(mp.kf_xy[kf]), self._dev(mp.kf_octave[kf]),
            self._dev(mp.kf_desc[kf]), self._dev(mp.kf_feat_valid[kf]), self._sf_dev,
            max_dist=M.TH_LOW, ratio=None, level_window=(-1, 0))
        midx = res.idx.cpu().numpy()[:len(sel)]
        self._support_matches = (pts[sel], midx)
        return int((midx >= 0).sum())

    # ------------------------------------------------------------- correction
    def _correct_loop(self, kf: int, kc: int, s12, R12, t12):
        """CorrectLoop (src/LoopClosing.cpp:512-810)."""
        t0 = time.perf_counter()
        mp = self.map
        # a running GBA operates on pre-loop geometry: abort it now
        # (src/LoopClosing.cpp:521-535); a fresh one launches below
        if self.global_ba.running:
            self.global_ba.request_abort()
        pre_pose = mp.kf_pose.copy()
        group = [kf] + [int(x) for x in mp.covisible_kfs(kf)]

        # corrected Sim3 of kf: S_cw = S12 ∘ T2w(kc)  (:548-557)
        T2 = pre_pose[kc]
        S_R = R12 @ T2[:, :3]
        S_t = s12 * (R12 @ T2[:, 3]) + t12
        S_s = s12

        # propagate to covisible group via their relative SE3 to kf (:557-596)
        corrected = {}
        T1_inv = se3_np.inverse(pre_pose[kf])
        for g in group:
            T_rel = se3_np.compose(pre_pose[g], T1_inv)  # T_g_kf
            # Sim3 compose: (1, T_rel) ∘ (S_s, S_R, S_t)
            cg_R = T_rel[:, :3] @ S_R
            cg_t = (T_rel[:, :3] @ S_t) + T_rel[:, 3]
            corrected[g] = (S_s, cg_R, cg_t)

        # remap the group's points: p' = S_corr^-1 (S_old p) (:598-632)
        moved = set()
        for g in group:
            pts = mp.kf_pt[g]
            pts = np.unique(pts[pts >= 0])
            pts = pts[mp.pt_valid[pts]]
            pts = np.array([p for p in pts if p not in moved], np.int64)
            if len(pts) == 0:
                continue
            s_c, R_c, t_c = corrected[g]
            T_old = pre_pose[g]
            Xc = mp.pt_xyz[pts] @ T_old[:, :3].T + T_old[:, 3]  # old cam coords
            # inverse of corrected Sim3: x_w = (1/s) R^T (x_c - t)
            Xw = ((Xc - t_c) @ R_c) / s_c
            mp.pt_xyz[pts] = Xw.astype(np.float32)
            mp.mark_points_dirty(pts)  # direct geometry write
            moved.update(int(p) for p in pts)

        # write corrected SE3 poses (t / s demotion, :634-645)
        for g, (s_c, R_c, t_c) in corrected.items():
            mp.kf_pose[g] = np.hstack([R_c, (t_c / s_c)[:, None]]).astype(np.float32)

        # loop-point fusion (:653-680): replace kf's matched points by the
        # established loop points
        if self._support_matches is not None:
            loop_pts, feat_idx = self._support_matches
            for p, f_i in zip(loop_pts, feat_idx):
                if f_i < 0:
                    continue
                existing = int(mp.kf_pt[kf, f_i])
                if existing >= 0 and existing != int(p) and mp.pt_valid[existing]:
                    mp.replace_point(existing, int(p))
                elif existing < 0:
                    mp.kf_pt[kf, f_i] = int(p)

        # group-wide SearchAndFuse (:744-789): project the loop-region
        # points into EVERY corrected keyframe and merge duplicates — this
        # is what creates the cross-loop covisibility links the essential
        # graph then leans on. Snapshot each member's neighbours first so
        # the NEW links can be diffed out (LoopConnections, :684-711).
        prev_neigh = {g: set(int(x) for x in mp.covisible_kfs(g)) for g in group}
        t_fuse = time.perf_counter()
        self.n_loop_fused = self._search_and_fuse(group, kc)
        fuse_ms = (time.perf_counter() - t_fuse) * 1e3
        group_set = set(group)
        loop_connections: set[tuple[int, int]] = set()
        for g in group:
            now = set(int(x) for x in mp.covisible_kfs(g))
            for n in now - prev_neigh[g] - group_set:
                loop_connections.add((g, int(n)))

        # essential-graph optimization (:715; src/Optimizer.cpp:944) — the
        # new cross-loop links enter with corrected-pose measurements
        t_pgo = time.perf_counter()
        self._optimize_essential_graph(kf, kc, pre_pose, loop_connections)
        pgo_ms = (time.perf_counter() - t_pgo) * 1e3
        self.loop_edges.append((kf, kc))

        # global BA (RunGlobalBundleAdjustment :811) on a worker thread on a
        # map snapshot, abortable between chunks: a second loop arriving
        # mid-solve aborts it (the reference's mbStopGBA, :521-542) and
        # relaunches after its own correction
        self.global_ba.launch(fixed_kf=kc)
        total = (time.perf_counter() - t0) * 1e3
        self._correct_ms = dict(total=total, correct=total - fuse_ms - pgo_ms,
                                fuse=fuse_ms, pgo=pgo_ms)

    def _search_and_fuse(self, group: list[int], kc: int) -> int:
        """LoopClosing::SearchAndFuse (src/LoopClosing.cpp:744-789): project
        the loop-region points into every corrected group keyframe (one
        device call, engine_keyframe.fuse_scw) and merge: an existing
        conflicting point is REPLACED by the loop point (the loop side is
        the older, better-constrained geometry); an empty feature adopts
        the loop point as a new observation. Returns the number of
        replacements and additions applied."""
        mp = self.map
        cam = self.cfg.camera
        pts = self._loop_points(kc)
        if len(pts) == 0:
            return 0
        cap = self.cfg.local_points_cap
        pts = pts[:cap]
        pad = cap - len(pts)
        lp = np.concatenate([pts, np.zeros(pad, pts.dtype)])
        pv = np.arange(cap) < len(pts)
        G = FUSE_GROUP  # strongest-covisibility-first group bucket
        grp = np.asarray((group + [group[0]] * G)[:G], np.int64)
        g_live = np.arange(G) < min(len(group), G)
        idx = EK.fuse_scw(
            self._dev(mp.kf_pose[grp]), self._dev(mp.kf_xy[grp]),
            self._dev(mp.kf_octave[grp]), self._dev(mp.kf_desc[grp]),
            self._dev(mp.kf_feat_valid[grp] & g_live[:, None]),
            self._dev(mp.kf_ur[grp]),
            self._dev(mp.pt_xyz[lp]), self._dev(pv), self._dev(mp.pt_desc[lp]),
            self._dev(mp.pt_normal[lp]), self._dev(mp.pt_min_dist[lp]),
            self._dev(mp.pt_max_dist[lp]), self._sf_dev,
            cam.fx, cam.fy, cam.cx, cam.cy, cam.bf, cam.width, cam.height,
            self.cfg.orb.n_levels, float(np.log(self.cfg.orb.scale_factor))
        ).cpu().numpy()
        n_applied = 0
        touched: list[int] = []
        for j in range(min(len(group), G)):
            g = int(grp[j])
            lp_res = mp.resolve_point_ids(lp)
            for s in np.flatnonzero(idx[j] >= 0):
                p = int(lp_res[s])
                if p < 0 or not mp.pt_valid[p]:
                    continue
                feat = int(idx[j, s])
                existing = int(mp.kf_pt[g, feat])
                if existing == p:
                    continue
                if existing >= 0 and mp.pt_valid[existing]:
                    # the loop point wins (src/LoopClosing.cpp:780-787)
                    mp.replace_point(existing, p)
                else:
                    mp.kf_pt[g, feat] = p
                touched.append(p)
                n_applied += 1
        if touched:
            mp.refresh_point_stats(np.unique(touched))
        return n_applied

    def _optimize_essential_graph(self, kf: int, kc: int, pre_pose,
                                  loop_connections=None):
        mp = self.map
        K = mp.kf_pose.shape[0]
        valid = mp.kf_valid.copy()
        ids = np.flatnonzero(valid)
        # edges: spanning tree + strong covisibility (>=100) + loop edges +
        # the post-fuse NEW cross-loop links (LoopConnections) — one full
        # covisibility-matrix pass (native kernel)
        loop_conn = {(min(int(a), int(b)), max(int(a), int(b)))
                     for (a, b) in (loop_connections or ())}
        e_set = set()
        for k in ids:
            p = mp.kf_parent[k]
            if p >= 0 and valid[p]:
                e_set.add((int(k), int(p)))
        W = mp.covis_matrix()
        for a, b in zip(*np.where(np.triu(W, 1) >= 100)):
            e_set.add((int(a), int(b)))
        for (a, b) in self.loop_edges + [(kf, kc)]:
            if valid[a] and valid[b]:
                e_set.add((int(a), int(b)))
        for (a, b) in loop_conn:
            if valid[a] and valid[b]:
                e_set.add((a, b))
        edges = sorted(e_set)
        if not edges:
            return
        self.last_pgo_edges = {
            "n_edges": len(edges),
            "n_loop_conn": sum(1 for (a, b) in edges
                               if (min(a, b), max(a, b)) in loop_conn),
        }
        e_i = np.array([a for a, b in edges], np.int64)
        e_j = np.array([b for a, b in edges], np.int64)

        # measurements from pre-correction poses (the drifty odometry),
        # except the new loop edge AND the post-fuse LoopConnections, whose
        # endpoints' relative geometry only exists in the CORRECTED poses
        # (the reference computes them from CorrectedSim3,
        # src/Optimizer.cpp:977-1043)
        mR, mt = [], []
        for (a, b) in edges:
            corrected = ((a, b) == (kf, kc) or (a, b) == (kc, kf)
                         or (min(a, b), max(a, b)) in loop_conn)
            Ta, Tb = (mp.kf_pose[a], mp.kf_pose[b]) if corrected else (
                pre_pose[a], pre_pose[b])
            T_rel = se3_np.compose(Ta, se3_np.inverse(Tb))
            mR.append(T_rel[:, :3])
            mt.append(T_rel[:, 3])

        R = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
        t = np.zeros((K, 3), np.float32)
        R[ids] = mp.kf_pose[ids][:, :, :3]
        t[ids] = mp.kf_pose[ids][:, :, 3]
        fixed = ~valid
        fixed[kc] = True  # the loop keyframe anchors the graph (:1000)

        pre_opt = mp.kf_pose.copy()
        sv2, R2, t2, _ = PG.optimize_pose_graph(
            self._dev(np.ones(K, np.float32)), self._dev(R), self._dev(t),
            self._dev(fixed), self._dev(e_i), self._dev(e_j),
            self._dev(np.ones(len(edges), np.float32)),
            self._dev(np.stack(mR).astype(np.float32)),
            self._dev(np.stack(mt).astype(np.float32)),
            self._dev(np.ones(len(edges), bool)), iters=20)
        sv2, R2, t2 = sv2.cpu().numpy(), R2.cpu().numpy(), t2.cpu().numpy()

        # write back SE3-demoted poses and remap points via their ref KF
        # (:1190-1260): p' = S_new^-1 ( S_old p )
        pt_ids = np.flatnonzero(mp.pt_valid)
        ref = mp.pt_ref_kf[pt_ids]
        ref = np.where((ref >= 0) & mp.kf_valid[np.clip(ref, 0, None)], ref, kf)
        for k in ids:
            m = pt_ids[ref == k]
            if len(m):
                T_old = pre_opt[k]
                Xc = mp.pt_xyz[m] @ T_old[:, :3].T + T_old[:, 3]
                Xw = ((Xc - t2[k]) @ R2[k]) / sv2[k]
                mp.pt_xyz[m] = Xw.astype(np.float32)
            mp.kf_pose[k] = np.hstack([R2[k], (t2[k] / sv2[k])[:, None]]).astype(np.float32)
        mp.refresh_point_stats(pt_ids)
