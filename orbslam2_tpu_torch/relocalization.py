"""Relocalization: recover the camera after tracking loss.

Counterpart of orbslam2_tpu/relocalization.py (Tracking::Relocalization,
src/Tracking.cpp:1800-2028): BoW candidates from the keyframe database ->
per-candidate node-gated descriptor matching -> batched PnP RANSAC -> LM
pose refinement -> projective rescue. ALL database candidates above the
0.75 * best cut are tried, best score first (src/Tracking.cpp:1814-1828
iterates the full set; the loop exits on the first candidate that reaches
the 50-inlier gate).

The path is staged and host-driven: it runs on a lost frame only. Per
candidate it waits for the card three times or more (the match indices, the
PnP inlier count, each pose optimization and rescue), and a `frame_bow`
costs one readback. `Relocalizer.attempts` records what each call of
`relocalize` did.

The vocabulary tables and their children-block table are uploaded once per
vocabulary and device (Vocabulary.device_tables_on, child_blocks_on), when
the relocalizer is built; the copies have finished before the constructor
returns, so the mapper's stream may read them too.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .config import SlamConfig
from .frontend import matcher as FM
from .frontend.frame import Frame
from .io.vocabulary import Vocabulary
from .map.keyframe_db import KeyFrameDatabase
from .map.mapstate import MapState
from .ops import bow as BOW
from .ops import cuda_kernels as CK
from .ops import features as F
from .ops import matching as M
from .ops import pnp as PNP
from .ops import pose_opt as PO
from .utils.device import upload

RESCUE_CAP = 1024  # most points one rescue pass projects


class Relocalizer:
    def __init__(self, cfg: SlamConfig, mp: MapState, voc: Vocabulary,
                 db: KeyFrameDatabase, device: torch.device | str = "cuda"):
        self.cfg = cfg
        self.map = mp
        self.voc = voc
        self.db = db
        self.device = torch.device(device)
        self.sigma2 = F.sigma2_per_octave(cfg.orb)
        self._sf_dev = self._dev(F.scale_factors(cfg.orb))
        # the minimal sets of the PnP RANSAC are drawn from this generator
        self._rng = torch.Generator(device=self.device)
        self._rng.manual_seed(17)
        # tests replay another package's draws: a callable that is given the
        # valid mask of a PnP call and returns its [N_HYPOTHESES, MIN_SET]
        # index array, or None to draw
        self.minimal_sets = None
        # one dict per relocalize() call (see relocalize)
        self.attempts: list[dict] = []
        # uploaded before any thread asks
        voc.device_tables_on(self.device)
        voc.child_blocks_on(self.device)

    def _dev(self, a) -> torch.Tensor:
        return upload(a, self.device)

    def frame_bow_dispatch(self, desc: np.ndarray, valid: np.ndarray):
        """Asynchronous half of frame_bow: start the word assignment on the
        device and return the (words, ok, nodes) tensors without reading
        them. LocalMapper's keyframe prep dispatches this beside its other
        device work, reads both back at once outside the map lock and hands
        the host arrays to frame_bow_finish."""
        nd, nc, nw = self.voc.device_tables_on(self.device)
        return BOW.assign_words(nd, nc, nw, self._dev(desc), self._dev(valid),
                                self.voc.levels,
                                blocks=self.voc.child_blocks_on(self.device))

    def frame_bow_finish(self, words, wvalid, nodes):
        """Host half of frame_bow: the sparse tf-idf vector from the fetched
        word assignments."""
        w = np.asarray(words)[np.asarray(wvalid)]
        uniq, counts = np.unique(w, return_counts=True)
        wt = self.voc.word_weight[uniq] * counts
        s = wt.sum()
        if s > 0:
            wt = wt / s
        return ((uniq.astype(np.int32), wt.astype(np.float32)),
                np.asarray(nodes, np.int32))

    def frame_bow(self, desc: np.ndarray, valid: np.ndarray):
        """Sparse tf-idf BoW of a frame plus per-feature gate nodes.

        Returns ((word_ids, L1-normalized weights), nodes [N]): nodes are
        the depth-2 vocabulary nodes per feature (the reference's
        FeatureVector, which gates SearchByBoW's candidate pairs,
        src/ORBmatcher.cpp:243-299). The device assigns words; the sparse
        vector is built on the host, so memory stays O(words per frame)
        whatever the vocabulary's size. One readback."""
        return self.frame_bow_finish(*self.frame_bow_fetch(
            self.frame_bow_dispatch(desc, valid)))

    @staticmethod
    def frame_bow_fetch(dispatched):
        """The three tensors of frame_bow_dispatch on the host, in one
        readback: (words, ok, nodes) numpy arrays."""
        out = torch.stack([t.to(torch.int32) for t in dispatched]).cpu().numpy()
        return out[0], out[1] != 0, out[2]

    def _next_minimal_sets(self, valid: np.ndarray):
        if self.minimal_sets is None:
            return None
        idx = self.minimal_sets(valid)
        return None if idx is None else self._dev(np.asarray(idx, np.int64))

    def relocalize(self, frame: Frame) -> bool:
        """Try every database candidate; on success the frame carries its
        pose and point bindings. Appends to `attempts` a dict with the
        number of candidates, the ms the call took, whether it succeeded,
        and per candidate tried: keyframe, BoW matches, PnP inliers, inliers
        after the first LM, rescue passes run, bindings and inliers after
        them."""
        t0 = time.perf_counter()
        log = dict(frame_id=frame.frame_id, candidates=0, tried=[], ok=False)
        self.attempts.append(log)
        try:
            with CK.launches_counted_as("reloc"):
                log["ok"] = self._relocalize(frame, log)
        finally:
            log["ms"] = (time.perf_counter() - t0) * 1e3
        return log["ok"]

    def _relocalize(self, frame: Frame, log: dict) -> bool:
        vec, qnodes = self.frame_bow(frame.desc, frame.valid)
        candidates = self.db.detect_reloc_candidates(vec)
        log["candidates"] = len(candidates)
        if len(candidates) == 0:
            return False
        mp = self.map
        cam = self.cfg.camera
        f_desc, f_valid, f_angle, q_nodes = (
            self._dev(a) for a in (frame.desc, frame.valid, frame.angle, qnodes))
        for k in candidates:
            k = int(k)
            tried = dict(kf=k, bow_matches=0, pnp_inliers=0, lm_inliers=0,
                         rescue_passes=0, bound=0, final_inliers=0)
            log["tried"].append(tried)
            has_pt = mp.kf_pt[k] >= 0
            res = FM.match_by_bow(
                self._dev(mp.kf_desc[k]), self._dev(has_pt),
                self._dev(mp.kf_angle[k]), self._dev(mp.kf_bow_node[k]),
                f_desc, f_valid, f_angle, q_nodes)
            midx = res.idx.cpu().numpy()
            src = np.flatnonzero(midx >= 0)
            tried["bow_matches"] = len(src)
            if len(src) < 15:  # src/Tracking.cpp:1862
                continue
            # PnP on the matched subset, padded to the frame's capacity
            N = frame.capacity
            X = np.zeros((N, 3), np.float32)
            uv = np.zeros((N, 2), np.float32)
            sg = np.ones(N, np.float32)
            val = np.zeros(N, bool)
            pts = mp.kf_pt[k, src]
            ok = mp.pt_valid[np.clip(pts, 0, None)] & (pts >= 0)
            tgt = midx[src[ok]]
            X[:len(tgt)] = mp.pt_xyz[pts[ok]]
            uv[:len(tgt)] = frame.xy[tgt]
            sg[:len(tgt)] = self.sigma2[
                np.clip(frame.octave[tgt], 0, len(self.sigma2) - 1)]
            val[:len(tgt)] = True
            if val.sum() < 10:  # also keeps the draw of 4 distinct rows legal
                continue
            pr = PNP.pnp_ransac(
                self._dev(X), self._dev(uv), self._dev(sg), self._dev(val),
                cam.fx, cam.fy, cam.cx, cam.cy,
                idx=self._next_minimal_sets(val), generator=self._rng)
            tried["pnp_inliers"] = int(pr.n_inliers)
            if tried["pnp_inliers"] < 10:
                continue
            # refine with the pose optimizer on the matched set
            frame.pose = pr.T.cpu().numpy()
            frame.pt_idx = np.full(frame.capacity, -1, np.int32)
            frame.pt_idx[tgt] = pts[ok]
            n_inl = self._pose_opt(frame)
            tried["lm_inliers"] = n_inl
            if n_inl < 10:  # src/Tracking.cpp:1898
                continue
            # projective rescue rounds (src/Tracking.cpp:1908-1950): when the
            # BoW matches alone cannot reach the 50-inlier acceptance gate,
            # project the candidate keyframe's remaining points with the
            # estimated pose: a coarse pass (window 10, ORBdist 100),
            # re-optimize, then for marginal results a narrow pass (window
            # 3, ORBdist 64) and a final optimization.
            if n_inl < 50:
                n_add = self._rescue(frame, k, window=10.0, orb_dist=100)
                tried["rescue_passes"] = 1
                if n_inl + n_add >= 50:
                    n_inl = self._pose_opt(frame)
                    if 30 <= n_inl < 50:
                        n_add2 = self._rescue(frame, k, window=3.0, orb_dist=64)
                        tried["rescue_passes"] = 2
                        if n_inl + n_add2 >= 50:
                            n_inl = self._pose_opt(frame)
            tried["bound"] = int((frame.pt_idx >= 0).sum())
            tried["final_inliers"] = n_inl
            if n_inl < 50:  # bMatch gate (src/Tracking.cpp:1958)
                continue
            return True
        return False

    def _pose_opt(self, frame: Frame) -> int:
        """Motion-only pose optimization over the frame's current bindings;
        prunes outlier associations (the PoseOptimization + outlier-erase
        pattern of Tracking::Relocalization, src/Tracking.cpp:1890-1906)."""
        mp = self.map
        cam = self.cfg.camera
        pvalid = (frame.pt_idx >= 0) & mp.pt_valid[np.clip(frame.pt_idx, 0, None)]
        obs = np.concatenate([frame.xy, frame.ur[:, None]], -1).astype(np.float32)
        info = (1.0 / self.sigma2)[np.clip(frame.octave, 0, len(self.sigma2) - 1)]
        opt = PO.pose_optimize(
            self._dev(frame.pose),
            self._dev(mp.pt_xyz[np.clip(frame.pt_idx, 0, None)]),
            self._dev(obs), self._dev((frame.ur >= 0) & pvalid),
            self._dev(info.astype(np.float32)), self._dev(pvalid),
            cam.fx, cam.fy, cam.cx, cam.cy, cam.bf)
        frame.pose = opt.T.cpu().numpy()
        inl = opt.inliers.cpu().numpy()
        frame.pt_idx = np.where(pvalid & ~inl, -1, frame.pt_idx)
        return int((inl & pvalid).sum())

    def _rescue(self, frame: Frame, k: int, window: float, orb_dist: int) -> int:
        """SearchByProjection(CurrentFrame, KF, sAlreadyFound, th, ORBdist)
        (src/ORBmatcher.cpp:1723-1851): project the candidate keyframe's map
        points not yet bound to the frame through the current pose estimate
        and bind window-gated descriptor matches. Returns the number of new
        associations."""
        mp = self.map
        cam = self.cfg.camera
        pts = mp.kf_pt[k]
        pts = np.unique(pts[pts >= 0])
        pts = pts[mp.pt_valid[pts]]
        bound = frame.pt_idx[frame.pt_idx >= 0]
        pts = pts[~np.isin(pts, bound)]
        if len(pts) == 0:
            return 0
        T = frame.pose
        Xc = mp.pt_xyz[pts] @ T[:, :3].T + T[:, 3]
        z = Xc[:, 2]
        u = cam.fx * Xc[:, 0] / np.maximum(z, 1e-6) + cam.cx
        v = cam.fy * Xc[:, 1] / np.maximum(z, 1e-6) + cam.cy
        Ow = -T[:, :3].T @ T[:, 3]
        dist_w = np.linalg.norm(mp.pt_xyz[pts] - Ow[None], axis=-1)
        band = (dist_w >= 0.8 * mp.pt_min_dist[pts]) & \
               (dist_w <= 1.2 * mp.pt_max_dist[pts])
        ok = (z > 0.1) & (u >= 0) & (u < cam.width) & (v >= 0) & \
            (v < cam.height) & band
        sel = np.flatnonzero(ok)
        if len(sel) == 0:
            return 0
        log_scale = float(np.log(self.cfg.orb.scale_factor))
        ratio = np.maximum(mp.pt_max_dist[pts], 1e-9) / np.maximum(dist_w, 1e-9)
        pred = np.clip(np.ceil(np.log(ratio) / log_scale), 0,
                       self.cfg.orb.n_levels - 1).astype(np.int32)
        sel = sel[:RESCUE_CAP]
        pad = RESCUE_CAP - len(sel)
        uvp = np.concatenate([np.stack([u[sel], v[sel]], -1),
                              np.zeros((pad, 2))]).astype(np.float32)
        descp = np.concatenate([mp.pt_desc[pts[sel]], np.zeros((pad, 8), np.int32)])
        predp = np.concatenate([pred[sel], np.zeros(pad, np.int32)])
        pv = np.concatenate([np.ones(len(sel), bool), np.zeros(pad, bool)])
        res = M.search_by_projection(
            self._dev(uvp), self._dev(predp),
            torch.full((RESCUE_CAP,), window, dtype=torch.float32,
                       device=self.device),
            self._dev(descp), self._dev(pv), self._dev(frame.xy),
            self._dev(frame.octave), self._dev(frame.desc),
            self._dev(frame.valid & (frame.pt_idx < 0)), self._sf_dev,
            max_dist=orb_dist, ratio=None, level_window=(-1, 1))
        res = M.resolve_duplicate_targets(res, frame.capacity)
        midx = res.idx.cpu().numpy()[:len(sel)]
        got = np.flatnonzero(midx >= 0)
        n_new = 0
        for i in got:
            kp = int(midx[i])
            if frame.pt_idx[kp] < 0:
                frame.pt_idx[kp] = pts[sel[i]]
                n_new += 1
        return n_new
