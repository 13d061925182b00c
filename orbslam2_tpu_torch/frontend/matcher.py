"""Per-frame matching functions used by the tracker.

Counterpart of orbslam2_tpu/frontend/matcher.py. Each function fuses one of
the reference's pointer-chasing search loops into a dense masked match on
the CUDA kernels of ops/cuda_kernels.py: `motion_model_core` computes one
Hamming matrix (`hamming_matrix`) and reduces it under two masks; every other
function here builds one mask and calls the fused best / second-best kernel
(`hamming_best2`, through ops/matching.py hamming_best_match):

- `motion_model_core` / `match_motion_model` <- ORBmatcher::SearchByProjection
  (cur, last, th) (src/ORBmatcher.cpp:1564-1721)
- `local_points_core` / `match_local_points` <- Frame::isInFrustum
  (src/Frame.cpp:307-386) fused with ORBmatcher::SearchByProjection
  (F, vpMapPoints, th) (src/ORBmatcher.cpp:63-219)
- `match_descriptors_ratio` <- SearchByBoW (src/ORBmatcher.cpp:220-369)
  without the vocabulary gate, TH_LOW + ratio 0.7 + rotation histogram: the
  tracker's reference-keyframe fallback when no vocabulary is loaded.
- `match_by_bow` <- SearchByBoW with the FeatureVector node gate
  (src/ORBmatcher.cpp:243-299): the reference-keyframe fallback with a
  vocabulary, and the relocalizer's candidate match.
- `epipolar_match_core` <- ORBmatcher::SearchForTriangulation +
  CheckDistEpipolarLine (src/ORBmatcher.cpp:785-994, :135-160): local
  mapping's match between two keyframes' unmatched features.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import matching as M
from ..utils.device import constant


def _project(T, pts_xyz, fx, fy, cx, cy, bf):
    """World points -> (camera points, pixel uv, predicted right-u, 1/z)."""
    R, t = T[:, :3], T[:, 3]
    pc = pts_xyz @ R.T + t
    iz = 1.0 / torch.clamp(pc[:, 2], min=1e-6)
    uv = torch.stack([fx * pc[:, 0] * iz + cx, fy * pc[:, 1] * iz + cy], -1)
    return pc, uv, uv[:, 0] - bf * iz


def motion_model_core(T, pts_xyz, pt_valid, pt_desc, pt_last_octave, pt_angle,
                      kp_xy, kp_octave, kp_desc, kp_valid, kp_angle, kp_ur,
                      scale_factors, fx, fy, cx, cy, bf, radius_th):
    """Motion-model search: project last frame's points with the predicted
    pose and match around the projections (radius th * scale(last octave),
    level window — src/ORBmatcher.cpp:1627-1634), with the stereo right-u
    gate (:1636-1642) and the rotation-histogram check (:1672-1696).

    Computes the Hamming matrix ONCE and evaluates both the base radius and
    the 2x widened retry (src/Tracking.cpp:1192-1196), selecting the widened
    result when the base search finds < 20 matches — the reference's
    sequential retry as a select, with no readback.
    Returns (MatchResult, number of matches)."""
    pc, uv, ur_pred = _project(T, pts_xyz, fx, fy, cx, cy, bf)
    ok = pt_valid & (pc[:, 2] > 0.1)
    sf = scale_factors
    r_base = sf[pt_last_octave.clamp(0, sf.shape[0] - 1).long()] * radius_th
    duv_x = (uv[:, 0:1] - kp_xy[None, :, 0]).abs()
    duv_y = (uv[:, 1:2] - kp_xy[None, :, 1]).abs()
    dur = (ur_pred[:, None] - kp_ur[None, :]).abs()
    lv_ok = (kp_octave[None, :] >= pt_last_octave[:, None] - 1) & (
        kp_octave[None, :] <= pt_last_octave[:, None] + 1)
    base = lv_ok & ok[:, None] & kp_valid[None, :]
    no_right = kp_ur[None, :] < 0
    dist = M.hamming_matrix(pt_desc, kp_desc)

    def at_radius(r):
        rc = r[:, None]
        cand = base & (duv_x <= rc) & (duv_y <= rc) & (no_right | (dur <= rc))
        res = M.masked_best_match(dist, cand, M.TH_HIGH, 0.9)
        rot_ok = M.rotation_consistency(pt_angle, kp_angle, res.idx, res.valid)
        res = M.resolve_duplicate_targets(M._select(rot_ok, res), kp_xy.shape[0])
        return res, (res.idx >= 0).sum()

    res_n, n_n = at_radius(r_base)
    res_w, n_w = at_radius(2.0 * r_base)
    wide = n_n < 20
    res = M.MatchResult(torch.where(wide, res_w.idx, res_n.idx),
                        torch.where(wide, res_w.dist, res_n.dist))
    return res, torch.where(wide, n_w, n_n)


def match_motion_model(T, pts_xyz, pt_valid, pt_desc, pt_last_octave, pt_angle,
                       kp_xy, kp_octave, kp_desc, kp_valid, kp_angle, kp_ur,
                       scale_factors, fx: float, fy: float, cx: float,
                       cy: float, bf: float, radius_th: float):
    """Single-radius motion-model search (the staged fallback's form; the
    fused frame uses motion_model_core's dual-radius form)."""
    pc, uv, ur_pred = _project(T, pts_xyz, fx, fy, cx, cy, bf)
    ok = pt_valid & (pc[:, 2] > 0.1)
    res = M.search_by_projection(
        uv, pt_last_octave, torch.full_like(pc[:, 2], radius_th), pt_desc, ok,
        kp_xy, kp_octave, kp_desc, kp_valid, scale_factors,
        max_dist=M.TH_HIGH, ratio=0.9, level_window=(-1, 1),
        pt_ur=ur_pred, kp_ur=kp_ur)
    rot_ok = M.rotation_consistency(pt_angle, kp_angle, res.idx, res.valid)
    return M.resolve_duplicate_targets(M._select(rot_ok, res), kp_xy.shape[0])


def local_points_core(T, pts_xyz, pt_valid, pt_desc, pt_normal,
                      pt_min_dist, pt_max_dist, already_matched,
                      kp_xy, kp_octave, kp_desc, kp_valid, kp_ur,
                      scale_factors, fx, fy, cx, cy, bf, width, height,
                      n_levels, log_scale, radius_th, dedup: bool = True):
    """Local-map search: frustum filter, view-cos radius, predicted level,
    masked Hamming argmin, one claimant per keypoint. radius_th may be a
    tensor (the lost-state widening is data).

    dedup=False returns every point's best keypoint without the
    one-claimant-per-keypoint reduction: the fuse needs several points that
    claim one keypoint to surface, so the host can merge them
    (ORBmatcher::Fuse, src/ORBmatcher.cpp:1091-1113).

    Returns (MatchResult pt->kp, in_frustum mask)."""
    pc, uv, ur_pred = _project(T, pts_xyz, fx, fy, cx, cy, bf)
    R, t = T[:, :3], T[:, 3]
    z_ok = pc[:, 2] > 0.1
    in_img = (uv[:, 0] >= 0) & (uv[:, 0] < width) & (uv[:, 1] >= 0) & (uv[:, 1] < height)
    Ow = -R.T @ t
    po = pts_xyz - Ow[None]
    dist = torch.linalg.vector_norm(po, dim=-1)
    band = (dist >= 0.8 * pt_min_dist) & (dist <= 1.2 * pt_max_dist)
    viewcos = torch.sum(po * pt_normal, dim=-1) / torch.clamp(dist, min=1e-9)
    in_frustum = pt_valid & z_ok & in_img & band & (viewcos > 0.5)

    # predicted level (MapPoint::PredictScale, src/MapPoint.cpp:489-530)
    ratio = torch.clamp(pt_max_dist, min=1e-9) / torch.clamp(dist, min=1e-9)
    pred = torch.ceil(torch.log(ratio) / log_scale).to(torch.int32)
    pred = pred.clamp(0, n_levels - 1)

    # view-cos radius (ORBmatcher::RadiusByViewingCos, src/ORBmatcher.cpp:211)
    radius = torch.where(viewcos > 0.998, 2.5, 4.0) * radius_th

    res = M.search_by_projection(
        uv, pred, radius, pt_desc, in_frustum & ~already_matched,
        kp_xy, kp_octave, kp_desc, kp_valid, scale_factors,
        max_dist=M.TH_HIGH, ratio=0.8, level_window=(-1, 0),
        pt_ur=ur_pred, kp_ur=kp_ur)
    if dedup:
        res = M.resolve_duplicate_targets(res, kp_xy.shape[0])
    return res, in_frustum


def match_local_points(T, pts_xyz, pt_valid, pt_desc, pt_normal,
                       pt_min_dist, pt_max_dist, already_matched,
                       kp_xy, kp_octave, kp_desc, kp_valid, kp_ur,
                       scale_factors, fx: float, fy: float, cx: float,
                       cy: float, bf: float, width: int, height: int,
                       n_levels: int, log_scale: float,
                       radius_th: float = 1.0):
    """Frustum-filter local map points and match them into the frame.
    Returns (MatchResult pt->kp, in_frustum mask) — the mask drives
    IncreaseVisible (src/Tracking.cpp:1592-1616)."""
    return local_points_core(
        T, pts_xyz, pt_valid, pt_desc, pt_normal, pt_min_dist, pt_max_dist,
        already_matched, kp_xy, kp_octave, kp_desc, kp_valid, kp_ur,
        scale_factors, fx, fy, cx, cy, bf, width, height, n_levels,
        log_scale, radius_th)


def match_descriptors_ratio(desc_a, valid_a, angle_a, desc_b, valid_b, angle_b):
    """Global ratio-test matching a->b (SearchByBoW's work without the
    vocabulary gate): TH_LOW + ratio 0.7 + rotation histogram."""
    cand = valid_a[:, None] & valid_b[None, :]
    res = M.hamming_best_match(desc_a, desc_b, cand, M.TH_LOW, 0.7)
    ok = M.rotation_consistency(angle_a, angle_b, res.idx, res.valid)
    return M.resolve_duplicate_targets(M._select(ok, res), desc_b.shape[0])


def match_by_bow(desc_a, valid_a, angle_a, node_a,
                 desc_b, valid_b, angle_b, node_b):
    """SearchByBoW with the reference's FeatureVector node gate
    (src/ORBmatcher.cpp:243-299): only descriptors under the SAME depth-2
    vocabulary node are compared. node_a/node_b: [*] int32 gate node per
    feature (-1 = unassigned, never matches). TH_LOW + ratio 0.7 + rotation
    histogram, as the ungated form."""
    same = (node_a[:, None] == node_b[None, :]) & (node_a >= 0)[:, None]
    cand = valid_a[:, None] & valid_b[None, :] & same
    res = M.hamming_best_match(desc_a, desc_b, cand, M.TH_LOW, 0.7)
    ok = M.rotation_consistency(angle_a, angle_b, res.idx, res.valid)
    return M.resolve_duplicate_targets(M._select(ok, res), desc_b.shape[0])


def epipolar_match_core(T1, T2, kp1_xy, kp1_oct, desc1, free1,
                        kp2_xy, kp2_oct, desc2, free2, sigma2_levels,
                        fx, fy, cx, cy):
    """Match keyframe 1's free features to keyframe 2's across the epipolar
    gate: distance to the epipolar line below 3.84 sigma^2 of the octave of
    kp2 (src/ORBmatcher.cpp:158), TH_LOW and ratio 0.75, one claimant per
    keypoint. T1/T2: [3,4] Tcw. Returns kp1 -> kp2 MatchResult."""
    R1, t1 = T1[:, :3], T1[:, 3]
    R2, t2 = T2[:, :3], T2[:, 3]
    # relative pose cam1<-cam2: R12 = R1 R2^T, t12 = -R12 t2 + t1
    R12 = R1 @ R2.T
    t12 = t1 - R12 @ t2
    # fundamental F12 with x1^T F12 x2 = 0 (LocalMapping::ComputeF12,
    # src/LocalMapping.cpp:723-744)
    zero = torch.zeros_like(t12[0])
    tx = torch.stack([torch.stack([zero, -t12[2], t12[1]]),
                      torch.stack([t12[2], zero, -t12[0]]),
                      torch.stack([-t12[1], t12[0], zero])])
    Kinv = constant(("Kinv", fx, fy, cx, cy), lambda: np.linalg.inv(np.array(
        [[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]], np.float32)), T1.device)
    F12 = Kinv.T @ tx @ R12 @ Kinv

    p1 = torch.cat([kp1_xy, torch.ones_like(kp1_xy[:, :1])], -1)
    p2 = torch.cat([kp2_xy, torch.ones_like(kp2_xy[:, :1])], -1)
    # epipolar line in image 2 for each kp1: l2 = F12^T x1
    l2 = p1 @ F12  # [N1, 3]
    num = (l2 @ p2.T).abs()  # [N1, N2]
    den = torch.sqrt(l2[:, 0] ** 2 + l2[:, 1] ** 2)[:, None]
    dsqr = (num / torch.clamp(den, min=1e-9)) ** 2
    sig2 = sigma2_levels[kp2_oct.clamp(0, sigma2_levels.shape[0] - 1).long()]
    epi_ok = dsqr < 3.84 * sig2[None, :]

    cand = epi_ok & free1[:, None] & free2[None, :]
    res = M.hamming_best_match(desc1, desc2, cand, M.TH_LOW, 0.75)
    return M.resolve_duplicate_targets(res, kp2_xy.shape[0])
