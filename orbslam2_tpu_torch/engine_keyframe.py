"""Per-keyframe mapping device programs.

Counterpart of orbslam2_tpu/engine_keyframe.py. The reference's
LocalMapping::CreateNewMapPoints and SearchInNeighbors
(src/LocalMapping.cpp:298-610, :611-721) loop over covisible neighbours
with per-pair matching, triangulation and fusion. Here each loop is one
function on device tensors with one readback by the caller:

- `map_new_points`: over the K neighbours, epipolar-gated matching
  (frontend/matcher.epipolar_match_core, on the Hamming kernel), LK
  refinement of the neighbour observation against the anchor template
  (ops/refine.refine_offsets), and gated DLT triangulation
  (ops/triangulation.triangulate_gated). The anchor's free-feature mask is
  carried from one neighbour to the next, so a feature consumed by
  neighbour j cannot match again in neighbour j+1: the reference's
  sequential semantics.
- `fuse_targets`: the new keyframe's points projected into each fuse target
  (ORBmatcher::Fuse direction 1), and the union of the targets' points
  projected into the new keyframe (direction 2).
- `fuse_scw`: loop closing's group-wide fusion (LoopClosing::SearchAndFuse,
  src/LoopClosing.cpp:744-789): the loop side's points projected into each
  keyframe of the corrected covisible group.

The host keeps the bookkeeping: slot allocation, observation merges
(local_mapping.py).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .frontend import matcher as FM
from .ops import refine as RF
from .ops import triangulation as TRI


class NewPoints(NamedTuple):
    """map_new_points' result, [K, N] per anchor feature and neighbour."""

    idx: torch.Tensor    # [K,N] int32 matched neighbour feature (-1 none)
    X: torch.Tensor      # [K,N,3] triangulated world point
    ok: torch.Tensor     # [K,N] bool: the point passed every gate
    delta: torch.Tensor  # [K,N,2] LK offset of the matched neighbour feature
    okr: torch.Tensor    # [K,N] bool: the LK offset was accepted


def map_new_points(T1, xy1, oct1, desc1, free1, patch1,
                   Tn, xy2_0, oct2, desc2, free2, patch2, k_valid,
                   sigma2, sf, fx: float, fy: float, cx: float, cy: float,
                   scale_factor: float) -> NewPoints:
    """CreateNewMapPoints over K neighbours.

    T1 [3,4] anchor pose; xy1 [N,2] the anchor's pristine undistorted
    coords (kf_xy0: the anchor observation is reset to the detection, the
    template centre); oct1/desc1/free1/patch1: anchor features. Tn [K,3,4];
    xy2_0/oct2/desc2/free2/patch2: neighbour features [K,N,...]; k_valid [K]
    bool (the host's baseline gate, src/LocalMapping.cpp:349-365).

    The host applies kf_xy[kn, idx] = kf_xy0[kn, idx] + delta * sf[octave]
    where okr."""
    tpl1 = RF.template_of(patch1.to(torch.float32))  # [N,11,11]
    free = free1
    out = []
    for j in range(Tn.shape[0]):
        res = FM.epipolar_match_core(
            T1, Tn[j], xy1, oct1, desc1, free & k_valid[j],
            xy2_0[j], oct2[j], desc2[j], free2[j], sigma2, fx, fy, cx, cy)
        idx = res.idx
        matched = idx >= 0
        m = idx.clamp(min=0).long()
        # refine the neighbour observation against the anchor template
        delta, okr = RF.refine_offsets(patch2[j][m], tpl1, matched)
        okr = okr & matched
        oct2m = oct2[j][m]
        sfj = sf[oct2m.clamp(0, sf.shape[0] - 1).long()]
        xy2m = xy2_0[j][m] + delta * (sfj * okr)[:, None]
        X, ok = TRI.triangulate_gated(
            T1, Tn[j], xy1, xy2m, oct1, oct2m, matched, sigma2, sf,
            fx, fy, cx, cy, scale_factor)
        ok = ok & matched
        free = free & ~ok
        out.append((idx, X, ok, delta, okr))
    return NewPoints(*(torch.stack(f) for f in zip(*out)))


def fuse_targets(T_t, kp_xy_t, kp_oct_t, kp_desc_t, kp_valid_t, kp_ur_t,
                 a_xyz, a_valid, a_desc, a_normal, a_mind, a_maxd,
                 T_kf, kp_xy_k, kp_oct_k, kp_desc_k, kp_valid_k, kp_ur_k,
                 b_xyz, b_valid, b_desc, b_normal, b_mind, b_maxd,
                 sf, fx: float, fy: float, cx: float, cy: float, bf: float,
                 width: int, height: int, n_levels: int, log_scale: float):
    """SearchInNeighbors' fuse, both directions.

    Direction 1: the new keyframe's point set a_* [Pa] projected into each
    of T fuse targets (poses T_t [T,3,4], feature arrays [T,N,...]).
    Direction 2: the union of the targets' points b_* [Pb] projected into
    the new keyframe (T_kf, [N,...] feature arrays). Radius 3, no dedup.

    Returns (idx_a [T,Pa], idx_b [Pb]): matched keypoint per point or -1."""
    def fuse(T, xyz, valid, desc, normal, mind, maxd, kp_xy, kp_oct,
             kp_desc, kp_valid, kp_ur):
        res, _ = FM.local_points_core(
            T, xyz, valid, desc, normal, mind, maxd,
            torch.zeros_like(valid), kp_xy, kp_oct, kp_desc, kp_valid, kp_ur,
            sf, fx, fy, cx, cy, bf, width, height, n_levels, log_scale, 3.0,
            dedup=False)
        return res.idx

    idx_a = torch.stack([
        fuse(T_t[j], a_xyz, a_valid, a_desc, a_normal, a_mind, a_maxd,
             kp_xy_t[j], kp_oct_t[j], kp_desc_t[j], kp_valid_t[j], kp_ur_t[j])
        for j in range(T_t.shape[0])])
    idx_b = fuse(T_kf, b_xyz, b_valid, b_desc, b_normal, b_mind, b_maxd,
                 kp_xy_k, kp_oct_k, kp_desc_k, kp_valid_k, kp_ur_k)
    return idx_a, idx_b


def fuse_scw(T_g, kp_xy_g, kp_oct_g, kp_desc_g, kp_valid_g, kp_ur_g,
             p_xyz, p_valid, p_desc, p_normal, p_mind, p_maxd,
             sf, fx: float, fy: float, cx: float, cy: float, bf: float,
             width: int, height: int, n_levels: int, log_scale: float):
    """Group-wide loop fusion: ORBmatcher::Fuse(Scw) swept over the
    corrected covisible group.

    T_g [G,3,4]: the group's corrected, SE3-demoted poses. Projecting the
    demoted pose is the same as projecting the Scw similarity: the scale
    cancels in the perspective divide, and the distance band uses |p_c|/s,
    which the demoted pose gives directly. kp_* [G,N,...]: the group
    keyframes' feature arrays; p_* [P]: the loop-region point set (padded,
    p_valid mask).

    Returns idx [G,P]: the matched keypoint per (group keyframe, loop
    point), -1 for none. No dedup: several loop points that claim one
    keypoint must all surface, so that the host can merge them (the
    reference's replace). Radius th = 1 (2.5 to 4 px times the scale)."""
    no_already = torch.zeros_like(p_valid)
    return torch.stack([
        FM.local_points_core(
            T_g[j], p_xyz, p_valid, p_desc, p_normal, p_mind, p_maxd, no_already,
            kp_xy_g[j], kp_oct_g[j], kp_desc_g[j], kp_valid_g[j], kp_ur_g[j],
            sf, fx, fy, cx, cy, bf, width, height, n_levels, log_scale, 1.0,
            dedup=False)[0].idx
        for j in range(T_g.shape[0])])
