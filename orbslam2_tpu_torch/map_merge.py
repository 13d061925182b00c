"""Multi-session map merging: align and fuse two independent maps.

Counterpart of orbslam2_tpu/map_merge.py (BASELINE.json configs item 5, a
capability beyond the reference: ORB-SLAM2 is single-session). It reuses
the loop-closing machinery: BoW candidates across the maps, ratio-test
descriptor matching (kernel hamming_best2), the Sim(3) RANSAC of
ops/sim3_solver.py, then a similarity re-basing of the second map into the
first map's world, the keyframes and points appended, their BoW registered
(kernel bow_assign), and the junction fused and refined by the local
mapper. Every kernel launch of a merge is counted under the caller "merge".

The JAX package draws each attempt's RANSAC minimal sets from
jax.random.PRNGKey(77), split once per attempt; the port draws them from a
torch.Generator seeded 77, or takes them from `minimal_sets` (a callable
valid [512] -> [256, 3] indices, called once per attempt in order), through
which tests replay JAX's draws.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import Sensor
from .frontend import matcher as FM
from .loop_closing import SIM3_CAP
from .map.mapstate import MapState
from .ops import features as F
from .ops import sim3_solver as S3
from .ops.cuda_kernels import launches_counted_as
from .utils.device import upload

SEED = 77


def find_cross_map_alignment(sys_a, map_b: MapState, bow_encode, sample: int = 8,
                             minimal_sets=None):
    """Find a Sim(3) aligning map_b's world frame into sys_a's.

    Returns (ok, W) with W = dict(s, R, t, ka, kb, n_inliers):
    p_worldA = s R p_worldB + t, from the keyframe pair (ka of A, kb of B)
    whose RANSAC found it with n_inliers inliers. Every len // sample-th
    keyframe of B is tried against its first 3 relocalization candidates in
    A's database."""
    mp_a = sys_a.map
    cfg = sys_a.cfg
    cam = cfg.camera
    device = sys_a.device
    sigma2 = F.sigma2_per_octave(cfg.orb)
    fix_scale = cfg.sensor != Sensor.MONOCULAR
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)

    def dev(a):
        return upload(np.asarray(a), device)

    kf_bs = map_b.kf_ids
    if len(kf_bs) == 0 or mp_a.n_keyframes == 0:
        return False, None
    step = max(len(kf_bs) // sample, 1)
    for kb in kf_bs[::step]:
        kb = int(kb)
        vec, _ = bow_encode(map_b.kf_desc[kb], map_b.kf_feat_valid[kb])
        cands = sys_a.kf_db.detect_reloc_candidates(vec)
        for ka in cands[:3]:
            ka = int(ka)
            res = FM.match_descriptors_ratio(
                dev(mp_a.kf_desc[ka]), dev(mp_a.kf_pt[ka] >= 0), dev(mp_a.kf_angle[ka]),
                dev(map_b.kf_desc[kb]), dev(map_b.kf_pt[kb] >= 0), dev(map_b.kf_angle[kb]))
            midx = res.idx.cpu().numpy()
            ia = np.flatnonzero(midx >= 0)
            if len(ia) < 20:
                continue
            ib = midx[ia]
            Ta, Tb = mp_a.kf_pose[ka], map_b.kf_pose[kb]
            P1 = mp_a.pt_xyz[mp_a.kf_pt[ka, ia]] @ Ta[:, :3].T + Ta[:, 3]
            P2 = map_b.pt_xyz[map_b.kf_pt[kb, ib]] @ Tb[:, :3].T + Tb[:, 3]
            n = min(len(ia), SIM3_CAP)
            pad = SIM3_CAP - n
            P1p = np.concatenate([P1[:n], np.zeros((pad, 3))]).astype(np.float32)
            P2p = np.concatenate([P2[:n], np.zeros((pad, 3))]).astype(np.float32)
            s1 = np.concatenate([sigma2[np.clip(mp_a.kf_octave[ka, ia[:n]], 0, 7)],
                                 np.ones(pad)]).astype(np.float32)
            s2 = np.concatenate([sigma2[np.clip(map_b.kf_octave[kb, ib[:n]], 0, 7)],
                                 np.ones(pad)]).astype(np.float32)
            vmask = np.arange(SIM3_CAP) < n
            idx = None if minimal_sets is None else dev(np.asarray(minimal_sets(vmask),
                                                                   np.int64))
            sr = S3.sim3_ransac(dev(P1p), dev(P2p), dev(s1), dev(s2), dev(vmask),
                                cam.fx, cam.fy, cam.cx, cam.cy, fix_scale=fix_scale,
                                idx=idx, generator=gen)
            n_inliers = int(sr.n_inliers)
            if n_inliers < 20:
                continue
            s12 = float(sr.s)
            R12, t12 = sr.R.cpu().numpy(), sr.t.cpu().numpy()
            # W_ab = T_a^-1 o S12 o T_b (cam_b -> cam_a lifted to the worlds)
            Ra, ta = Ta[:, :3], Ta[:, 3]
            Rb, tb = Tb[:, :3], Tb[:, 3]
            R_w = Ra.T @ R12 @ Rb
            t_w = Ra.T @ (s12 * (R12 @ tb) + t12 - ta)
            return True, {"s": s12, "R": R_w.astype(np.float32),
                          "t": t_w.astype(np.float32), "ka": ka, "kb": kb,
                          "n_inliers": n_inliers}
    return False, None


def merge_maps(sys_a, map_b: MapState, minimal_sets=None) -> dict | None:
    """Merge map_b into sys_a's map, in place. Returns the alignment used
    (find_cross_map_alignment's W), or None when none was found. B's points
    and keyframes are appended to A in A's world (the keyframes demoted to
    SE(3) at the alignment's scale), every new keyframe registered in A's
    database, its spanning-tree parent remapped (B's root hangs on the
    aligned keyframe of A); then the duplicates around the aligned keyframe
    are fused and its window bundle-adjusted."""
    with launches_counted_as("merge"):
        ok, W = find_cross_map_alignment(sys_a, map_b, sys_a.relocalizer.frame_bow,
                                         minimal_sets=minimal_sets)
        if not ok:
            return None
        mp_a = sys_a.map
        s_w, R_w, t_w = W["s"], W["R"], W["t"]
        with mp_a.lock:
            # B's points in A's world
            b_pts = np.flatnonzero(map_b.pt_valid)
            new_xyz = (s_w * (map_b.pt_xyz[b_pts] @ R_w.T) + t_w).astype(np.float32)
            ids = mp_a.add_points(new_xyz, map_b.pt_desc[b_pts], ref_kf=0, first_kf=0,
                                  patch=map_b.pt_patch[b_pts])
            pt_map = np.full(map_b.pt_valid.shape[0], -1, np.int64)
            pt_map[b_pts] = ids
            # B's keyframes re-based: T'_j = (1, T_j) o W^-1, demoted to SE(3)
            s_inv = 1.0 / s_w
            R_inv = R_w.T
            t_inv = -s_inv * (R_inv @ t_w)
            kf_map = {}
            for kb in map_b.kf_ids:
                kb = int(kb)
                Tb = map_b.kf_pose[kb]
                R_new = Tb[:, :3] @ R_inv
                t_new = (Tb[:, :3] @ t_inv + Tb[:, 3]) / s_inv
                T_new = np.hstack([R_new, t_new[:, None]]).astype(np.float32)
                pt_idx = np.where(map_b.kf_pt[kb] >= 0,
                                  pt_map[np.maximum(map_b.kf_pt[kb], 0)], -1).astype(np.int32)
                ka_new = mp_a.add_keyframe(
                    T_new, map_b.kf_timestamp[kb], int(map_b.kf_frame_id[kb]),
                    map_b.kf_xy[kb], map_b.kf_octave[kb], map_b.kf_angle[kb],
                    map_b.kf_desc[kb], map_b.kf_feat_valid[kb], pt_idx,
                    depth=map_b.kf_depth[kb], ur=map_b.kf_ur[kb],
                    patch=map_b.kf_patch[kb], xy0=map_b.kf_xy0[kb],
                    ur0=map_b.kf_ur0[kb])
                kf_map[kb] = ka_new
                sys_a.local_mapper.register_keyframe(ka_new)
                mp_a.kf_parent[ka_new] = kf_map.get(int(map_b.kf_parent[kb]), W["ka"])
            mp_a.pt_ref_kf[ids] = kf_map.get(int(W["kb"]), W["ka"])
            mp_a.refresh_point_stats(ids)
        # fuse the duplicates around the junction, then refine it jointly
        sys_a.local_mapper.fuse_neighbors(kf_map[W["kb"]])
        sys_a.local_mapper.local_ba(kf_map[W["kb"]])
    return W
