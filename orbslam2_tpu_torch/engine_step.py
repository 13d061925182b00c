"""The fused per-frame tracking step.

Counterpart of orbslam2_tpu/engine_step.py. Four entry points:

- `tracking_step`: the minimal step (extract -> project+match -> pose LM).
- `track_frame_full`: the per-frame hot path of the reference's Track()
  (src/Tracking.cpp:320-628, OK branch) as one function on device tensors:
  extraction + undistortion + depth association, motion-model search with
  the 2x widening retry, feature-metric LK refinement, pose LM, the
  frustum-gated local-map search, a second refinement, a second pose LM.
- `track_frames_block`: K frames in a row, the pose/velocity recurrence
  and the binding chain carried from one `_frame_core` to the next as
  tensors (the block driver, tracking.Tracker.run_blocked).
- `mono_init_step`: one monocular-initialization attempt (extraction at the
  doubled budget, the windowed init match, refinement, the two-view RANSAC).

Nothing in `_frame_core` or `track_frames_block` reads a device value
back: every data-dependent choice is a `torch.where`, so a block costs one
readback of its outputs (and can later be captured in a CUDA graph). The
host keeps the bookkeeping: keyframe decisions, map updates, state
transitions.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .config import OrbParams
from .frontend import matcher as FM
from .geometry import camera as cam_mod
from .ops import features as F
from .ops import matching as M
from .ops import pose_opt as PO
from .ops import refine as RF
from .ops import stereo as ST
from .ops import twoview as TV


def _scatter_drop(n: int, tgt: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """out[tgt[i]] = values[i] into a [n] int32 buffer of -1, where tgt == n
    means "drop" (JAX's `.at[t].set(v, mode="drop")` with t out of range):
    the scatter goes into an [n + 1] buffer whose last row is discarded.
    Targets below n are unique (one claimant per keypoint); only the dropped
    row receives duplicates."""
    buf = torch.full((n + 1,), -1, dtype=torch.int32, device=tgt.device)
    buf.scatter_(0, tgt.long(), values.to(torch.int32))
    return buf[:n]


def tracking_step(img, T_pred, pts_xyz, pt_desc, pt_octave, pt_valid,
                  scale_factors, sigma2,
                  params: OrbParams, height: int, width: int,
                  fx: float, fy: float, cx: float, cy: float, bf: float):
    """One tracked frame: extract -> project+match -> pose-only LM.

    Returns (T_new [3,4], n_inliers, features)."""
    feats = F.extract_orb(img, params, height, width)

    R, t = T_pred[:, :3], T_pred[:, 3]
    pc = pts_xyz @ R.T + t
    z = pc[:, 2]
    ok = pt_valid & (z > 0.1)
    zc = torch.clamp(z, min=1e-6)
    uv = torch.stack([fx * pc[:, 0] / zc + cx, fy * pc[:, 1] / zc + cy], -1)
    res = M.search_by_projection(
        uv, pt_octave, torch.full_like(z, 15.0), pt_desc, ok,
        feats.xy, feats.octave, feats.desc, feats.valid, scale_factors,
        max_dist=M.TH_HIGH, ratio=0.9, level_window=(-1, 1))
    res = M.resolve_duplicate_targets(res, feats.xy.shape[0])

    # scatter matches into per-keypoint observation slots
    n_kp = feats.xy.shape[0]
    target = torch.where(res.valid, res.idx, n_kp)
    src = torch.arange(pts_xyz.shape[0], dtype=torch.int32, device=img.device)
    kp_pt = _scatter_drop(n_kp, target, src)
    matched = kp_pt >= 0
    obs = torch.cat([feats.xy, feats.xy.new_zeros((n_kp, 1))], -1)
    info = 1.0 / sigma2[feats.octave.clamp(0, sigma2.shape[0] - 1).long()]
    opt = PO.pose_optimize(
        T_pred, pts_xyz[kp_pt.clamp(min=0).long()], obs,
        torch.zeros_like(matched), info, matched & feats.valid,
        fx, fy, cx, cy, bf)
    return opt.T, opt.n_inliers, feats


class TrackFrameOut(NamedTuple):
    """Result of track_frame_full, packed into few tensors so the host reads
    a frame back in one go.

    hdr  [32] f32: T1 (rows flattened, 12), T2 (12), n_cand, n_mm,
                   n_inl1_map, n_inl2_map (counts are exact in f32), pad
    fmat [N,11] f32: xy(2) xy_raw(2) xy0(2) ur ur0 depth angle response
    imat [N,5] i32: octave, kp_mm_row, kp_src, refined, valid
    desc [N,8] i32
    in_frustum [P] bool
    patch [N,15,15] u8 (read back only when the host needs it)
    kp_pt [N] i32 resolved map-point id per keypoint (-1)
    T_out [3,4] final pose (same as hdr[12:24])
    """

    hdr: torch.Tensor
    fmat: torch.Tensor
    imat: torch.Tensor
    desc: torch.Tensor
    in_frustum: torch.Tensor
    patch: torch.Tensor
    kp_pt: torch.Tensor
    T_out: torch.Tensor


def _rgbd_depth(dm, xy_raw, und_x, cam, H: int, W: int):
    """RGB-D depth association (Frame::ComputeStereoFromRGBD,
    src/Frame.cpp:773-800) with bilinear depth at the subpixel keypoint and
    a 3x3 discontinuity gate (frontend/frame.py explains both)."""
    x = torch.clamp(xy_raw[:, 0], 0, W - 1.001)
    y = torch.clamp(xy_raw[:, 1], 0, H - 1.001)
    x0 = x.to(torch.int64)
    y0 = y.to(torch.int64)
    fx_ = x - x0
    fy_ = y - y0
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    flat = dm.reshape(-1)

    def at(yy, xx):
        return flat[yy * W + xx]

    c00, c01 = at(y0, x0), at(y0, x1)
    c10, c11 = at(y1, x0), at(y1, x1)
    d = ((c00 * (1 - fx_) + c01 * fx_) * (1 - fy_)
         + (c10 * (1 - fx_) + c11 * fx_) * fy_)
    xi = torch.clamp(torch.round(x).to(torch.int64), 1, W - 2)
    yi = torch.clamp(torch.round(y).to(torch.int64), 1, H - 2)
    neigh = torch.stack([at(yi + dy, xi + dx)
                         for dy in (-1, 0, 1) for dx in (-1, 0, 1)], -1)
    flat_ok = (neigh.amax(-1) - neigh.amin(-1)) < 0.1 * torch.clamp(d, min=1e-6)
    ok = (c00 > 0) & (c01 > 0) & (c10 > 0) & (c11 > 0) & (d > 0) & flat_ok
    depth = torch.where(ok, d, -1.0)
    ur = torch.where(ok, und_x - cam.bf / torch.clamp(d, min=1e-6), -1.0)
    return depth, ur


def _nearest_rotation(R, iters: int = 4):
    """The orthogonal polar factor of a near-rotation R [3,3] by Newton's
    iteration R <- (R + R^-T) / 2, with R^-T = cof(R) / det(R): the U Vt of
    R's SVD without a decomposition (torch.linalg.svd syncs with the host
    on CUDA). Converges quadratically: a scale error of 1e-3 is below f32
    resolution after 3 steps."""
    for _ in range(iters):
        cof = torch.stack([torch.linalg.cross(R[1], R[2]),
                           torch.linalg.cross(R[2], R[0]),
                           torch.linalg.cross(R[0], R[1])])
        det = torch.dot(R[0], cof[0])
        R = 0.5 * (R + cof / det)
    return R


def _predict_pose(Tl, Tp):
    """Constant-velocity prediction T_pred = (Tl o Tp^-1) o Tl with SO(3)
    projection (f32 scale leakage compounds through the recurrence — see
    se3_np.orthonormalize)."""
    Rl, tl_ = Tl[:, :3], Tl[:, 3]
    Rp, tp_ = Tp[:, :3], Tp[:, 3]
    Rv = Rl @ Rp.T
    tv = tl_ - Rv @ tp_
    Rpred = Rv @ Rl
    tpred = Rv @ tl_ + tv
    return torch.cat([_nearest_rotation(Rpred), tpred[:, None]], dim=1)


def track_frame_full(img, aux, T_pred, T_last,
                     last_pt, last_xy, last_desc, last_octave, last_angle,
                     last_patch, last_valid, last_depth, tmp_enable,
                     m_xyz, m_desc, m_patch, m_normal, m_mind, m_maxd, m_valid,
                     lp_ids, lp_mask, lp_radius_th, sf, sig2,
                     params: OrbParams, cam, sensor: str,
                     close_th: float, depth_factor: float, log_scale: float
                     ) -> TrackFrameOut:
    """One tracked frame, fused (see module docstring).

    aux: depth map [H,W] (rgbd), the right image (stereo), or img (mono,
    ignored). last_*: previous
    frame's per-feature tensors. m_*: the map-point device mirror (the full
    point table, gathered by index). lp_ids/lp_mask: the local-map slice
    (host-selected from covisibility). tmp_enable: bool tensor — include
    temporal VO candidates (localization-only mode, Tracking::UpdateLastFrame).
    T_pred [3,4]: the host's motion-model prediction (track_frames_block
    predicts on the device instead, _predict_pose)."""
    return _frame_core(img, aux, T_pred, T_last, last_pt, last_xy, last_desc,
                       last_octave, last_angle, last_patch, last_valid,
                       last_depth, tmp_enable, m_xyz, m_desc, m_patch,
                       m_normal, m_mind, m_maxd, m_valid, lp_ids, lp_mask,
                       lp_radius_th, sf, sig2, params, cam, sensor, close_th,
                       depth_factor, log_scale)


def _frame_core(img, aux, T_pred, T_last,
                last_pt, last_xy, last_desc, last_octave, last_angle,
                last_patch, last_valid, last_depth, tmp_enable,
                m_xyz, m_desc, m_patch, m_normal, m_mind, m_maxd, m_valid,
                lp_ids, lp_mask, lp_radius_th, sf, sig2,
                params: OrbParams, cam, sensor: str,
                close_th: float, depth_factor: float, log_scale: float
                ) -> TrackFrameOut:
    H, W = cam.height, cam.width
    N = last_pt.shape[0]
    dev = img.device

    def clamp_idx(i, hi=None):
        return i.clamp(0, hi).long()

    # ---- stage 1: extraction + undistortion + depth association ----
    img = img.to(torch.float32)
    aux = aux.to(torch.float32)
    last_patch = last_patch.to(torch.float32)
    feats = F.extract_orb(img, params, H, W)
    xy_und = cam_mod.undistort_pixels(cam, feats.xy)
    if sensor == "rgbd":
        depth, ur = _rgbd_depth(aux * depth_factor, feats.xy, xy_und[:, 0],
                                cam, H, W)
    elif sensor == "stereo":
        feats_r = F.extract_orb(aux, params, H, W)
        ur, depth = ST.stereo_match(
            feats.xy, feats.octave, feats.desc, feats.valid,
            feats_r.xy, feats_r.octave, feats_r.desc, feats_r.valid,
            sf, cam.bf, cam.fx)
    else:  # mono
        depth = torch.full((feats.xy.shape[0],), -1.0, device=dev)
        ur = torch.full((feats.xy.shape[0],), -1.0, device=dev)
    ur0 = ur

    # ---- stage 2: motion-model candidates (rows = last-frame slots) ----
    ptc = clamp_idx(last_pt)
    bound_last = (last_pt >= 0) & m_valid[ptc]
    # temporal VO candidates: unmatched close-depth last-frame features
    # backprojected with the last pose (Tracking::UpdateLastFrame,
    # src/Tracking.cpp:1065-1160; localization-only gate as upstream)
    tmp_sel = (tmp_enable & ~bound_last & last_valid & (last_depth > 0)
               & (last_depth < 2.0 * close_th))
    Rl, tl = T_last[:, :3], T_last[:, 3]
    Xc = cam_mod.backproject(cam, last_xy, last_depth)
    Xw = (Xc - tl[None]) @ Rl  # Xw = Rl^T (Xc - tl)
    mm_xyz = torch.where(bound_last[:, None], m_xyz[ptc], Xw)
    mm_desc = torch.where(bound_last[:, None], m_desc[ptc], last_desc)
    mm_tpl = torch.where(bound_last[:, None, None],
                         m_patch[ptc].to(torch.float32),
                         RF.template_of(last_patch))
    mm_ok = bound_last | tmp_sel
    n_cand = mm_ok.sum()

    th = 7.0 if sensor != "mono" else 15.0
    res_mm, n_mm = FM.motion_model_core(
        T_pred, mm_xyz, mm_ok, mm_desc, last_octave, last_angle,
        xy_und, feats.octave, feats.desc, feats.valid, feats.angle, ur, sf,
        cam.fx, cam.fy, cam.cx, cam.cy, cam.bf, th)

    # keypoint-side binding: kp -> last-frame slot
    slots = torch.arange(N, dtype=torch.int32, device=dev)
    kp_mm = _scatter_drop(N, torch.where(res_mm.idx >= 0, res_mm.idx, N), slots)
    bound0 = kp_mm >= 0

    # ---- stage 3: feature-metric refinement of MM matches ----
    tpl_kp = mm_tpl[clamp_idx(kp_mm)]
    delta, okr = RF.refine_offsets(feats.patch, tpl_kp, bound0 & feats.valid)
    sf_kp = sf[clamp_idx(feats.octave, sf.shape[0] - 1)]
    shift = delta * (sf_kp * okr)[:, None]
    xy_raw1 = feats.xy + shift
    xy1 = torch.where(okr[:, None], cam_mod.undistort_pixels(cam, xy_raw1), xy_und)
    ur = torch.where(okr & (ur >= 0), ur + shift[:, 0], ur)
    refined0 = okr

    # ---- stage 4: pose optimization 1 ----
    info = 1.0 / sig2[clamp_idx(feats.octave, sig2.shape[0] - 1)]
    obs1 = torch.cat([xy1, ur[:, None]], -1)
    valid1 = bound0 & feats.valid
    opt1 = PO.pose_optimize(
        T_pred, mm_xyz[clamp_idx(kp_mm)], obs1, valid1 & (ur >= 0), info,
        valid1, cam.fx, cam.fy, cam.cx, cam.cy, cam.bf)
    inl1 = opt1.inliers
    kp_is_map = bound0 & bound_last[clamp_idx(kp_mm)]
    n_inl1_map = (inl1 & kp_is_map).sum()
    kp_mm = torch.where(valid1 & ~inl1, -1, kp_mm)  # prune outlier bindings
    bound1 = kp_mm >= 0

    # ---- stage 5: local-map candidates + already-bound mask ----
    lpc = clamp_idx(lp_ids)
    lp_ok = lp_mask & m_valid[lpc]
    # a local point is "already matched" if a surviving MM binding carries it
    surv_pt = torch.where(bound1 & bound_last[clamp_idx(kp_mm)],
                          last_pt[clamp_idx(kp_mm)], -1)  # [N] pt id or -1
    already = ((surv_pt[None, :] == lp_ids[:, None])
               & (surv_pt[None, :] >= 0)).any(dim=1)

    res_lp, in_frustum = FM.local_points_core(
        opt1.T, m_xyz[lpc], lp_ok, m_desc[lpc], m_normal[lpc],
        m_mind[lpc], m_maxd[lpc], already,
        xy1, feats.octave, feats.desc, feats.valid & ~bound1, ur, sf,
        cam.fx, cam.fy, cam.cx, cam.cy, cam.bf, W, H,
        params.n_levels, log_scale, lp_radius_th)
    P = lp_ids.shape[0]
    rows = torch.arange(P, dtype=torch.int32, device=dev)
    kp_lp = _scatter_drop(N, torch.where(res_lp.idx >= 0, res_lp.idx, N), rows)
    kp_lp = torch.where(bound1, -1, kp_lp)  # MM bindings win
    bound_lp = kp_lp >= 0

    # ---- stage 6: refinement of the new local-map matches ----
    tpl2 = m_patch[lpc][clamp_idx(kp_lp)].to(torch.float32)
    delta2, ok2 = RF.refine_offsets(feats.patch, tpl2,
                                    bound_lp & ~refined0 & feats.valid)
    shift2 = delta2 * (sf_kp * ok2)[:, None]
    xy_raw2 = xy_raw1 + shift2
    xy2 = torch.where(ok2[:, None], cam_mod.undistort_pixels(cam, xy_raw2), xy1)
    ur = torch.where(ok2 & (ur >= 0), ur + shift2[:, 0], ur)
    refined = refined0 | ok2

    # ---- stage 7: pose optimization 2 over the union of bindings ----
    pts2 = torch.where(bound1[:, None], mm_xyz[clamp_idx(kp_mm)],
                       m_xyz[lpc][clamp_idx(kp_lp)])
    valid2 = (bound1 | bound_lp) & feats.valid
    obs2 = torch.cat([xy2, ur[:, None]], -1)
    opt2 = PO.pose_optimize(
        opt1.T, pts2, obs2, valid2 & (ur >= 0), info, valid2,
        cam.fx, cam.fy, cam.cx, cam.cy, cam.bf)
    inl2 = opt2.inliers
    kp_map2 = (bound1 & bound_last[clamp_idx(kp_mm)]) | bound_lp
    n_inl2_map = (inl2 & kp_map2).sum()
    # final bindings post-prune: a last-frame slot (< N) or N + local row
    kp_src = torch.where(bound1, kp_mm, torch.where(bound_lp, N + kp_lp, -1))
    kp_src = torch.where(valid2 & ~inl2, -1, kp_src)
    # resolved point id per keypoint (temporal VO slots stay -1)
    pt_mm = last_pt[clamp_idx(kp_mm)]
    kp_pt_out = torch.where(
        kp_src < 0, -1,
        torch.where(kp_src < N, pt_mm, lp_ids[clamp_idx(kp_src - N, P - 1)]))

    hdr = torch.cat([
        opt1.T.reshape(-1), opt2.T.reshape(-1),
        torch.stack([n_cand, n_mm, n_inl1_map, n_inl2_map]).to(torch.float32),
        torch.zeros(4, dtype=torch.float32, device=dev)])
    fmat = torch.cat([
        xy2, xy_raw2, xy_und,
        ur[:, None], ur0[:, None], depth[:, None],
        feats.angle[:, None], feats.response[:, None]], dim=1)
    imat = torch.stack([
        feats.octave, kp_mm, kp_src.to(torch.int32),
        refined.to(torch.int32), feats.valid.to(torch.int32)], dim=1)
    return TrackFrameOut(
        hdr=hdr, fmat=fmat, imat=imat, desc=feats.desc,
        in_frustum=in_frustum,
        # u8, as the map stores its windows (MapState.kf_patch); the
        # rounding is part of the result: the next frame's templates see it
        patch=torch.clamp(torch.round(feats.patch), 0, 255).to(torch.uint8),
        kp_pt=kp_pt_out.to(torch.int32), T_out=opt2.T)


def track_frames_block(imgs, auxs, T_last, T_prev,
                       last_pt, last_xy, last_desc, last_octave, last_angle,
                       last_patch, last_valid, last_depth,
                       m_xyz, m_desc, m_patch, m_normal, m_mind, m_maxd,
                       m_valid, lp_ids, lp_mask, sf, sig2,
                       params: OrbParams, cam, sensor: str,
                       close_th: float, depth_factor: float, log_scale: float):
    """K frames tracked in a row (the JAX package's lax.scan of _frame_core).

    The pose/velocity recurrence and the binding chain are carried from
    frame to frame as tensors; the local-map slice (lp_ids) and the point
    mirror are frozen for the block (the host applies map updates between
    blocks, the lag the reference's concurrent LocalMapping has).

    imgs: [K, H, W]; auxs: [K, H, W] depth maps (rgbd), right images
    (stereo) or imgs again (mono). Returns (outs, chain):
    outs is a TrackFrameOut of [K, ...] tensors, chain the tuple of tensors
    the next block takes as (T_last, ..., last_depth). The carried patch
    stays u8."""
    dev = imgs.device
    no_tmp = torch.zeros((), dtype=torch.bool, device=dev)
    chain = (T_last, T_prev, last_pt, last_xy, last_desc, last_octave,
             last_angle, last_patch.to(torch.uint8), last_valid, last_depth)
    outs = []
    for k in range(imgs.shape[0]):
        Tl, Tp, c_pt, c_xy, c_desc, c_oct, c_ang, c_patch, c_valid, c_depth = chain
        out = _frame_core(
            imgs[k], auxs[k], _predict_pose(Tl, Tp), Tl, c_pt, c_xy, c_desc,
            c_oct, c_ang, c_patch, c_valid, c_depth, no_tmp,
            m_xyz, m_desc, m_patch, m_normal, m_mind, m_maxd, m_valid,
            lp_ids, lp_mask, 1.0, sf, sig2,
            params, cam, sensor, close_th, depth_factor, log_scale)
        chain = (out.T_out, Tl, out.kp_pt, out.fmat[:, 0:2], out.desc,
                 out.imat[:, 0], out.fmat[:, 9], out.patch, out.imat[:, 4] != 0,
                 out.fmat[:, 8])
        outs.append(out)
    return TrackFrameOut(*(torch.stack(f) for f in zip(*outs))), chain


class MonoInitOut(NamedTuple):
    """Result of mono_init_step, all on the device.

    hdr [16] f32: n_valid, n_matches, success, n_good, R (rows flattened,
    9), t (3): the only tensor the host reads per attempt; the rest is read
    once, when initialization succeeds.
    idx/good/X/xy2*/ref_ok: per REFERENCE-frame row (the match layout of
    search_for_initialization). fmat/imat/desc/patch: the current frame's
    features in TrackFrameOut's packing, so the host decodes both alike.
    """

    hdr: torch.Tensor
    idx: torch.Tensor      # [N] int32: ref row -> current feature (-1)
    good: torch.Tensor     # [N] bool: triangulated inlier
    X: torch.Tensor        # [N, 3] points in the reference camera's frame
    xy2: torch.Tensor      # [N, 2] refined undistorted position of the match
    xy2_raw: torch.Tensor  # [N, 2] refined raw position
    ref_ok: torch.Tensor   # [N] bool: the match exists and was refined
    fmat: torch.Tensor     # [N, 11] (TrackFrameOut layout; depth, ur = -1)
    imat: torch.Tensor     # [N, 5]
    desc: torch.Tensor     # [N, 8] int32
    patch: torch.Tensor    # [N, 15, 15] u8


def mono_init_step(img, ref_xy, ref_desc, ref_valid, ref_angle, ref_patch, sf,
                   params: OrbParams, cam, *, generator=None, idx_H=None,
                   idx_F=None) -> MonoInitOut:
    """One monocular-initialization attempt (MonocularInitialization,
    src/Tracking.cpp:729-832): extraction, the windowed init match against
    the reference frame, feature-metric refinement of the matched windows
    against the reference frame's templates, and the 200-hypothesis H + F
    two-view RANSAC. The host reads the 16-float header to drive its state
    machine and the large tensors only on success.

    ref_*: the reference frame's feature tensors (chained from ITS
    mono_init_step call, never uploaded again). Without a reference yet the
    caller passes zeros with ref_valid all False: the match count comes back
    0 and the host uses only n_valid. generator / idx_H / idx_F: the minimal
    sets of ops/twoview.initialize_two_view."""
    H, W = cam.height, cam.width
    dev = img.device
    feats = F.extract_orb(img, params, H, W)
    xy_und = cam_mod.undistort_pixels(cam, feats.xy)
    res = M.search_for_initialization(
        ref_xy, ref_desc, ref_valid, ref_angle,
        xy_und, feats.desc, feats.valid, feats.angle)
    idx = res.idx
    m = idx >= 0
    idc = idx.clamp(min=0).long()

    tpl = RF.template_of(ref_patch.to(torch.float32))
    delta, okr = RF.refine_offsets(feats.patch[idc], tpl, m)
    okr = okr & m
    sf_c = sf[feats.octave[idc].clamp(0, sf.shape[0] - 1).long()]
    xy2_raw = feats.xy[idc] + delta * (sf_c * okr)[:, None]
    xy2 = torch.where(okr[:, None], cam_mod.undistort_pixels(cam, xy2_raw),
                      xy_und[idc])
    xy2 = torch.where(m[:, None], xy2, 0.0)

    K3 = torch.tensor([[cam.fx, 0.0, cam.cx], [0.0, cam.fy, cam.cy],
                       [0.0, 0.0, 1.0]], dtype=torch.float32, device=dev)
    tv = TV.initialize_two_view(ref_xy, xy2, m, K3, idx_H=idx_H, idx_F=idx_F,
                                generator=generator)

    hdr = torch.cat([
        torch.stack([feats.valid.sum(), m.sum(), tv.success.sum(),
                     (tv.good & m).sum()]).to(torch.float32),
        tv.R.reshape(-1), tv.t])

    N = feats.xy.shape[0]
    neg1 = torch.full((N, 1), -1.0, dtype=torch.float32, device=dev)
    fmat = torch.cat([
        xy_und, feats.xy, xy_und, neg1, neg1, neg1,
        feats.angle[:, None], feats.response[:, None]], dim=1)
    # the refined flag per CURRENT feature (scattered from the ref rows)
    refined_cur = _scatter_drop(N, torch.where(okr, idx, N), torch.ones_like(idx))
    none = torch.full((N,), -1, dtype=torch.int32, device=dev)
    imat = torch.stack([feats.octave, none, none, refined_cur.clamp(min=0),
                        feats.valid.to(torch.int32)], dim=1)
    return MonoInitOut(
        hdr=hdr, idx=idx, good=tv.good, X=tv.points3d, xy2=xy2,
        xy2_raw=xy2_raw, ref_ok=okr, fmat=fmat, imat=imat, desc=feats.desc,
        patch=torch.clamp(torch.round(feats.patch), 0, 255).to(torch.uint8))
