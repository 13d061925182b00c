"""Hamming descriptor matching on tensors.

Counterpart of orbslam2_tpu/ops/matching.py (the reference's ORBmatcher,
src/ORBmatcher.cpp): every matcher is a dense candidate mask [A, B], the
best and second-best Hamming distance of each row under it, and the
reference's gating rules on the resulting [A] vectors:

- DescriptorDistance (:1901)      -> the CUDA kernels of ops/cuda_kernels.py.
  `hamming_best_match` (search_by_projection and search_for_initialization
  here; ops/stereo.stereo_match; match_descriptors_ratio and
  epipolar_match_core in frontend/matcher.py) runs on the fused kernel
  `hamming_best2`: the [A, B] distances are never written. Only
  frontend/matcher.py motion_model_core takes the matrix itself
  (`hamming_matrix`) and reduces it twice, under two masks, with
  `masked_best_match`.
- TH_HIGH=100 / TH_LOW=50 / HISTO_LENGTH=30 constants (:37-39)
- nn-ratio test + rotation-histogram consistency (ComputeThreeMaxima, :1854)
- SearchByProjection (:63, :1564) -> `search_by_projection`
- SearchForInitialization (:499) -> `search_for_initialization`

Nothing here reads a device value back to the host: selections are
`torch.where`, histograms and scatter-mins are scatter ops.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .cuda_kernels import (BIG, hamming_best2, hamming_matrix,  # noqa: F401
                           masked_best2)

TH_HIGH = 100
TH_LOW = 50
HISTO_LENGTH = 30
INIT_WINDOW = 100.0  # search window of the monocular-initialization match, px
_INT32_MAX = 2 ** 31 - 1


class MatchResult(NamedTuple):
    idx: torch.Tensor    # [A] int32 index into B, -1 if unmatched
    dist: torch.Tensor   # [A] int32 Hamming distance (BIG if unmatched)

    @property
    def valid(self) -> torch.Tensor:
        return self.idx >= 0


def _select(ok: torch.Tensor, res: MatchResult) -> MatchResult:
    """Keep the matches where `ok`, unmatch the rest."""
    return MatchResult(torch.where(ok, res.idx, -1), torch.where(ok, res.dist, BIG))


def rotation_consistency(angle_a, angle_b, match_idx, valid):
    """Keep only matches whose orientation difference falls in the 3 dominant
    histogram bins (ORBmatcher::ComputeThreeMaxima, src/ORBmatcher.cpp:1854).

    angle_a: [A]; angle_b: [B]; match_idx: [A] index into B (-1 invalid).
    Returns the updated valid mask [A].

    The histogram is a scatter-add, not torch.bincount: bincount on a CUDA
    tensor reads the input's maximum back to the host to size its output."""
    rot = angle_a - angle_b[match_idx.clamp(min=0).long()]
    binf = rot * (HISTO_LENGTH / (2.0 * math.pi))
    # round half to even (as jnp.round), floor modulo (as jnp.mod)
    bins = torch.remainder(torch.round(binf).to(torch.int64), HISTO_LENGTH)
    hist = torch.zeros(HISTO_LENGTH, dtype=torch.int64, device=bins.device)
    hist = hist.scatter_add(0, bins, valid.to(torch.int64))
    top3 = torch.topk(hist, 3).values  # only the values are used: tie order is moot
    thresh = torch.clamp((0.1 * top3[0].to(torch.float32)).to(torch.int64), min=1)
    keep_count = torch.where(top3 >= thresh, top3, -1)
    in_top = hist[bins][:, None] == keep_count[None, :]
    return valid & in_top.any(dim=-1)


def best_match_gate(idx: torch.Tensor, best: torch.Tensor, second: torch.Tensor,
                    max_dist: int, ratio: float | None) -> MatchResult:
    """Distance gate and optional Lowe ratio test on each row's best column,
    best and second-best distance."""
    ok = best <= max_dist
    if ratio is not None:
        ok = ok & (best.to(torch.float32) < ratio * second.to(torch.float32))
    return MatchResult(torch.where(ok, idx, -1), torch.where(ok, best, BIG))


def masked_best_match(dist: torch.Tensor, cand_mask: torch.Tensor,
                      max_dist: int, ratio: float | None) -> MatchResult:
    """Best + second-best along axis 1 of a given distance matrix with
    candidate mask, distance gate and optional Lowe ratio test. Ties take the
    lowest column (argmin's first index, as jnp.argmin)."""
    return best_match_gate(*masked_best2(dist, cand_mask), max_dist, ratio)


def hamming_best_match(desc_a: torch.Tensor, desc_b: torch.Tensor,
                       cand_mask: torch.Tensor, max_dist: int,
                       ratio: float | None) -> MatchResult:
    """masked_best_match(hamming_matrix(desc_a, desc_b), ...) on the fused
    kernel: the same result without the [A, B] distances in memory."""
    return best_match_gate(*hamming_best2(desc_a, desc_b, cand_mask), max_dist, ratio)


def search_for_initialization(xy_a, desc_a, valid_a, angle_a,
                              xy_b, desc_b, valid_b, angle_b) -> MatchResult:
    """Monocular-initialization windowed matching
    (ORBmatcher::SearchForInitialization, src/ORBmatcher.cpp:499-630): each
    feature of frame a against the features of frame b within +-100 pixels,
    TH_LOW and a 0.9 ratio test, then the rotation histogram."""
    dxy = xy_a[:, None, :] - xy_b[None, :, :]
    in_window = (dxy[..., 0].abs() < INIT_WINDOW) & (dxy[..., 1].abs() < INIT_WINDOW)
    cand = in_window & valid_a[:, None] & valid_b[None, :]
    res = hamming_best_match(desc_a, desc_b, cand, TH_LOW, 0.9)
    return _select(rotation_consistency(angle_a, angle_b, res.idx, res.valid), res)


def search_by_projection(proj_uv, pred_level, radius, pt_desc, pt_valid,
                         kp_xy, kp_octave, kp_desc, kp_valid,
                         scale_factors, max_dist: int = TH_HIGH,
                         ratio: float | None = 0.8,
                         level_window: tuple[int, int] = (-1, 1),
                         pt_ur=None, kp_ur=None) -> MatchResult:
    """Project-and-match: map points (rows) vs frame keypoints (cols).

    proj_uv: [P, 2] projected pixel positions of points (undistorted coords)
    pred_level: [P] predicted octave per point (PredictScale,
        src/MapPoint.cpp:489-530)
    radius: [P] base search radius in level-0 pixels; the effective radius
        is radius * scale(pred_level)
    level_window: keypoint octave must be within [pred+lo, pred+hi]
    pt_ur/kp_ur: predicted vs measured right-u; stereo keypoints must also
        agree in the right image, |pt_ur - kp_ur| <= r_eff
        (src/ORBmatcher.cpp:123-129)

    Returns each point's best keypoint match."""
    sf = scale_factors
    r_eff = radius * sf[pred_level.clamp(0, sf.shape[0] - 1).long()]
    duv = proj_uv[:, None, :] - kp_xy[None, :, :]
    within = (duv[..., 0].abs() <= r_eff[:, None]) & (duv[..., 1].abs() <= r_eff[:, None])
    lv_ok = (kp_octave[None, :] >= pred_level[:, None] + level_window[0]) & (
        kp_octave[None, :] <= pred_level[:, None] + level_window[1])
    cand = within & lv_ok & pt_valid[:, None] & kp_valid[None, :]
    if pt_ur is not None and kp_ur is not None:
        er_ok = (kp_ur[None, :] < 0) | (
            (pt_ur[:, None] - kp_ur[None, :]).abs() <= r_eff[:, None])
        cand = cand & er_ok
    return hamming_best_match(pt_desc, kp_desc, cand, max_dist, ratio)


def resolve_duplicate_targets(res: MatchResult, n_targets: int) -> MatchResult:
    """Ensure each target (keypoint) is claimed by at most one source (point):
    keep the lowest-distance claimant, and among equal distances the lowest
    source index. Two scatter-mins (`scatter_reduce` "amin"; `index_put_`
    with duplicate indices is undefined on CUDA)."""
    tgt = res.idx.clamp(min=0).long()
    dev = res.idx.device
    src = torch.arange(res.idx.shape[0], dtype=torch.int32, device=dev)
    best_per_tgt = torch.full((n_targets,), BIG, dtype=torch.int32, device=dev)
    best_per_tgt = best_per_tgt.scatter_reduce(
        0, tgt, torch.where(res.valid, res.dist, BIG), "amin", include_self=True)
    achieves = res.valid & (res.dist == best_per_tgt[tgt])
    first = torch.full((n_targets,), _INT32_MAX, dtype=torch.int32, device=dev)
    first = first.scatter_reduce(
        0, tgt, torch.where(achieves, src, _INT32_MAX), "amin", include_self=True)
    keep = achieves & (first[tgt] == src)
    return _select(keep, res)
