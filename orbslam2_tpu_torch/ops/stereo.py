"""Stereo keypoint matching.

Counterpart of orbslam2_tpu/ops/stereo.py `stereo_match`
(Frame::ComputeStereoMatches, src/Frame.cpp:551-770): the whole left-to-right
association is one dense candidate mask and one fused Hamming best-match
(ops/matching.hamming_best_match, so the [N, N] distances are never
written), under the reference's gates:

- row band: |v_L - v_R| <= 2 * scale(octave_R) (src/Frame.cpp:574-589)
- octave window: octave_R in [octave_L - 1, octave_L + 1] (:628)
- disparity in (0.1, fx], that is depth >= baseline (:591-595)
- Hamming <= TH_HIGH, then the median trim 1.5 * 1.4 * median (:754-769),
  applied to the Hamming distance.

Nothing is read back from the device: it runs inside the fused frame
(engine_step._frame_core). The sub-pixel SAD refinement of the JAX package
(`refine_disparity`) is superseded there and not ported.
"""
from __future__ import annotations

import torch

from . import matching as M


def _median_or(values: torch.Tensor, mask: torch.Tensor, empty: float) -> torch.Tensor:
    """Median of values[mask] as jnp.nanmedian gives it (an even count
    averages the two middle values; torch.nanmedian would return the lower
    one), `empty` where the mask is empty. Sort with the unmasked pushed to
    the end, then index the two middle ones from the masked count."""
    n = mask.sum()
    s = torch.sort(torch.where(mask, values, torch.inf)).values
    lo = torch.div(n - 1, 2, rounding_mode="floor").clamp(min=0)
    hi = torch.div(n, 2, rounding_mode="floor").clamp(max=values.shape[0] - 1)
    # gather, not s[lo]: indexing with a 0-d tensor reads it back to the host
    mid = s.gather(0, torch.stack([lo, hi]))
    return torch.where(n > 0, 0.5 * (mid[0] + mid[1]), empty)


def stereo_match(l_xy, l_oct, l_desc, l_valid, r_xy, r_oct, r_desc, r_valid,
                 scale_factors, bf: float, fx: float):
    """Associate left keypoints with right keypoints along epipolar rows.

    Inputs are level-0 (rectified) coordinates. Returns (ur [N], depth [N]),
    -1 where unmatched."""
    sf = scale_factors
    dv = (l_xy[:, None, 1] - r_xy[None, :, 1]).abs()
    band = 2.0 * sf[r_oct.clamp(0, sf.shape[0] - 1).long()]
    row_ok = dv <= band[None, :]
    d_oct = l_oct[:, None] - r_oct[None, :]
    oct_ok = (d_oct >= -1) & (d_oct <= 1)
    disp = l_xy[:, None, 0] - r_xy[None, :, 0]
    disp_ok = (disp > 0.1) & (disp <= fx)
    cand = row_ok & oct_ok & disp_ok & l_valid[:, None] & r_valid[None, :]

    res = M.hamming_best_match(l_desc, r_desc, cand, M.TH_HIGH, ratio=None)

    matched = res.valid
    r_x = r_xy[res.idx.clamp(min=0).long(), 0]
    best_disp = torch.where(matched, l_xy[:, 0] - r_x, -1.0)
    # median-based trim of weak matches
    dist = res.dist.to(torch.float32)
    med = _median_or(dist, matched, float(M.TH_HIGH))
    keep = matched & (dist <= (1.5 * 1.4) * med) & (best_disp > 0.1)

    depth = torch.where(keep, bf / best_disp.clamp(min=1e-6), -1.0)
    ur = torch.where(keep, r_x, -1.0)
    return ur, depth
