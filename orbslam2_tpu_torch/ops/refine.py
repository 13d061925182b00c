"""Feature-metric subpixel match refinement (batched inverse-compositional LK).

Counterpart of orbslam2_tpu/ops/refine.py. Every accepted match is
re-measured photometrically: the map point's 11x11 anchor template is
aligned against the observing feature's 15x15 window by 8 iterations of a
2-dof Lucas-Kanade solve, so all observations of a point agree to a small
fraction of a pixel on the same template (the reference refines only stereo
rows, by SAD slides, src/Frame.cpp:662-750).

Sampling is a Catmull-Rom shift-blend: the shift (dx, dy) is one scalar pair
per feature, so cubic interpolation is a per-feature blend of 8 statically
shifted copies of the window along each axis (no data-dependent gathers).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as Fnn

from ..utils.device import constant
from .features import PATCH_WIN, TEMPLATE_WIN

_R_WIN = PATCH_WIN // 2      # 7
_R_TPL = TEMPLATE_WIN // 2   # 5
_N_ITERS = 8
_MAX_SHIFT = float(_R_WIN - _R_TPL)  # 2 px: stay inside the stored window
_N_SHIFT = 8  # taps at j + t for t in -1..6


def _cubic_weights(f):
    """Catmull-Rom kernel weights for taps at offsets [-1, 0, 1, 2] of the
    fractional position f."""
    f2, f3 = f * f, f * f * f
    w0 = -0.5 * f3 + f2 - 0.5 * f
    w1 = 1.5 * f3 - 2.5 * f2 + 1.0
    w2 = -1.5 * f3 + 2.0 * f2 + 0.5 * f
    w3 = 0.5 * f3 - 0.5 * f2
    return w0, w1, w2, w3


@functools.lru_cache(maxsize=1)
def _gauss_weight() -> np.ndarray:
    """Gaussian weighting of the template window (downweights the rim)."""
    r = _R_TPL
    g = np.exp(-0.5 * (np.arange(-r, r + 1) / (0.6 * r)) ** 2)
    w = np.outer(g, g)
    return (w / w.sum()).astype(np.float32)


def template_of(patch: torch.Tensor) -> torch.Tensor:
    """Central 11x11 crop of a 15x15 window: the anchor template."""
    c = _R_WIN - _R_TPL
    return patch[..., c:c + TEMPLATE_WIN, c:c + TEMPLATE_WIN]


def refine_offsets(patches: torch.Tensor, templates: torch.Tensor,
                   valid: torch.Tensor):
    """Align each template to its observation window.

    patches:   [M, 15, 15] — window around the current measurement
    templates: [M, 11, 11] — the point's anchor template
    valid:     [M] bool

    Returns (delta [M, 2] (dx, dy) in the window's level-pixel units, ok [M]).
    Apply as xy_level0 += delta * scale_factor[octave] where ok."""
    dev = patches.device
    M = patches.shape[0]
    patches = patches.to(torch.float32)
    templates = templates.to(torch.float32)
    w = constant("lk_gauss", _gauss_weight, dev)  # [11, 11]

    # bias-corrected template and its gradients (inverse-compositional: the
    # Jacobian and Hessian come from the template and do not change)
    tmean = torch.sum(templates * w[None], dim=(1, 2), keepdim=True)
    T = templates - tmean
    rim = torch.zeros((TEMPLATE_WIN, TEMPLATE_WIN), dtype=torch.float32, device=dev)
    rim[1:-1, 1:-1] = 1.0  # roll wraps at the rim; zero it
    gx = 0.5 * (torch.roll(T, -1, 2) - torch.roll(T, 1, 2)) * rim
    gy = 0.5 * (torch.roll(T, -1, 1) - torch.roll(T, 1, 1)) * rim

    h11 = torch.sum(w * gx * gx, dim=(1, 2))
    h12 = torch.sum(w * gx * gy, dim=(1, 2))
    h22 = torch.sum(w * gy * gy, dim=(1, 2))
    det = h11 * h22 - h12 * h12
    conditioned = det > 1e-4
    inv_det = 1.0 / torch.where(conditioned, det, 1.0)

    c = float(_R_WIN - _R_TPL)
    t_idx = torch.arange(_N_SHIFT, device=dev)
    tap = torch.arange(4, device=dev)

    def shift_weights(d):
        """[M] shift in [-c, c] -> [M, 8] blend weights over the t = -1..6
        statically-shifted copies (tap q sits at copy index s + q)."""
        q = c + d
        s = torch.clamp(torch.floor(q).to(torch.int64), 0, int(2 * c))
        f = torch.clamp(q - s, 0.0, 1.0)
        taps = torch.stack(_cubic_weights(f), -1)  # [M, 4]
        sel = t_idx[None, :, None] == (s[:, None, None] + tap[None, None, :])
        return torch.sum(torch.where(sel, taps[:, None, :], 0.0), -1)

    padx = Fnn.pad(patches, (1, 2), mode="replicate")  # [M, 15, 18]

    def sample(dx, dy):
        """Catmull-Rom sample of each window at the shifted template grid,
        as two separable shift-blend passes."""
        wx = shift_weights(dx)
        wy = shift_weights(dy)
        xout = 0.0
        for t in range(_N_SHIFT):
            xout = xout + wx[:, t, None, None] * padx[:, :, t:t + TEMPLATE_WIN]
        pady = Fnn.pad(xout[:, None], (0, 0, 1, 2), mode="replicate")[:, 0]
        out = 0.0
        for t in range(_N_SHIFT):
            out = out + wy[:, t, None, None] * pady[:, t:t + TEMPLATE_WIN, :]
        return out  # [M, 11, 11]

    zeros = torch.zeros((M,), dtype=torch.float32, device=dev)
    dx, dy = zeros, zeros
    for _ in range(_N_ITERS):
        img = sample(dx, dy)
        imean = torch.sum(img * w[None], dim=(1, 2), keepdim=True)
        resid = (img - imean) - T
        bx = torch.sum(w * gx * resid, dim=(1, 2))
        by = torch.sum(w * gy * resid, dim=(1, 2))
        # solve H d = b; inverse-compositional translation update p <- p - d
        ddx = (h22 * bx - h12 * by) * inv_det
        ddy = (h11 * by - h12 * bx) * inv_det
        dx = torch.clamp(dx - ddx, -_MAX_SHIFT, _MAX_SHIFT)
        dy = torch.clamp(dy - ddy, -_MAX_SHIFT, _MAX_SHIFT)

    # accept: well-conditioned, inside the trust region, and the aligned
    # residual is no worse than the unaligned one
    def ssd(img):
        im = torch.sum(img * w[None], dim=(1, 2), keepdim=True)
        return torch.sum(w * ((img - im) - T) ** 2, dim=(1, 2))

    ok = (valid & conditioned
          & (torch.maximum(dx.abs(), dy.abs()) < _MAX_SHIFT - 1e-3)
          & (ssd(sample(dx, dy)) <= ssd(sample(zeros, zeros))))
    delta = torch.stack([dx, dy], -1)
    return torch.where(ok[:, None], delta, 0.0), ok
