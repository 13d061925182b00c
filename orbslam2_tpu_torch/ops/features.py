"""ORB feature extraction over an image pyramid, as batched tensor code.

Counterpart of orbslam2_tpu/ops/features.py `extract_orb` (the reference's
ORBextractor, src/ORBextractor.cpp), with the same algorithm and outputs:

- pyramid: each level is the previous one resized with JAX's antialiased
  bilinear (triangle-kernel) weights, applied as two small weight matrices
  per level; all levels live in one edge-replicated atlas [L, H, W]
- dense FAST-9/16 at two thresholds, 3x3 NMS, and a tiered cell-uniform
  per-level top-k in place of the quadtree (src/ORBextractor.cpp:571)
- Harris 3x3 snap and quadratic subpixel fit on the blurred atlas
- intensity-centroid angle (IC_Angle, :79), rotated 256-pair BRIEF on the
  blurred atlas (computeOrbDescriptor, :113), 15x15 bilinear patches

Descriptors are [N, 8] int32 bit-views of the uint32 words (PyTorch has no
uint32 shifts on the CPU; the bit work is done in int64). Selection ties
resolve to the lower flat index, as `lax.top_k` does.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as Fnn

from ..config import OrbParams
from ..utils.device import constant

HALF_PATCH = 15
PATCH = 31
EDGE_BORDER = 20  # reference EDGE_THRESHOLD=19 (src/ORBextractor.cpp:76)
# Photometric template window per keypoint: a 15x15 window (allows +-2 px LK
# refinement of an 11x11 template, ops/refine.py) sampled at the subpixel
# detection position from the blurred level image.
PATCH_WIN = 15
TEMPLATE_WIN = 11

# FAST-9/16 Bresenham circle of radius 3, (dy, dx), clockwise.
_CIRCLE = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)


def level_sizes(height: int, width: int, n_levels: int, scale: float):
    """Static pyramid level shapes."""
    out = []
    for lv in range(n_levels):
        s = scale ** lv
        out.append((max(8, int(round(height / s))), max(8, int(round(width / s)))))
    return out


def features_per_level(n_features: int, n_levels: int, scale: float):
    """Geometric per-level feature budget (ORBextractor ctor logic,
    src/ORBextractor.cpp:436-452)."""
    inv = 1.0 / scale
    n_first = n_features * (1 - inv) / (1 - inv ** n_levels)
    budgets, total = [], 0
    for lv in range(n_levels - 1):
        b = int(round(n_first * inv ** lv))
        budgets.append(b)
        total += b
    budgets.append(max(n_features - total, 0))
    return budgets


@functools.lru_cache(maxsize=8)
def brief_pattern(seed: int = 7) -> np.ndarray:
    """Deterministic 256-pair BRIEF sampling pattern, shape [256, 4] =
    (ax, ay, bx, by), Gaussian sigma=patch/5, clipped to radius 13 so any
    rotation stays inside the 31x31 patch + border margin. The same seeded
    pattern as the JAX package, so descriptors are interchangeable."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, PATCH / 5.0, size=(256, 4))
    pts = np.clip(pts, -13.0, 13.0)
    for off in (0, 2):
        r = np.sqrt(pts[:, off] ** 2 + pts[:, off + 1] ** 2)
        f = np.where(r > 13.0, 13.0 / r, 1.0)
        pts[:, off] *= f
        pts[:, off + 1] *= f
    return pts.astype(np.float32)


@functools.lru_cache(maxsize=2)
def _ic_angle_masks():
    """Circular mask and coordinate grids for the intensity centroid."""
    ys, xs = np.mgrid[-HALF_PATCH:HALF_PATCH + 1, -HALF_PATCH:HALF_PATCH + 1]
    mask = (xs ** 2 + ys ** 2) <= HALF_PATCH ** 2
    return (mask.astype(np.float32), xs.astype(np.float32), ys.astype(np.float32))


@functools.lru_cache(maxsize=32)
def _resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """[out, in] weights of jax.image.resize(..., "bilinear") along one axis:
    a triangle kernel widened by 1/scale when downsampling (antialiasing),
    columns normalized, in float32 as JAX computes them
    (jax._src.image.scale.compute_weight_mat)."""
    if in_size == out_size:
        return np.eye(out_size, dtype=np.float32)
    inv_scale = np.float32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample_f = ((np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * inv_scale
                - np.float32(0.5))
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=np.float32)[:, None]) \
        / kernel_scale
    w = np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x))
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, 0.0).astype(np.float32).T.copy()


class FrameFeatures(NamedTuple):
    """Fixed-capacity per-frame feature set (include/Frame.h keypoint and
    descriptor members)."""

    xy: torch.Tensor        # [N, 2] float32, level-0 pixel coords (raw image)
    response: torch.Tensor  # [N] float32
    angle: torch.Tensor     # [N] float32 radians
    octave: torch.Tensor    # [N] int32
    desc: torch.Tensor      # [N, 8] int32 bit-views of the uint32 words
    valid: torch.Tensor     # [N] bool
    patch: torch.Tensor     # [N, 15, 15] float32, blurred level-image window
    #                         centered exactly on the subpixel keypoint

    @property
    def capacity(self) -> int:
        return self.xy.shape[0]


def padded_capacity(n_features: int) -> int:
    return int(math.ceil(n_features / 256) * 256)


def scale_factors(params: OrbParams) -> np.ndarray:
    return (params.scale_factor ** np.arange(params.n_levels)).astype(np.float32)


def sigma2_per_octave(params: OrbParams) -> np.ndarray:
    """Per-octave measurement variance sigma^2 = scale^2, the BA information
    weighting (src/Optimizer.cpp:376-377)."""
    return (scale_factors(params) ** 2).astype(np.float32)


def _fast_response_batched(atlas: torch.Tensor, th_high: float, th_low: float):
    """FAST-9/16 over the whole pyramid atlas [L, H, W] at once.

    A pixel is a corner at threshold th when 9 contiguous circle pixels are
    all brighter (d > th) or all darker (d < -th); its score is the sum of
    the threshold-exceeding differences on that side."""
    L, H, W = atlas.shape
    pad = Fnn.pad(atlas[:, None], (3, 3, 3, 3), mode="replicate")[:, 0]
    d = torch.stack(
        [pad[:, 3 + dy: 3 + dy + H, 3 + dx: 3 + dx + W] for dy, dx in _CIRCLE],
        dim=0) - atlas[None]  # [16, L, H, W] circle minus center

    def has_run9(bits16: torch.Tensor) -> torch.Tensor:
        # pack the 16 circle bits into an int64 mask, duplicate it, AND 9 shifts
        m = torch.zeros((L, H, W), dtype=torch.int64, device=atlas.device)
        for k in range(16):
            m = m | (bits16[k].to(torch.int64) << k)
        m2 = m | (m << 16)
        run = m2
        for k in range(1, 9):
            run = run & (m2 >> k)
        return (run & 0xFFFF) != 0

    def corner_and_score(th):
        is_b = has_run9(d > th)
        is_d = has_run9(d < -th)
        sb = torch.clamp(d - th, min=0.0).sum(0)
        sd = torch.clamp(-d - th, min=0.0).sum(0)
        score = torch.where(is_b, sb, 0.0)
        return torch.maximum(score, torch.where(is_d, sd, 0.0))

    return corner_and_score(th_high), corner_and_score(th_low)


def _nms3_batched(resp: torch.Tensor) -> torch.Tensor:
    """3x3 non-max suppression (OpenCV FAST's nonmaxSuppression=true,
    src/ORBextractor.cpp:875). Responses are >= 0, so the max pool's -inf
    border acts as JAX's zero border."""
    mx = Fnn.max_pool2d(resp[:, None], 3, stride=1, padding=1)[:, 0]
    return torch.where(resp >= mx, resp, 0.0)


def gaussian_blur7_batched(atlas: torch.Tensor, sigma: float = 2.0) -> torch.Tensor:
    """Separable 7x7 Gaussian over [L, H, W], edge-replicated (the reference
    blurs before BRIEF, src/ORBextractor.cpp:1167). Taps are summed in the
    JAX version's order."""
    r = 3
    k = np.exp(-0.5 * (np.arange(-r, r + 1) / sigma) ** 2)
    k = (k / k.sum()).astype(np.float32)
    L, H, W = atlas.shape
    pad = Fnn.pad(atlas[:, None], (r, r, 0, 0), mode="replicate")[:, 0]
    h = 0.0
    for i in range(2 * r + 1):
        h = h + float(k[i]) * pad[:, :, i: i + W]
    hpad = Fnn.pad(h[:, None], (0, 0, r, r), mode="replicate")[:, 0]
    out = 0.0
    for i in range(2 * r + 1):
        out = out + float(k[i]) * hpad[:, i: i + H, :]
    return out


def _u32_words_to_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same bit pattern."""
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


def extract_orb(img: torch.Tensor, params: OrbParams, height: int,
                width: int) -> FrameFeatures:
    """Full ORB extraction over the pyramid. img: [H, W] (any dtype, values
    in [0, 255]) on the device that runs the extraction.

    Replaces ORBextractor::operator() (src/ORBextractor.cpp:1120-1195)."""
    dev = img.device
    img = img.to(torch.float32)
    L = params.n_levels
    sizes = level_sizes(height, width, L, params.scale_factor)
    budgets = features_per_level(params.n_features, L, params.scale_factor)
    min_size = 2 * EDGE_BORDER + 8
    H0, W0 = height, width

    # ---- pyramid atlas: each level edge-replicated to [H0, W0] ----
    levels = []
    level_img = img
    for lv in range(L):
        h, w = sizes[lv]
        if h < min_size or w < min_size:
            levels.append(torch.zeros((H0, W0), dtype=torch.float32, device=dev))
            continue
        if lv > 0:
            hi, wi = level_img.shape
            wy = constant(("resize", hi, h), lambda: _resize_weights(hi, h), dev)
            wx = constant(("resize", wi, w), lambda: _resize_weights(wi, w), dev)
            level_img = wy @ level_img @ wx.T
        levels.append(Fnn.pad(level_img[None, None], (0, W0 - w, 0, H0 - h),
                              mode="replicate")[0, 0])
    atlas = torch.stack(levels)

    # ---- batched FAST + NMS, masked to per-level valid interiors ----
    rh, rl = _fast_response_batched(atlas, params.ini_th_fast, params.min_th_fast)
    ys_g = torch.arange(H0, device=dev)[:, None]
    xs_g = torch.arange(W0, device=dev)[None, :]
    interior = torch.stack([
        (ys_g >= EDGE_BORDER) & (ys_g < sizes[lv][0] - EDGE_BORDER)
        & (xs_g >= EDGE_BORDER) & (xs_g < sizes[lv][1] - EDGE_BORDER)
        if sizes[lv][0] >= min_size and sizes[lv][1] >= min_size
        else torch.zeros((H0, W0), dtype=torch.bool, device=dev)
        for lv in range(L)
    ])
    rh = torch.where(interior, _nms3_batched(rh), 0.0)
    rl = torch.where(interior, _nms3_batched(rl), 0.0)

    # ---- per-level budgeted selection (tiered cell-uniform top-k) ----
    cell = params.cell_size
    Hp = (H0 + cell - 1) // cell * cell
    Wp = (W0 + cell - 1) // cell * cell

    def cell_best_mask(r):
        rp = Fnn.pad(r, (0, Wp - W0, 0, Hp - H0))
        c = rp.reshape(L, Hp // cell, cell, Wp // cell, cell)
        cmax = c.amax(dim=(2, 4), keepdim=True)
        best = (c == cmax) & (c > 0)
        return best.reshape(L, Hp, Wp)[:, :H0, :W0]

    def norm(r):
        return r / (r.amax(dim=(1, 2), keepdim=True) + 1e-6)

    nh, nl = norm(rh), norm(rl)
    tier = torch.zeros_like(rh)
    tier = torch.where(rl > 0, 1.0 + nl, tier)
    tier = torch.where(cell_best_mask(rl), 3.0 + nl, tier)
    tier = torch.where(rh > 0, 5.0 + nh, tier)
    tier = torch.where(cell_best_mask(rh) & (rh > 0), 7.0 + nh, tier)

    # stable descending sort: equal scores keep the lower flat index
    scores_all, idx_all = torch.sort(tier.reshape(L, -1), dim=1,
                                     descending=True, stable=True)
    rh_flat, rl_flat = rh.reshape(L, -1), rl.reshape(L, -1)
    xs_l, ys_l, lvl_l, resp_l, valid_l = [], [], [], [], []
    for lv in range(L):
        k = budgets[lv]
        scores, idx = scores_all[lv, :k], idx_all[lv, :k]
        valid = scores > 0
        rhv, rlv = rh_flat[lv][idx], rl_flat[lv][idx]
        xs_l.append(idx % W0)
        ys_l.append(idx // W0)
        lvl_l.append(torch.full((k,), lv, dtype=torch.int64, device=dev))
        resp_l.append(torch.where(valid, torch.where(rhv > 0, rhv, rlv), 0.0))
        valid_l.append(valid)
    xs = torch.cat(xs_l)
    ys = torch.cat(ys_l)
    lvl = torch.cat(lvl_l)
    resp = torch.cat(resp_l)
    valid = torch.cat(valid_l)

    # ---- sub-pixel localization: Harris snap + 1D quadratic fits ----
    blur = gaussian_blur7_batched(atlas)
    gx = 0.5 * (torch.roll(blur, -1, 2) - torch.roll(blur, 1, 2))
    gy = 0.5 * (torch.roll(blur, -1, 1) - torch.roll(blur, 1, 1))

    def box3(x):
        s = x + torch.roll(x, 1, 2) + torch.roll(x, -1, 2)
        return s + torch.roll(s, 1, 1) + torch.roll(s, -1, 1)

    Ixx, Iyy, Ixy = box3(gx * gx), box3(gy * gy), box3(gx * gy)
    flat_resp = (Ixx * Iyy - Ixy * Ixy - 0.04 * (Ixx + Iyy) ** 2).reshape(-1)

    def rsample(dy, dx):
        xq = torch.clamp(xs + dx, 0, W0 - 1)
        yq = torch.clamp(ys + dy, 0, H0 - 1)
        return flat_resp[(lvl * H0 + yq) * W0 + xq]

    # snap to the Harris argmax in the 3x3 neighbourhood of the FAST peak
    # (argmax takes the first index among ties, as jnp.argmax)
    flat9 = torch.stack([rsample(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)],
                        dim=-1)
    arg = torch.argmax(flat9, dim=-1)
    xs_s = torch.clamp(xs + arg % 3 - 1, 1, W0 - 2)
    ys_s = torch.clamp(ys + arg // 3 - 1, 1, H0 - 2)

    def rsample_s(dy, dx):
        return flat_resp[(lvl * H0 + (ys_s + dy)) * W0 + (xs_s + dx)]

    c0 = rsample_s(0, 0)

    def subpix(m, p):
        denom = m - 2.0 * c0 + p
        off = 0.5 * (m - p) / torch.where(denom.abs() > 1e-6, denom, 1e6)
        return torch.clamp(off, -0.5, 0.5)

    dx_sub = (xs_s - xs) + subpix(rsample_s(0, -1), rsample_s(0, 1))
    dy_sub = (ys_s - ys) + subpix(rsample_s(-1, 0), rsample_s(1, 0))

    # ---- orientation: circular moments of the 31x31 atlas patch. The window
    # start is clamped into the image, as jax.lax.dynamic_slice does ----
    mask, gxm, gym = (constant(("ic_angle", i), lambda i=i: _ic_angle_masks()[i], dev)
                      for i in range(3))
    ar = torch.arange(PATCH, device=dev)
    y0p = torch.clamp(ys - HALF_PATCH, 0, H0 - PATCH)
    x0p = torch.clamp(xs - HALF_PATCH, 0, W0 - PATCH)
    pidx = ((lvl[:, None, None] * H0 + y0p[:, None, None] + ar[None, :, None]) * W0
            + x0p[:, None, None] + ar[None, None, :])
    pm = atlas.reshape(-1)[pidx] * mask
    ang = torch.atan2(torch.sum(pm * gym, dim=(1, 2)), torch.sum(pm * gxm, dim=(1, 2)))

    # ---- descriptors: rotated BRIEF gathers on the blurred atlas ----
    pat = constant("brief", brief_pattern, dev)
    ca, sa = torch.cos(ang), torch.sin(ang)

    def rotxy(px, py):
        rx = torch.round(px[None, :] * ca[:, None] - py[None, :] * sa[:, None])
        ry = torch.round(px[None, :] * sa[:, None] + py[None, :] * ca[:, None])
        return rx.to(torch.int64), ry.to(torch.int64)

    ax, ay = rotxy(pat[:, 0], pat[:, 1])
    bx, by = rotxy(pat[:, 2], pat[:, 3])
    flat = blur.reshape(-1)

    def sample(dx, dy):
        x = torch.clamp(xs[:, None] + dx, 0, W0 - 1)
        y = torch.clamp(ys[:, None] + dy, 0, H0 - 1)
        return flat[(lvl[:, None] * H0 + y) * W0 + x]

    bits = (sample(ax, ay) < sample(bx, by)).to(torch.int64).reshape(-1, 8, 32)
    weights = torch.ones(32, dtype=torch.int64, device=dev) << torch.arange(
        32, dtype=torch.int64, device=dev)
    desc = _u32_words_to_i32((bits * weights).sum(-1))

    # ---- photometric patches: bilinear 15x15 windows on the blurred level
    # image, centered exactly at the subpixel keypoint (LK templates) ----
    px = xs.to(torch.float32) + dx_sub
    py = ys.to(torch.float32) + dy_sub
    r = PATCH_WIN // 2
    off = torch.arange(-r, r + 1, dtype=torch.float32, device=dev)
    gxq = px[:, None, None] + off[None, None, :]   # [K, 1, 15]
    gyq = py[:, None, None] + off[None, :, None]   # [K, 15, 1]
    x0 = torch.clamp(torch.floor(gxq).to(torch.int64), 0, W0 - 2)
    y0 = torch.clamp(torch.floor(gyq).to(torch.int64), 0, H0 - 2)
    fx_ = torch.clamp(gxq - x0, 0.0, 1.0)
    fy_ = torch.clamp(gyq - y0, 0.0, 1.0)
    base = lvl[:, None, None] * (H0 * W0)

    def samp(yy, xx):
        return flat[base + yy * W0 + xx]

    patch = ((samp(y0, x0) * (1 - fx_) + samp(y0, x0 + 1) * fx_) * (1 - fy_)
             + (samp(y0 + 1, x0) * (1 - fx_) + samp(y0 + 1, x0 + 1) * fx_) * fy_)

    # ---- scale coords to level 0, pad to capacity ----
    sf = constant(("scale_factors", params.scale_factor, params.n_levels),
                  lambda: scale_factors(params), dev)[lvl]
    xy = torch.stack([px * sf, py * sf], -1)
    pad = padded_capacity(params.n_features) - xy.shape[0]

    def pad0(t):
        return torch.cat([t, t.new_zeros((pad,) + t.shape[1:])])

    return FrameFeatures(xy=pad0(xy), response=pad0(resp), angle=pad0(ang),
                         octave=pad0(lvl.to(torch.int32)), desc=pad0(desc),
                         valid=pad0(valid), patch=pad0(patch))
