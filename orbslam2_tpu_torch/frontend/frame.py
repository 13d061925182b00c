"""Per-frame feature container and construction.

Counterpart of orbslam2_tpu/frontend/frame.py and frontend/stereo.py
(src/Frame.cpp), all three sensors: construction runs the extraction on the
device, reads the features back and undistorts keypoints. RGB-D depths are
assigned on the host; a stereo frame extracts the right image too and
matches along rows on the device (ops/stereo.stereo_match; inputs must be
rectified). The JAX package's sub-pixel SAD refinement
(`stereo_depths_refined`) is superseded there and not ported.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np
import torch

from ..config import SlamConfig
from ..geometry import camera as cam_mod
from ..ops import features as F
from ..ops import stereo as ST
from ..utils.device import upload


@dataclass
class Frame:
    frame_id: int
    timestamp: float
    xy: np.ndarray       # [N, 2] undistorted level-0 coords
    xy_raw: np.ndarray   # [N, 2] raw pixel coords
    octave: np.ndarray   # [N]
    angle: np.ndarray    # [N]
    response: np.ndarray
    desc: np.ndarray     # [N, 8] int32 descriptor words
    valid: np.ndarray    # [N]
    depth: np.ndarray    # [N] (-1 mono)
    ur: np.ndarray       # [N] right-image u (-1 mono)
    patch: np.ndarray = None  # [N, 15, 15] f32 photometric windows centered
    #                           on the ORIGINAL detection (ops/refine.py)
    xy0: np.ndarray = None    # [N, 2] pristine undistorted detection coords
    ur0: np.ndarray = None    # [N] pristine right-u measurements
    pose: np.ndarray | None = None        # [3, 4] Tcw
    pt_idx: np.ndarray = field(default=None)  # [N] map point per feature (-1)
    # temporal "VO" points: world positions for features matched to
    # depth-backprojected last-frame features that carry no map point
    # (Tracking::UpdateLastFrame). Never enter the map.
    tmp_xyz: np.ndarray = field(default=None)
    tmp_valid: np.ndarray = field(default=None)
    # lazy frames (block driver): xy and the other per-feature arrays are
    # None until tracking.Tracker._ensure_features fills them from the
    # block's readback; n_feat carries the capacity until then
    n_feat: int = 0

    def __post_init__(self):
        n = self.xy.shape[0] if self.xy is not None else self.n_feat
        self.n_feat = n
        if self.pt_idx is None:
            self.pt_idx = np.full(n, -1, np.int32)
        if self.tmp_xyz is None:
            self.tmp_xyz = np.zeros((n, 3), np.float32)
            self.tmp_valid = np.zeros(n, bool)

    @property
    def capacity(self) -> int:
        return self.n_feat

    @property
    def n_valid(self) -> int:
        return int(self.valid.sum())


class FrameBuilder:
    """Builds Frames by running the extraction on `device`. One instance
    per extractor configuration: monocular initialization has its own, with
    twice the feature budget (src/Tracking.cpp:141-149)."""

    def __init__(self, cfg: SlamConfig, device: torch.device,
                 n_features: int | None = None):
        self.cfg = cfg
        self.device = device
        self.orb = (cfg.orb if n_features is None
                    else replace(cfg.orb, n_features=n_features))
        self._next_id = 0

    def build(self, img: np.ndarray, timestamp: float,
              depth_map: np.ndarray | None = None,
              right_img: np.ndarray | None = None) -> Frame:
        h, w = img.shape
        feats = F.extract_orb(upload(img, self.device), self.orb, h, w)
        und_t = cam_mod.undistort_pixels(self.cfg.camera, feats.xy)
        stereo = None
        if right_img is not None:
            feats_r = F.extract_orb(upload(right_img, self.device), self.orb, h, w)
            cam = self.cfg.camera
            stereo = ST.stereo_match(
                feats.xy, feats.octave, feats.desc, feats.valid,
                feats_r.xy, feats_r.octave, feats_r.desc, feats_r.valid,
                upload(F.scale_factors(self.orb), self.device), cam.bf, cam.fx)
        feats = [t.cpu().numpy() for t in feats]
        xy_raw, response, angle, octave, desc, valid, patch = feats
        # a copy: without distortion und_t IS feats.xy, and on the CPU
        # .numpy() shares memory
        und = und_t.cpu().numpy().copy()
        n = xy_raw.shape[0]
        depth = np.full(n, -1.0, np.float32)
        ur = np.full(n, -1.0, np.float32)
        if stereo is not None:
            ur, depth = (t.cpu().numpy() for t in stereo)
        elif depth_map is not None:
            depth, ur = self._rgbd_depth(depth_map, xy_raw, und, h, w)
        frame = Frame(
            frame_id=self._next_id, timestamp=timestamp, xy=und, xy_raw=xy_raw,
            octave=octave, angle=angle, response=response, desc=desc,
            valid=valid, depth=depth, ur=ur, patch=patch, xy0=und.copy(),
            ur0=ur.copy())
        self._next_id += 1
        return frame

    def _rgbd_depth(self, depth_map, xy_raw, und, h, w):
        """RGB-D depth lookup at the keypoint and virtual right coordinate
        (Frame::ComputeStereoFromRGBD, src/Frame.cpp:773-800), with two
        upgrades over the reference's integer-truncated lookup:
        1. bilinear depth at the subpixel keypoint;
        2. keypoints on depth discontinuities (3x3 range > 10% of z) get no
           depth: their depth is ill-defined and their biased virtual-ur
           edges are what pose optimization would lock onto.
        depth_map is in raw sensor units; scaled to meters in f32."""
        dm = (np.asarray(depth_map, np.float32)
              * np.float32(self.cfg.depth_map_factor))
        x = np.clip(xy_raw[:, 0], 0, w - 1.001)
        y = np.clip(xy_raw[:, 1], 0, h - 1.001)
        x0 = x.astype(int)
        y0 = y.astype(int)
        fx_ = (x - x0)[:, None]
        fy_ = (y - y0)[:, None]
        x1 = np.minimum(x0 + 1, w - 1)
        y1 = np.minimum(y0 + 1, h - 1)
        corners = np.stack([dm[y0, x0], dm[y0, x1], dm[y1, x0], dm[y1, x1]], -1)
        wgt = np.concatenate([(1 - fx_) * (1 - fy_), fx_ * (1 - fy_),
                              (1 - fx_) * fy_, fx_ * fy_], -1)
        d = (corners * wgt).sum(-1)
        xi = np.clip(np.round(x).astype(int), 1, w - 2)
        yi = np.clip(np.round(y).astype(int), 1, h - 2)
        neigh = np.stack([dm[yi + dy, xi + dx]
                          for dy in (-1, 0, 1) for dx in (-1, 0, 1)], -1)
        flat_ok = (neigh.max(-1) - neigh.min(-1)) < 0.1 * np.maximum(d, 1e-6)
        ok = (corners > 0).all(-1) & (d > 0) & flat_ok
        depth = np.where(ok, d, -1.0).astype(np.float32)
        ur = np.where(ok, und[:, 0] - self.cfg.camera.bf / np.maximum(d, 1e-6),
                      -1.0).astype(np.float32)
        return depth, ur
