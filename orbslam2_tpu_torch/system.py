"""System facade: the public entry point of the port.

Counterpart of orbslam2_tpu/system.py (src/System.cpp). This step of the port
builds the map and an RGB-D tracker with the local mapper and relocalizer
off, and exposes the reference's API surface (include/System.h:63-110):

    System(cfg, device="cuda").track_rgbd(rgb, depth, t) -> Tcw [3,4] or None
    run_sequence(frames, pipelined=False)
    save_trajectory_tum(path)
    reset()

What the port does not do yet raises NotImplementedError naming the
ROADMAP.md item that brings it: monocular and stereo tracking, the block
driver (pipelined=True), localization mode, map save/load.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .config import SlamConfig, Sensor
from .io import trajectory as traj_io
from .map.mapstate import MapState
from .ops.features import padded_capacity
from .tracking import Tracker
from .utils.metrics import MetricsLog


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md queue 1: {item})")


class System:
    def __init__(self, cfg: SlamConfig, device: torch.device | str = "cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.metrics = MetricsLog()
        self._build()

    def _build(self):
        self.map = MapState(self.cfg, padded_capacity(self.cfg.orb.n_features))
        self.tracker = Tracker(self.cfg, self.map, None, relocalizer=None,
                               device=self.device)
        self.tracker.reset_callback = self.reset

    # ------------------------------------------------------------- public API
    def track_monocular(self, img: np.ndarray, timestamp: float):
        raise _not_ported("monocular tracking", "mono initialization, "
                          "ops/twoview.py and engine_step.mono_init_step")

    def track_stereo(self, left: np.ndarray, right: np.ndarray, timestamp: float):
        raise _not_ported("stereo tracking", "stereo, ops/stereo.stereo_match")

    def track_rgbd(self, img: np.ndarray, depth: np.ndarray, timestamp: float):
        if self.cfg.sensor != Sensor.RGBD:
            raise ValueError(f"track_rgbd on a {self.cfg.sensor.name} system")
        gray = self._gray(img)
        return self._tracked(timestamp, lambda: self.tracker.process_image(
            gray, timestamp, depth_map=depth))

    def _tracked(self, timestamp: float, fn):
        kfs_before = self.map.n_keyframes
        t0 = time.perf_counter()
        pose = fn()
        dt = (time.perf_counter() - t0) * 1e3
        self.metrics.append(
            frame_id=len(self.metrics.records), timestamp=timestamp,
            state=self.tracker.state.name,
            inliers=self.tracker.matches_inliers,
            keyframes=self.map.n_keyframes, points=self.map.n_points,
            loops=0, track_ms=dt,
            created_keyframe=self.map.n_keyframes != kfs_before)
        return pose

    def run_sequence(self, frames, pipelined: bool = True):
        """Sequence runner over (timestamp, {"image", "depth"}) pairs, one
        synchronous frame at a time (pipelined=False). Returns the number of
        tracked frames. pipelined=True is the JAX package's block driver,
        not ported yet."""
        if pipelined:
            raise _not_ported("the pipelined block driver (pipelined=True)",
                              "block driver, Tracker.run_blocked and "
                              "engine_step.track_frames_block")
        tracked = 0
        for ts, data in frames:
            if "right" in data:
                raise _not_ported("stereo tracking", "stereo")
            if "depth" not in data:
                raise _not_ported("monocular tracking", "mono initialization")
            pose = self.track_rgbd(data["image"], data["depth"], ts)
            tracked += int(pose is not None)
        return tracked

    @staticmethod
    def _gray(img: np.ndarray) -> np.ndarray:
        """Gray u8 image (the reference's CV_8U input)."""
        if img.ndim == 3:
            img = img @ np.array([0.299, 0.587, 0.114], np.float32)
        if img.dtype == np.uint8:
            return img
        return np.clip(np.round(img), 0, 255).astype(np.uint8)

    # ------------------------------------------------------------------ state
    def activate_localization_mode(self):
        raise _not_ported("localization mode", "relocalization")

    def reset(self):
        """System::Reset (src/System.cpp:279; Tracking::Reset :2030)."""
        self._build()

    # ------------------------------------------------------------- checkpoint
    def save_map(self, path):
        raise _not_ported("map save", "the rest, map checkpoints")

    def load_map(self, path):
        raise _not_ported("map load", "the rest, map checkpoints")

    # -------------------------------------------------------------- trajectory
    def save_trajectory_tum(self, path):
        ts, poses = self.tracker.trajectory()
        traj_io.save_tum(path, ts, poses)

