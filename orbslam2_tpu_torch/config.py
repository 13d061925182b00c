"""Typed configuration covering the reference's OpenCV-YAML settings keys.

Counterpart of orbslam2_tpu/config.py, without JAX: `Intrinsics` lives in
geometry/camera.py, which imports only torch and numpy.

Replaces the cv::FileStorage parsing scattered through the reference
(src/Tracking.cpp:56-175, src/Viewer.cpp:33-51, src/MapDrawer.cpp ctor) with
one frozen dataclass. `load_settings()` reads the reference's YAML files
(e.g. Examples/Monocular/TUM1.yaml) so existing configs work unchanged.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field, replace
from enum import IntEnum
from pathlib import Path

import numpy as np

from .geometry.camera import Intrinsics


class Sensor(IntEnum):
    """include/System.h:53-57."""

    MONOCULAR = 0
    STEREO = 1
    RGBD = 2


@dataclass(frozen=True)
class OrbParams:
    """ORBextractor settings (src/Tracking.cpp:130-159)."""

    n_features: int = 1000
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: int = 20
    min_th_fast: int = 7
    # grid-cell size for the uniformity selection that replaces the
    # quadtree (src/ORBextractor.cpp:571)
    cell_size: int = 32


@dataclass(frozen=True)
class SlamConfig:
    sensor: Sensor = Sensor.MONOCULAR
    camera: Intrinsics = field(default_factory=lambda: Intrinsics(fx=517.3, fy=516.5, cx=318.6, cy=255.3, width=640, height=480))
    fps: float = 30.0
    rgb_order: bool = True  # Camera.RGB
    orb: OrbParams = field(default_factory=OrbParams)
    th_depth: float = 35.0        # ThDepth: close/far stereo point threshold
    depth_map_factor: float = 1.0  # DepthMapFactor (RGB-D depth scaling)
    # Initial capacities of the structure-of-arrays map (map/mapstate.py
    # doubles them when full; the reference grows pointer graphs instead).
    max_keyframes: int = 512
    max_points: int = 65536
    # fixed size of the local-map slice a frame is matched against
    local_points_cap: int = 4096
    # local-BA window: the new keyframe and its covisible ones, at most this
    # many (the fixed second ring comes on top)
    local_ba_cam_cap: int = 48
    # Local-BA gauge fixing. "window": fix the second ring plus the oldest
    # window camera (and the global-oldest when it is in the window). "ref":
    # the reference's rule, only the second ring and the map-origin keyframe
    # (src/Optimizer.cpp:640-652), LM damping handling the rest.
    local_ba_gauge: str = "window"
    # shape buckets of a BA problem (local_mapping.build_ba_problem): a
    # window pads up to the first bucket that holds it
    ba_cam_buckets: tuple = (8, 16, 32, 64, 128, 256, 512)
    ba_point_buckets: tuple = (1024, 2048, 4096, 8192, 16384, 32768, 65536)
    ba_edge_buckets: tuple = (4096, 8192, 16384, 32768, 65536, 131072, 262144)
    # Tracking constants (src/Tracking.cpp:167, :1417)
    min_frames_between_kf: int = 0

    @property
    def max_frames_between_kf(self) -> int:
        return int(self.fps)

    @property
    def close_depth_threshold(self) -> float:
        """mThDepth = bf * ThDepth / fx (src/Tracking.cpp:161)."""
        return self.camera.bf * self.th_depth / self.camera.fx


_NUM = re.compile(r"^-?\d+(\.\d+)?([eE][+-]?\d+)?$")


def _parse_opencv_yaml(path: str | Path) -> dict:
    """Minimal parser for the reference's flat OpenCV YAML files.

    Handles `Key: value` scalar lines and `Key: !!opencv-matrix` blocks (the
    LEFT.*/RIGHT.* rectification matrices of the EuRoC stereo settings, read
    by io/rectify.py) with their rows, cols and data, the data list possibly
    over several lines; returns floats, strings and float64 arrays. Skips
    the %YAML directive.
    """
    out: dict[str, float | str | np.ndarray] = {}
    lines = iter(Path(path).read_text().splitlines())
    for line in lines:
        line = line.split("#")[0].strip()
        if not line or line.startswith("%") or line.startswith("-") or ":" not in line:
            continue
        key, _, val = line.partition(":")
        key, val = key.strip(), val.strip().strip('"')
        if val == "!!opencv-matrix":
            out[key] = _parse_opencv_matrix(key, lines)
        elif not val:
            continue
        elif _NUM.match(val):
            out[key] = float(val)
        else:
            out[key] = val
    return out


def _parse_opencv_matrix(key: str, lines) -> np.ndarray:
    """The rows / cols / dt / data fields of one opencv-matrix block."""
    fields: dict[str, str] = {}
    try:
        for line in lines:
            name, _, val = line.split("#")[0].strip().partition(":")
            fields[name.strip()] = val.strip()
            if name.strip() == "data":
                while "]" not in fields["data"]:
                    fields["data"] += " " + next(lines).split("#")[0].strip()
                break
        rows, cols = int(fields["rows"]), int(fields["cols"])
        data = [float(x) for x in fields["data"].strip("[] ").replace(",", " ").split()]
        return np.array(data, np.float64).reshape(rows, cols)
    except (KeyError, ValueError, StopIteration) as e:
        raise ValueError(f"malformed opencv-matrix {key}: {fields}") from e


def load_settings(path: str | Path, sensor: Sensor = Sensor.MONOCULAR) -> SlamConfig:
    """Load a reference-format settings YAML into a SlamConfig
    (keys per src/Tracking.cpp:56-175)."""
    y = _parse_opencv_yaml(path)

    def g(key, default=0.0):
        return float(y.get(key, default))

    cam = Intrinsics(
        fx=g("Camera.fx"), fy=g("Camera.fy"), cx=g("Camera.cx"), cy=g("Camera.cy"),
        k1=g("Camera.k1"), k2=g("Camera.k2"), p1=g("Camera.p1"), p2=g("Camera.p2"),
        k3=g("Camera.k3"), bf=g("Camera.bf"),
        width=int(g("Camera.width", 640)), height=int(g("Camera.height", 480)),
    )
    orb = OrbParams(
        n_features=int(g("ORBextractor.nFeatures", 1000)),
        scale_factor=g("ORBextractor.scaleFactor", 1.2),
        n_levels=int(g("ORBextractor.nLevels", 8)),
        ini_th_fast=int(g("ORBextractor.iniThFAST", 20)),
        min_th_fast=int(g("ORBextractor.minThFAST", 7)),
    )
    dmf = g("DepthMapFactor", 1.0)
    if abs(dmf) < 1e-5:
        dmf = 1.0
    return SlamConfig(
        sensor=sensor,
        camera=cam,
        fps=g("Camera.fps", 30.0) or 30.0,
        rgb_order=bool(int(g("Camera.RGB", 1))),
        orb=orb,
        th_depth=g("ThDepth", 35.0),
        depth_map_factor=1.0 / dmf if sensor == Sensor.RGBD and dmf > 1.0 else dmf,
    )


def with_camera(cfg: SlamConfig, **kw) -> SlamConfig:
    return replace(cfg, camera=replace(cfg.camera, **kw))
