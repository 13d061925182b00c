"""Dataset loaders for the reference's evaluation suites.

Covers the formats consumed by the reference's Examples/ drivers
(SURVEY.md §2.3): TUM RGB-D (rgb.txt/depth.txt + associations,
Examples/RGB-D/rgbd_tum.cc + associations/*.txt), KITTI odometry
(times.txt + image_0/image_1, Examples/Stereo/stereo_kitti.cpp), and
EuRoC MAV (mav0/cam0/data + timestamp lists, Examples/Stereo/
stereo_EuRoC.cpp). Counterpart of orbslam2_tpu/io/datasets.py: the same
items, the images decoded by the port's own PNG reader (io/png.py) into
what OpenCV's imread gives there, since the port runs where OpenCV is not
installed (host IO).

Each loader yields (timestamp, frame dict) lazily so long sequences never
fully reside in memory.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from .png import read_png


def _imread_gray(path) -> np.ndarray:
    # native u8: System._gray passes it through
    return read_png(path)


def _imread_depth(path, factor: float) -> np.ndarray:
    d = read_png(path, unchanged=True)
    if factor == 1.0 and d.dtype == np.uint16:
        # raw sensor units, native u16 (TUM depth PNGs): the tracker applies
        # cfg.depth_map_factor once (tracking._depth_wire)
        return d
    return d.astype(np.float32) * factor


def load_tum_rgb(seq_dir):
    """Monocular TUM: parse rgb.txt (mono_tum.cc:36-126 LoadImages)."""
    seq = Path(seq_dir)
    out = []
    for line in (seq / "rgb.txt").read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        ts, rel = line.split()[:2]
        out.append((float(ts), seq / rel))
    return out


def iter_tum_mono(seq_dir):
    for ts, path in load_tum_rgb(seq_dir):
        yield ts, {"image": _imread_gray(path)}


def load_tum_associations(seq_dir, assoc_file=None):
    """TUM RGB-D with an associations file (rgbd_tum.cc LoadImages; the
    reference ships associations under Examples/RGB-D/associations/)."""
    seq = Path(seq_dir)
    assoc = Path(assoc_file) if assoc_file else seq / "associations.txt"
    out = []
    for line in assoc.read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        # format: ts_rgb rgb_path ts_depth depth_path (or swapped)
        ts = float(parts[0])
        p1, p2 = parts[1], parts[3]
        rgb, depth = (p1, p2) if "rgb" in p1 else (p2, p1)
        out.append((ts, seq / rgb, seq / depth))
    return out


def iter_tum_rgbd(seq_dir, assoc_file=None, depth_factor=1.0):
    """Yields raw depth values by default (depth_factor=1.0):
    cfg.depth_map_factor (DepthMapFactor from the reference YAML,
    src/Tracking.cpp:165-173) is the single scaling point, applied by the
    tracker. Pass an explicit factor only for non-standard sources."""
    for ts, rgb, depth in load_tum_associations(seq_dir, assoc_file):
        yield ts, {"image": _imread_gray(rgb),
                   "depth": _imread_depth(depth, depth_factor)}


def load_kitti_times(seq_dir):
    seq = Path(seq_dir)
    return [float(x) for x in (seq / "times.txt").read_text().split()]


def iter_kitti_stereo(seq_dir):
    """KITTI odometry grayscale pair (stereo_kitti.cpp LoadImages)."""
    seq = Path(seq_dir)
    times = load_kitti_times(seq_dir)
    for i, ts in enumerate(times):
        name = f"{i:06d}.png"
        yield ts, {"image": _imread_gray(seq / "image_0" / name),
                   "right": _imread_gray(seq / "image_1" / name)}


def iter_kitti_mono(seq_dir):
    seq = Path(seq_dir)
    for i, ts in enumerate(load_kitti_times(seq_dir)):
        yield ts, {"image": _imread_gray(seq / "image_0" / f"{i:06d}.png")}


def _euroc_stamps(cam_dir):
    data = Path(cam_dir) / "data.csv"
    out = []
    for line in data.read_text().splitlines()[1:]:
        if not line.strip():
            continue
        ns, name = line.split(",")[:2]
        out.append((int(ns) * 1e-9, Path(cam_dir) / "data" / name.strip()))
    return out


def iter_euroc(mav0_dir, stereo=False):
    """EuRoC MAV mav0 layout (mono_euroc.cc / stereo_EuRoC.cpp). Stereo
    rectification (the LEFT.*/RIGHT.* YAML matrices) is the caller's, with
    io/rectify.load_rectification."""
    left = _euroc_stamps(Path(mav0_dir) / "cam0")
    if not stereo:
        for ts, p in left:
            yield ts, {"image": _imread_gray(p)}
        return
    rdict = {round(ts, 4): p for ts, p in _euroc_stamps(Path(mav0_dir) / "cam1")}
    for ts, p in left:
        rp = rdict.get(round(ts, 4))
        if rp is None:
            continue
        yield ts, {"image": _imread_gray(p), "right": _imread_gray(rp)}
