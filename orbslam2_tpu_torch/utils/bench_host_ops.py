"""Host map bookkeeping against the map's size: a keyframe's host work on the
map should stay flat as the map grows to 500 keyframes.

Counterpart of the JAX package's scripts/bench_host_ops.py, over this
package's MapState and native/mapops.cpp. At K = 50, 150, 300 and 500
keyframes with proportional points (the JAX script's seeded map, draw for
draw) it times, in ms on the host:

- covisibility_weights of one keyframe (the native library);
- covis_matrix, the full [K, K] pass of the pose-graph edges (native);
- refresh_point_stats over one keyframe's bound points (native medoids);
- point_obs_count, the kf_pt sweep (numpy).

Beside the JAX script's table it prints the same four times with the
native library withheld (native.withheld()), so the numpy fallback runs.

    python3 -m orbslam2_tpu_torch.utils.bench_host_ops
"""
from __future__ import annotations

import sys
import time

import numpy as np

from .. import native
from ..config import SlamConfig
from ..interop import desc_u32_to_i32
from ..map.mapstate import MapState

KEYFRAMES = (50, 150, 300, 500)
OPS = ("covis_weights", "covis_matrix", "refresh_point_stats", "point_obs_count")


def build(K, pts_per_kf=300, n_feat=1024, seed=0):
    """The JAX script's map of K keyframes, draw for draw: K * 60 + 2000
    points, each keyframe seeing pts_per_kf of a band of 1200 points.
    Returns (map, point ids)."""
    rng = np.random.default_rng(seed)
    P = K * 60 + 2000
    cfg = SlamConfig(max_keyframes=max(K + 8, 512),
                     max_points=max(P + 1024, 65536))
    mp = MapState(cfg, n_feat)
    pts = mp.add_points(rng.uniform(-5, 5, (P, 3)).astype(np.float32),
                        desc_u32_to_i32(rng.integers(0, 2**32, (P, 8), dtype=np.uint32)),
                        0, 0)
    for k in range(K):
        pose = np.hstack([np.eye(3), rng.normal(0, 1, (3, 1))]).astype(np.float32)
        pt_idx = np.full(n_feat, -1, np.int32)
        # local visibility: each keyframe sees a contiguous band of points
        lo = int(k * 60)
        sel = rng.choice(np.arange(lo, min(lo + 1200, P)),
                         min(pts_per_kf, 1200), replace=False)
        pt_idx[:len(sel)] = pts[sel]
        mp.add_keyframe(pose, float(k), k,
                        rng.uniform(0, 640, (n_feat, 2)).astype(np.float32),
                        rng.integers(0, 8, n_feat).astype(np.int32),
                        np.zeros(n_feat, np.float32),
                        desc_u32_to_i32(rng.integers(0, 2**32, (n_feat, 8),
                                                     dtype=np.uint32)),
                        np.ones(n_feat, bool), pt_idx)
    return mp, pts


def operations(mp: MapState) -> dict:
    """The four timed operations on the last keyframe, by name, as calls."""
    k = mp.n_keyframes - 1
    bound = np.unique(mp.kf_pt[k][mp.kf_pt[k] >= 0])
    return {"covis_weights": lambda: mp.covisibility_weights(k),
            "covis_matrix": mp.covis_matrix,
            "refresh_point_stats": lambda: mp.refresh_point_stats(bound),
            "point_obs_count": mp.point_obs_count}


def t(fn, n=5):
    fn()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n * 1e3


def times(mp: MapState) -> dict:
    """ms of each operation, as the JAX script times it (covis_matrix over
    3 calls, the others over 5, after one untimed call)."""
    return {name: t(fn, n=3 if name == "covis_matrix" else 5)
            for name, fn in operations(mp).items()}


def main(keyframes=KEYFRAMES) -> int:
    if not native.available():
        raise RuntimeError("host map library (native/mapops.cpp) did not load")
    print("| K keyframes | covis_weights ms | covis_matrix ms | "
          "refresh_point_stats ms | point_obs_count ms | "
          + " | ".join(f"{name} ms (numpy)" for name in OPS) + " |")
    print("|---|---|---|---|---|" + "---|" * len(OPS))
    for K in keyframes:
        mp, _ = build(K)
        ms = times(mp)
        with native.withheld():
            fallback = times(mp)
        print(f"| {K} | " + " | ".join(f"{ms[name]:.2f}" for name in OPS) + " | "
              + " | ".join(f"{fallback[name]:.2f}" for name in OPS) + " |", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
