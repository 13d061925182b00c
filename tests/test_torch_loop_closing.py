"""The port's loop closer (loop_closing.LoopCloser), fuse_scw and
covis_matrix against the JAX package's, on the CPU.

The shared map is the JAX System's own, caught at the moment its loop
closer first corrects a loop on a cut RGB-D lap of the corridor circuit
(320x240, the same cut as test_torch_slice_loop.py): the map, its keyframe
database and the Sim(3) of the closure are carried into both packages'
closers (interop.map_from_numpy, keyframe_db_from_numpy), so that every
step runs on identical inputs. The global BA is replaced by a recorder in
both; test_torch_global_ba.py holds it apart.

Tolerances: integer results (candidate lists, match indices, observation
tables, fusion counts, the essential graph's edges) exact, but for
fuse_scw's matches of points whose predicted pyramid level sits within
1e-5 of an integer (at most 1% of the matches): a point seen from its reference keyframe has
log(max_dist / dist) / log(scale) = its octave exactly, and the f32 log of
XLA and of torch round it to either side of the ceil. Poses and points
after the Sim(3) propagation, the fusion and the write-back of a given
pose-graph solution 1e-4. The pose-graph solver itself: the same first
cost (1e-4 relative) and final cost (1%), poses within 2 cm and 5e-3 in
rotation. Its cost flattens after 4 of its 20 iterations and the poses
then wander along the flat valley: on the caught problem a float64 run
of 20 iterations ends 9 mm from one of 60, so no tighter pose bound holds
between any two implementations.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from orbslam2_tpu.loop_closing import LoopCloser as JLoopCloser
from orbslam2_tpu.map.keyframe_db import KeyFrameDatabase as JKeyFrameDB
from orbslam2_tpu.map.mapstate import MapState as JMap
from orbslam2_tpu.system import System as JSystem
from orbslam2_tpu import engine_keyframe as JEK
from orbslam2_tpu.ops import features as JF
from orbslam2_tpu_torch import engine_keyframe as TEK
from orbslam2_tpu_torch import native
from orbslam2_tpu_torch.interop import (desc_u32_to_i32, keyframe_db_from_numpy,
                                        map_from_numpy)
from orbslam2_tpu_torch.io.vocabulary import default_vocabulary
from orbslam2_tpu_torch.loop_closing import LoopCloser
from orbslam2_tpu_torch.ops import features as TF

import torch_slice_common as C
from test_search_by_sim3 import _build_two_kf_map



class _Caught(Exception):
    pass


class RecordingGBA:
    """Stands in for GlobalBA: records launches, never runs."""

    running = False

    def __init__(self):
        self.launches = []

    def launch(self, fixed_kf):
        self.launches.append(fixed_kf)

    def poll(self):
        return False


@functools.lru_cache(maxsize=1)
def jax_loop_state():
    """Run the JAX System over the cut lap until its loop closer calls
    _correct_loop for the first time; return copies of the map arrays, the
    keyframe database, the closure's (kf, kc, s12, R12, t12), the support
    matches and the keyframes the closer had processed."""
    cfg_j, _ = C.configs("RGBD")
    _, items = C.render_corridor(*C.LOOP_CUT)
    js = JSystem(cfg_j)
    lc = js.loop_closer
    seen = []
    orig_process = lc.process

    def process(kf):
        seen.append(int(kf))
        return orig_process(kf)

    def correct(kf, kc, s12, R12, t12):
        mp = js.map
        state["map"] = {k: np.array(getattr(mp, k)) for k in mp._ARRAY_FIELDS}
        state["map"].update(next_kf_id=mp.next_kf_id, next_pt_id=mp.next_pt_id,
                            pt_redirect=mp.pt_redirect.copy())
        state["retired"] = {k: (a, T.copy()) for k, (a, T) in mp.kf_retired.items()}
        state["db"] = {k: np.array(getattr(js.kf_db, k))
                       for k in ("word_ids", "weights", "registered")}
        state["loop"] = (int(kf), int(kc), float(s12), np.array(R12), np.array(t12))
        state["support"] = tuple(np.array(a) for a in lc._support_matches)
        state["processed"] = list(seen)
        raise _Caught

    state = {}
    lc.process = process
    lc._correct_loop = correct
    try:
        for ts, d in items:
            js.track_rgbd(d["image"], d["depth"], ts)
    except _Caught:
        pass
    assert "loop" in state, "the JAX System closed no loop on the cut lap"
    return state


def jax_map(state, cfg):
    a = state["map"]
    mp = JMap(cfg, a["kf_xy"].shape[1])
    for k in mp._ARRAY_FIELDS:
        setattr(mp, k, a[k].copy())
    mp.pt_redirect = a["pt_redirect"].copy()
    mp.next_kf_id, mp.next_pt_id = a["next_kf_id"], a["next_pt_id"]
    mp._pt_free = [int(i) for i in np.flatnonzero(~mp.pt_valid[:mp.next_pt_id])]
    mp.kf_retired = {k: (a_, T.copy()) for k, (a_, T) in state["retired"].items()}
    return mp


def port_map(state, cfg):
    arrays = dict(state["map"])
    arrays["retired_k"] = list(state["retired"])
    arrays["retired_anchor"] = [a for a, _ in state["retired"].values()]
    arrays["retired_T"] = [T for _, T in state["retired"].values()]
    mp = map_from_numpy(arrays, cfg)
    mp.pt_redirect = state["map"]["pt_redirect"].copy()
    return mp


def closers(state):
    """Fresh closers of both packages over copies of the caught map, with
    recording global BAs."""
    cfg_j, cfg_t = C.configs("RGBD")
    jmp, tmp = jax_map(state, cfg_j), port_map(state, cfg_t)
    n_words = default_vocabulary().n_words
    jdb = JKeyFrameDB(cfg_j, jmp, n_words)
    for k, v in state["db"].items():
        setattr(jdb, k, v.copy())
    tdb = keyframe_db_from_numpy(state["db"], cfg_t, tmp, n_words)
    jl = JLoopCloser(cfg_j, jmp, jdb, None, global_ba=RecordingGBA())
    tl = LoopCloser(cfg_t, tmp, tdb, RecordingGBA(), device="cpu")
    return jl, tl


def _same_map(jmp, tmp, atol):
    np.testing.assert_array_equal(tmp.kf_valid, jmp.kf_valid)
    np.testing.assert_array_equal(tmp.kf_pt, jmp.kf_pt)
    np.testing.assert_array_equal(tmp.pt_valid, jmp.pt_valid)
    live = np.flatnonzero(jmp.kf_valid)
    np.testing.assert_allclose(tmp.kf_pose[live], jmp.kf_pose[live], atol=atol)
    pts = np.flatnonzero(jmp.pt_valid)
    np.testing.assert_allclose(tmp.pt_xyz[pts], jmp.pt_xyz[pts], atol=atol)


def test_covis_matrix_exact(monkeypatch):
    """covis_matrix on the caught map: the port's native result equals
    JAX's, and so do the two packages' incidence-matmul fallbacks (which
    count a point seen twice by one keyframe once, where the native pass
    counts each pair of observations)."""
    from orbslam2_tpu import native as jnative
    state = jax_loop_state()
    cfg_j, cfg_t = C.configs("RGBD")
    jmp, tmp = jax_map(state, cfg_j), port_map(state, cfg_t)
    W = tmp.covis_matrix()
    np.testing.assert_array_equal(W, jmp.covis_matrix())
    assert native.available() and (np.triu(W, 1) >= 100).any()
    monkeypatch.setattr(native, "covis_matrix", lambda *a: None)
    monkeypatch.setattr(jnative, "covis_matrix", lambda *a: None)
    Wf = tmp.covis_matrix()
    np.testing.assert_array_equal(Wf, jmp.covis_matrix())
    assert (Wf <= W).all() and (Wf > 0).sum() == (W > 0).sum()


def test_fuse_scw_same_idx():
    """fuse_scw on the caught map: the loop keyframe's region points into
    its covisible group (16 keyframes, the last ones repeating the first
    and masked off, as _search_and_fuse pads) give the same [G, P] match
    indices in both packages."""
    state = jax_loop_state()
    jl, tl = closers(state)
    mp, cfg = tl.map, tl.cfg
    cam = cfg.camera
    kc = state["loop"][1]
    group = [kc] + [int(x) for x in mp.covisible_kfs(kc)]
    pts = tl._loop_points(kc)
    np.testing.assert_array_equal(pts, jl._loop_points(kc))
    P = cfg.local_points_cap
    lp = np.concatenate([pts[:P], np.zeros(P - len(pts[:P]), pts.dtype)])
    pv = np.arange(P) < len(pts)
    grp = np.asarray((group + [group[0]] * 16)[:16])
    live = np.arange(16) < min(len(group), 16)
    args = [mp.kf_pose[grp], mp.kf_xy[grp], mp.kf_octave[grp], mp.kf_desc[grp],
            mp.kf_feat_valid[grp] & live[:, None], mp.kf_ur[grp], mp.pt_xyz[lp], pv,
            mp.pt_desc[lp], mp.pt_normal[lp], mp.pt_min_dist[lp], mp.pt_max_dist[lp]]
    rest = (cam.fx, cam.fy, cam.cx, cam.cy, cam.bf, cam.width, cam.height,
            cfg.orb.n_levels, float(np.log(cfg.orb.scale_factor)))
    jargs = [a.view(np.uint32) if a.dtype == np.int32 and a.shape[-1:] == (8,) else a
             for a in args]
    idx_j = np.asarray(JEK.fuse_scw(*[jax.numpy.asarray(a) for a in jargs],
                                    jax.numpy.asarray(JF.scale_factors(cfg.orb)), *rest))
    idx_t = TEK.fuse_scw(*[torch.from_numpy(np.array(a)) for a in args],
                         torch.from_numpy(TF.scale_factors(cfg.orb)), *rest).numpy()
    n_match = (idx_j >= 0).sum()
    assert (idx_t[:len(group)] >= 0).sum() > 100 and n_match > 100
    rows, cols = np.nonzero(idx_t != idx_j)
    assert len(rows) <= 1e-2 * n_match, (len(rows), n_match)
    for g, p in zip(grp[rows], lp[cols]):
        T = mp.kf_pose[g].astype(np.float64)
        Ow = -T[:, :3].T @ T[:, 3]
        dist = np.linalg.norm(mp.pt_xyz[p] - Ow)
        level = np.log(mp.pt_max_dist[p] / dist) / np.log(cfg.orb.scale_factor)
        assert abs(level - np.round(level)) < 1e-5, (g, p, level)


@pytest.mark.parametrize("case", ["expands", "mutual"])
def test_search_by_sim3_cases(case):
    """The two cases of tests/test_search_by_sim3.py on the port's closer:
    the same expanded sets as JAX's closer."""
    cfg_j, mp_j, k1, k2, n_unique, n_pts = _build_two_kf_map()
    from orbslam2_tpu_torch.config import SlamConfig, Sensor, with_camera
    cfg_t = with_camera(SlamConfig(sensor=Sensor.RGBD, max_keyframes=8, max_points=2048),
                        fx=400.0, fy=400.0, cx=320.0, cy=240.0, width=640,
                        height=480, bf=40.0)
    arrays = {k: getattr(mp_j, k) for k in mp_j._ARRAY_FIELDS}
    arrays.update(next_kf_id=mp_j.next_kf_id, next_pt_id=mp_j.next_pt_id)
    mp_t = map_from_numpy(arrays, cfg_t)
    jl = JLoopCloser(cfg_j, mp_j, kf_db=None, local_mapper=None)
    tl = LoopCloser(cfg_t, mp_t, kf_db=None, global_ba=RecordingGBA(),
                    device="cpu")
    i1 = np.arange(n_unique)
    R = np.eye(3) if case == "expands" else np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1.0]])
    ej = jl._search_by_sim3(k1, k2, 1.0, R, np.zeros(3), i1, i1.copy())
    et = tl._search_by_sim3(k1, k2, 1.0, R, np.zeros(3), i1, i1.copy())
    for a, b in zip(et, ej):
        np.testing.assert_array_equal(a, b)
    if case == "expands":
        assert len(et[0]) > n_unique + 0.6 * (n_pts - n_unique)
        assert (et[0][n_unique:] == et[1][n_unique:]).all()
    else:
        assert len(et[0]) == n_unique


def test_detect_same_candidates():
    """_detect over the last 8 keyframes the JAX closer processed, in the
    same order, on the caught map: the same candidate lists step by step
    (the consistency chaining included)."""
    state = jax_loop_state()
    jl, tl = closers(state)
    seq = [k for k in state["processed"] if tl.map.kf_valid[k]][-8:]
    got = []
    for k in seq:
        cj, ct = jl._detect(k), tl._detect(k)
        assert ct == cj, (k, ct, cj)
        got.append(ct)
        assert [(sorted(g), c) for g, c in tl.prev_groups] == \
               [(sorted(g), c) for g, c in jl.prev_groups]
    assert any(got), "no keyframe of the sequence had a consistent candidate"


@functools.lru_cache(maxsize=1)
def jax_correction():
    """The JAX closer's _loop_support and _correct_loop with the caught
    closure on the caught map: its support, the state before its pose-graph
    optimization, that optimization's inputs and outputs, and the closer."""
    from orbslam2_tpu import loop_closing as JLC
    state = jax_loop_state()
    jl, _ = closers(state)
    kf, kc, s12, R12, t12 = state["loop"]
    out = dict(support=jl._loop_support(kf, kc, s12, R12, t12))
    solve = JLC.PG.optimize_pose_graph

    def caught(*args, **kw):
        mp = jl.map
        out["before"] = (mp.kf_pose.copy(), mp.pt_xyz.copy(), mp.kf_pt.copy())
        out["args"] = [np.array(a) for a in args]
        res = solve(*args, **kw)
        out["result"] = [np.array(r) for r in res]
        return res

    JLC.PG.optimize_pose_graph = caught
    try:
        jl._correct_loop(kf, kc, s12, R12, t12)
    finally:
        JLC.PG.optimize_pose_graph = solve
    out["closer"] = jl
    return out


def test_correct_loop(monkeypatch):
    """_loop_support, then _correct_loop with the JAX closure's Sim(3) on
    the port's closer: the same support matches; after the propagation,
    the point remap, the loop-point fusion and SearchAndFuse the same
    observations, fusion count and loop connections, poses and points
    within 1e-4; the same essential graph handed to the pose-graph solver
    (edges exact, measurements and poses 1e-4); given JAX's solution, the
    same written-back map (1e-4). Both launch the global BA at the loop
    keyframe."""
    from orbslam2_tpu_torch import loop_closing as TLC
    state = jax_loop_state()
    jc = jax_correction()
    jl = jc["closer"]
    _, tl = closers(state)
    kf, kc, s12, R12, t12 = state["loop"]
    assert tl._loop_support(kf, kc, s12, R12, t12) == jc["support"] >= 40
    for a, c in zip(tl._support_matches, state["support"]):
        np.testing.assert_array_equal(a, c)
    seen = {}

    def given(*args, **kw):
        mp = tl.map
        seen["before"] = (mp.kf_pose.copy(), mp.pt_xyz.copy(), mp.kf_pt.copy())
        seen["args"] = [a.numpy() for a in args]
        return tuple(torch.from_numpy(r) for r in jc["result"])

    monkeypatch.setattr(TLC.PG, "optimize_pose_graph", given)
    tl._correct_loop(kf, kc, s12, R12, t12)

    (pj, xj, kj), (pt, xt, kt) = jc["before"], seen["before"]
    np.testing.assert_array_equal(kt, kj)
    live = np.flatnonzero(jl.map.kf_valid)
    np.testing.assert_allclose(pt[live], pj[live], atol=1e-4)
    pts = np.flatnonzero(jl.map.pt_valid)
    np.testing.assert_allclose(xt[pts], xj[pts], atol=1e-4)
    assert tl.n_loop_fused == jl.n_loop_fused > 0
    assert tl.last_pgo_edges == jl.last_pgo_edges
    assert tl.last_pgo_edges["n_loop_conn"] >= 1
    for a, b in zip(seen["args"], jc["args"]):
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, atol=1e-4)
    _same_map(jl.map, tl.map, atol=1e-4)
    assert tl.loop_edges == jl.loop_edges == [(kf, kc)]
    assert tl.global_ba.launches == jl.global_ba.launches == [kc]
    np.testing.assert_array_equal(tl.map.pt_desc, desc_u32_to_i32(jl.map.pt_desc))


def test_essential_graph_solver():
    """optimize_pose_graph on the essential graph the JAX closer built for
    the caught closure (one fixed keyframe, spanning tree, strong
    covisibility, the loop edge and the post-fuse loop connections): the
    same first and final cost, poses within the flat valley's spread (see
    the module docstring)."""
    from orbslam2_tpu_torch.ops import pose_graph as TPG
    jc = jax_correction()
    args, (sj, Rj, tj, cj) = jc["args"], jc["result"]
    st, Rt, tt, ct = (x.numpy() for x in TPG.optimize_pose_graph(
        *(torch.from_numpy(a) for a in args), iters=20))
    np.testing.assert_allclose(ct[0], cj[0], rtol=1e-4)
    np.testing.assert_allclose(ct[-1], cj[-1], rtol=1e-2)
    assert ct[-1] < 0.5 * ct[0]
    free = ~args[3]
    np.testing.assert_allclose(st[free], sj[free], atol=5e-3)
    np.testing.assert_allclose(Rt[free], Rj[free], atol=5e-3)
    np.testing.assert_allclose(tt[free], tj[free], atol=0.02)
    np.testing.assert_array_equal(Rt[~free], args[1][~free])
