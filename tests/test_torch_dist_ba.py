"""The port's distributed solvers (orbslam2_tpu_torch/parallel/) over gloo
ranks on the CPU, against the JAX package's on its 8-device CPU mesh
(tests/conftest.py) and against the port's unsharded solvers.

The ranks are processes started by tests/torch_dist_workers.run_ranks (1, 2
and 4 of them, a file store under the test's temporary directory, one torch
thread each); they import neither JAX nor this module.

Tolerances:
- sharded BA against JAX's dist_ba_solve on 8 devices: JAX's own between its
  sharded and unsharded solves (tests/test_dist_ba.py): cam_T within rtol
  1e-4 and atol 1e-5, cost within rtol 1e-3;
- sharded BA against the port's ba_solve(solver="cg") in one process: the
  partial sums are the single process's, in float32, and the cross-rank sum
  is taken in float64 (parallel/collectives.py), so one rank is the
  unsharded solve bit for bit; at 2 and 4 ranks only the order of the
  camera sums differs, but this monocular problem (one camera fixed) has a
  free scale and a weak yaw, along which such differences and the LM's
  accept decisions near convergence (cost steps of one float32 ulp) move
  the cameras: at 2 ranks on seed 3 the scale by 2.0e-4 and the rotations
  by 4.4e-5. The cameras are therefore held to rotations within 1e-4 and
  translations within 5e-4 m (the largest is 1.24 m), the cost within 1e-5
  relative, the inlier masks on >= 99.9% of edges;
- every rank holds the same cameras, points, inliers and cost, bit for bit
  (they are all-reduced or all-gathered);
- sharded PGO (K = 64, 10 Gauss-Newton iterations) against one rank and
  against JAX's dist_pose_graph on 8 devices: JAX's tolerances, t within
  atol 2e-2, svals within 1e-3;
- the global BA's distributed branch at 2 ranks against the port's
  single-process GlobalBA on the same map: poses within 1e-4
  (tests/test_torch_global_ba.py).
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_tpu.config import SlamConfig as JConfig, Sensor as JSensor
from orbslam2_tpu.ops import ba as JBA
from orbslam2_tpu.parallel.dist_ba import dist_ba_solve as j_dist_ba_solve, make_mesh
from orbslam2_tpu.parallel.dist_pgo import dist_pose_graph as j_dist_pose_graph
from orbslam2_tpu_torch.config import SlamConfig, Sensor
from orbslam2_tpu_torch.global_ba import GlobalBA
from orbslam2_tpu_torch.map.mapstate import MapState
from orbslam2_tpu_torch.ops import ba as TBA
from orbslam2_tpu_torch.ops import pose_graph as TPG
from orbslam2_tpu_torch.parallel import dist_ba

import torch_dist_workers as W
from __graft_entry__ import _make_pgo_problem
from test_dist_ba import synth_problem
from test_global_ba import _build_map, _pose_err
from test_torch_global_ba import port_map

WORLDS = (1, 2, 4)
PGO_ITERS = 10


def _arrays(prob):
    return {k: np.asarray(getattr(prob, k)) for k in prob._fields}


def _cases():
    out = {}
    for name, seed in (("synth", 0), ("seed3", 3)):
        prob, cams_gt, (fx, fy, cx, cy) = synth_problem(seed=seed)
        out[name] = (_arrays(prob), (fx, fy, cx, cy, 0.0), {})
    return out


@pytest.fixture(scope="module")
def cases():
    return _cases()


@pytest.fixture(scope="module")
def pgo():
    return _make_pgo_problem(K=64)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, cases, pgo):
    """The solvers at 1, 2 and 4 ranks: world -> [rank -> results]."""
    out = {}
    for world in WORLDS:
        work = W.run_ranks(W.solvers, world, tmp_path_factory.mktemp(f"w{world}"),
                           cases, pgo, PGO_ITERS)
        out[world] = {
            "ba": {name: [dict(np.load(work / f"ba_{name}_{r}.npz")) for r in range(world)]
                   for name in cases},
            "pgo": [dict(np.load(work / f"pgo_{r}.npz")) for r in range(world)],
            "counts": json.loads((work / "counts.json").read_text())}
    return out


@pytest.fixture(scope="module")
def jax_ba(cases):
    res = {}
    for name, (arrays, intr, _) in cases.items():
        prob = JBA.BAProblem(**{k: jnp.asarray(v) for k, v in arrays.items()})
        r = j_dist_ba_solve(prob, make_mesh(8), *intr)
        res[name] = (np.asarray(r.cam_T), float(r.cost))
    return res


@pytest.fixture(scope="module")
def single_ba(cases):
    return {name: TBA.ba_solve(TBA.problem_from_numpy(arrays, torch.device("cpu")),
                               *intr, solver="cg")
            for name, (arrays, intr, _) in cases.items()}


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_matches_jax_mesh(runs, jax_ba, world):
    j_cam, j_cost = jax_ba["synth"]
    r = runs[world]["ba"]["synth"][0]
    np.testing.assert_allclose(r["cam_T"], j_cam, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(r["cost"]), j_cost, rtol=1e-3)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_matches_single_process(runs, single_ba, cases, world):
    for name in cases:
        r, s = runs[world]["ba"][name][0], single_ba[name]
        if world == 1:  # the plan is the identity: the same sums in the same order
            for k in ("cam_T", "pts", "e_inlier", "cost"):
                np.testing.assert_array_equal(r[k], getattr(s, k).numpy(), err_msg=k)
            continue
        np.testing.assert_allclose(r["cam_T"][..., :3], s.cam_T.numpy()[..., :3],
                                   rtol=0, atol=1e-4)
        np.testing.assert_allclose(r["cam_T"][..., 3], s.cam_T.numpy()[..., 3],
                                   rtol=0, atol=5e-4)
        np.testing.assert_allclose(float(r["cost"]), float(s.cost), rtol=1e-5)
        assert (r["e_inlier"] == s.e_inlier.numpy()).mean() >= 0.999


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_hold_the_same_result(runs, cases, world):
    for name in cases:
        first = runs[world]["ba"][name][0]
        for other in runs[world]["ba"][name][1:]:
            for k in first:
                np.testing.assert_array_equal(other[k], first[k], err_msg=k)
    for other in runs[world]["pgo"][1:]:
        for k in other:
            np.testing.assert_array_equal(other[k], runs[world]["pgo"][0][k])


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_solution_quality(runs, world):
    _, cams_gt, _ = synth_problem(seed=3)
    err = np.abs(runs[world]["ba"]["seed3"][0]["cam_T"] - cams_gt).max()
    assert err < 0.02, err


@pytest.mark.parametrize("world", (1, 2, 3, 4, 8))
def test_shard_plan(cases, world):
    """Every edge lands on its point's owner, the padding is invalid, the
    index maps put every point and edge back, the cameras are whole."""
    arrays, _, _ = cases["synth"]
    p = TBA.problem_from_numpy(arrays, torch.device("cpu"))
    P, E = p.pts.shape[0], p.e_pt.shape[0]
    pt_seen, e_seen = [], []
    for rank in range(world):
        s = dist_ba.shard_problem(p, rank, world)
        lp, pi, ei = s.problem, s.pt_index[rank], s.edge_index[rank]
        for k in ("cam_T", "cam_fixed", "cam_valid"):
            assert torch.equal(getattr(lp, k), getattr(p, k))
        own = pi >= 0
        assert torch.equal(lp.pts[own], p.pts[pi[own]])
        assert not lp.pt_valid[~own].any()
        lo, hi = rank * P // world, (rank + 1) * P // world
        assert torch.equal(pi[own], torch.arange(lo, hi))
        real = ei >= 0
        assert not lp.e_valid[~real].any()
        g = ei[real]
        assert torch.equal(g, g.sort().values)  # the global order kept
        assert ((p.e_pt[g] >= lo) & (p.e_pt[g] < hi)).all()
        assert torch.equal(lp.e_pt[real] + lo, p.e_pt[g])
        for k in ("e_cam", "e_obs", "e_stereo", "e_info", "e_valid"):
            assert torch.equal(getattr(lp, k)[real], getattr(p, k)[g])
        pt_seen.append(pi[own])
        e_seen.append(g)
    assert torch.equal(torch.cat(pt_seen).sort().values, torch.arange(P))
    assert torch.equal(torch.cat(e_seen).sort().values, torch.arange(E))


@pytest.mark.parametrize("world", WORLDS)
def test_collective_counts(runs, world):
    """dist_ba: (iters1 + iters2) * (cg_iters + 2) all_reduce and one
    all_gather; dist_pgo: iters * (cg_iters + 1) all_reduce (the counts
    were taken at iters1=2, iters2=1, cg_iters=3 and iters=2, cg_iters=5)."""
    counts = runs[world]["counts"]
    assert counts["ba"] == [["all_gather", 1], ["all_reduce", (2 + 1) * (3 + 2)]]
    assert counts["pgo"] == [["all_reduce", 2 * (5 + 1)]]


@pytest.fixture(scope="module")
def pgo_refs(pgo):
    jres = j_dist_pose_graph(make_mesh(8), *(jnp.asarray(a) for a in pgo),
                             iters=PGO_ITERS)
    single = TPG.optimize_pose_graph(*(torch.from_numpy(np.asarray(a)) for a in pgo),
                                     iters=PGO_ITERS)
    return [np.asarray(x) for x in jres], [x.numpy() for x in single]


@pytest.mark.parametrize("world", WORLDS)
def test_dist_pgo_matches(runs, pgo_refs, world):
    r = runs[world]["pgo"][0]
    jax_ref, single = pgo_refs
    assert np.isfinite(r["t"]).all()
    if world == 1:
        for k, ref in zip(("svals", "R", "t", "costs"), single):
            np.testing.assert_array_equal(r[k], ref, err_msg=k)
    for ref in (single, jax_ref):
        np.testing.assert_allclose(r["t"], ref[2], atol=2e-2)
        np.testing.assert_allclose(r["svals"], ref[0], atol=1e-3)


@pytest.mark.parametrize("world", WORLDS)
def test_dist_pgo_reduces_loop_drift(runs, world):
    costs = runs[world]["pgo"][0]["costs"]
    assert costs[-1] < 0.2 * costs[0], costs


def test_group_none_issues_no_collective(cases, pgo, monkeypatch):
    """Without a group the solvers call no torch.distributed function (and
    need no initialized process group): one rank's bit-exact match above
    shows that the hook path sums as the unsharded path does."""
    import torch.distributed as dist

    def refuse(*a, **k):
        raise AssertionError("a collective without a group")

    for name in ("all_reduce", "all_gather", "broadcast", "get_rank", "get_world_size"):
        monkeypatch.setattr(dist, name, refuse)
    arrays, intr, _ = cases["synth"]
    for solver in ("dense", "cg"):
        TBA.ba_solve(TBA.problem_from_numpy(arrays, torch.device("cpu")), *intr,
                     iters1=1, iters2=1, solver=solver)
    TPG.optimize_pose_graph(*(torch.from_numpy(np.asarray(a)) for a in pgo), iters=2)


def test_sharded_solve_refuses_the_dense_step(cases):
    arrays, intr, _ = cases["synth"]
    p = TBA.problem_from_numpy(arrays, torch.device("cpu"))
    with pytest.raises(ValueError, match="solver='cg'"):
        TBA.ba_solve(p, *intr, solver="dense", group=object())


# --- the global BA's distributed branch (tests/test_global_ba.py:164-189) ---

@pytest.fixture(scope="module")
def gba_run(tmp_path_factory):
    jcfg = JConfig(sensor=JSensor.MONOCULAR, max_keyframes=32, max_points=1024)
    cfg = SlamConfig(sensor=Sensor.MONOCULAR, max_keyframes=32, max_points=1024)
    jmp, poses_gt, _, _ = _build_map(jcfg)
    work = tmp_path_factory.mktemp("gba")
    path = work / "map.npz"
    port_map(jmp, cfg).save(path)
    W.run_ranks(W.global_ba, 2, work, str(path), cfg)
    single = MapState.load(path, cfg)
    gba = GlobalBA(cfg, single, device="cpu")
    gba.launch(fixed_kf=0, chunks=2, chunk_iters=(1, 2), background=False)
    assert gba.poll()
    return dict(np.load(work / "gba.npz")), json.loads(
        (work / "served_1.json").read_text()), single, MapState.load(path, cfg), poses_gt


def test_gba_takes_the_distributed_branch(gba_run):
    res, served, _, start, poses_gt = gba_run
    assert res["dispatch"].tolist() == [2]
    assert bool(res["applied"])
    assert served == [2, 1]  # rank 1 joined both chunks, then chunk 0 of the aborted solve
    before = _pose_err(start, poses_gt, range(1, 8))
    after = max(float(np.abs(res["kf_pose"][k] - poses_gt[k]).max()) for k in range(1, 8))
    assert after < 0.4 * before


def test_gba_distributed_matches_single_process(gba_run):
    res, _, single, _, _ = gba_run
    np.testing.assert_allclose(res["kf_pose"][..., :3], single.kf_pose[..., :3], atol=1e-4)
    np.testing.assert_allclose(res["kf_pose"][..., 3], single.kf_pose[..., 3],
                               rtol=1e-4, atol=1e-4)
    live = np.flatnonzero(single.pt_valid)
    np.testing.assert_allclose(res["pt_xyz"][live], single.pt_xyz[live], rtol=1e-4,
                               atol=1e-4)


def test_gba_abort_stops_both_ranks(gba_run):
    res, served, _, _, _ = gba_run
    assert int(res["aborted"]) == 1 and not bool(res["aborted_applied"])
    assert served[-1] == 1
    np.testing.assert_array_equal(res["abort_after"], res["abort_before"])
