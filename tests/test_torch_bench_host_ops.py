"""The port's host-bookkeeping probe (orbslam2_tpu_torch/utils/bench_host_ops.py)
against the JAX package's scripts/bench_host_ops.py, loaded with importlib:
the same seeded map, the same four operations' results, the JAX table plus
the numpy fallback's columns, and the fallback's results equal to the
native library's."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

from orbslam2_tpu_torch import native
from orbslam2_tpu_torch.interop import desc_i32_to_u32
from orbslam2_tpu_torch.utils import bench_host_ops as TB

ROOT = Path(__file__).resolve().parent.parent
K = 50
STATS = ("pt_desc", "pt_normal", "pt_min_dist", "pt_max_dist")


def jax_script():
    spec = importlib.util.spec_from_file_location("jax_bench_host_ops",
                                                  ROOT / "scripts" / "bench_host_ops.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def results(mp) -> dict:
    """What the four operations return (refresh_point_stats: the point
    statistics it writes), on the last keyframe as the probes time them."""
    k = mp.n_keyframes - 1
    bound = np.unique(mp.kf_pt[k][mp.kf_pt[k] >= 0])
    out = {"covis_weights": np.asarray(mp.covisibility_weights(k)),
           "covis_matrix": np.asarray(mp.covis_matrix()),
           "point_obs_count": np.asarray(mp.point_obs_count())}
    mp.refresh_point_stats(bound)
    for f in STATS:
        out[f] = getattr(mp, f)[bound].copy()
    out["pt_desc"] = out["pt_desc"].view(np.uint32)
    return out


@pytest.fixture(scope="module")
def maps():
    assert native.available()
    return jax_script().build(K)[0], TB.build(K)[0]


def test_build_gives_the_jax_map(maps):
    jm, tm = maps
    np.testing.assert_array_equal(tm.kf_pt, jm.kf_pt)
    np.testing.assert_array_equal(tm.kf_valid, jm.kf_valid)
    np.testing.assert_array_equal(tm.pt_xyz, jm.pt_xyz)
    np.testing.assert_array_equal(tm.kf_pose, jm.kf_pose)
    np.testing.assert_array_equal(desc_i32_to_u32(tm.pt_desc), jm.pt_desc)
    np.testing.assert_array_equal(desc_i32_to_u32(tm.kf_desc), jm.kf_desc)


def test_operations_agree_with_jax(maps):
    got, want = results(maps[1]), results(maps[0])
    for name, x in want.items():
        np.testing.assert_array_equal(got[name], x, err_msg=name)


def test_numpy_fallback_gives_the_native_results():
    mp_native, mp_numpy = TB.build(K)[0], TB.build(K)[0]
    want = results(mp_native)
    with native.withheld():
        assert not native.available()
        assert native.covis_matrix(mp_numpy.kf_pt, mp_numpy.kf_valid, 1) is None
        got = results(mp_numpy)
    assert native.available()
    for name, x in want.items():
        np.testing.assert_array_equal(got[name], x, err_msg=name)


def test_main_prints_the_jax_table_and_the_numpy_columns(capsys):
    assert TB.main(keyframes=(K,)) == 0
    lines = capsys.readouterr().out.splitlines()
    head = [c.strip() for c in lines[0].strip("|").split("|")]
    assert head == ["K keyframes", "covis_weights ms", "covis_matrix ms",
                    "refresh_point_stats ms", "point_obs_count ms"] + [
        f"{name} ms (numpy)" for name in TB.OPS]
    assert lines[1] == "|" + "---|" * 9
    row = [c.strip() for c in lines[2].strip("|").split("|")]
    assert row[0] == str(K) and len(row) == 9
    assert all(float(c) >= 0 for c in row[1:])
