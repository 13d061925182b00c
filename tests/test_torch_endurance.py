"""The port's endurance run (orbslam2_tpu_torch/endurance_run.py) against
the JAX package's scripts/endurance_run.py, on the CPU at a cut size: 24
frames of the RGB-D corridor circuit at 640x480 (0.05 laps of radius 8),
each package's production combination (block driver, async mapper, loop
closer, background GBA).

- The JSON line: the port prints every key of the JAX script's line plus
  its two additions, `launches` (the hand kernels' launches by caller;
  nothing on the CPU, where the wrappers run their plain versions) and
  `max_keyframes`; both track 24/24; the keyframe counts agree within
  KF_TOL (the async mapper's keyframe schedule depends on timing, ROADMAP
  queue 3).
- The closure wrapper: on a stubbed `_correct_loop`, each closure's record
  has the keys of the JAX artifacts' closures and the numbers of the call.
"""
import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np

import torch_slice_common  # noqa: F401  (caps torch's threads under xdist)
from orbslam2_tpu_torch import endurance_run

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402
CUT = ["--sensor", "rgbd", "--frames", "24", "--laps", "0.05"]
KF_TOL = 3
PORT_KEYS = {"launches", "max_keyframes"}


def _last_json(text: str) -> dict:
    return json.loads([ln for ln in text.splitlines() if ln.startswith("{")][-1])


def test_endurance_run_matches_the_jax_script():
    # JAX's script in its own process, beside the port's run in this one
    jax_proc = subprocess.Popen(
        [sys.executable, str(ROOT / "scripts" / "endurance_run.py"), "--cpu", *CUT],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    try:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = endurance_run.main(["--device", "cpu", *CUT])
        out, err = jax_proc.communicate(timeout=900)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.wait()
    assert rc == 0 and jax_proc.returncode == 0, err[-2000:]
    port, jax = _last_json(buf.getvalue()), _last_json(out)
    assert set(port) == set(jax) | PORT_KEYS and not PORT_KEYS & set(jax)
    assert set(chip_smoke.ENDURANCE_KEYS) == set(jax)  # what 10e holds the card's line to
    assert port["tracked"] == jax["tracked"] == 24
    assert (port["sensor"], port["frames"], port["laps"]) == (jax["sensor"], 24, 0.05)
    assert abs(port["keyframes"] - jax["keyframes"]) <= KF_TOL, (port, jax)
    assert port["kf_created_total"] - port["kf_culled"] == port["keyframes"]
    assert port["device"] == "cpu" and port["max_keyframes"] == 512
    assert port["launches"] == {"hamming_matrix": {}, "hamming_best2": {}, "bow_assign": {},
                                "seg_sum": {}, "schur_matvec": {}, "ba_edges": {}}
    assert port["ate_m"] < 0.05 and jax["ate_m"] < 0.05


def test_closure_record_on_a_stubbed_correct_loop():
    """record_closures wraps `_correct_loop`: the call goes through with its
    arguments and result, and the record holds the frame it fired at, the
    pair, the scale, the ATE before and after, the essential-graph census
    and the fused points, under the keys of the JAX artifacts' closures."""
    calls = []

    def correct(kf, kc, s12, R12, t12):
        calls.append((kf, kc, s12))
        lc.last_pgo_edges = {"n_edges": 42, "n_loop_conn": 3}
        lc.n_loop_fused = 17
        return "corrected"

    lc = SimpleNamespace(_correct_loop=correct, last_pgo_edges={}, n_loop_fused=0)
    slam = SimpleNamespace(loop_closer=lc, tracker=SimpleNamespace(frame_log=[None] * 481))
    ates = iter([0.06244, 0.07481])
    closures = endurance_run.record_closures(slam, lambda: next(ates))
    out = lc._correct_loop(np.int64(57), np.int64(0), np.float32(1.0),
                           np.eye(3), np.zeros(3))
    assert out == "corrected" and calls == [(57, 0, 1.0)]
    (rec,) = closures
    assert rec == {"at_frame": 481, "kf": 57, "kc": 0, "scale": 1.0, "ate_pre_m": 0.0624,
                   "ate_post_m": 0.0748, "pgo_edges": {"n_edges": 42, "n_loop_conn": 3},
                   "fused": 17}
    artifact = _last_json((ROOT / "docs/artifacts/endurance_r5_rgbd.json").read_text())
    assert set(rec) == set(artifact["closures"][0])
    assert json.loads(json.dumps(rec)) == rec
