"""chip_smoke.LapRecorder, which phase 8's failure message and the
`--lap-start` probe use, on the port's System on the CPU: the first frames
of phase 8's monocular corridor lap (640x480, as on the card), then a blank
frame that loses track. The recorder names the initialization frame, the
first frame that was not OK and the gate of Tracker._track_fused_finish that
dropped it, and records the initialization's BA and the first two local
BAs (map scale and cost); detaching restores the BA module."""
import sys
from pathlib import Path

import numpy as np

import torch_slice_common  # noqa: F401  (caps torch's threads under xdist)
from orbslam2_tpu_torch import local_mapping
from orbslam2_tpu_torch.config import Sensor
from orbslam2_tpu_torch.io import synth
from orbslam2_tpu_torch.system import System
from orbslam2_tpu_torch.utils.profile_frame import bench_config

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

N_TRACKED = 7   # the port initializes at frame 2 and runs local BAs at 5 and 6


def test_recorder_names_the_lost_frame_and_its_gate():
    scene = synth.make_corridor(seed=3)
    gt = synth.corridor_trajectory(chip_smoke.LOOP_FRAMES, radius=chip_smoke.LOOP_RADIUS)
    items = chip_smoke.render_corridor(synth, scene, gt[:N_TRACKED])
    items.append((N_TRACKED / 30.0, {"image": np.full((scene.height, scene.width), 128.0,
                                                      np.float32)}))
    solve = local_mapping.BA.ba_solve
    slam = System(bench_config(scene, Sensor.MONOCULAR), device="cpu", async_mapping=False)
    rec = chip_smoke.LapRecorder(slam, gt=gt)
    try:
        tracked = slam.run_sequence(iter(items), pipelined=False)
    finally:
        rec.detach()
        slam.shutdown()
    assert local_mapping.BA.ba_solve is solve
    assert rec.init_frame == 2 and tracked == N_TRACKED - rec.init_frame
    frame, gate = rec.first_loss
    assert frame == N_TRACKED
    assert gate.startswith("_track_fused_finish motion-model gate"), gate
    assert "TrackReferenceKeyFrame failed" in gate, gate
    assert rec.loss_line() == f"first frame not OK {N_TRACKED}: {gate}"
    assert [b["label"] for b in rec.bas] == ["init BA", "local BA 1", "local BA 2"]
    assert rec.bas[0]["frame"] == rec.init_frame
    for b in rec.bas:
        assert np.isfinite(b["cost"]) and b["cost"] > 0, b
        assert b["scale_before"] > 0 and b["scale_after"] > 0, b
    # the initialization scales the map to a median depth of 1 after its BA
    assert rec.bas[1]["scale_before"] != rec.bas[0]["scale_after"]
