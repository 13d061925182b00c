"""The port's endurance artifacts (docs/artifacts/torch/endurance_*.json,
each the last line of `python3 -m orbslam2_tpu_torch.endurance_run` on the
card) held to the JAX artifacts' gates: tests/test_endurance_artifact.py's
own checks, imported as a module and called on each file (tracked >= frames
- 10, the sensor's closures and ATE bound, a GBA applied, keyframes culled,
every closure's invariants). Each artifact's `device` names the card, and
the RGB-D and stereo runs are present."""
from pathlib import Path

import pytest

import test_endurance_artifact as ref

ARTIFACTS = sorted((Path(__file__).resolve().parent.parent / "docs" / "artifacts"
                    / "torch").glob("endurance_*.json"))


@pytest.mark.parametrize("path", ARTIFACTS, ids=lambda p: p.stem)
def test_torch_endurance_artifact(path):
    ref.test_endurance_artifact(path)
    a = ref._load(path)
    # nvidia-smi's "name, power limit" of the card that ran it
    name, _, limit = a["device"].rpartition(", ")
    assert name.startswith("NVIDIA") and limit.endswith(" W"), a["device"]
    assert set(a["launches"]) == {"hamming_matrix", "hamming_best2", "bow_assign"}
    assert a["launches"]["hamming_best2"].get("loop", 0) > 0


def test_torch_artifacts_present():
    sensors = {ref._load(p)["sensor"] for p in ARTIFACTS}
    assert {"rgbd", "stereo"} <= sensors, sensors
