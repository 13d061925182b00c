"""The generator of the GBA cells' input: repeatable by seed, and driven by
the configuration's numbers alone."""
import copy

import torch

from benchmark import harness as H
from benchmark.gen import ba_problem as GEN


def cut_config(cameras=16, points=512, observations=4096) -> dict:
    conf = copy.deepcopy(H.config("kitti00-gba-512"))
    conf["problem"].update(cameras=cameras, points=points, observations=observations)
    return conf


def test_ba_problem_repeats_by_seed_and_keeps_its_shape():
    conf = cut_config()
    a = GEN.make(conf, 2**31 + 3, "cpu")
    b = GEN.make(conf, 2**31 + 3, "cpu")
    c = GEN.make(conf, 2**31 + 4, "cpu")
    for k in GEN.FIELDS:
        assert torch.equal(a[k], b[k]), k
    assert not torch.equal(a["pts"], c["pts"])
    assert a["cam_T"].shape == (16, 3, 4) and a["e_obs"].shape == (4096, 3)
    assert a["e_cam"].dtype == torch.int64 and bool(a["cam_fixed"][0])
    # visible edges: the point in front of its camera, stereo only where valid
    pc = torch.einsum("eij,ej->ei", a["cam_T"][a["e_cam"], :, :3], a["pts"][a["e_pt"]])
    assert a["e_valid"].float().mean() > 0.95
    assert not bool((a["e_stereo"] & ~a["e_valid"]).any())
    assert 0.25 < float(a["e_stereo"].float().mean()) < 0.35
    assert float(pc[:, 2][a["e_valid"]].min()) > 0.5


def test_ba_problem_takes_its_numbers_from_the_configuration():
    conf = cut_config()
    s = conf["settings"]
    a = GEN.make(conf, 11, "cpu")
    assert a["intrinsics"] == (s["Camera.fx"], s["Camera.fy"], s["Camera.cx"],
                               s["Camera.cy"], s["Camera.bf"])
    shifted = copy.deepcopy(conf)
    shifted["settings"]["Camera.cx"] += 100.0
    b = GEN.make(shifted, 11, "cpu")
    assert torch.equal(a["e_cam"], b["e_cam"]) and torch.equal(a["e_pt"], b["e_pt"])
    assert torch.allclose(b["e_obs"][:, 0] - a["e_obs"][:, 0], torch.tensor(100.0), atol=1e-3)
    assert torch.allclose(b["e_obs"][:, 2] - a["e_obs"][:, 2], torch.tensor(100.0), atol=1e-3)
    assert torch.equal(b["e_obs"][:, 1], a["e_obs"][:, 1])
    longer = copy.deepcopy(conf)
    longer["scene"]["track_step_m"] = 2.0
    c = GEN.make(longer, 11, "cpu")
    assert abs(float(c["cam_T"][-1, 2, 3]) - (-2.0 * 15)) < 0.2
    assert abs(float(a["cam_T"][-1, 2, 3]) - (-0.8 * 15)) < 0.2
    assert H.generator(conf["generator"]).make(conf, 11, "cpu")["e_obs"].equal(a["e_obs"])
