"""A seeded bundle-adjustment problem: cameras on a forward track observing
points drawn uniformly over (camera, point) pairs.

Frozen from the port's generator (orbslam2_tpu_torch/ops/ba.py
`synthetic_problem`, itself the JAX package's `_make_ba_problem`), with every
number taken from the configuration instead of from the code:

- `settings`: the intrinsics `Camera.fx`, `.fy`, `.cx`, `.cy` and `.bf`;
- `problem`: `cameras`, `points`, `observations`, `stereo_share` (the share
  of observations with a right-image coordinate) and `noise_px` (Gaussian
  noise on (u, v));
- `scene`: `track_step_m` (forward distance between cameras, the first held
  fixed), `lateral_step_m` (sideways drift a camera), `points_x_m`,
  `points_y_m` (ranges across and up), `points_ahead_m` (range ahead of the
  track), `min_depth_m` (an observation is re-drawn where its point lies
  nearer its camera), `pose_noise_m`, `point_noise_m` (the start's
  distance from the truth).

The same steps and distributions as the original, drawn on the device from
one seeded `torch.Generator`, so that a million observations take
milliseconds instead of seconds of numpy; the draws are therefore not the
original's.
"""
from __future__ import annotations

import torch

FIELDS = ("cam_T", "cam_fixed", "cam_valid", "pts", "pt_valid", "e_cam", "e_pt",
          "e_obs", "e_stereo", "e_info", "e_valid")


def make(config: dict, seed: int, device) -> dict:
    """The problem as tensors on `device`, named as the port's BAProblem
    fields (edge indices int64), plus "intrinsics": (fx, fy, cx, cy, bf)."""
    s, c, sc = config["settings"], config["problem"], config["scene"]
    fx, fy, cx, cy, bf = (float(s[f"Camera.{k}"]) for k in ("fx", "fy", "cx", "cy", "bf"))
    C, P, E = c["cameras"], c["points"], c["observations"]
    device = torch.device(device)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    f32 = dict(dtype=torch.float32, device=device)

    def uniform(lo_hi, *shape):
        lo, hi = lo_hi
        return lo + (hi - lo) * torch.rand(shape, generator=g, **f32)

    step = sc["track_step_m"]
    along = uniform((0.0, C * step), P)
    pts = torch.stack([uniform(sc["points_x_m"], P), uniform(sc["points_y_m"], P),
                       along + uniform(sc["points_ahead_m"], P)], -1)
    i = torch.arange(C, **f32)
    cams = torch.zeros(C, 3, 4, **f32)
    cams[:, :3, :3] = torch.eye(3, **f32)
    cams[:, 0, 3] = sc["lateral_step_m"] * i
    cams[:, 2, 3] = -step * i
    e_cam = torch.randint(0, C, (E,), generator=g, device=device)
    e_pt = torch.randint(0, P, (E,), generator=g, device=device)
    near = sc["min_depth_m"]

    def visible():
        pc = torch.einsum("eij,ej->ei", cams[e_cam, :, :3], pts[e_pt]) + cams[e_cam, :, 3]
        return pc, pc[:, 2] > near

    pc, ok = visible()
    for _ in range(8):  # re-draw the observations behind their camera
        bad = ~ok
        # drawn for every edge and kept where bad, so the draws do not
        # depend on how many are bad (no readback)
        e_cam = torch.where(bad, torch.randint(0, C, (E,), generator=g, device=device), e_cam)
        e_pt = torch.where(bad, torch.randint(0, P, (E,), generator=g, device=device), e_pt)
        pc, ok = visible()
    z = pc[:, 2].clamp(min=near)
    u = fx * pc[:, 0] / z + cx
    obs = torch.stack([u, fy * pc[:, 1] / z + cy, u - bf / z], -1)
    obs[:, :2] += c["noise_px"] * torch.randn((E, 2), generator=g, **f32)
    stereo = torch.rand(E, generator=g, **f32) < c["stereo_share"]
    shift = sc["pose_noise_m"] * torch.randn((C, 3), generator=g, **f32)
    shift[0] = 0.0
    cam_T = cams.clone()
    cam_T[:, :, 3] += shift
    return dict(
        cam_T=cam_T,
        cam_fixed=torch.arange(C, device=device) < 1,
        cam_valid=torch.ones(C, dtype=torch.bool, device=device),
        pts=pts + sc["point_noise_m"] * torch.randn((P, 3), generator=g, **f32),
        pt_valid=torch.ones(P, dtype=torch.bool, device=device),
        e_cam=e_cam, e_pt=e_pt, e_obs=obs, e_stereo=stereo & ok,
        e_info=torch.ones(E, **f32), e_valid=ok,
        intrinsics=(fx, fy, cx, cy, bf))
