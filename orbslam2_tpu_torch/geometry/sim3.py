"""Sim(3) similarity transforms on tensors, for loop closure.

Counterpart of orbslam2_tpu/geometry/sim3.py (g2o's Sim3 Lie group,
Thirdparty/g2o/g2o/types/sim3.h). A Sim3 S = (s, R, t) acts as
x' = s * R @ x + t and is a dict of tensors {"s": [...], "R": [..., 3, 3],
"t": [..., 3]}; every function broadcasts over the leading batch axes.

The 7-dof tangent [v(3), w(3), sigma(1)] (sigma = log s) is the pose-graph
optimizer's parameterization (ops/pose_graph.py), as g2o::Sim3's exp/log in
Optimizer::OptimizeEssentialGraph (src/Optimizer.cpp:944-1260). The closed
form of exp follows Ethan Eade's Lie-group notes, with Taylor limits near
sigma = 0 and theta = 0: both branches are computed on safe inputs and
picked with torch.where, so neither can produce an inf or a NaN.
"""
from __future__ import annotations

import torch

from . import se3

_EPS = 1e-8


def make(s, R, t) -> dict:
    return {"s": torch.as_tensor(s, dtype=R.dtype, device=R.device), "R": R, "t": t}


def identity(dtype=torch.float32, device="cpu") -> dict:
    return make(torch.ones((), dtype=dtype, device=device),
                torch.eye(3, dtype=dtype, device=device),
                torch.zeros(3, dtype=dtype, device=device))


def from_se3(T: torch.Tensor) -> dict:
    return make(torch.ones(T.shape[:-2], dtype=T.dtype, device=T.device),
                se3.rot(T), se3.trans(T))


def to_se3(S: dict) -> torch.Tensor:
    """Demote to SE(3) by t / s (the reference's SE3 demotion,
    src/LoopClosing.cpp:634-645)."""
    return se3.make_T(S["R"], S["t"] / S["s"][..., None])


def apply(S: dict, pts: torch.Tensor) -> torch.Tensor:
    """(..., N, 3) -> (..., N, 3): s R x + t."""
    return (S["s"][..., None, None] * (pts @ S["R"].transpose(-1, -2))
            + S["t"][..., None, :])


def compose(Sa: dict, Sb: dict) -> dict:
    """Sa ∘ Sb: x -> Sa(Sb(x))."""
    s = Sa["s"] * Sb["s"]
    R = Sa["R"] @ Sb["R"]
    t = Sa["s"][..., None] * (Sa["R"] @ Sb["t"][..., None])[..., 0] + Sa["t"]
    return make(s, R, t)


def inverse(S: dict) -> dict:
    s_inv = 1.0 / S["s"]
    Rt = S["R"].transpose(-1, -2)
    t = -s_inv[..., None] * (Rt @ S["t"][..., None])[..., 0]
    return make(s_inv, Rt, t)


def _V_coeffs(w: torch.Tensor, sigma: torch.Tensor):
    """Coefficients (A, B, C) of V = A I + B W + C W^2 for Sim(3) exp.

    A = (s-1)/sigma
    B = (sigma s sin(th) + (1 - s cos(th)) th) / (th (sigma^2 + th^2))
    C = (A - ((s cos(th) - 1) sigma + s sin(th) th) / (sigma^2 + th^2)) / th^2
    with Taylor limits at sigma->0 and th->0 (W ~ 0 there, so B, C precision
    barely matters in the th->0 branch)."""
    s = torch.exp(sigma)
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS)
    small_sig = sigma.abs() < 1e-5
    small_th = theta2 < 1e-8

    sig_safe = torch.where(small_sig, 1.0, sigma)
    A = torch.where(small_sig, 1.0 + sigma / 2.0 + sigma * sigma / 6.0,
                    (s - 1.0) / sig_safe)

    th_safe = torch.where(small_th, 1.0, theta)
    denom = sigma * sigma + theta2
    denom_safe = torch.where(denom < _EPS, 1.0, denom)
    sc, ss = s * torch.cos(theta), s * torch.sin(theta)

    B_gen = (sigma * ss + (1.0 - sc) * th_safe) / (th_safe * denom_safe)
    B_sm = torch.where(small_sig, 0.5 + sigma / 3.0,
                       (sigma * s - s + 1.0) / (sig_safe * sig_safe))
    B = torch.where(small_th, B_sm, B_gen)

    C_gen = (A - ((sc - 1.0) * sigma + ss * th_safe) / denom_safe) / torch.where(
        small_th, 1.0, theta2)
    C = torch.where(small_th, 1.0 / 6.0 + sigma / 8.0, C_gen)
    return A, B, C


def _V_matrix(w: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    A, B, C = _V_coeffs(w, sigma)
    W = se3.hat(w)
    W2 = W @ W
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return A[..., None, None] * eye + B[..., None, None] * W + C[..., None, None] * W2


def exp(xi: torch.Tensor) -> dict:
    """(..., 7) [v, w, sigma] -> Sim3."""
    v, w, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    R = se3.so3_exp(w)
    t = (_V_matrix(w, sigma) @ v[..., None])[..., 0]
    return make(torch.exp(sigma), R, t)


def log(S: dict) -> torch.Tensor:
    """Sim3 -> (..., 7) [v, w, sigma], the inverse of exp (solves V v = t;
    without the solver's error check, which would wait for the device)."""
    sigma = torch.log(S["s"])
    w = se3.so3_log(S["R"])
    V = _V_matrix(w, sigma)
    v = torch.linalg.solve_ex(V, S["t"][..., None], check_errors=False)[0][..., 0]
    return torch.cat([v, w, sigma[..., None]], dim=-1)


def retract(S: dict, xi: torch.Tensor) -> dict:
    """Left-multiplicative update exp(xi) ∘ S (pose-graph parameterization)."""
    return compose(exp(xi), S)
