"""Batched Schur-complement bundle adjustment (the g2o replacement).

Counterpart of orbslam2_tpu/ops/ba.py (Optimizer::LocalBundleAdjustment,
src/Optimizer.cpp:564-941, and the BundleAdjustment core, :44-304), which
replaces g2o's sparse BlockSolver_6_3 + OptimizationAlgorithmLevenberg:

- the linearization of every observation edge in one batch (mono and
  stereo edges unified, the mathematics of ops/ba_core.py): the kernel
  `ba_edges` of ops/cuda_kernels.py, one thread an edge, keeps each edge's
  residual, Jacobians and weight in registers and writes only its blocks
  (Hcc_e, bc_e, Hpp_e, bp_e, the coupling W [E,6,3], the weight and the
  cost term), once an LM iteration; the trial cost and the outlier
  classification run it without Jacobians. On the CPU its plain version;
- block assembly by segment sums over the edge list (`seg_sum`, the
  order-fixed kernel of ops/cuda_kernels.py, so a solve repeats itself bit
  for bit as the JAX package's does): Hcc [C,6,6], Hpp [P,3,3]. The edge
  structure is fixed through a solve, so the sums' plans (`BAPlans`) are
  built once a solve;
- point marginalization by batched 3x3 inverses (the reference's
  `setMarginalized(true)` Schur trick, src/Optimizer.cpp:707);
- the reduced camera system S = Hcc - W Hpp^-1 W^T either formed and solved
  by dense Cholesky, or solved matrix-free by block-Jacobi preconditioned
  conjugate gradient (the form that shards across devices), whose product
  S x is the order-fixed kernel pair `schur_matvec` (two passes over the
  edges, by point and by camera);
- Levenberg-Marquardt accept/reject as `torch.where` selects, in the
  reference's schedule: 5 iterations with Huber, the chi2 outlier cut
  (5.991 mono, 7.815 stereo), 10 more without (src/Optimizer.cpp:790-841).

Nothing is read back from the device inside a solve: the LM and CG
iterations are Python loops of device ops. On a card the CG loop of an
unsharded solve is a CUDA graph, captured once a problem shape and
replayed every LM iteration (`_CGGraph`): the host launches it once in
place of its 24 steps' vector ops.

Each phase is a span (utils/metrics.py), opened where its ops are launched:
`ba.solve`, `ba.plans`, `ba.lm` (an LM iteration), `ba.edge_terms` (every
`ba_edges` call: the LM's blocks, the trial cost, the classification),
`ba.assemble` (the block sums, the Hpp inverse and the Schur right-hand
side), `ba.pcg` with `ba.pcg.matvec` (one a CG step, where the loop runs
eagerly or is captured) and `ba.pcg.replay` (one a graph's replay: the
profiler puts the replayed kernels down to its `cudaGraphLaunch`) or
`ba.dense_schur`, `ba.apply` (back-substitution and accept/reject) and
`ba.classify`. While spans are recorded, a device trace's kernels and idle
gaps can be put down to the phase that launched them.

`group` shards the solve by point owner (parallel/dist_ba.py): each rank
holds its points and every edge of them, the cameras are replicated. The
camera-indexed sums (Hcc, the Schur rhs, the CG matvec) and the costs then
go through one all_reduce each (parallel/collectives.py); the point blocks
stay local; the LM accept/reject and the CG scalars are computed from
replicated values, so every rank takes the same branch.
"""
from __future__ import annotations

import threading
import weakref
from typing import NamedTuple

import numpy as np
import torch

from ..geometry import se3
from ..parallel import collectives as COL
from ..utils.device import upload
from ..utils.metrics import span, spanned
from . import ba_core as BC
from . import cuda_kernels as CK

_CHOL_BLOCK = 64    # rows of a diagonal block of the CPU Cholesky (_cholesky)


class BAProblem(NamedTuple):
    """Fixed-shape BA problem. Invalid edges/cameras/points are masked."""

    cam_T: torch.Tensor      # [C, 3, 4] Tcw
    cam_fixed: torch.Tensor  # [C] bool (pose held constant)
    cam_valid: torch.Tensor  # [C] bool
    pts: torch.Tensor        # [P, 3] world points
    pt_valid: torch.Tensor   # [P] bool
    e_cam: torch.Tensor      # [E] int64 camera index
    e_pt: torch.Tensor       # [E] int64 point index
    e_obs: torch.Tensor      # [E, 3] (u, v, u_r)
    e_stereo: torch.Tensor   # [E] bool
    e_info: torch.Tensor     # [E] float32 (1/sigma^2)
    e_valid: torch.Tensor    # [E] bool


class BAPlans(NamedTuple):
    """The segment-sum plans of a problem's edges: by camera, by point, and
    by (point, camera) pair for the dense Schur step's coupling G (None
    where the solve is the CG one); and the CG matvec's plan (None where
    the solve is the dense one)."""

    cam: CK.SegPlan
    pt: CK.SegPlan
    pair: CK.SegPlan | None
    schur: CK.SchurPlan | None


@spanned("ba.plans")
def ba_plans(p: BAProblem, dense: bool) -> BAPlans:
    """The plans of p's edges, built on p's device without a readback. Every
    edge is in them, the invalid ones too (they carry zero weight), so the
    order of a sum does not depend on the mask."""
    C, P = p.cam_T.shape[0], p.pts.shape[0]
    cam, pt = CK.seg_plan(p.e_cam, C), CK.seg_plan(p.e_pt, P)
    if dense:
        return BAPlans(cam, pt, CK.seg_plan(p.e_pt.long() * C + p.e_cam.long(), P * C), None)
    return BAPlans(cam, pt, None, CK.schur_plan(cam, pt))


class BAResult(NamedTuple):
    cam_T: torch.Tensor
    pts: torch.Tensor
    e_inlier: torch.Tensor   # [E] final chi2 classification
    cost: torch.Tensor


@spanned("ba.edge_terms")
def _edge_terms(p: BAProblem, cam_T, pts, e_active, fx, fy, cx, cy, bf, robust,
                mode: str):
    """One `ba_edges` call over every edge in `mode` ("blocks", "cost" or
    "chi2"): its outputs, the per-edge cost summed to the objective."""
    terms = CK.ba_edges(mode, cam_T, pts, p.e_cam, p.e_pt, p.e_obs, p.e_stereo,
                        p.e_info, e_active, (fx, fy, cx, cy, bf), robust)
    if mode == "chi2":
        return terms
    return (*terms[:-1], torch.sum(terms[-1]))


def _cholesky(S: torch.Tensor) -> torch.Tensor:
    """The lower Cholesky factor of the reduced camera system S (not
    checked: a factor of a system that is not positive definite gives a
    non-finite step, which the caller zeroes). On a card, cuSOLVER's. On
    the CPU, by diagonal blocks of _CHOL_BLOCK in a fixed order: LAPACK's
    threaded factorization (MKL's potrf at 4 threads) returned other bits
    for one S from one solve to the next at 384 rows (64 cameras, the
    mapper's largest local window; not at 96 or 192), which made two runs
    of the inline mapper part on the CPU (ROADMAP F4). A block this small
    is factored without threads, and the panel solves and updates repeat."""
    if S.device.type != "cpu":
        return torch.linalg.cholesky_ex(S, check_errors=False)[0]
    n = S.shape[0]
    L = torch.zeros_like(S)
    for j in range(0, n, _CHOL_BLOCK):
        e = min(j + _CHOL_BLOCK, n)
        L[j:e, j:e] = torch.linalg.cholesky_ex(
            S[j:e, j:e] - L[j:e, :j] @ L[j:e, :j].T, check_errors=False)[0]
        if e < n:
            panel = S[e:, j:e] - L[e:, :j] @ L[j:e, :j].T
            L[e:, j:e] = torch.linalg.solve_triangular(L[j:e, j:e], panel.T,
                                                       upper=False).T
    return L


@spanned("ba.dense_schur")
def _dense_schur_step(p: BAProblem, plans: BAPlans, Hcc_d, Hpp_inv, W, rhs,
                      free_cam):
    """Form the reduced camera system S = Hcc_d - W Hpp^-1 W^T (one matrix
    product over the per-point camera coupling G [P, C, 6, 3]) and solve it
    by dense Cholesky, restricted to the free cameras."""
    C = Hcc_d.shape[0]
    P = Hpp_inv.shape[0]
    # G[p, c] = sum of W_e over the edges by which c observes p
    G = CK.seg_sum(W, plans.pair).reshape(P, C, 6, 3)
    Y = torch.einsum("pcij,pjk->pcik", G, Hpp_inv)
    # coupling[(c,i),(d,j)] = sum_{p,k} Y[p,c,i,k] G[p,d,j,k]
    Yf = Y.permute(1, 2, 0, 3).reshape(6 * C, 3 * P)
    Gf = G.permute(1, 2, 0, 3).reshape(6 * C, 3 * P)
    S = -(Yf @ Gf.T)
    diag = torch.arange(C, device=S.device)
    Sv = S.view(C, 6, C, 6)
    Sv[diag, :, diag, :] += Hcc_d
    # restrict to free cameras: identity rows/cols elsewhere (their rhs is 0)
    f = free_cam[:, 0].repeat_interleave(6)
    S = S * f[:, None] * f[None, :] + torch.diag(torch.where(f > 0, 1e-6, 1.0))
    L = _cholesky(S)
    dx = torch.cholesky_solve((rhs.reshape(-1) * f)[:, None], L)[:, 0]
    return (dx * f).reshape(C, 6)


@spanned("ba.lm")
def _lm_iteration(p: BAProblem, plans: BAPlans, cam_T, pts, lam, e_active, fx,
                  fy, cx, cy, bf, robust, cg_iters: int, dense_schur: bool = False,
                  group=None):
    Hcc_e, bc_e, Hpp_e, bp_e, W, m, cost = _edge_terms(
        p, cam_T, pts, e_active, fx, fy, cx, cy, bf, robust, "blocks")

    free_cam = (p.cam_valid & ~p.cam_fixed).to(torch.float32)[:, None]

    with span("ba.assemble"):
        # block assembly (segment sums over the edge list)
        Hcc = CK.seg_sum(Hcc_e, plans.cam)
        bc = CK.seg_sum(bc_e, plans.cam)
        Hpp = CK.seg_sum(Hpp_e, plans.pt)
        bp = CK.seg_sum(bp_e, plans.pt)

        # LM damping (multiplicative on block diagonals)
        eye6 = torch.eye(6, device=cam_T.device)
        eye3 = torch.eye(3, device=cam_T.device)
        Hpp_d = Hpp + lam * Hpp * eye3 + 1e-8 * eye3
        Hpp_inv = torch.linalg.inv_ex(Hpp_d)[0]   # [P, 3, 3] point marginalization

        # Schur RHS: bc - W Hpp^-1 bp
        hb = torch.einsum("pij,pj->pi", Hpp_inv, bp)
        rhs = bc - CK.seg_sum(torch.einsum("eij,ej->ei", W, hb[p.e_pt]), plans.cam)
    Hcc, rhs, cost = COL.all_reduce([Hcc, rhs, cost], group)
    Hcc_d = Hcc + lam * Hcc * eye6 + 1e-8 * eye6
    rhs = rhs * free_cam

    if dense_schur:
        dx_c = _dense_schur_step(p, plans, Hcc_d, Hpp_inv, W, rhs, free_cam)
    else:
        dx_c = _pcg(plans, Hcc_d, Hpp_inv, W, rhs, free_cam, cg_iters, group)
    return _apply_step(p, plans, cam_T, pts, lam, e_active, fx, fy, cx, cy, bf,
                       robust, dx_c, Hpp_inv, W, bp, m, cost, free_cam, group)


@spanned("ba.pcg.matvec")
def _schur_mv(x, plan: CK.SchurPlan, Hcc_d, terms: CK.SchurTerms, free_cam, group=None):
    """S x, S = Hcc_d - W Hpp^-1 W^T the reduced camera system, matrix free,
    restricted to the free cameras: one order-fixed kernel pair
    (`schur_matvec`). A rank of a sharded solve takes the pair's coupling
    part alone and sums it over the ranks before subtracting it."""
    if group is None:
        return CK.schur_matvec(x, terms, plan, free_cam, Hcc_d)
    x = x * free_cam
    s = CK.schur_matvec(x, terms, plan, free_cam)
    y = torch.einsum("cij,cj->ci", Hcc_d, x) - COL.all_reduce([s], group)[0]
    return y * free_cam


def _cg_steps(plan: CK.SchurPlan, Hcc_d, terms: CK.SchurTerms, Minv, rhs, free_cam,
              cg_iters: int, group=None):
    """The CG loop from x = 0, preconditioned by the block inverses Minv:
    the first residual's z, pdir and rz, then `cg_iters` steps. Its ops
    are what a graph of the loop captures (`_CGGraph`)."""
    def precond(r):
        return torch.einsum("cij,cj->ci", Minv, r) * free_cam

    x = torch.zeros_like(rhs)
    r = rhs
    z = precond(r)
    pdir = z
    rz = torch.sum(r * z)
    for _ in range(cg_iters):
        Ap = _schur_mv(pdir, plan, Hcc_d, terms, free_cam, group)
        denom = torch.sum(pdir * Ap)
        # Krylov breakdown guard: along a near-null (gauge) direction
        # denom ~ 0; freeze the iterate there instead of dividing
        ok = denom > 1e-12
        alpha = torch.where(ok, rz / torch.where(ok, denom, 1.0), 0.0)
        x = x + alpha * pdir
        r = r - alpha * Ap
        z = precond(r)
        rz_new = torch.sum(r * z)
        big = rz > 1e-20
        beta = torch.where(big, rz_new / torch.where(big, rz, 1.0), 0.0)
        pdir = z + beta * pdir
        rz = rz_new
    return x


class _CGGraph:
    """The CG loop of one problem shape as a CUDA graph, and the buffers it
    reads at their fixed addresses. `run` fills them from an LM iteration's
    tensors (W's rows in the plans' orders by `schur_terms` itself; the
    matvec plan's tensors once a solve), captures the graph on its first
    call, replays it on the current stream and returns a copy of its x.
    Each buffer takes the layout of the tensor that fills it (`inv_ex`
    returns Minv column-major), so the graph runs the eager loop's kernels
    on the same values and gives its bits. The lock and the event after
    the last replay order the users of different threads and streams."""

    def __init__(self, plan: CK.SchurPlan, Hcc_d, Minv, rhs, free_cam, cg_iters: int):
        C, P, E = plan.cam.n, plan.pt.n, plan.cam.perm.shape[0]
        dev = rhs.device
        self.cg_iters = cg_iters
        self.lock = threading.Lock()
        self.graph = self.x = self.done = None
        self.sources = (None,) * 4  # weak refs to the plan tensors last copied in
        self.inputs = [torch.empty_like(t) for t in (Hcc_d, Minv, rhs, free_cam)]
        self.terms = (torch.empty((P, 3, 3), device=dev),
                      torch.empty((E, 6, 3), device=dev), torch.empty((E, 6, 3), device=dev))
        # the matvec reads the plans' offsets and each row's other index;
        # perm, idx and seg only give it E and the device
        stand_in = torch.zeros((), dtype=torch.int32, device=dev).expand(E)
        self.plan = CK.SchurPlan(
            CK.SegPlan(stand_in, stand_in, torch.empty_like(plan.cam.offsets), stand_in, C),
            CK.SegPlan(stand_in, stand_in, torch.empty_like(plan.pt.offsets), stand_in, P),
            torch.empty_like(plan.cam_pt), torch.empty_like(plan.pt_cam))

    def run(self, plan: CK.SchurPlan, W, Hpp_inv, Hcc_d, Minv, rhs, free_cam):
        stream = torch.cuda.current_stream(rhs.device)
        with self.lock:
            if self.done is not None:
                stream.wait_event(self.done)
            sources = (plan.cam.offsets, plan.pt.offsets, plan.cam_pt, plan.pt_cam)
            if any(ref is None or ref() is not t for ref, t in zip(self.sources, sources)):
                for buf, t in zip((self.plan.cam.offsets, self.plan.pt.offsets,
                                   self.plan.cam_pt, self.plan.pt_cam), sources):
                    buf.copy_(t)
                self.sources = tuple(weakref.ref(t) for t in sources)
            terms = CK.schur_terms(W, Hpp_inv, plan, out=self.terms)
            for buf, t in zip(self.inputs, (Hcc_d, Minv, rhs, free_cam)):
                buf.copy_(t)
            if self.graph is None:
                self._capture(terms)
            with span("ba.pcg.replay"):
                self.graph.replay()
            CK.pcg_graph.count("replays")
            x = self.x.clone()
            self.done = stream.record_event()
        return x

    def _capture(self, terms: CK.SchurTerms):
        """Capture the loop (torch.cuda.graph waits for the device first);
        another thread's work goes on meanwhile. Work queued on the
        capturing stream by any thread would join the graph, so it comes
        from the high-priority pool, which none of the port's side streams
        (the mapper's, GlobalBA's) are taken from, and captures take turns."""
        Hcc_d, Minv, rhs, free_cam = self.inputs
        graph = torch.cuda.CUDAGraph()
        with _cg_capture_lock, torch.cuda.graph(
                graph, stream=torch.cuda.Stream(rhs.device, priority=-1),
                capture_error_mode="thread_local"):
            self.x = _cg_steps(self.plan, Hcc_d, terms, Minv, rhs, free_cam, self.cg_iters)
        self.graph = graph
        CK.pcg_graph.count("captures")


# the CG graph of each (device, C, P, E, cg_iters), captured once a process
_cg_graphs: dict = {}
_cg_graphs_lock = threading.Lock()
_cg_capture_lock = threading.Lock()


def _cg_graph(plan: CK.SchurPlan, Hcc_d, Minv, rhs, free_cam, cg_iters: int) -> _CGGraph:
    key = (rhs.device, plan.cam.n, plan.pt.n, plan.cam.perm.shape[0], cg_iters)
    with _cg_graphs_lock:
        graph = _cg_graphs.get(key)
        if graph is None:
            graph = _cg_graphs[key] = _CGGraph(plan, Hcc_d, Minv, rhs, free_cam, cg_iters)
    return graph


def _graphed(device: torch.device, group) -> bool:
    """Whether `_pcg` runs its loop as a CUDA graph: on a card, for a solve
    in this process alone (a sharded rank's matvec all-reduces)."""
    return device.type == "cuda" and group is None


@spanned("ba.pcg")
def _pcg(plans: BAPlans, Hcc_d, Hpp_inv, W, rhs, free_cam, cg_iters: int,
         group=None):
    """Block-Jacobi preconditioned CG on the reduced camera system, matrix
    free: S @ x costs two passes over the edges (`_schur_mv`), on terms laid
    out for them once (`schur_terms`). On a card, a whole solve's loop
    (`group` None) is a CUDA graph replayed each LM iteration (`_CGGraph`);
    a sharded rank's matvec all-reduces, so its loop runs eagerly."""
    Minv = torch.linalg.inv_ex(Hcc_d + 1e-6 * torch.eye(6, device=Hcc_d.device))[0]
    if not _graphed(Hcc_d.device, group):
        terms = CK.schur_terms(W, Hpp_inv, plans.schur)
        return _cg_steps(plans.schur, Hcc_d, terms, Minv, rhs, free_cam, cg_iters, group)
    return _cg_graph(plans.schur, Hcc_d, Minv, rhs, free_cam, cg_iters).run(
        plans.schur, W, Hpp_inv, Hcc_d, Minv, rhs, free_cam)


@spanned("ba.apply")
def _apply_step(p: BAProblem, plans: BAPlans, cam_T, pts, lam, e_active, fx, fy,
                cx, cy, bf, robust, dx_c, Hpp_inv, W, bp, m, cost, free_cam,
                group=None):
    """Point back-substitution + LM accept/reject for a camera step dx_c."""
    dx_c = torch.where(torch.isfinite(dx_c), dx_c, 0.0)
    # back-substitute points: dx_p = Hpp^-1 (bp - W^T dx_c)
    wtx = CK.seg_sum(torch.einsum("eij,ei->ej", W, dx_c[p.e_cam]), plans.pt)
    dx_p = torch.einsum("pij,pj->pi", Hpp_inv, bp - wtx)
    pt_has_edges = CK.seg_sum(m, plans.pt) > 0
    dx_p = torch.where((p.pt_valid & pt_has_edges)[:, None], dx_p, 0.0)
    dx_p = torch.where(torch.isfinite(dx_p), dx_p, 0.0)

    cam_T_new = se3.retract(cam_T, dx_c * free_cam)
    pts_new = pts + dx_p
    cost_new = COL.all_reduce(list(_edge_terms(p, cam_T_new, pts_new, e_active, fx,
                                               fy, cx, cy, bf, robust, "cost")), group)[0]

    accept = cost_new < cost
    cam_T = torch.where(accept, cam_T_new, cam_T)
    pts = torch.where(accept, pts_new, pts)
    lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-8),
                      torch.clamp(lam * 4.0, max=1e6))
    return cam_T, pts, lam, torch.minimum(cost_new, cost)


@spanned("ba.classify")
def _classify(p: BAProblem, cam_T, pts, fx, fy, cx, cy, bf):
    chi2, z = _edge_terms(p, cam_T, pts, p.e_valid, fx, fy, cx, cy, bf, False, "chi2")
    th = torch.where(p.e_stereo, BC.CHI2_STEREO, BC.CHI2_MONO)
    return p.e_valid & (chi2 <= th) & (z > CK.BA_MIN_DEPTH)


# [P, C, 6, 3] f32 budget for the formed per-point camera coupling; above
# this the matrix-free CG path is used instead (512 MB at 72 B/entry)
_DENSE_SCHUR_MAX_PC = 7_000_000


def _use_dense_schur(C: int, P: int, solver: str) -> bool:
    if solver == "dense":
        return True
    if solver == "cg":
        return False
    return P * C <= _DENSE_SCHUR_MAX_PC and 6 * C <= 4096


@spanned("ba.solve")
def ba_solve(p: BAProblem, fx: float, fy: float, cx: float, cy: float,
             bf: float, iters1: int = 5, iters2: int = 10,
             cg_iters: int = 24, solver: str = "auto", group=None) -> BAResult:
    """Two-phase LM Schur BA (reference schedule: 5 iterations, outlier
    cut, 10 iterations, src/Optimizer.cpp:790-841). Huber in phase 1,
    plain in phase 2 (outliers excluded instead).

    solver: "dense" forms the reduced camera system and solves it by
    Cholesky, "cg" is the matrix-free preconditioned CG, "auto" takes dense
    when the [P, C] coupling fits.

    group: None for the whole problem in this process; a process group (or
    collectives.Counting) for this rank's shard of a problem sharded by
    point owner (parallel/dist_ba.shard_problem), which needs "cg"."""
    cam_T, pts = p.cam_T, p.pts
    lam = torch.full((), 1e-4, dtype=torch.float32, device=cam_T.device)
    cost = torch.full((), float("inf"), dtype=torch.float32, device=cam_T.device)
    dense = _use_dense_schur(cam_T.shape[0], pts.shape[0], solver)
    if dense and group is not None:
        raise ValueError("a sharded solve runs solver='cg': the dense Schur step "
                         "forms the reduced system from every point")
    plans = ba_plans(p, dense)

    e_active = p.e_valid
    for n, robust in ((iters1, True), (iters2, False)):
        for _ in range(n):
            cam_T, pts, lam, cost = _lm_iteration(
                p, plans, cam_T, pts, lam, e_active, fx, fy, cx, cy, bf, robust,
                cg_iters, dense_schur=dense, group=group)
        e_active = _classify(p, cam_T, pts, fx, fy, cx, cy, bf)
    return BAResult(cam_T=cam_T, pts=pts, e_inlier=e_active, cost=cost)


def synthetic_problem(C: int, P: int, E: int, seed: int = 0,
                      stereo_frac: float = 0.3) -> tuple[dict, tuple]:
    """A seeded BA problem as numpy arrays: C cameras on a forward
    trajectory (the first fixed) observing P points through E edges, mono
    and stereo mixed, 0.5 px observation noise, poses and points perturbed.
    Returns (arrays named as BAProblem's fields, (fx, fy, cx, cy, bf)):
    the same draws and roundings as the JAX package's
    __graft_entry__._make_ba_problem, array for array."""
    rng = np.random.default_rng(seed)
    fx = fy = 718.0
    cx, cy = 607.0, 185.0
    bf = 386.0
    s = rng.uniform(0, C * 0.8, P)
    pts = np.stack([rng.uniform(-12, 12, P), rng.uniform(-2, 3, P),
                    s + rng.uniform(4, 30, P)], -1).astype(np.float32)
    cams = np.stack([
        np.hstack([np.eye(3), np.array([[0.02 * i], [0.0], [-0.8 * i]])])
        for i in range(C)]).astype(np.float32)
    e_cam = rng.integers(0, C, E)
    e_pt = rng.integers(0, P, E)

    def visible():
        pc = np.einsum("eij,ej->ei", cams[e_cam, :, :3], pts[e_pt]) + cams[e_cam, :, 3]
        return pc, pc[:, 2] > 1.0

    pc, ok = visible()
    for _ in range(8):  # re-draw the edges that look behind their camera
        bad = ~ok
        if not bad.any():
            break
        e_cam[bad] = rng.integers(0, C, bad.sum())
        e_pt[bad] = rng.integers(0, P, bad.sum())
        pc, ok = visible()
    z = np.maximum(pc[:, 2], 1.0)
    obs = np.stack([fx * pc[:, 0] / z + cx, fy * pc[:, 1] / z + cy,
                    fx * pc[:, 0] / z + cx - bf / z], -1).astype(np.float32)
    obs[:, :2] += rng.normal(0, 0.5, (E, 2))
    stereo = rng.random(E) < stereo_frac
    shift = np.concatenate([np.zeros((C, 3, 3)), rng.normal(0, 0.02, (C, 3, 1))], -1)
    arrays = dict(
        cam_T=(cams + shift.astype(np.float32) * (np.arange(C) > 0)[:, None, None]
               ).astype(np.float32),
        cam_fixed=np.arange(C) < 1, cam_valid=np.ones(C, bool),
        pts=pts + rng.normal(0, 0.05, (P, 3)).astype(np.float32),
        pt_valid=np.ones(P, bool),
        e_cam=e_cam.astype(np.int32), e_pt=e_pt.astype(np.int32), e_obs=obs,
        e_stereo=stereo & ok, e_info=np.ones(E, np.float32), e_valid=ok)
    return arrays, (fx, fy, cx, cy, bf)


def problem_from_numpy(arrays: dict, device: torch.device) -> BAProblem:
    """BAProblem on `device` from numpy arrays named as its fields."""
    return BAProblem(**{k: upload(np.asarray(
        arrays[k], np.int64) if k in ("e_cam", "e_pt") else arrays[k], device)
        for k in BAProblem._fields})
