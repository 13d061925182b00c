"""The BA solver's per-edge linearization (ops/ba.py `_edge_terms`) and its
kernel (ops/cuda_kernels.py `ba_edges`, csrc/ba_edges.cu).

On the CPU `ba_edges` runs the plain version, `ba_edges_ref`, which is the
composition the solver ran before the kernel (the edge gathers, ops/ba_core.py's
residual, Jacobians and weights, the block assembly's batched products): it
must give that composition's results bit for bit, so every CPU solve, and
every parity test against the JAX package, is unchanged.

On a card (`cuda` marker) the kernel is held to the plain version on the
same card within `ba_edges_bound` at UNITS = 32: how far float32 rounding of
32 units of 2^-24 moves each output, in float64. Both versions compute the
same expressions and differ only in how they round, and the bound adds up
what rounding reaches an output: 32 units of its sum of absolute terms (each
product and sum rounds within a unit or two of that), and how far the float64
plain version moves when either of the composition's two cancellations is
moved by 32 units of its rounding, the camera-frame point pc = R X + t
(2^-24 (|R_i| |X| + |t_i|) in coordinate i) and each residual's difference of
projection and observation (2^-24 of about twice |obs|). A share of the
absolute terms alone does not do: at the global BA's shape a point 400 m
down the track lies 4 m in front of its camera, so pc's depth keeps about
1/200 of its float32 digits, and the Jacobians (~1/z^2), the blocks (~1/z^4)
and, through the residual, the Huber weight lose as much; and the weight has
a kink at the Huber threshold, where a first-order scale reads nothing on
one side. Each version sits a few units from the float64 one (the plain
version on the CPU read up to 5.4 units, Hcc, at the global BA's shape and
the local BA's), so the two lie within about 11 units of each other; a wrong
term, row or mask moves an output by about its absolute terms, millions of
units. Two calls must give equal bits, and an edge of weight 0 exact zeros.
"""
import functools

import numpy as np
import pytest
import torch

from orbslam2_tpu_torch.ops import ba as TBA
from orbslam2_tpu_torch.ops import ba_core as BC
from orbslam2_tpu_torch.ops import cuda_kernels as CK
from orbslam2_tpu_torch.utils import metrics as M

UNITS = 32  # of float32 rounding, in `ba_edges_bound`: the docstring
MODES = tuple(CK.BA_EDGE_OUTPUTS)


def edge_mix(E=600, seed=0, device="cpu"):
    """The inputs of `ba_edges` (without the mode and `robust`) on the
    edges of a seeded synthetic problem, mono and stereo, with information
    from 1 to 1/1.44^7 and these edges made special: 0 sees a point of its
    own 2 cm in front of its camera (below the depth floor), 1 one behind
    it, 2 is 2000 px off (chi2 above the trim), every seventh inactive."""
    arrays, intr = TBA.synthetic_problem(6, 94, E, seed=seed)
    rng = np.random.default_rng(seed)
    pts, cams = arrays["pts"], arrays["cam_T"]
    e_cam, e_pt = arrays["e_cam"].astype(np.int64), arrays["e_pt"].astype(np.int64)
    for k, depth in ((0, 0.02), (1, -2.0)):
        e_pt[k] = len(pts)
        R, t = cams[e_cam[k], :, :3], cams[e_cam[k], :, 3]
        pts = np.concatenate([pts, [R.T @ (np.array([0.1, -0.2, depth], np.float32) - t)]])
    obs = arrays["e_obs"].copy()
    obs[2, :2] += 2000.0
    active = arrays["e_valid"].copy()
    active[:3], active[3::7] = True, False
    info = (1.44 ** -rng.integers(0, 8, E)).astype(np.float32)
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return (up(cams), up(pts), up(e_cam), up(e_pt), up(obs), up(arrays["e_stereo"]),
            up(info), up(active)), intr


def parents_terms(mode, cam_T, pts, e_cam, e_pt, e_obs, e_stereo, e_info, e_active,
                  intr, robust):
    """The solver's former `_edge_terms` and the per-edge products of its
    block assembly, as it ran them, per edge (the cost unsummed)."""
    fx, fy, cx, cy, bf = intr
    Te = cam_T[e_cam]
    Xe = pts[e_pt]
    R, t = Te[..., :3], Te[..., 3]
    pc = torch.einsum("eij,ej->ei", R, Xe) + t
    z = pc[:, 2]
    iz = 1.0 / torch.where(z.abs() > 1e-6, z, 1e-6)
    u = fx * pc[:, 0] * iz + cx
    v = fy * pc[:, 1] * iz + cy
    ur = u - bf * iz
    res = torch.stack(
        [u - e_obs[:, 0], v - e_obs[:, 1],
         torch.where(e_stereo, ur - e_obs[:, 2], 0.0)], dim=-1)
    Jp, Jpc = BC.residual_jacobians(pc, e_stereo, fx, fy, bf)
    Jpt = Jpc @ R
    chi2, w = BC.chi2_and_weight(res, e_stereo, e_info, robust)
    usable = e_active & (z > 0.05) & (chi2 < 1e5)
    m = usable.to(torch.float32) * w * e_info
    rho = BC.robust_cost(chi2, e_stereo, robust)
    cost = torch.where(e_active & (z > 0.05), torch.clamp(rho, max=1e5), 0.0)
    if mode == "chi2":
        return chi2, z
    if mode == "cost":
        return (cost,)
    Jpm = Jp * m[:, None, None]
    Jptm = Jpt * m[:, None, None]
    return (Jpm.transpose(1, 2) @ Jp, -torch.einsum("eri,er->ei", Jpm, res),
            Jptm.transpose(1, 2) @ Jpt, -torch.einsum("eri,er->ei", Jptm, res),
            Jpm.transpose(1, 2) @ Jpt, m, cost)


@pytest.mark.parametrize("robust", [True, False], ids=["Huber", "plain"])
@pytest.mark.parametrize("mode", MODES)
def test_the_plain_version_is_the_solvers_former_composition_bit_for_bit(mode, robust):
    """ba_edges on CPU tensors (its plain version) and ba_edges_ref give the
    former composition's bits in every mode, with and without Huber, on mono
    and stereo edges, inactive ones, one below the depth floor, one behind
    its camera and one above the chi2 trim; the special edges' blocks are
    exact zeros."""
    inputs, intr = edge_mix()
    want = parents_terms(mode, *inputs, intr, robust)
    got = CK.ba_edges(mode, *inputs, intr, robust)
    ref = CK.ba_edges_ref(mode, *inputs, intr, robust)
    assert len(got) == len(ref) == len(want) == len(CK.BA_EDGE_OUTPUTS[mode])
    for name, g, r, w in zip(CK.BA_EDGE_OUTPUTS[mode], got, ref, want):
        assert g.dtype == torch.float32 and torch.equal(g, w) and torch.equal(r, w), name
    if mode != "blocks":
        return
    named = dict(zip(CK.BA_EDGE_OUTPUTS[mode], got))
    m = named["m"]
    active = inputs[-1]
    special = torch.zeros_like(active)
    special[:3] = True
    assert bool((m[special | ~active] == 0).all()) and bool((m[~special & active] > 0).all())
    for name in ("Hcc", "bc", "Hpp", "bp", "W"):
        assert bool((named[name][m == 0] == 0).all()), name
    # the cost: nothing from an inactive edge or one behind its camera; the
    # trimmed edge's plain cost at the trim
    assert float(named["cost"][1]) == 0 and (robust or float(named["cost"][2]) == 1e5)
    assert bool((named["cost"][~active] == 0).all())
    if robust:  # both sides of the Huber threshold are in the mix
        plain = dict(zip(CK.BA_EDGE_OUTPUTS[mode], CK.ba_edges(mode, *inputs, intr, False)))
        usable = m > 0
        assert bool((m[usable] < plain["m"][usable]).any())
        assert bool((m[usable] == plain["m"][usable]).any())


def test_the_wrapper_checks_its_inputs_and_launches_nothing_on_the_cpu():
    inputs, intr = edge_mix(E=50)
    cam_T, pts, e_cam, e_pt, e_obs, e_stereo, e_info, e_active = inputs
    CK.reset_launch_counts()
    bad = {"mode": ("mode 'jacobians'", dict(mode="jacobians")),
           "cam_T": ("cam_T expected", dict(cam_T=cam_T[:, :2])),
           "pts": ("pts expected", dict(pts=pts.double())),
           "e_cam": ("e_cam expected", dict(e_cam=e_cam.int())),
           "e_pt": ("e_pt expected", dict(e_pt=e_pt[:49])),
           "e_obs": ("e_obs expected", dict(e_obs=e_obs[:, :2])),
           "e_stereo": ("e_stereo expected", dict(e_stereo=e_stereo.float())),
           "e_info": ("e_info expected", dict(e_info=e_info[:, None])),
           "e_active": ("e_active expected", dict(e_active=e_active[:10]))}
    args = dict(mode="blocks", cam_T=cam_T, pts=pts, e_cam=e_cam, e_pt=e_pt, e_obs=e_obs,
                e_stereo=e_stereo, e_info=e_info, e_active=e_active)
    for name, (match, change) in bad.items():
        with pytest.raises(ValueError, match=match):
            CK.ba_edges(**{**args, **change}, intr=intr, robust=True)
    with pytest.raises(ValueError, match="out= takes 2 tensors"):
        CK.ba_edges(**{**args, "mode": "chi2"}, intr=intr, robust=False,
                    out=[torch.empty(50)])
    with pytest.raises(ValueError, match="out= expected"):
        CK.ba_edges(**{**args, "mode": "cost"}, intr=intr, robust=False,
                    out=[torch.empty(50, 1)])
    out = [torch.full((50, *CK._EDGE_ROWS[k]), 7.0) for k in CK.BA_EDGE_OUTPUTS["blocks"]]
    got = CK.ba_edges(**args, intr=intr, robust=True, out=out)
    want = CK.ba_edges_ref(*args.values(), intr, True)
    assert all(g is o and torch.equal(g, w) for g, o, w in zip(got, out, want))
    empty = [t[:0] for t in inputs]
    for mode in MODES:
        got = CK.ba_edges(mode, *empty, intr, True)
        assert [tuple(t.shape) for t in got] == [
            (0, *CK._EDGE_ROWS[k]) for k in CK.BA_EDGE_OUTPUTS[mode]]
    assert CK.ba_edges.launches == 0 and CK.ba_edges.launches_by == {}


@pytest.mark.parametrize("solver", ["cg", "dense"])
def test_a_cpu_solve_gives_the_former_compositions_bits(solver, monkeypatch):
    """A CPU ba_solve through `ba_edges` returns the bits of the same solve
    with the former composition in its place (the rest of the solver is
    unchanged), on a problem with inactive edges, an outlier and a point
    behind its camera; it opens one span ba.edge_terms a call."""
    torch.set_num_threads(1)
    arrays, intr = TBA.synthetic_problem(8, 256, 2048, seed=11)
    arrays["e_valid"][:7] = False
    arrays["e_obs"][10, :2] += 400.0
    arrays["pts"][arrays["e_pt"][20]] = np.array([0.0, 0.0, -3.0], np.float32)
    p = TBA.problem_from_numpy(arrays, torch.device("cpu"))

    def solve():
        return TBA.ba_solve(p, *intr, iters1=2, iters2=2, cg_iters=12, solver=solver)

    with M.recording() as records:
        got = solve()
    monkeypatch.setattr(CK, "ba_edges", parents_terms)
    want = solve()
    for name, a, b in zip(got._fields, got, want):
        assert torch.equal(a, b), name
    assert sum(r.name == "ba.edge_terms" for r in records) == 4 + 4 + 2


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


# (C, P, E) of synthetic problems: no edges, one edge, a local BA window,
# the global BA's cell
CARD_SHAPES = {"no edges": (2, 4, 0), "one edge": (1, 1, 1), "local": (16, 2048, 8192),
               "global": (512, 65536, 1048576)}


@functools.lru_cache(maxsize=None)
def card_inputs(shape):
    if shape == "mix":
        return edge_mix(device="cuda")
    arrays, intr = TBA.synthetic_problem(*CARD_SHAPES[shape], seed=2)
    p = TBA.problem_from_numpy(arrays, torch.device("cuda"))
    return (p.cam_T, p.pts, p.e_cam, p.e_pt, p.e_obs, p.e_stereo, p.e_info, p.e_valid), intr


@pytest.mark.cuda
@pytest.mark.parametrize("robust", [True, False], ids=["Huber", "plain"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", ["mix", *CARD_SHAPES])
def test_cuda_kernel_matches_the_plain_version_and_repeats(shape, mode, robust):
    _need_cuda()
    inputs, intr = card_inputs(shape)
    before = CK.ba_edges.launches
    got = CK.ba_edges(mode, *inputs, intr, robust)
    again = CK.ba_edges(mode, *inputs, intr, robust)
    assert CK.ba_edges.launches == before + (2 if inputs[2].shape[0] else 0)
    want = CK.ba_edges_ref(mode, *inputs, intr, robust)
    bound = CK.ba_edges_bound(mode, *inputs, intr, robust, UNITS)
    for name, g, a, w, b in zip(CK.BA_EDGE_OUTPUTS[mode], got, again, want, bound):
        assert torch.equal(g, a), name
        gap = (g.double() - w.double()).abs()
        assert bool((gap <= b).all()), (name, float((gap / b).nan_to_num(0.0).max()))
    if mode == "blocks":
        m = got[5]
        for name, g in zip(CK.BA_EDGE_OUTPUTS[mode][:5], got[:5]):
            assert bool((g[m == 0] == 0).all()), name


@pytest.mark.cuda
def test_cuda_cg_solves_repeat_bit_for_bit():
    _need_cuda()
    arrays, intr = TBA.synthetic_problem(128, 8192, 65536, seed=1)
    prob = TBA.problem_from_numpy(arrays, torch.device("cuda"))
    first = TBA.ba_solve(prob, *intr, solver="cg")
    second = TBA.ba_solve(prob, *intr, solver="cg")
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["cg", "dense"])
def test_cuda_solve_launches_one_kernel_an_lm_iteration_trial_and_classification(
        solver, monkeypatch):
    """Under the span ba.edge_terms: 1 "blocks" launch an LM iteration (its
    span's parent ba.lm), 1 "cost" launch a trial step (ba.apply) and a
    classification (ba.classify), nothing else of ba_edges."""
    _need_cuda()
    seen = []
    launch = CK._launch

    def counted(wrapper, name, device, *args):
        if wrapper is CK.ba_edges:
            stack = M._local.stack
            seen.append((args[0], stack[-1].name, stack[-2].name))
        return launch(wrapper, name, device, *args)

    monkeypatch.setattr(CK, "_launch", counted)
    arrays, intr = TBA.synthetic_problem(16, 2048, 8192, seed=0)
    prob = TBA.problem_from_numpy(arrays, torch.device("cuda"))
    with M.recording():
        TBA.ba_solve(prob, *intr, iters1=1, iters2=2, cg_iters=24, solver=solver)
    assert sorted(seen) == sorted([(0, "ba.edge_terms", "ba.lm")] * 3
                                  + [(1, "ba.edge_terms", "ba.apply")] * 3
                                  + [(1, "ba.edge_terms", "ba.classify")] * 2)
