"""The BA solver's CG matvec (ops/ba.py `_schur_mv`) and its kernel pair
(ops/cuda_kernels.py `schur_matvec`, csrc/schur_matvec.cu).

On the CPU the matvec runs the plain version, `schur_matvec_ref`, which is
the composition the solver ran before the kernel pair (edge gathers,
batched einsums, two segment sums): it must give that composition's
results bit for bit, so every CPU solve is unchanged.

On a card (`cuda` marker) the pair is held to the plain version on the
same card within 1e-5 of each output's sum of absolute terms (`_abs_terms`):
both add the same rows in the same order, from the same plans, and differ
only in how each row's 6- or 3-term product, each point's 3x3 product and
each camera's Hcc x round (a few units of 2^-24 of their absolute terms)
and in the drift these start in the running sums. On an H100 the largest such difference
read 1.3e-7 at the global BA's shape; a row left out or added twice moves
an output by about its sum of absolute terms over the rows a segment, 5e-4
at that shape, so the bound still sees one. Two calls, and two CG solves,
must give equal bits.

On a card the CG loop of an unsharded solve is a CUDA graph (ops/ba.py
`_CGGraph`): its replays must give the eager loop's bits, for one shape and
for two in turns, for another problem at the same shape and from two
threads. On the CPU the loop stays eager and gives the unfactored loop's
bits.
"""
import threading

import pytest
import torch

from orbslam2_tpu_torch.ops import ba as TBA
from orbslam2_tpu_torch.ops import cuda_kernels as CK
from orbslam2_tpu_torch.parallel import collectives as COL
from orbslam2_tpu_torch.utils import metrics as M

REL = 1e-5  # of each output's sum of absolute terms: the module's docstring


def problem(C, P, E, seed, device="cpu", no_cams=(), no_pts=(), masked=0.0):
    """A random matvec: masked direction x, the plans, Hcc_d [C, 6, 6],
    Hpp_inv, W (rows of a `masked` share of the edges zero, as an invalid
    edge's are), free_cam. Cameras in `no_cams` and points in `no_pts`
    have no edges; free_cam is 0 for camera 0 (fixed) and, where C > 2,
    camera 2 (invalid)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    kw = dict(generator=g, device=device)

    def ids(n, left_out):
        keep = torch.tensor([i for i in range(n) if i not in left_out], device=device)
        return keep[torch.randint(0, len(keep), (E,), **kw)]

    e_cam, e_pt = ids(C, no_cams), ids(P, no_pts)
    W = torch.randn((E, 6, 3), **kw)
    W[torch.rand(E, **kw) < masked] = 0.0
    A = torch.randn((C, 6, 6), **kw)
    Hcc_d = A @ A.transpose(1, 2) + torch.eye(6, device=device)
    Hpp_inv = torch.randn((P, 3, 3), **kw)
    free = torch.ones(C, device=device)
    free[[c for c in (0, 2) if c < C and C > 1]] = 0.0
    cam, pt = CK.seg_plan(e_cam, C), CK.seg_plan(e_pt, P)
    plans = TBA.BAPlans(cam, pt, None, CK.schur_plan(cam, pt))
    x = torch.randn((C, 6), **kw)
    return x, plans, Hcc_d, Hpp_inv, W, free[:, None]


def parents_matvec(x, plans, Hcc_d, Hpp_inv, W, free_cam, group=None):
    """S_mv as the solver ran it before the kernel pair."""
    x = x * free_cam
    u = torch.einsum("eij,ei->ej", W, x[plans.cam.idx])
    wp = torch.einsum("pij,pj->pi", Hpp_inv, CK.seg_sum(u, plans.pt))
    ze = torch.einsum("eij,ej->ei", W, wp[plans.pt.idx])
    y = (torch.einsum("cij,cj->ci", Hcc_d, x)
         - COL.all_reduce([CK.seg_sum(ze, plans.cam)], group)[0])
    return y * free_cam


CASES = {
    "ragged": dict(C=6, P=40, E=500),
    "a point with no edges": dict(C=5, P=30, E=200, no_pts=(0, 7, 29)),
    "a camera with no edges": dict(C=6, P=30, E=300, no_cams=(1, 5)),
    "masked edges": dict(C=4, P=50, E=400, masked=0.3),
    "no edges": dict(C=3, P=10, E=0),
    "one camera and one point": dict(C=1, P=1, E=9),
    "more points than edges": dict(C=8, P=2000, E=300),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("sharded", [False, True], ids=["group None", "Counting group"])
def test_the_matvec_is_the_parents_composition_bit_for_bit(case, sharded, monkeypatch):
    """On the CPU `_schur_mv` (the plain version of the pair) gives the
    solver's former matvec bit for bit: fixed and invalid cameras (free_cam
    0), cameras and points without edges, zero W rows, no edges at all,
    and a sharded solve's group (a Counting wrapper of a one-rank group:
    one all_reduce a matvec, through the float64 reduction)."""
    x, plans, Hcc_d, Hpp_inv, W, free = problem(seed=len(case), **CASES[case])
    group = None
    if sharded:
        group = COL.Counting(None)
        monkeypatch.setattr(COL.dist, "all_reduce", lambda t, group=None: None)
    want = parents_matvec(x, plans, Hcc_d, Hpp_inv, W, free, group)
    with M.recording() as spans:
        got = TBA._schur_mv(x, plans.schur, Hcc_d, CK.schur_terms(W, Hpp_inv, plans.schur), free,
                            group)
    assert got.dtype == torch.float32 and torch.equal(got, want)
    assert torch.equal(got[free[:, 0] == 0], torch.zeros_like(got[free[:, 0] == 0]))
    assert [s.name for s in spans] == ["ba.pcg.matvec"]
    if sharded:  # one all_reduce each
        assert group.counts == {"all_reduce": 2}


def test_the_plain_version_is_the_mask_gathers_einsums_and_segment_sums():
    """Without Hcc the coupling part s; with it (Hcc x - s), x and the
    result masked to the free cameras."""
    x, plans, Hcc_d, Hpp_inv, W, free = problem(7, 60, 700, seed=1)
    e_cam, e_pt = plans.cam.idx, plans.pt.idx
    xm = x * free
    u = torch.zeros(60, 3).index_add_(0, e_pt, torch.einsum("eij,ei->ej", W, xm[e_cam]))
    wp = torch.einsum("pij,pj->pi", Hpp_inv, u)
    s = torch.zeros(7, 6).index_add_(0, e_cam, torch.einsum("eij,ej->ei", W, wp[e_pt]))
    Sx = (torch.einsum("cij,cj->ci", Hcc_d, xm) - s) * free
    terms = CK.schur_terms(W, Hpp_inv, plans.schur)
    for Hcc, want in ((None, s), (Hcc_d, Sx)):
        assert torch.equal(CK.schur_matvec_ref(x, W, Hpp_inv, e_cam, e_pt, free, Hcc), want)
        out = torch.full((7, 6), 5.0)
        got = CK.schur_matvec(x, terms, plans.schur, free, Hcc, out=out)
        assert got is out and torch.equal(out, want)


def test_the_plan_holds_each_rows_other_index_in_its_order():
    """ba_plans builds the matvec's plan for a CG solve only; cam_pt and
    pt_cam are the point and the camera of each plan position's edge."""
    arrays, _ = TBA.synthetic_problem(8, 256, 1024, seed=5)
    prob = TBA.problem_from_numpy(arrays, torch.device("cpu"))
    assert TBA.ba_plans(prob, dense=True).schur is None
    plans = TBA.ba_plans(prob, dense=False)
    plan = plans.schur
    assert plan.cam is plans.cam and plan.pt is plans.pt
    assert plan.cam_pt.dtype == plan.pt_cam.dtype == torch.int32
    assert torch.equal(plan.cam_pt.long(), prob.e_pt[plans.cam.perm.long()])
    assert torch.equal(plan.pt_cam.long(), prob.e_cam[plans.pt.perm.long()])
    W, Hpp_inv = torch.randn(1024, 6, 3), torch.randn(256, 3, 3).mT
    terms = CK.schur_terms(W, Hpp_inv, plan)  # no copies on the CPU
    assert terms.W is W and terms.Hpp_inv is Hpp_inv and terms.by_cam is terms.by_pt is None


def test_the_wrapper_checks_its_inputs_and_launches_nothing_on_the_cpu():
    x, plans, Hcc_d, Hpp_inv, W, free = problem(5, 30, 100, seed=2)
    terms, plan = CK.schur_terms(W, Hpp_inv, plans.schur), plans.schur
    CK.reset_launch_counts()
    with pytest.raises(ValueError, match="x expected"):
        CK.schur_matvec(x[:4], terms, plan, free)
    with pytest.raises(ValueError, match="W expected"):
        CK.schur_matvec(x, terms._replace(W=W.double()), plan, free)
    with pytest.raises(ValueError, match="Hpp_inv expected"):
        CK.schur_matvec(x, terms._replace(Hpp_inv=Hpp_inv[:, :2]), plan, free)
    with pytest.raises(ValueError, match="free expected"):
        CK.schur_matvec(x, terms, plan, free[:, 0])
    with pytest.raises(ValueError, match="Hcc expected"):
        CK.schur_matvec(x, terms, plan, free, Hcc_d[:, :3])
    with pytest.raises(ValueError, match="out= expected"):
        CK.schur_matvec(x, terms, plan, free, out=torch.empty(5, 3))
    CK.schur_matvec(x, terms, plan, free, Hcc_d)
    assert CK.schur_matvec.launches == 0 and CK.schur_matvec.launches_by == {}


def parents_pcg(plans, Hcc_d, Hpp_inv, W, rhs, free_cam, cg_iters, group=None):
    """_pcg as the solver ran it before its loop was factored out."""
    terms = CK.schur_terms(W, Hpp_inv, plans.schur)
    eye6 = torch.eye(6, device=Hcc_d.device)
    Minv = torch.linalg.inv_ex(Hcc_d + 1e-6 * eye6)[0]

    def precond(r):
        return torch.einsum("cij,cj->ci", Minv, r) * free_cam

    x = torch.zeros_like(rhs)
    r = rhs
    z = precond(r)
    pdir = z
    rz = torch.sum(r * z)
    for _ in range(cg_iters):
        Ap = TBA._schur_mv(pdir, plans.schur, Hcc_d, terms, free_cam, group)
        denom = torch.sum(pdir * Ap)
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


def pcg_inputs(C, P, E, seed, device="cpu"):
    """_pcg's inputs from `problem`: plans, Hcc_d, Hpp_inv laid out as
    inv_ex lays it out (column-major), W, a right-hand side zero on the
    cameras that are not free, free_cam."""
    x, plans, Hcc_d, Hpp_inv, W, free = problem(C, P, E, seed, device=device,
                                                no_cams=(1,) if C > 2 else (), masked=0.2)
    return plans, Hcc_d, Hpp_inv.mT.contiguous().mT, W, x * free, free


def no_graph(*args, **kwargs):
    raise AssertionError("a CUDA graph was asked for")


@pytest.mark.parametrize("sharded", [False, True], ids=["group None", "Counting group"])
def test_the_cpu_loop_is_the_unfactored_loop_bit_for_bit(sharded, monkeypatch):
    """On the CPU `_pcg` runs `_cg_steps` eagerly and gives the loop it was
    factored from bit for bit, with a sharded solve's group too; it asks for
    no graph and opens no replay span."""
    plans, Hcc_d, Hpp_inv, W, rhs, free = pcg_inputs(6, 40, 500, seed=9)
    group = None
    if sharded:
        group = COL.Counting(None)
        monkeypatch.setattr(COL.dist, "all_reduce", lambda t, group=None: None)
    monkeypatch.setattr(TBA, "_cg_graph", no_graph)
    CK.reset_launch_counts()
    want = parents_pcg(plans, Hcc_d, Hpp_inv, W, rhs, free, 24, group)
    with M.recording() as spans:
        got = TBA._pcg(plans, Hcc_d, Hpp_inv, W, rhs, free, 24, group)
    assert torch.equal(got, want)
    names = [s.name for s in spans]
    assert names.count("ba.pcg") == 1 and names.count("ba.pcg.matvec") == 24
    assert "ba.pcg.replay" not in names
    assert CK.pcg_graph.captures == CK.pcg_graph.replays == 0


def test_the_loop_is_a_graph_on_a_card_for_an_unsharded_solve_alone(monkeypatch):
    """The gate: a card and no group. On the CPU and on a sharded rank the
    loop runs eagerly; the dense path never reaches `_pcg`, even where the
    gate would take the graph."""
    cuda = torch.device("cuda", 0)
    assert TBA._graphed(cuda, None)
    assert not TBA._graphed(torch.device("cpu"), None)
    assert not TBA._graphed(cuda, COL.Counting(None))
    monkeypatch.setattr(TBA, "_cg_graph", no_graph)
    arrays, intr = TBA.synthetic_problem(8, 256, 2048, seed=4)
    prob = TBA.problem_from_numpy(arrays, torch.device("cpu"))
    CK.reset_launch_counts()
    TBA.ba_solve(prob, *intr, iters1=1, iters2=1, solver="cg")
    monkeypatch.setattr(TBA, "_graphed", lambda device, group: True)
    TBA.ba_solve(prob, *intr, iters1=1, iters2=1, solver="dense")
    with pytest.raises(AssertionError, match="CUDA graph"):
        TBA.ba_solve(prob, *intr, iters1=1, iters2=1, solver="cg")
    assert CK.pcg_graph.captures == CK.pcg_graph.replays == 0


def test_one_graph_a_device_shape_and_step_count(monkeypatch):
    """`_cg_graph` keys its graphs by (device, C, P, E, cg_iters) and makes
    each once; a new one has captured nothing yet, and its buffers take the
    layouts of the tensors that fill them (Minv column-major as inv_ex
    gives it)."""
    monkeypatch.setattr(TBA, "_cg_graphs", {})
    CK.reset_launch_counts()

    def graph(C, P, E, cg_iters, seed=0):
        plans, Hcc_d, Hpp_inv, W, rhs, free = pcg_inputs(C, P, E, seed)
        Minv = torch.linalg.inv_ex(Hcc_d + 1e-6 * torch.eye(6))[0]
        made = TBA._cg_graph(plans.schur, Hcc_d, Minv, rhs, free, cg_iters)
        return made, (Hcc_d, Minv, rhs, free)

    first, inputs = graph(6, 40, 500, 24)
    assert graph(6, 40, 500, 24, seed=1)[0] is first  # other edges, the same shape
    others = [graph(6, 40, 500, 12)[0], graph(6, 40, 501, 24)[0],
              graph(6, 41, 500, 24)[0], graph(7, 40, 500, 24)[0]]
    assert len({id(g) for g in [first, *others]}) == 5
    cpu = torch.device("cpu")
    assert set(TBA._cg_graphs) == {(cpu, 6, 40, 500, 24), (cpu, 6, 40, 500, 12),
                                   (cpu, 6, 40, 501, 24), (cpu, 6, 41, 500, 24),
                                   (cpu, 7, 40, 500, 24)}
    assert first.graph is None and CK.pcg_graph.captures == 0
    for buf, t in zip(first.inputs, inputs):
        assert buf.shape == t.shape and buf.stride() == t.stride() and buf is not t
    assert inputs[1].stride() != (36, 6, 1)  # the column-major layout is kept
    assert [tuple(t.shape) for t in first.terms] == [(40, 3, 3), (500, 6, 3), (500, 6, 3)]
    plan = first.plan
    assert (plan.cam.n, plan.pt.n, tuple(plan.cam.offsets.shape),
            tuple(plan.pt.offsets.shape)) == (6, 40, (7,), (41,))
    assert tuple(plan.cam_pt.shape) == tuple(plan.pt_cam.shape) == (500,)
    assert plan.cam.perm.shape == (500,) and plan.cam.perm.stride() == (0,)


def test_graph_counts_split_by_caller_and_reset():
    CK.reset_launch_counts()
    CK.pcg_graph.count("captures")
    with CK.launches_counted_as("gba"):
        CK.pcg_graph.count("captures")
        CK.pcg_graph.count("replays")
        with CK.launches_counted_as("entry"):
            CK.pcg_graph.count("replays")
        CK.pcg_graph.count("replays")
    assert (CK.pcg_graph.captures, CK.pcg_graph.replays) == (2, 3)
    assert CK.pcg_graph.captures_by == {"tracker": 1, "gba": 1}
    assert CK.pcg_graph.replays_by == {"gba": 2, "entry": 1}
    CK.reset_launch_counts()
    assert CK.pcg_graph.captures == CK.pcg_graph.replays == 0
    assert CK.pcg_graph.captures_by == CK.pcg_graph.replays_by == {}


def _abs_terms(x, W, Hpp_inv, plan, free, Hcc=None):
    """Each output's sum of the absolute values of the terms it adds up."""
    free, x = free.double(), x.double().abs()
    s = CK.schur_matvec_ref(x, W.double().abs(), Hpp_inv.double().abs(), plan.cam.idx,
                            plan.pt.idx, free)
    return s if Hcc is None else (torch.einsum("cij,cj->ci", Hcc.double().abs(), x * free)
                                  + s) * free


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


# (C, P, E): the empty and one-element shapes, a local BA window, a rank of
# the global BA sharded over four cards, the global BA's cell
CARD_SHAPES = {"no edges": (3, 10, 0), "one camera and one point": (1, 1, 9),
               "empty segments": (300, 70000, 5000), "local": (16, 2048, 8192),
               "sharded rank": (512, 16384, 262144), "global": (512, 65536, 1048576)}


@pytest.mark.cuda
@pytest.mark.parametrize("with_hcc", [True, False], ids=["S x", "s alone"])
@pytest.mark.parametrize("shape", list(CARD_SHAPES))
def test_cuda_pair_matches_the_plain_version_and_repeats(shape, with_hcc):
    _need_cuda()
    C, P, E = CARD_SHAPES[shape]
    x, plans, Hcc_d, Hpp_inv, W, free = problem(C, P, E, seed=3, device="cuda",
                                                no_cams=(1,) if C > 2 else (),
                                                no_pts=(0, 5) if P > 5 else (), masked=0.2)
    Hcc = Hcc_d if with_hcc else None
    terms = CK.schur_terms(W, Hpp_inv.mT.contiguous().mT, plans.schur)  # as inv_ex lays it out
    before = CK.schur_matvec.launches
    got = CK.schur_matvec(x, terms, plans.schur, free, Hcc)
    again = CK.schur_matvec(x, terms, plans.schur, free, Hcc)
    assert CK.schur_matvec.launches == before + 4
    assert torch.equal(got, again)
    want = CK.schur_matvec_ref(x, W, Hpp_inv, plans.cam.idx, plans.pt.idx, free, Hcc)
    gap = (got.double() - want.double()).abs()
    terms = _abs_terms(x, W, Hpp_inv, plans.schur, free, Hcc)
    assert bool((gap <= REL * terms).all()), float(gap.max())


@pytest.mark.cuda
def test_cuda_cg_solve_repeats_bit_for_bit_at_the_global_bas_shape():
    _need_cuda()
    arrays, intr = TBA.synthetic_problem(512, 65536, 1048576, seed=0)
    prob = TBA.problem_from_numpy(arrays, torch.device("cuda"))
    first = TBA.ba_solve(prob, *intr, solver="cg")
    second = TBA.ba_solve(prob, *intr, solver="cg")
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
def test_cuda_matvec_launches_the_pair_and_no_segment_sum(monkeypatch):
    """Under the span ba.pcg.matvec, 2 launches of schur_matvec a CG step of
    the capture (48 at 24 steps) and none of seg_sum; a replay launches
    nothing through the wrappers, and each LM iteration opens one
    ba.pcg.replay under ba.pcg."""
    _need_cuda()
    monkeypatch.setattr(TBA, "_cg_graphs", {})
    seen = []
    launch = CK._launch

    def counted(wrapper, *args):
        stack = getattr(M._local, "stack", None)
        seen.append((wrapper.__name__, stack[-1].name if stack else None))
        return launch(wrapper, *args)

    monkeypatch.setattr(CK, "_launch", counted)
    arrays, intr = TBA.synthetic_problem(16, 2048, 8192, seed=0)
    prob = TBA.problem_from_numpy(arrays, torch.device("cuda"))
    for solve in range(2):
        seen.clear()
        with M.recording() as records:
            TBA.ba_solve(prob, *intr, iters1=1, iters2=2, cg_iters=24, solver="cg")
        under = [w for w, where in seen if where == "ba.pcg.matvec"]
        assert under == ["schur_matvec"] * (2 * 24 if solve == 0 else 0)
        names = [r.name for r in records]
        replays = [r for r in records if r.name == "ba.pcg.replay"]
        assert len(replays) == 3 and all(names[r.parent] == "ba.pcg" for r in replays)
        assert names.count("ba.pcg.matvec") == (24 if solve == 0 else 0)


def eager_solve(prob, intr, **kw):
    """ba_solve with the CG loop run eagerly, as on a sharded rank."""
    graphed = TBA._graphed
    TBA._graphed = lambda device, group: False
    try:
        return TBA.ba_solve(prob, *intr, solver="cg", **kw)
    finally:
        TBA._graphed = graphed


def card_problem(C, P, E, seed):
    arrays, intr = TBA.synthetic_problem(C, P, E, seed=seed)
    return TBA.problem_from_numpy(arrays, torch.device("cuda")), intr


def assert_same_bits(got, want):
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["local", "global"])
def test_cuda_pcg_replay_is_the_eager_loop_bit_for_bit(shape, monkeypatch):
    """`_pcg` by the graph (its capture's first replay, then a replay)
    against `_cg_steps` run eagerly on the same inputs; the first result
    is a copy that the second replay leaves alone."""
    _need_cuda()
    monkeypatch.setattr(TBA, "_cg_graphs", {})
    CK.reset_launch_counts()
    plans, Hcc_d, Hpp_inv, W, rhs, free = pcg_inputs(*CARD_SHAPES[shape], seed=5,
                                                     device="cuda")
    Minv = torch.linalg.inv_ex(Hcc_d + 1e-6 * torch.eye(6, device="cuda"))[0]
    want = TBA._cg_steps(plans.schur, Hcc_d, CK.schur_terms(W, Hpp_inv, plans.schur), Minv,
                         rhs, free, 24)
    first = TBA._pcg(plans, Hcc_d, Hpp_inv, W, rhs, free, 24)
    second = TBA._pcg(plans, Hcc_d, Hpp_inv, W, rhs, free, 24)
    assert torch.equal(first, want) and torch.equal(second, want)
    assert first.data_ptr() != second.data_ptr()
    assert (CK.pcg_graph.captures, CK.pcg_graph.replays) == (1, 2)


@pytest.mark.cuda
def test_cuda_graphed_solve_at_the_cells_shape_is_the_eager_solve_bit_for_bit(monkeypatch):
    """The cell's solve (1 + 2 LM iterations at C = 512, P = 65,536, E = 1M)
    twice, the first capturing, against the eager loop's solve."""
    _need_cuda()
    monkeypatch.setattr(TBA, "_cg_graphs", {})
    prob, intr = card_problem(512, 65536, 1048576, seed=0)
    want = eager_solve(prob, intr, iters1=1, iters2=2)
    CK.reset_launch_counts()
    for _ in range(2):
        assert_same_bits(TBA.ba_solve(prob, *intr, iters1=1, iters2=2, solver="cg"), want)
    assert (CK.pcg_graph.captures, CK.pcg_graph.replays) == (1, 6)


@pytest.mark.cuda
def test_cuda_graph_takes_each_problems_edges_and_alternates_shapes(monkeypatch):
    """Two problems with other edges at one shape, then a third shape, in
    turns: every solve is its eager solve's bits (the buffers, the plan's
    copies among them, are refilled), one capture a shape."""
    _need_cuda()
    monkeypatch.setattr(TBA, "_cg_graphs", {})
    probs = [card_problem(64, 4096, 32768, seed=s) for s in (1, 2)]
    probs.append(card_problem(128, 8192, 65536, seed=3))
    wants = [eager_solve(p, intr, iters1=1, iters2=2) for p, intr in probs]
    CK.reset_launch_counts()
    for k in (0, 1, 2, 0, 2, 1):
        prob, intr = probs[k]
        assert_same_bits(TBA.ba_solve(prob, *intr, iters1=1, iters2=2, solver="cg"),
                         wants[k])
    assert (CK.pcg_graph.captures, CK.pcg_graph.replays) == (2, 18)
    assert len(TBA._cg_graphs) == 2


@pytest.mark.cuda
def test_cuda_graph_serves_two_threads_on_their_own_streams(monkeypatch):
    """Two threads, each on a stream of its own as GlobalBA's worker is,
    solve two problems of one shape at once: each result is its eager
    solve's bits."""
    _need_cuda()
    monkeypatch.setattr(TBA, "_cg_graphs", {})
    probs = [card_problem(64, 4096, 32768, seed=s) for s in (4, 5)]
    wants = [eager_solve(p, intr, iters1=1, iters2=2) for p, intr in probs]
    CK.reset_launch_counts()
    torch.cuda.synchronize()  # the problems and the eager solves, on the default stream
    got, errors = [[], []], []

    def worker(k):
        try:
            stream = torch.cuda.Stream()
            with torch.cuda.stream(stream):
                for _ in range(3):
                    prob, intr = probs[k]
                    got[k].append(TBA.ba_solve(prob, *intr, iters1=1, iters2=2,
                                               solver="cg"))
            stream.synchronize()
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(k,)) for k in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    assert errors == []
    for k in (0, 1):
        assert len(got[k]) == 3
        for res in got[k]:
            assert_same_bits(res, wants[k])
    assert (CK.pcg_graph.captures, CK.pcg_graph.replays) == (1, 18)
