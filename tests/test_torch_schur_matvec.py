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
"""
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
        got = TBA._schur_mv(x, plans, Hcc_d, CK.schur_terms(W, Hpp_inv, plans.schur), free,
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
    """Under the span ba.pcg.matvec, 2 launches of schur_matvec a CG step
    and none of seg_sum."""
    _need_cuda()
    seen = []
    launch = CK._launch

    def counted(wrapper, *args):
        stack = getattr(M._local, "stack", None)
        seen.append((wrapper.__name__, stack[-1].name if stack else None))
        return launch(wrapper, *args)

    monkeypatch.setattr(CK, "_launch", counted)
    arrays, intr = TBA.synthetic_problem(16, 2048, 8192, seed=0)
    prob = TBA.problem_from_numpy(arrays, torch.device("cuda"))
    with M.recording():
        TBA.ba_solve(prob, *intr, iters1=1, iters2=2, cg_iters=24, solver="cg")
    under = [w for w, where in seen if where == "ba.pcg.matvec"]
    assert under.count("schur_matvec") == 2 * 3 * 24 and len(under) == 2 * 3 * 24
