"""The port's Hamming kernels (orbslam2_tpu_torch/ops/cuda_kernels.py):
`hamming_matrix` against the JAX package's Pallas kernel and XLA expression,
and the fused `hamming_best2` against the JAX package's masked reduction of
that matrix (orbslam2_tpu/ops/matching.py masked_best_match).

On the CPU a wrapper runs its plain PyTorch version; the CUDA kernels
themselves run only on a card (the `cuda` tests below, and chip_smoke.py).
Hamming distances are integers: every comparison here is exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_tpu.ops import matching as JM
from orbslam2_tpu.ops import pallas_kernels as PK
from orbslam2_tpu_torch import _build
from orbslam2_tpu_torch.ops import cuda_kernels as CK
from orbslam2_tpu_torch.utils.probe_hamming import best2_cases


def _desc(rng, n):
    return rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)


def _xla_hamming(a, b):
    x = jnp.bitwise_xor(jnp.asarray(a)[:, None, :], jnp.asarray(b)[None, :, :])
    return np.asarray(jnp.sum(jax.lax.population_count(x), axis=-1))


def _port(a, b, fn=CK.hamming_matrix):
    return fn(torch.from_numpy(a.view(np.int32)),
              torch.from_numpy(b.view(np.int32))).numpy()


def test_plain_matches_pallas_interpret_and_xla():
    rng = np.random.default_rng(7)
    a, b = _desc(rng, 256), _desc(rng, 512)
    pallas = np.asarray(PK.hamming_matrix_pallas(jnp.asarray(a), jnp.asarray(b),
                                                 interpret=True))
    ref = _port(a, b, CK.hamming_matrix_ref)
    assert ref.dtype == np.int32
    np.testing.assert_array_equal(ref, pallas)
    np.testing.assert_array_equal(ref, _xla_hamming(a, b))


@pytest.mark.parametrize("shape", [(300, 700), (1, 1), (5, 1031)])
def test_plain_matches_xla_ragged(shape):
    rng = np.random.default_rng(shape[0] * 7919 + shape[1])
    a, b = _desc(rng, shape[0]), _desc(rng, shape[1])
    np.testing.assert_array_equal(_port(a, b), _xla_hamming(a, b))


def test_plain_chunking_is_exact():
    """At B = 1024 the plain version works in 256-row chunks: [600, 1024]
    takes two full chunks and a ragged one; the result must not change."""
    rng = np.random.default_rng(3)
    a, b = _desc(rng, 600), _desc(rng, 1024)
    assert CK._REF_CHUNK_ELEMS // (1024 * 4 * CK.DESC_WORDS) < 600
    np.testing.assert_array_equal(_port(a, b, CK.hamming_matrix_ref), _xla_hamming(a, b))


def test_extreme_words():
    """All-zero against all-one descriptors: 256 bits apart; self: 0."""
    a = np.zeros((2, 8), np.uint32)
    a[1] = 0xFFFFFFFF
    out = _port(a, a)
    np.testing.assert_array_equal(out, [[0, 256], [256, 0]])


@pytest.mark.parametrize("bad,exc", [
    (torch.zeros((4, 8), dtype=torch.float32), TypeError),
    (torch.zeros((4, 8), dtype=torch.int64), TypeError),
    (torch.zeros((4, 7), dtype=torch.int32), ValueError),
    (torch.zeros((4, 8, 1), dtype=torch.int32), ValueError),
    (torch.zeros((8, 4), dtype=torch.int32).T, ValueError),  # not contiguous
])
def test_wrapper_rejects_bad_input(bad, exc):
    good = torch.zeros((3, 8), dtype=torch.int32)
    with pytest.raises(exc):
        CK.hamming_matrix(bad, good)
    with pytest.raises(exc):
        CK.hamming_matrix(good, bad)


def test_cpu_tensors_run_the_plain_version_and_count_no_launch():
    before = CK.hamming_matrix.launches
    rng = np.random.default_rng(1)
    _port(_desc(rng, 10), _desc(rng, 12))
    assert CK.hamming_matrix.launches == before


def test_build_refuses_unknown_compiler(tmp_path):
    src = tmp_path / "x.c"
    src.write_text("int f(void) { return 0; }\n")
    with pytest.raises(ValueError):
        _build.build_library("never_built_test_lib", [src], "cc-unknown")


@pytest.mark.cuda
def test_cuda_kernel_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    rng = np.random.default_rng(11)
    for A, B in [(1024, 1024), (4096, 1024), (1000, 777), (1, 3)]:
        a = torch.from_numpy(_desc(rng, A).view(np.int32)).cuda()
        b = torch.from_numpy(_desc(rng, B).view(np.int32)).cuda()
        before = CK.hamming_matrix.launches
        got = CK.hamming_matrix(a, b)
        torch.cuda.synchronize()
        assert CK.hamming_matrix.launches == before + 1
        assert torch.equal(got, CK.hamming_matrix_ref(a, b))
    before = CK.hamming_matrix.launches
    empty = CK.hamming_matrix(a[:0], b)
    assert empty.shape == (0, b.shape[0])
    assert CK.hamming_matrix.launches == before  # nothing to launch


def _jax_best2(a_i32, b_i32, cand):
    """The JAX package's reduction (ops/matching.py masked_best_match before
    its gate) on its own Hamming matrix."""
    a, b = (jnp.asarray(x.view(np.uint32)) for x in (a_i32, b_i32))
    d = jnp.where(jnp.asarray(cand), JM.hamming_matrix(a, b), JM.BIG)
    idx = jnp.argmin(d, axis=1)
    best = jnp.min(d, axis=1)
    second = jnp.min(d.at[jnp.arange(d.shape[0]), idx].set(JM.BIG), axis=1)
    return [np.asarray(x) for x in (idx, best, second)]


def _port_best2(a_i32, b_i32, cand, fn=CK.hamming_best2):
    out = fn(*(torch.from_numpy(x) for x in (a_i32, b_i32, cand)))
    assert all(x.dtype == torch.int32 for x in out)
    return [x.numpy() for x in out]


@pytest.mark.parametrize("kind", ["sparse", "full", "edges"])
@pytest.mark.parametrize("shape", [(300, 700), (1, 1), (5, 1031), (9, 1), (64, 2)])
def test_best2_matches_jax(shape, kind):
    """Index, best and second agree exactly with the JAX reduction, over
    ragged shapes, B = 1, and masks with rows that have no candidate, one
    candidate and tied best columns (the `edges` kind)."""
    (a, b, cand), = [c[1:] for c in best2_cases(*shape, seed=shape[0]) if c[0] == kind]
    want = _jax_best2(a, b, cand)
    for got in (_port_best2(a, b, cand), _port_best2(a, b, cand, CK.hamming_best2_ref)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_best2_edge_rows_by_hand():
    """No candidate: idx 0, best = second = BIG. One candidate: second = BIG.
    A tied pair: the lower column wins and second == best."""
    rng = np.random.default_rng(5)
    a = rng.integers(0, 2 ** 32, (3, 8), dtype=np.uint32).view(np.int32)
    b = rng.integers(0, 2 ** 32, (6, 8), dtype=np.uint32).view(np.int32)
    b[4] = b[2]
    cand = np.zeros((3, 6), bool)
    cand[1, 3] = True
    cand[2, [4, 2]] = True
    idx, best, second = _port_best2(a, b, cand)
    d = _port(a.view(np.uint32), b.view(np.uint32))
    np.testing.assert_array_equal(idx, [0, 3, 2])
    np.testing.assert_array_equal(best, [CK.BIG, d[1, 3], d[2, 2]])
    np.testing.assert_array_equal(second, [CK.BIG, CK.BIG, d[2, 2]])


def test_best2_case_generator_covers_the_edges():
    """The `edges` masks really hold what the card check relies on."""
    (a, b, cand), = [c[1:] for c in best2_cases(64, 48) if c[0] == "edges"]
    n = cand.sum(axis=1)
    assert (n[0::4] == 0).all() and (n[1::4] == 1).all() and (n[2::4] == 2).all()
    idx, best, second = _port_best2(a, b, cand)
    assert (best[2::4] == second[2::4]).all() and (best[2::4] < CK.BIG).all()
    np.testing.assert_array_equal(b[1::2], b[0::2])


@pytest.mark.parametrize("bad,exc", [
    (torch.zeros((3, 5), dtype=torch.uint8), TypeError),       # not bool
    (torch.zeros((3, 5), dtype=torch.int32), TypeError),
    (torch.zeros((5, 3), dtype=torch.bool), ValueError),       # wrong shape
    (torch.zeros((3, 5, 1), dtype=torch.bool), ValueError),
    (torch.zeros((5, 3), dtype=torch.bool).T, ValueError),     # wrong strides
    (torch.zeros((3, 10), dtype=torch.bool)[:, ::2], ValueError),
    (torch.zeros((3, 5), dtype=torch.bool, device="meta"), ValueError),  # device
])
def test_best2_wrapper_rejects_bad_mask(bad, exc):
    a = torch.zeros((3, 8), dtype=torch.int32)
    b = torch.zeros((5, 8), dtype=torch.int32)
    with pytest.raises(exc):
        CK.hamming_best2(a, b, bad)


def test_best2_wrapper_rejects_bad_descriptors_and_no_columns():
    good = torch.zeros((3, 8), dtype=torch.int32)
    with pytest.raises(TypeError):
        CK.hamming_best2(good.float(), good, torch.zeros((3, 3), dtype=torch.bool))
    with pytest.raises(ValueError):  # argmin over no column has no answer
        CK.hamming_best2(good, good[:0], torch.zeros((3, 0), dtype=torch.bool))
    idx, best, second = CK.hamming_best2(good[:0], good, torch.zeros((0, 3), dtype=torch.bool))
    assert idx.shape == best.shape == second.shape == (0,)


def test_best2_cpu_tensors_count_no_launch():
    before = (CK.hamming_best2.launches, dict(CK.hamming_best2.launches_by))
    (a, b, cand), = [c[1:] for c in best2_cases(10, 12) if c[0] == "sparse"]
    with CK.launches_counted_as("mapper"):
        _port_best2(a, b, cand)
    assert (CK.hamming_best2.launches, CK.hamming_best2.launches_by) == before


def test_reset_launch_counts_covers_both_kernels():
    CK.hamming_matrix.launches_by["probe"] = 1
    CK.hamming_best2.launches = 7
    CK.reset_launch_counts()
    for wrapper in (CK.hamming_matrix, CK.hamming_best2):
        assert wrapper.launches == 0 and wrapper.launches_by == {}


def test_wrappers_write_into_out():
    """out= (chip_smoke.py's guarded outputs) receives the results, and a
    wrong shape, type or count is refused."""
    (a, b, cand), = [c[1:] for c in best2_cases(10, 12) if c[0] == "sparse"]
    ta, tb, tc = (torch.from_numpy(x) for x in (a, b, cand))
    out = torch.full((10, 12), -1, dtype=torch.int32)
    assert CK.hamming_matrix(ta, tb, out=out) is out
    assert torch.equal(out, CK.hamming_matrix_ref(ta, tb))
    three = [torch.full((10,), -1, dtype=torch.int32) for _ in range(3)]
    got = CK.hamming_best2(ta, tb, tc, out=three)
    assert all(g is o for g, o in zip(got, three))
    assert all(torch.equal(g, r) for g, r in zip(got, CK.hamming_best2_ref(ta, tb, tc)))
    for bad in (out[:, :11], out.to(torch.int64), out.T):
        with pytest.raises(ValueError, match="out="):
            CK.hamming_matrix(ta, tb, out=bad)
    with pytest.raises(ValueError, match="out="):
        CK.hamming_best2(ta, tb, tc, out=three[:2])


@pytest.mark.cuda
def test_cuda_best2_kernel_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    for A, B in [(1024, 1024), (4096, 1024), (1000, 777), (3, 1), (17, 2100)]:
        for kind, a, b, cand in best2_cases(A, B, seed=11):
            args = [torch.from_numpy(x).cuda() for x in (a, b, cand)]
            before = CK.hamming_best2.launches
            got = CK.hamming_best2(*args)
            torch.cuda.synchronize()
            assert CK.hamming_best2.launches == before + 1
            for g, w in zip(got, CK.hamming_best2_ref(*args)):
                assert torch.equal(g, w), (A, B, kind)
