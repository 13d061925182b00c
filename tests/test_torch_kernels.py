"""The port's Hamming kernel K1 (orbslam2_tpu_torch/ops/cuda_kernels.py)
against the JAX package's Pallas kernel and XLA expression.

On the CPU the wrapper runs the plain PyTorch version; the CUDA kernel itself
runs only on a card (the `cuda` test below, and chip_smoke.py). Hamming
distances are integers: every comparison here is exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_tpu.ops import pallas_kernels as PK
from orbslam2_tpu_torch import _build
from orbslam2_tpu_torch.ops import cuda_kernels as CK


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
