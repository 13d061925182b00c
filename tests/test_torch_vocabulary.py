"""The port's vocabulary module (io/vocabulary.py) against the JAX package's:
the shipped file is the same file, and load/save, the host descent, the
ORBvoc text parser and training give the same arrays on the same inputs."""
import hashlib

import numpy as np
import pytest

from orbslam2_tpu.io import vocabulary as JV
from orbslam2_tpu.system import DEFAULT_VOCAB as J_DEFAULT
from orbslam2_tpu_torch import interop
from orbslam2_tpu_torch.io import vocabulary as TV

FIELDS = ("node_desc", "node_children", "node_word", "word_weight", "word_node")


def rand_desc(rng, n):
    return rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)


def assert_same_vocabulary(a, b):
    assert (a.k, a.levels) == (b.k, b.levels)
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.fixture(scope="module")
def trained():
    d = rand_desc(np.random.default_rng(0), 1500)
    return (JV.train_vocabulary(d, k=5, levels=3, seed=1),
            TV.train_vocabulary(d, k=5, levels=3, seed=1))


def test_default_vocabulary_is_the_same_file():
    digest = [hashlib.sha256(p.read_bytes()).hexdigest()
              for p in (J_DEFAULT, TV.DEFAULT_VOCAB)]
    assert digest[0] == digest[1]
    voc = TV.default_vocabulary()
    assert voc is TV.default_vocabulary()  # loaded once
    assert (voc.k, voc.levels, len(voc.node_desc), voc.n_words) == (11, 5, 168840, 152892)


def test_train_vocabulary_gives_the_same_tree(trained):
    assert_same_vocabulary(*trained)
    assert trained[1].n_words > 50


def test_save_load_round_trip(trained, tmp_path):
    trained[1].save(tmp_path / "v.npz")
    assert_same_vocabulary(TV.Vocabulary.load(tmp_path / "v.npz"), trained[1])
    # either package reads the other's file
    assert_same_vocabulary(JV.Vocabulary.load(tmp_path / "v.npz"), trained[0])


@pytest.mark.parametrize("as_int32", [False, True])
def test_assign_words_numpy_equals_jax(trained, as_int32):
    d = rand_desc(np.random.default_rng(2), 300)
    want = JV.assign_words_numpy(trained[0], d)
    got = TV.assign_words_numpy(trained[1], d.view(np.int32) if as_int32 else d)
    np.testing.assert_array_equal(got, want)


def test_load_orbvoc_text_equals_jax(tmp_path):
    rng = np.random.default_rng(0)
    lines = ["2 2 0 0"]
    for parent, leaf, w in ((0, 0, 0.0), (0, 0, 0.0), (1, 1, 0.5), (1, 1, 0.7),
                            (2, 1, 0.9), (2, 1, 1.1)):
        lines.append(f"{parent} {leaf} " + " ".join(map(str, rng.integers(0, 256, 32)))
                     + f" {w:.6f}")
    p = tmp_path / "voc.txt"
    p.write_text("\n".join(lines) + "\n")
    a, b = JV.load_orbvoc_text(p), TV.load_orbvoc_text(p)
    assert_same_vocabulary(a, b)
    assert b.n_words == 4 and set(b.node_children[0]) == {1, 2}


def test_interop_and_device_tables(trained):
    voc = interop.vocabulary_from_numpy(trained[0])
    assert_same_vocabulary(voc, trained[1])
    nd, nc, nw = voc.device_tables()
    assert nd.dtype == nc.dtype == nw.dtype == np.int32
    np.testing.assert_array_equal(nd.view(np.uint32), trained[0].node_desc)
