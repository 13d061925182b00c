"""The port's vocabulary module (io/vocabulary.py) against the JAX package's:
the shipped file is the same file, and load/save, the host descent, the
ORBvoc text parser and training give the same arrays on the same inputs.
The children-block table the `bow_assign` kernel descends is the port's
own: its invariants are checked against the tree it packs, and its uploads
against threads that ask at once."""
import hashlib
import threading

import numpy as np
import pytest
import torch

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


def steps(voc):
    """Where JAX's descent steps: a child and no word."""
    return (voc.node_children >= 0).any(1) & (voc.node_word < 0)


def handmade():
    """A childless inner node (2), a node with a word and children (3), -1
    pads."""
    rng = np.random.default_rng(4)
    children = np.array([[1, 2, 3], [4, -1, -1], [-1, -1, -1], [5, 6, -1],
                         [7, -1, -1], [-1, -1, -1], [-1, -1, -1], [-1, -1, -1]],
                        np.int32)
    return TV.Vocabulary(3, 4, rand_desc(rng, 8), children,
                         np.array([-1, -1, -1, 0, -1, 1, 2, 3], np.int32),
                         np.ones(4, np.float32), np.array([3, 5, 6, 7], np.int32))


@pytest.mark.parametrize("which", ["default", "trained", "handmade"])
def test_child_blocks_invariants(trained, which):
    voc = {"default": TV.default_vocabulary, "trained": lambda: trained[1],
           "handmade": handmade}[which]()
    b = voc.child_blocks()
    t = b.table
    assert t.dtype == np.int32 and t.shape[1:] == (voc.k, TV.BLOCK_ROW)
    # one block per node that steps (every one of these trees' is reached)
    assert len(t) == int(steps(voc).sum())
    assert b.root_block == (0 if steps(voc)[0] else -1)
    assert b.root_word == voc.node_word[0]
    node = t[..., TV.ROW_NODE]
    has = node >= 0
    # each block holds one parent's children, in order, with their rows
    parent_of = np.full(len(voc.node_word), -1)
    rows, _ = np.nonzero(voc.node_children >= 0)
    parent_of[voc.node_children[voc.node_children >= 0]] = rows
    parents = parent_of[node[:, 0]]
    np.testing.assert_array_equal(node, voc.node_children[parents])
    c = np.where(has, node, 0)
    np.testing.assert_array_equal(t[..., :8][has],
                                  voc.node_desc.view(np.int32)[c][has])
    np.testing.assert_array_equal(t[..., TV.ROW_WORD][has], voc.node_word[c][has])
    # a -1 block wherever JAX would not step, else the child's own block
    blk = t[..., TV.ROW_BLOCK]
    np.testing.assert_array_equal(blk[has] >= 0, steps(voc)[c][has])
    own = blk[has & (blk >= 0)]
    assert len(np.unique(own)) == len(own) == len(t) - (b.root_block >= 0)
    np.testing.assert_array_equal(parents[own], node[has & (blk >= 0)])
    # empty rows: no block, no word, no node, a zero descriptor
    assert (blk[~has] == -1).all() and (t[..., TV.ROW_WORD][~has] == -1).all()
    assert (t[..., :8][~has] == 0).all()
    # breadth-first: the root's block and its children's come first
    assert b.n_top == 1 + int(steps(voc)[voc.node_children[0][voc.node_children[0] >= 0]]
                              .sum())
    if which == "default":
        assert (len(t), b.n_top, t.nbytes) == (15948, 12, 15948 * 11 * 48)


def test_pack_child_blocks_refuses_what_is_not_a_tree():
    voc = handmade()
    loop = voc.node_children.copy()
    loop[4, 0] = 1  # node 4 points back to its parent
    with pytest.raises(ValueError, match="not a tree"):
        TV.pack_child_blocks(voc.node_desc, loop, voc.node_word)
    with pytest.raises(ValueError, match="outside"):
        TV.pack_child_blocks(voc.node_desc, np.where(loop == 1, 99, loop),
                             voc.node_word)


def test_device_uploads_happen_once_under_threads(monkeypatch, trained):
    """device_tables_on, child_blocks_on and utils.device.constant fill
    their caches under a lock: threads that ask at once get one upload."""
    from orbslam2_tpu_torch.utils import device as D
    voc = TV.Vocabulary(*(getattr(trained[1], f) for f in (
        "k", "levels", "node_desc", "node_children", "node_word", "word_weight",
        "word_node")))
    calls = []
    real = D.upload_and_wait

    def slow_upload(a, device):
        calls.append(a.shape)
        threading.Event().wait(0.01)  # widen the race a check without a lock has
        return real(a, device)

    monkeypatch.setattr(TV, "upload_and_wait", slow_upload)
    monkeypatch.setattr(D, "upload_and_wait", slow_upload)
    key = ("test-constant", len(calls))
    got = []

    def ask():
        got.append((voc.device_tables_on("cpu"), voc.child_blocks_on("cpu"),
                    D.constant(key, lambda: np.arange(5), torch.device("cpu"))))

    threads = [threading.Thread(target=ask) for _ in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert len(calls) == 3 + 1 + 1  # three tables, the block table, the constant
    assert all(g[0] is got[0][0] and g[1] is got[0][1] and g[2] is got[0][2]
               for g in got)
    assert torch.equal(got[0][1].table, torch.from_numpy(voc.child_blocks().table))
