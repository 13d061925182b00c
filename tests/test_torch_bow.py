"""ops/bow.py of the port against orbslam2_tpu/ops/bow.py and against the
host descent, on the default vocabulary (168,840 nodes) and on a small tree
with a childless inner node. On the CPU `assign_words` runs a plain version
of the `bow_assign` kernel: on the JAX package's layout of the tree, or,
given the tree's children-block table (as the main path gives it), the
kernel's own walk over that table, which must equal JAX's descent bit for
bit on every tree (the default vocabulary, a trained one with its node ids
permuted, hand-made ones). The kernel itself is held to both plain versions
on a card (the `cuda` test). Integer outputs are compared exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_slice_common as C
from orbslam2_tpu.ops import bow as JB
from orbslam2_tpu_torch.io import synth
from orbslam2_tpu_torch.io import vocabulary as TV
from orbslam2_tpu_torch.ops import bow as TB
from orbslam2_tpu_torch.ops import cuda_kernels as CK
from orbslam2_tpu_torch.ops import features as TF


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def voc():
    return TV.default_vocabulary()


@pytest.fixture(scope="module")
def room_frame():
    """Descriptors of a rendered 320x240 room frame, as the tracker extracts
    them (int32 words, 512 rows)."""
    _, cfg = C.configs()
    img = C.render(synth.sweep_trajectory(1))[0][0]
    feats = TF.extract_orb(torch.from_numpy(img), cfg.orb, C.H, C.W)
    return feats.desc.numpy(), feats.valid.numpy()


def both(voc, desc_i32, valid, packed=False):
    """(JAX's outputs, the port's) of one descent; packed=True hands the
    port the vocabulary's children-block table."""
    jax_out = JB.assign_words(
        jnp.asarray(voc.node_desc), jnp.asarray(voc.node_children),
        jnp.asarray(voc.node_word), jnp.asarray(desc_i32.view(np.uint32)),
        jnp.asarray(valid), voc.levels)
    got = TB.assign_words(*map(_t, voc.device_tables()), _t(desc_i32), _t(valid),
                          voc.levels,
                          blocks=voc.child_blocks_on("cpu") if packed else None)
    return [np.asarray(x) for x in jax_out], [x.numpy() for x in got]


def assert_same(jax_out, port_out):
    for j, t in zip(jax_out, port_out):
        assert t.dtype == np.asarray(j).dtype
        np.testing.assert_array_equal(t, j)


def permuted(voc, rng):
    """The same tree with every node id but the root's (the descent starts
    at node 0) permuted: siblings are no longer contiguous ids."""
    n = len(voc.node_desc)
    perm = np.concatenate([[0], 1 + rng.permutation(n - 1)]).astype(np.int32)
    desc, children, word = (np.empty_like(a) for a in (
        voc.node_desc, voc.node_children, voc.node_word))
    desc[perm], word[perm] = voc.node_desc, voc.node_word
    children[perm] = np.where(voc.node_children >= 0,
                              perm[np.clip(voc.node_children, 0, None)], -1)
    out = TV.Vocabulary(voc.k, voc.levels, desc, children, word, voc.word_weight,
                        perm[voc.word_node])
    return out, perm


def word_and_children_tree():
    """A tree with a childless inner node (2), a node with one child and -1
    pads (1), and a node (3) that has a word and children: the descent stops
    there (JAX's rule: step only where the node has a child and no word)."""
    rng = np.random.default_rng(4)
    node_desc = rng.integers(0, 2 ** 32, (8, 8), dtype=np.uint32)
    children = np.array([[1, 2, 3], [4, -1, -1], [-1, -1, -1], [5, 6, -1],
                         [7, -1, -1], [-1, -1, -1], [-1, -1, -1], [-1, -1, -1]],
                        np.int32)
    node_word = np.array([-1, -1, -1, 0, -1, 1, 2, 3], np.int32)
    return TV.Vocabulary(3, 4, node_desc, children, node_word,
                         np.ones(4, np.float32), np.array([3, 5, 6, 7], np.int32))


@pytest.mark.parametrize("source", ["room", "random"])
def test_assign_words_default_vocabulary(voc, room_frame, source):
    rng = np.random.default_rng(3)
    if source == "room":
        desc, valid = room_frame
        valid = valid & (rng.random(len(valid)) < 0.9)
        assert valid.sum() > 300
    else:
        desc = rng.integers(0, 2 ** 32, (700, 8), dtype=np.uint32).view(np.int32)
        valid = rng.random(700) < 0.8
    (jw, jok, jg), (tw, tok, tg) = both(voc, desc, valid)
    assert tw.dtype == np.int32 and tok.dtype == bool and tg.dtype == np.int32
    np.testing.assert_array_equal(tw, jw)
    np.testing.assert_array_equal(tok, jok)
    np.testing.assert_array_equal(tg, jg)
    host = TV.assign_words_numpy(voc, desc)
    np.testing.assert_array_equal(tw[tok], host[tok])
    assert (tg[~tok] == -1).all() and (tw[~tok] == 0).all()
    assert len(np.unique(tg[tok])) <= voc.k ** 2  # depth-2 nodes


@pytest.mark.parametrize("source", ["room", "random"])
def test_packed_descent_default_vocabulary(voc, room_frame, source):
    """The walk over the children-block table equals JAX's descent."""
    rng = np.random.default_rng(5)
    if source == "room":
        desc, valid = room_frame
        valid = valid & (rng.random(len(valid)) < 0.9)
    else:
        desc = rng.integers(0, 2 ** 32, (900, 8), dtype=np.uint32).view(np.int32)
        valid = rng.random(900) < 0.85
    jax_out, port_out = both(voc, desc, valid, packed=True)
    assert_same(jax_out, port_out)
    assert port_out[1].sum() > 0.8 * valid.sum()


@pytest.fixture(scope="module")
def trained_permuted():
    rng = np.random.default_rng(6)
    train = rng.integers(0, 2 ** 32, (1200, 8), dtype=np.uint32)
    voc = TV.train_vocabulary(train, k=4, levels=3, seed=2)
    return voc, *permuted(voc, rng)


def test_packed_descent_trained_vocabulary_permuted(trained_permuted):
    voc, pvoc, perm = trained_permuted
    # siblings are not contiguous ids any more
    inner = pvoc.node_children[(pvoc.node_children >= 0).sum(1) > 1]
    assert (np.diff(np.sort(inner, axis=1)[:, -2:], axis=1) != 1).any()
    rng = np.random.default_rng(7)
    desc = rng.integers(0, 2 ** 32, (500, 8), dtype=np.uint32).view(np.int32)
    valid = rng.random(500) < 0.9
    (jw, jok, jg), port = both(pvoc, desc, valid, packed=True)
    assert_same((jw, jok, jg), port)
    # the same words as on the unpermuted tree, the gate nodes renamed
    (w0, ok0, g0), _ = both(voc, desc, valid)
    np.testing.assert_array_equal(jw, w0)
    np.testing.assert_array_equal(jok, ok0)
    np.testing.assert_array_equal(jg[jok], perm[g0[ok0]])


def test_packed_descent_hand_made_trees():
    """The childless-inner-node tree below, and one whose node 3 has both a
    word and children, through the children-block walk."""
    rng = np.random.default_rng(0)
    node_desc = rng.integers(0, 2 ** 32, (6, 8), dtype=np.uint32)
    children = np.array([[1, 2, 3], [4, -1, -1], [-1, -1, -1], [-1, -1, -1],
                         [5, -1, -1], [-1, -1, -1]], np.int32)
    node_word = np.array([-1, -1, -1, 0, -1, 1], np.int32)
    childless = TV.Vocabulary(3, 4, node_desc, children, node_word,
                              np.ones(2, np.float32), np.array([3, 5], np.int32))
    stops = word_and_children_tree()
    for voc in (childless, stops):
        nd = voc.node_desc
        desc = np.concatenate([nd[1:], nd[1:] ^ np.uint32(1),
                               rng.integers(0, 2 ** 32, (40, 8), dtype=np.uint32)])
        valid = rng.random(len(desc)) < 0.9
        jax_out, port_out = both(voc, desc.view(np.int32), valid, packed=True)
        assert_same(jax_out, port_out)
    # on `stops` the descriptor of node 3 ends there, with node 3's word 0,
    # although node 3 has children
    jax_out, port_out = both(stops, stops.node_desc[[3]].view(np.int32),
                             np.ones(1, bool), packed=True)
    assert_same(jax_out, port_out)
    assert list(map(int, (port_out[0][0], port_out[1][0], port_out[2][0]))) == [0, 1, 3]


def test_assign_words_childless_inner_node_and_pads():
    """A tree whose node 2 is an inner node without children (no word), whose
    node 1 has one child and -1 pads, and whose leaves lie at depth 1 and 2."""
    rng = np.random.default_rng(0)
    node_desc = rng.integers(0, 2 ** 32, (6, 8), dtype=np.uint32)
    children = np.array([[1, 2, 3], [4, -1, -1], [-1, -1, -1], [-1, -1, -1],
                         [5, -1, -1], [-1, -1, -1]], np.int32)
    node_word = np.array([-1, -1, -1, 0, -1, 1], np.int32)
    voc = TV.Vocabulary(3, 4, node_desc, children, node_word,
                        np.ones(2, np.float32), np.array([3, 5], np.int32))
    desc = np.concatenate([node_desc[1:4], rng.integers(0, 2 ** 32, (40, 8),
                                                       dtype=np.uint32)])
    valid = np.ones(len(desc), bool)
    valid[5] = False
    (jw, jok, jg), (tw, tok, tg) = both(voc, desc.view(np.int32), valid)
    np.testing.assert_array_equal(tw, jw)
    np.testing.assert_array_equal(tok, jok)
    np.testing.assert_array_equal(tg, jg)
    # the descriptor equal to node 2's ends on the childless node: no word
    assert not tok[1] and tok[0] and tok[2] and tw[0] == 1 and tw[2] == 0


def test_bow_assign_refuses_what_the_kernel_cannot_take(voc):
    nd, nc, nw = map(_t, voc.device_tables())
    d, v = torch.zeros((4, 8), dtype=torch.int32), torch.ones(4, dtype=torch.bool)
    wide = torch.full((len(nd), 33), -1, dtype=torch.int32)
    with pytest.raises(ValueError, match="branching"):
        CK.bow_assign(nd, wide, nw, d, v, 5, 2)
    with pytest.raises(TypeError):
        CK.bow_assign(nd, nc, nw, d.to(torch.int64), v, 5, 2)
    with pytest.raises(ValueError, match="valid"):
        CK.bow_assign(nd, nc, nw, d, v.to(torch.uint8), 5, 2)
    w, ok, g = CK.bow_assign(nd, nc, nw, d[:0], v[:0], 5, 2)
    assert len(w) == len(ok) == len(g) == 0
    assert CK.bow_assign.launches == 0  # the CPU path launches nothing


def test_bow_vector_and_l1_scores(voc):
    rng = np.random.default_rng(1)
    words = rng.integers(0, voc.n_words, 600).astype(np.int32)
    words[:50] = words[50:100]  # repeated words
    wvalid = rng.random(600) < 0.9
    jv = np.asarray(JB.bow_vector(jnp.asarray(words), jnp.asarray(wvalid),
                                  jnp.asarray(voc.word_weight), voc.n_words))
    tv = TB.bow_vector(_t(words), _t(wvalid), _t(voc.word_weight), voc.n_words).numpy()
    np.testing.assert_allclose(tv, jv, atol=1e-6)  # f32 sums in another order
    assert abs(tv.sum() - 1.0) < 1e-5
    kf = rng.random((5, 300)).astype(np.float32)
    kf /= kf.sum(1, keepdims=True)
    q = kf[2] * 0.5 + kf[3] * 0.5
    np.testing.assert_allclose(TB.l1_scores(_t(q), _t(kf)).numpy(),
                               np.asarray(JB.l1_scores(jnp.asarray(q), jnp.asarray(kf))),
                               atol=1e-6)


def test_bow_assign_refuses_a_malformed_packed_table(voc):
    nd, nc, nw = map(_t, voc.device_tables())
    d, v = torch.zeros((4, 8), dtype=torch.int32), torch.ones(4, dtype=torch.bool)
    good = voc.child_blocks_on("cpu")
    table = good.table
    for bad in (good._replace(table=table.numpy()),               # not a tensor
                good._replace(table=table.to(torch.int64)),       # dtype
                good._replace(table=table[:, :5].contiguous()),   # another k
                good._replace(table=table[..., :8].contiguous()),  # row width
                good._replace(table=table.transpose(0, 1)),       # not contiguous
                good._replace(root_block=len(table)),             # root outside
                good._replace(n_top=len(table) + 1)):             # top outside
        with pytest.raises(ValueError, match="blocks"):
            CK.bow_assign(nd, nc, nw, d, v, voc.levels, TB.GATE_DEPTH, blocks=bad)


def test_bow_assign_writes_into_out(voc):
    tables = list(map(_t, voc.device_tables()))
    rng = np.random.default_rng(2)
    d = _t(rng.integers(0, 2 ** 32, (30, 8), dtype=np.uint32).view(np.int32))
    v = torch.ones(30, dtype=torch.bool)
    out = (torch.zeros(30, dtype=torch.int32), torch.zeros(30, dtype=torch.bool),
           torch.zeros(30, dtype=torch.int32))
    got = CK.bow_assign(*tables, d, v, voc.levels, TB.GATE_DEPTH,
                        blocks=voc.child_blocks_on("cpu"), out=out)
    assert all(g is o for g, o in zip(got, out))
    want = CK.bow_assign_ref(*tables, d, v, voc.levels, TB.GATE_DEPTH)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="out="):
        CK.bow_assign(*tables, d, v, voc.levels, TB.GATE_DEPTH, out=out[:2])
    with pytest.raises(ValueError, match="out="):
        CK.bow_assign(*tables, d, v, voc.levels, TB.GATE_DEPTH,
                      out=(out[0], out[1], out[2].to(torch.int64)))


@pytest.mark.cuda
def test_bow_assign_kernel_equals_its_plain_version(voc):
    """The kernel on the packed table, at ragged and main-path sizes, against
    both plain versions; once without the table, which it packs on the fly."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the bow_assign kernel has no CPU form")
    rng = np.random.default_rng(0)
    tables = [_t(a).cuda() for a in voc.device_tables()]
    blocks = voc.child_blocks_on("cuda")
    for m in (1, 37, 1023, 2048):
        d = _t(rng.integers(0, 2 ** 32, (m, 8), dtype=np.uint32).view(np.int32)).cuda()
        v = _t(rng.random(m) < 0.9).cuda()
        before = CK.bow_assign.launches
        got = CK.bow_assign(*tables, d, v, voc.levels, TB.GATE_DEPTH, blocks=blocks)
        torch.cuda.synchronize()
        assert CK.bow_assign.launches == before + 1
        for ref in (CK.bow_assign_ref(*tables, d, v, voc.levels, TB.GATE_DEPTH),
                    CK.bow_assign_blocks_ref(blocks, d, v, voc.levels, TB.GATE_DEPTH)):
            for x, y in zip(got, ref):
                assert x.dtype == y.dtype and torch.equal(x, y)
    packed = CK.bow_assign.packed_on_the_fly
    again = CK.bow_assign(*tables, d, v, voc.levels, TB.GATE_DEPTH)
    assert CK.bow_assign.packed_on_the_fly == packed + 1
    assert all(torch.equal(x, y) for x, y in zip(again, got))
