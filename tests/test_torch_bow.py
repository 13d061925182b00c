"""ops/bow.py of the port against orbslam2_tpu/ops/bow.py and against the
host descent, on the default vocabulary (168,840 nodes) and on a small tree
with a childless inner node. On the CPU `assign_words` runs the plain version
of the `bow_assign` kernel; the kernel itself is held to that plain version
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


def both(voc, desc_i32, valid):
    jax_out = JB.assign_words(
        jnp.asarray(voc.node_desc), jnp.asarray(voc.node_children),
        jnp.asarray(voc.node_word), jnp.asarray(desc_i32.view(np.uint32)),
        jnp.asarray(valid), voc.levels)
    got = TB.assign_words(*map(_t, voc.device_tables()), _t(desc_i32), _t(valid),
                          voc.levels)
    return [np.asarray(x) for x in jax_out], [x.numpy() for x in got]


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


@pytest.mark.cuda
def test_bow_assign_kernel_equals_its_plain_version(voc):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the bow_assign kernel has no CPU form")
    rng = np.random.default_rng(0)
    tables = [_t(a).cuda() for a in voc.device_tables()]
    for m in (1, 37, 1024, 2048):
        d = _t(rng.integers(0, 2 ** 32, (m, 8), dtype=np.uint32).view(np.int32)).cuda()
        v = _t(rng.random(m) < 0.9).cuda()
        before = CK.bow_assign.launches
        got = CK.bow_assign(*tables, d, v, voc.levels, TB.GATE_DEPTH)
        torch.cuda.synchronize()
        assert CK.bow_assign.launches == before + 1
        for x, y in zip(got, CK.bow_assign_ref(*tables, d, v, voc.levels, TB.GATE_DEPTH)):
            assert x.dtype == y.dtype and torch.equal(x, y)
