"""The port's vocabulary trainer (orbslam2_tpu_torch/train_vocab.py and the
device path of io/vocabulary.train_vocabulary) against the JAX package's
scripts/train_vocab.py, loaded with importlib: the blur against scipy, the
gathered descriptors against the JAX script's (BRIEF rounding aside), and
the tree trained through the plain versions of `hamming_best2` and
`bow_assign` against JAX's tree, exactly."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from orbslam2_tpu.io import vocabulary as JV
from orbslam2_tpu_torch import train_vocab as TT
from orbslam2_tpu_torch.io import vocabulary as TV

ROOT = Path(__file__).resolve().parent.parent
FIELDS = ("node_desc", "node_children", "node_word", "word_node", "word_weight")
N_SCENES, N_FEATURES = 5, 3000   # one scene of each image mode


def jax_script():
    spec = importlib.util.spec_from_file_location("jax_train_vocab",
                                                  ROOT / "scripts" / "train_vocab.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def counting(monkeypatch, module, counts: list) -> None:
    """Record the valid keypoints of every extract_orb call of `module`."""
    orig = module.extract_orb

    def run(*a, **kw):
        f = orig(*a, **kw)
        counts.append(int(np.asarray(f.valid).sum()) if not torch.is_tensor(f.valid)
                      else int(f.valid.sum()))
        return f
    monkeypatch.setattr(module, "extract_orb", run)


@pytest.fixture(scope="module")
def gathered():
    """(JAX's descriptors, the port's, scene counts of each)."""
    mp = pytest.MonkeyPatch()
    try:
        torch.set_num_threads(2)
        jmod, jcounts, tcounts = jax_script(), [], []
        counting(mp, jmod, jcounts)
        counting(mp, TT, tcounts)
        jd = jmod.gather_descriptors(N_SCENES, N_FEATURES)
        td = TT.gather_descriptors(N_SCENES, N_FEATURES, "cpu")
    finally:
        mp.undo()
    return jd, td, jcounts, tcounts


@pytest.mark.parametrize("sigma", [1.0, 2.5, 4.0])
def test_gaussian_filter_is_scipys(sigma):
    rng = np.random.default_rng(int(sigma * 10))
    img = np.kron(rng.uniform(0, 255, (30, 40)), np.ones((16, 16)))  # image mode 1
    np.testing.assert_allclose(TT._gaussian_filter(img, sigma),
                               gaussian_filter(img, sigma), rtol=0, atol=1e-9)


def test_gathered_descriptors_match_the_jax_script(gathered):
    jd, td, jcounts, tcounts = gathered
    assert len(jcounts) == len(tcounts) == N_SCENES
    assert jcounts == tcounts and len(jd) == len(td) == sum(jcounts)
    assert jd.dtype == td.dtype == np.uint32 and td.shape[1] == 8
    def hamming(a, b):
        return np.unpackbits((a ^ b).view(np.uint8), axis=-1).sum(axis=-1)

    bits = hamming(jd, td)
    assert (bits == 0).mean() >= 0.995, (bits > 0).sum()
    # a differing row is the BRIEF rounding of a .5 px rotated sample
    # (ROADMAP, expected differences): at most 2 bits from a row of the same
    # scene. Not always in place: on the float pyramid levels two keypoints
    # whose scores differ in the last bits can come out of the selection in
    # the other order (tests/test_torch_features.py), which swaps two rows
    # (3 pairs of the 14,953 rows here)
    ends = np.cumsum(jcounts)
    for r in np.flatnonzero(bits > 0):
        s = np.searchsorted(ends, r, side="right")
        scene = td[ends[s] - jcounts[s]:ends[s]]
        assert hamming(scene, jd[r]).min() <= 2, (r, bits[r])


@pytest.mark.parametrize("k,levels,rows", [(5, 3, None), (10, 4, 2000)])
def test_device_path_trains_the_jax_tree(gathered, k, levels, rows):
    """The device path on CPU tensors (the plain versions of both kernels)
    against JAX's host trainer, on the JAX-gathered descriptors. 2,000 rows
    at k=10, 4 levels leave leaves above the last level and short child
    lists."""
    d = gathered[0][:rows]
    jv = JV.train_vocabulary(d, k=k, levels=levels, seed=0, max_train=800_000)
    seconds = {}
    tv = TV.train_vocabulary(d, k=k, levels=levels, seed=0, max_train=800_000,
                             device="cpu", seconds=seconds)
    assert (tv.k, tv.levels) == (jv.k, jv.levels)
    for f in FIELDS:
        x, y = getattr(jv, f), getattr(tv, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert set(seconds) == {"split", "idf"}
    if rows is not None:
        depth = np.zeros(len(tv.node_desc), int)
        for i, ch in enumerate(tv.node_children):
            depth[ch[ch >= 0]] = depth[i] + 1
        n_children = (tv.node_children >= 0).sum(axis=1)
        assert (depth[tv.word_node] < levels).any()           # early leaves
        assert ((n_children > 0) & (n_children < k)).any()    # short child lists


def test_cli_writes_a_file_both_packages_read(tmp_path, capsys):
    out = tmp_path / "voc.npz"
    rc = TT.main([str(out), "--device", "cpu", "--scenes", "2", "--features", "400",
                  "--k", "4", "--levels", "2"])
    assert rc == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("scene 0/2: ")
    assert lines[1].startswith("total descriptors: ")
    assert lines[2].startswith("trained in ")
    assert lines[3].startswith(f"saved {out} words: ")
    jv, tv = JV.Vocabulary.load(out), TV.Vocabulary.load(out)
    assert (jv.k, jv.levels) == (tv.k, tv.levels) == (4, 2)
    assert 1 < jv.n_words <= 16 and int(lines[3].split()[-1]) == jv.n_words
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(jv, f), getattr(tv, f), err_msg=f)


def test_cli_needs_an_output_path(capsys):
    with pytest.raises(SystemExit) as exc:
        TT.main([])
    assert exc.value.code == 2
    assert "out" in capsys.readouterr().err
