"""State shared with the JAX package: descriptors, maps, the vocabulary and
the keyframe database.

The two packages share no learned weights. What they share is the seeded
BRIEF pattern (copied in ops/features.py), the configuration, the map, the
vocabulary file and what the keyframe database holds.
The JAX package stores descriptors as uint32 words; the port stores the same
bits as int32 (ops/cuda_kernels.py), and these helpers convert between them.
"""
from __future__ import annotations

import numpy as np

from .config import SlamConfig
from .io.vocabulary import Vocabulary
from .map.keyframe_db import KeyFrameDatabase
from .map.mapstate import MapState

_DESC_FIELDS = ("kf_desc", "pt_desc")


def desc_u32_to_i32(desc: np.ndarray) -> np.ndarray:
    """uint32 descriptor words -> int32 with the same bits."""
    return np.ascontiguousarray(desc, np.uint32).view(np.int32)


def desc_i32_to_u32(desc: np.ndarray) -> np.ndarray:
    """int32 descriptor words -> uint32 with the same bits."""
    return np.ascontiguousarray(desc, np.int32).view(np.uint32)


def map_from_numpy(arrays: dict, cfg: SlamConfig) -> MapState:
    """Build the port's MapState from the JAX package's map arrays: the npz
    that orbslam2_tpu's MapState.save writes (np.load(path)), or a dict of
    a live MapState's fields ({k: getattr(mp, k) for k in
    MapState._ARRAY_FIELDS} plus next_kf_id / next_pt_id)."""
    n_feat = int(arrays["n_feat"]) if "n_feat" in arrays else arrays["kf_xy"].shape[1]
    mp = MapState(cfg, n_feat)
    for k in MapState._ARRAY_FIELDS:
        if k not in arrays:
            continue
        a = np.asarray(arrays[k])
        if k in _DESC_FIELDS:
            a = desc_u32_to_i32(a)
        setattr(mp, k, a.astype(getattr(mp, k).dtype, copy=True))
    n_pts = mp.pt_valid.shape[0]
    mp.pt_redirect = np.full(n_pts, -1, np.int32)
    if "next_kf_id" in arrays:
        mp.next_kf_id = int(arrays["next_kf_id"])
    else:
        kfs = np.flatnonzero(mp.kf_valid)
        mp.next_kf_id = int(kfs[-1]) + 1 if len(kfs) else 0
    if "next_pt_id" in arrays:
        mp.next_pt_id = min(int(arrays["next_pt_id"]), n_pts)
    else:
        used = np.flatnonzero(mp.pt_valid)
        mp.next_pt_id = int(used[-1]) + 1 if len(used) else 0
    # no live frame holds point ids of this map: freed slots are reusable
    mp._pt_free = [int(i) for i in np.flatnonzero(~mp.pt_valid[:mp.next_pt_id])]
    for k, a, T in zip(arrays.get("retired_k", ()), arrays.get("retired_anchor", ()),
                       arrays.get("retired_T", ())):
        mp.kf_retired[int(k)] = (int(a), np.asarray(T, np.float32))
    mp.generation += 1
    mp._dirty_pts = None  # the device mirror uploads the whole table
    return mp


def vocabulary_from_numpy(arrays) -> Vocabulary:
    """The port's Vocabulary from the JAX package's: its object, a dict of
    its fields, or the npz it saves (np.load(path)). Node descriptors stay
    uint32 words, the file format of both packages;
    `Vocabulary.device_tables` gives the int32 bit-views for the device."""
    get = (lambda k: arrays[k]) if hasattr(arrays, "__getitem__") else (
        lambda k: getattr(arrays, k))
    return Vocabulary(
        int(get("k")), int(get("levels")),
        np.array(get("node_desc"), np.uint32), np.array(get("node_children"), np.int32),
        np.array(get("node_word"), np.int32), np.array(get("word_weight"), np.float32),
        np.array(get("word_node"), np.int32))


def keyframe_db_from_numpy(arrays, cfg: SlamConfig, mp: MapState,
                           n_words: int) -> KeyFrameDatabase:
    """The port's KeyFrameDatabase over `mp` holding what the JAX package's
    holds: `arrays` is that database or a dict of its `word_ids`, `weights`
    and `registered`."""
    get = (lambda k: arrays[k]) if isinstance(arrays, dict) else (
        lambda k: getattr(arrays, k))
    word_ids = np.asarray(get("word_ids"))
    db = KeyFrameDatabase(cfg, mp, n_words, max_words_per_kf=word_ids.shape[1])
    db.word_ids = word_ids.astype(np.int32, copy=True)
    db.weights = np.asarray(get("weights")).astype(np.float32, copy=True)
    db.registered = np.asarray(get("registered")).astype(bool, copy=True)
    return db
