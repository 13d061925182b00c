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


def desc_u32_to_i32(desc: np.ndarray) -> np.ndarray:
    """uint32 descriptor words -> int32 with the same bits."""
    return np.ascontiguousarray(desc, np.uint32).view(np.int32)


def desc_i32_to_u32(desc: np.ndarray) -> np.ndarray:
    """int32 descriptor words -> uint32 with the same bits."""
    return np.ascontiguousarray(desc, np.int32).view(np.uint32)


def map_from_numpy(arrays, cfg: SlamConfig) -> MapState:
    """Build the port's MapState from the JAX package's map arrays: the npz
    that orbslam2_tpu's MapState.save writes (np.load(path)), or a dict of
    a live MapState's fields ({k: getattr(mp, k) for k in
    MapState._ARRAY_FIELDS} plus next_kf_id / next_pt_id). The array path
    of MapState.load."""
    return MapState.from_arrays(arrays, cfg)


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
