"""Map checkpoint / resume: save and load the full SLAM state.

The reference never implemented this — `// TODO: Save/Load functions
SaveMap/LoadMap` (reference: include/System.h:115-117) — which also means
its localization-only mode can never start from a stored map. Because the
map here is already a struct-of-arrays (slam_map/mapstate.py), a
checkpoint is one compressed npz of those arrays plus scalar counters;
the BoW vocabulary (needed for relocalization against the stored map)
rides along in the same file.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from c_orb_slam_tpu.config import SlamConfig
from c_orb_slam_tpu.slam_map.mapstate import MapState

_ARRAY_FIELDS = [
    "kf_pose", "kf_valid", "kf_frame_id", "kf_serial", "kf_timestamp",
    "kf_xy", "kf_octave", "kf_angle",
    "kf_desc", "kf_ur", "kf_depth", "kf_kp_valid", "kf_mp",
    "pt_xyz", "pt_desc", "pt_normal", "pt_min_dist", "pt_max_dist",
    "pt_valid", "pt_ref_kf", "pt_first_kf", "pt_visible", "pt_found",
    "pt_replaced_by", "pt_serial", "pt_obs_kf", "pt_obs_feat", "pt_n_obs",
    "covis", "spanning_parent",
]
_SCALAR_FIELDS = [
    "n_keyframes", "n_added_keyframes", "n_added_points", "big_change_idx",
]


def save_map(path: str, mapstate: MapState, vocabulary=None):
    """Write the map (and optional vocabulary) to one .npz file."""
    data = {f: getattr(mapstate, f) for f in _ARRAY_FIELDS}
    for f in _SCALAR_FIELDS:
        data[f] = np.asarray(getattr(mapstate, f))
    if vocabulary is not None:
        import jax.numpy as jnp  # noqa: F401

        data["voc_k"] = np.asarray(vocabulary.k)
        data["voc_L"] = np.asarray(vocabulary.L)
        data["voc_levels_up"] = np.asarray(vocabulary.levels_up)
        data["voc_word_weight"] = np.asarray(vocabulary.word_weight)
        for l in range(vocabulary.L):
            data[f"voc_level_{l}"] = np.asarray(vocabulary.levels[l])
            data[f"voc_valid_{l}"] = np.asarray(vocabulary.valid[l])
    np.savez_compressed(path, **data)


def load_map(path: str, cfg: SlamConfig) -> tuple[MapState, Optional[object]]:
    """Rebuild (MapState, Vocabulary-or-None) from a checkpoint.

    Stored capacities win over cfg capacities (arrays are loaded as-is);
    cfg supplies everything else (thresholds, camera, ...).
    """
    z = np.load(path, allow_pickle=False)
    m = MapState(cfg)
    for f in _ARRAY_FIELDS:
        if f in z:
            setattr(m, f, z[f].copy())
    for f in _SCALAR_FIELDS:
        if f in z:
            setattr(m, f, int(z[f]))
    if "kf_serial" not in z:
        # Pre-serial checkpoint: slots were never recycled, so slot id
        # order IS insertion order.
        m.kf_serial[: m.n_keyframes] = np.arange(m.n_keyframes)
    if "n_added_keyframes" not in z:
        m.n_added_keyframes = m.n_keyframes
    if "pt_serial" not in z:
        # Pre-serial checkpoint: give live points fresh serials.
        live = np.nonzero(m.pt_valid)[0]
        m.pt_serial[live] = np.arange(len(live))
        m.n_added_points = len(live)
    voc = None
    if "voc_k" in z:
        import jax.numpy as jnp

        from c_orb_slam_tpu.bow.vocab import Vocabulary

        L = int(z["voc_L"])
        voc = Vocabulary(
            k=int(z["voc_k"]),
            L=L,
            levels=tuple(jnp.asarray(z[f"voc_level_{l}"]) for l in range(L)),
            valid=tuple(jnp.asarray(z[f"voc_valid_{l}"]) for l in range(L)),
            word_weight=jnp.asarray(z["voc_word_weight"]),
            levels_up=int(z["voc_levels_up"]),
        )
    return m, voc
