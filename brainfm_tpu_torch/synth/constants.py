"""Label tables and contrast groups for the synthetic generator (port of
brainfm_tpu/synth/constants.py, kept as its own copy so the port imports
nothing of the JAX package)."""

from __future__ import annotations

import numpy as np

# the segmentation label lists
LABELS_LEFT = [0, 1, 2, 3, 4, 7, 8, 9, 10, 14, 15, 17, 31, 34, 36, 38, 40, 42]
LABELS_EXTRACEREBRAL = [0, 11, 12, 13, 16, 31, 32, 33, 34, 35, 36, 37, 38, 39,
                        40, 41, 42, 43, 44, 46,
                        1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 14, 15, 17, 47, 49, 51,
                        53, 55,
                        18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 48,
                        50, 52, 54, 56]
N_NEUTRAL = 20

# SynthSeg right->left label merge for contrast synthesis
# (parity: Generator/utils.py:646-661)
RIGHT_TO_LEFT = {41: 2, 42: 3, 43: 4, 44: 5, 46: 7, 47: 8, 49: 10, 50: 11,
                 51: 12, 52: 13, 53: 17, 54: 18, 58: 26, 60: 28}

# (parity: Generator/utils.py:663-669)
CT_BRIGHTNESS_GROUP = {
    "darker": [4, 5, 14, 15, 24, 31, 72],
    "dark": [2, 7, 16, 77, 30],
    "bright": [3, 8, 17, 18, 28, 10, 11, 12, 13, 26],
    "brighter": [],
}


def build_lut(label_list, size: int = 10000) -> np.ndarray:
    """Label id -> one-hot index (parity: Generator/datasets.py:174-176)."""
    lut = np.zeros(size, np.int32)
    for i, lab in enumerate(label_list):
        lut[lab] = i
    return lut


def build_vflip(n_labels: int, n_neutral: int = N_NEUTRAL) -> np.ndarray:
    """Left-right one-hot channel permutation under sagittal flip
    (parity: Generator/datasets.py:180-183).

    A left-hemisphere-only list has no lateral pairs (n_labels <=
    n_neutral): the permutation is the identity of length n_labels —
    matching the reference, where flip is forced OFF in left mode
    (datasets.py:483) and its vflip is "useless for left_hemis_only"
    (:179); the naive formula would emit a length-n_neutral table and
    desync the one-hot width from the model head's n_labels."""
    nlat = (n_labels - n_neutral) // 2
    if nlat <= 0:
        return np.arange(n_labels, dtype=np.int32)
    return np.concatenate([
        np.arange(n_neutral),
        np.arange(n_neutral + nlat, n_labels),
        np.arange(n_neutral, n_neutral + nlat),
    ]).astype(np.int32)
