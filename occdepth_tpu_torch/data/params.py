"""Dataset constants: class names and loss weights (NumPy).

A copy of `occdepth_tpu/data/params.py` (dataset statistics, not code):
class_weights = 1 / log(freq + 0.001), as the reference's train script
computes them.
"""
from __future__ import annotations

import numpy as np

SEMANTIC_KITTI_CLASS_FREQUENCIES = np.array([
    5.41773033e09, 1.57835390e07, 1.25136000e05, 1.18809000e05,
    6.46799000e05, 8.21951000e05, 2.62978000e05, 2.83696000e05,
    2.04750000e05, 6.16887030e07, 4.50296100e06, 4.48836500e07,
    2.26992300e06, 5.68402180e07, 1.57196520e07, 1.58442623e08,
    2.06162300e06, 3.69705220e07, 1.15198800e06, 3.34146000e05,
])

KITTI_CLASS_NAMES = [
    "empty", "car", "bicycle", "motorcycle", "truck", "other-vehicle",
    "person", "bicyclist", "motorcyclist", "road", "parking", "sidewalk",
    "other-ground", "building", "fence", "vegetation", "trunk", "terrain",
    "pole", "traffic-sign",
]

NYU_CLASS_NAMES = [
    "empty", "ceiling", "floor", "wall", "window", "chair", "bed", "sofa",
    "table", "tvs", "furn", "objs",
]
NYU_CLASS_WEIGHTS = np.array(
    [0.05, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1], np.float32
)

TARTANAIR_CLASS_NAMES = [
    "empty", "ceiling", "floor", "wall", "window", "chair", "rug", "sofa",
    "screen", "tvs", "furn", "clock", "bonasai", "objs",
]
TARTANAIR_CLASS_WEIGHTS = np.array([0.05] + [1.0] * 13, np.float32)


def class_weights_for(dataset: str) -> np.ndarray:
    """Semantic class weights for the CE loss."""
    if dataset == "kitti":
        return (1.0 / np.log(SEMANTIC_KITTI_CLASS_FREQUENCIES + 0.001)).astype(
            np.float32
        )
    if dataset == "NYU":
        return NYU_CLASS_WEIGHTS
    if dataset == "tartanair":
        return TARTANAIR_CLASS_WEIGHTS
    raise ValueError(dataset)


def class_weights_occ_for(dataset: str) -> np.ndarray:
    """Binary occupancy weights for the cascade head's CE loss."""
    if dataset == "kitti":
        freq = SEMANTIC_KITTI_CLASS_FREQUENCIES
        occ = np.array([freq[0], freq[1:].sum()])
        return (1.0 / np.log(occ + 0.001)).astype(np.float32)
    return np.array([0.05, 2.0], np.float32)


def class_names_for(dataset: str):
    return {
        "kitti": KITTI_CLASS_NAMES,
        "NYU": NYU_CLASS_NAMES,
        "tartanair": TARTANAIR_CLASS_NAMES,
    }[dataset]
