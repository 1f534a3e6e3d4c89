"""Per-frustum ground-truth class histograms for the fp loss (NumPy).

A copy of `compute_frustum_class_dists` and `world_order_target` of
`occdepth_tpu/geometry/frustums_mask.py` (its NumPy path).  The voxel
masks themselves are rebuilt on the device inside the loss
(`losses/fp_device.py`); the data side only needs these (F, C) tables.
"""
from __future__ import annotations

import numpy as np


def world_order_target(target: np.ndarray, dataset: str) -> np.ndarray:
    """A target volume in flat world voxel order, the (X, Y, Z)-'ij'
    flattening the projections index.  KITTI/TartanAir targets already are;
    the NYU target is (X, Zup, Y)."""
    if dataset == "NYU":
        return np.ascontiguousarray(np.transpose(target, (0, 2, 1)))
    return target


def compute_frustum_class_dists(
    projected_pix: np.ndarray,
    pix_z: np.ndarray,
    target: np.ndarray,
    img_W: int,
    img_H: int,
    dataset: str,
    n_classes: int,
    size: int = 4,
) -> np.ndarray:
    """GT class counts of each of the size x size image-tile frustums.

    Args:
        projected_pix: (V, N, P, 2) per-view pattern pixels; only the centre
            point (P index 0) is used.
        pix_z: (V, N) per-view voxel depths.
        target: voxel labels (255 = invalid).
        img_W, img_H: image dims.
        dataset: "kitti" | "NYU" | "tartanair" (the target's layout).
        n_classes: histogram size.
        size: tiles per image side; size^2 frustums, tile t = iy*size + ix.

    Returns (size^2, n_classes) float64 counts; a voxel seen by several
    views in one tile counts once.
    """
    px = projected_pix[:, :, 0, 0]  # (V, N)
    py = projected_pix[:, :, 0, 1]
    V = px.shape[0]
    T = size * size
    cls = world_order_target(target, dataset).reshape(-1).astype(np.int32)

    # integer tile index: floor(p*size/dim) == (p*size)//dim for p >= 0
    # (negative pixels are culled by `valid` before use)
    ix = (px * size) // img_W
    iy = (py * size) // img_H
    valid = (px >= 0) & (px < img_W) & (py >= 0) & (py < img_H) & (pix_z > 0)
    tile = np.where(valid, iy * size + ix, -1)  # (V, N)
    cls_valid = cls != 255

    dists = np.zeros(T * n_classes, dtype=np.float64)
    for v in range(V):
        new = (tile[v] >= 0) & cls_valid
        for u in range(v):  # OR over views: each (voxel, tile) once
            new &= tile[u] != tile[v]
        dists += np.bincount(
            tile[v][new] * n_classes + cls[new], minlength=T * n_classes
        )
    return dists.reshape(T, n_classes)
