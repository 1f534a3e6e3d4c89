"""Voxel-to-pixel projection geometry (host-side NumPy).

A copy of the entry points of `occdepth_tpu/geometry/projection.py` the
serving path needs (importing that package's geometry modules pulls in
JAX).  Results are bit-identical to it (`tests/test_torch_port_modules.py`).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

# DSO-style residual pixel patterns, indexed by the `pattern_id` config key
PIXEL_PATTERNS = (
    ((0, 0),),
    ((0, 0), (0, -1), (-1, 0), (1, 0), (0, 1)),
    ((0, 0), (-1, -1), (1, 1), (-1, 1), (1, -1)),
    (
        (0, 0), (-1, -1), (-1, 0), (-1, 1), (-1, 0),
        (0, 1), (1, -1), (1, 0), (1, 1),
    ),
    (
        (0, 0), (0, -2), (-1, -1), (1, -1), (-2, 0),
        (2, 0), (-1, 1), (1, 1), (0, 2),
    ),
    (
        (0, 0), (0, -2), (-1, -1), (1, -1), (-2, 0), (2, 0),
        (-1, 1), (1, 1), (0, 2), (-2, -2), (-2, 2), (2, -2), (2, 2),
    ),
    (
        (0, 0), (-2, -2), (-2, -1), (-2, 0), (-2, 1), (-2, 2),
        (-1, -2), (-1, -1), (-1, 0), (-1, 1), (-1, 2),
        (0, -2), (0, -1), (0, 1), (0, 2),
        (1, -2), (1, -1), (1, 0), (1, 1), (1, 2),
        (2, -2), (2, -1), (2, 0), (2, 1), (2, 2),
    ),
    ((0, 0), (0, -2), (-1, -1), (1, -1), (-2, 0), (2, 0), (-1, 1), (0, 2)),
    (
        (0, 0), (0, -2), (-1, -1), (1, -1), (-2, 0), (2, 0),
        (-1, 1), (1, 1), (0, 2), (-2, -2), (-2, 2), (2, -2), (2, 2),
        (-3, -1), (-3, 1), (3, -1), (3, 1), (1, -3), (-1, -3), (1, 3), (-1, 3),
    ),
)


def voxel_centroids(
    vox_origin: np.ndarray, vol_dim: Tuple[int, int, int], voxel_size: float
) -> np.ndarray:
    """(N, 3) float32 voxel centres, row-major over an (X, Y, Z) grid."""
    xv, yv, zv = np.meshgrid(
        np.arange(vol_dim[0]), np.arange(vol_dim[1]), np.arange(vol_dim[2]),
        indexing="ij",
    )
    coords = np.stack(
        [xv.reshape(-1), yv.reshape(-1), zv.reshape(-1)], axis=1
    ).astype(np.float32)
    origin = np.asarray(vox_origin, dtype=np.float32)
    return origin[None, :] + voxel_size * (coords + 0.5)


def rigid_transform(points: np.ndarray, transform: np.ndarray) -> np.ndarray:
    """Apply a 4x4 rigid transform to (N, 3) points."""
    points = np.asarray(points, dtype=np.float32)
    rot = transform[:3, :3].astype(np.float32)
    trans = transform[:3, 3].astype(np.float32)
    return points @ rot.T + trans[None, :]


def project_pattern_pixels(
    cam_pts: np.ndarray, cam_k: np.ndarray, pattern_id: int
) -> np.ndarray:
    """Camera-frame points -> int64 (N, P, 2) pattern pixels (x, y)."""
    fx, fy = float(cam_k[0, 0]), float(cam_k[1, 1])
    cx, cy = float(cam_k[0, 2]), float(cam_k[1, 2])
    z = cam_pts[:, 2]
    x_center = np.round(cam_pts[:, 0] * fx / z + cx).astype(np.int64)
    y_center = np.round(cam_pts[:, 1] * fy / z + cy).astype(np.int64)
    pattern = np.asarray(PIXEL_PATTERNS[pattern_id], dtype=np.int64)
    pix = np.empty((cam_pts.shape[0], pattern.shape[0], 2), dtype=np.int64)
    pix[:, :, 0] = x_center[:, None] + pattern[None, :, 0]
    pix[:, :, 1] = y_center[:, None] + pattern[None, :, 1]
    return pix


def vox2pix(
    cam_E: np.ndarray,
    cam_k: np.ndarray,
    vox_origin: np.ndarray,
    voxel_size: float,
    img_W: int,
    img_H: int,
    scene_size: Tuple[float, float, float],
    pattern_id: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Project voxel centroids to pattern pixels.

    Returns (projected_pix (N, P, 2) int64, fov_mask (N, P) bool,
    pix_z (N,) float32 camera depth).
    """
    vox_origin = np.asarray(vox_origin, dtype=np.float64)
    vol_dim = tuple(
        int(np.ceil(s / voxel_size))
        for s in np.asarray(scene_size, dtype=np.float64)
    )
    pts_world = voxel_centroids(vox_origin, vol_dim, voxel_size)
    cam_pts = rigid_transform(pts_world, np.asarray(cam_E))
    projected_pix = project_pattern_pixels(
        cam_pts, np.asarray(cam_k), pattern_id
    )
    pix_x = projected_pix[:, :, 0]
    pix_y = projected_pix[:, :, 1]
    pix_z = cam_pts[:, 2]
    fov_mask = (
        (pix_x >= 0)
        & (pix_x < img_W)
        & (pix_y >= 0)
        & (pix_y < img_H)
        & (pix_z[:, None] > 0)
    )
    return projected_pix, fov_mask, pix_z
