"""Frustum sampling grids for the OAD frustum->voxel resample.

Counterpart of `occdepth_tpu/geometry/frustum.py`, batched over any leading
(batch, camera) dims instead of vmapped.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from occdepth_tpu_torch.geometry.depth_bins import bin_depths

OUT_OF_BOUNDS_VAL = -2.0  # reference frustum_grid_generator.py:21


@dataclasses.dataclass(frozen=True)
class FrustumGridSpec:
    """Static geometry of the voxel grid + depth discretization."""

    grid_size: Tuple[int, int, int]  # (X, Y, Z) voxels
    pc_range: Tuple[float, float, float, float, float, float]
    num_bins: int
    depth_min: float
    depth_max: float
    mode: str = "LID"
    final_dim: Tuple[int, int] = (370, 1220)  # (H, W) image size

    @property
    def pc_min(self) -> np.ndarray:
        return np.asarray(self.pc_range[:3], dtype=np.float32)

    @property
    def voxel_size(self) -> np.ndarray:
        lo = np.asarray(self.pc_range[:3], dtype=np.float32)
        hi = np.asarray(self.pc_range[3:], dtype=np.float32)
        return (hi - lo) / np.asarray(self.grid_size, dtype=np.float32)


def voxel_grid_points(spec: FrustumGridSpec, device: torch.device,
                      pc_min: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Voxel-centre points in lidar/world coords, (X, Y, Z, 3) float32:
    pc_min + voxel_size * (index + 0.5).  `pc_min` (3,) is NYU's origin of
    the batch, else the spec's constant one."""
    vs = spec.voxel_size
    pm = spec.pc_min.tolist() if pc_min is None else pc_min.float()
    axes = [
        (torch.arange(n, dtype=torch.float32, device=device) + 0.5)
        * float(vs[i]) + pm[i]
        for i, n in enumerate(spec.grid_size)
    ]
    gx, gy, gz = torch.meshgrid(*axes, indexing="ij")
    return torch.stack([gx, gy, gz], dim=-1)


def frustum_grid(
    spec: FrustumGridSpec,
    lidar_to_cam: torch.Tensor,  # (..., 4, 4)
    cam_to_img: torch.Tensor,  # (..., 3, 4)
    ida_mat: torch.Tensor,  # (..., 4, 4)
    pc_min: Optional[torch.Tensor] = None,  # (3,): NYU's voxel origin
) -> torch.Tensor:
    """Normalized (u, v, depth_bin) sampling grid, (..., X, Y, Z, 3).

    Coordinates are in [-1, 1] for F.grid_sample (x->W, y->H, z->D);
    non-finite entries become OUT_OF_BOUNDS_VAL.
    """
    lead = lidar_to_cam.shape[:-2]
    pts = voxel_grid_points(spec, lidar_to_cam.device, pc_min)
    pts_h = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)
    X, Y, Z = spec.grid_size
    pts_h = pts_h.reshape(X * Y * Z, 4)

    l2c = lidar_to_cam.float().reshape(-1, 4, 4)
    c2i = cam_to_img.float().reshape(-1, 3, 4)
    ida = ida_mat.float().reshape(-1, 4, 4)
    cam = torch.einsum("gij,nj->gni", l2c, pts_h)
    img = torch.einsum("gij,gnj->gni", c2i, cam)

    # homogeneous divide; depth excludes the projection translation
    w = img[..., 2:3]
    uv = img[..., :2] / w
    depth = img[..., 2] - c2i[:, None, 2, 3]
    dbin = bin_depths(depth, spec.mode, spec.depth_min, spec.depth_max,
                      spec.num_bins)
    grid = torch.cat([uv, dbin[..., None]], dim=-1)

    # inverse image augmentation on (u, v, dbin) as homogeneous points
    grid_h = torch.cat([grid, torch.ones_like(w)], dim=-1)
    grid = torch.einsum("gij,gnj->gni", ida, grid_h)[..., :3]

    # normalize to [-1, 1] by (dim - 1); python-scalar divisors keep the
    # forward free of host->device copies
    H, W = spec.final_dim
    grid = torch.stack([
        grid[..., 0] / (W - 1),
        grid[..., 1] / (H - 1),
        grid[..., 2] / (spec.num_bins - 1),
    ], dim=-1) * 2.0 - 1.0
    grid = torch.where(torch.isfinite(grid), grid,
                       torch.full_like(grid, OUT_OF_BOUNDS_VAL))
    return grid.reshape(*lead, X, Y, Z, 3)

