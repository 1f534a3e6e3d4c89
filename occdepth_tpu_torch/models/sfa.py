"""SFA: multi-scale FLoSP lifting with Stereo-SFA cross-view fusion.

Counterpart of `occdepth_tpu/models/sfa.py`.  Two views (a stereo pair,
or NYU's real and virtual views) go through the fused lift
(`flosp_stereo_lift`, one kernel on CUDA); one view through the per-scale
gather.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from occdepth_tpu_torch.ops.flosp_gather import (
    flosp_gather_flat,
    flosp_stereo_lift,
    multiview_cosine_fuse,
)


def sfa_lift(
    x_rgb: Dict[str, torch.Tensor],  # {'1_s': (B, V, C, h_s, w_s)}
    projected_pix: torch.Tensor,  # (B, V, N, P, 2) int, project_scale coords
    fov_mask: torch.Tensor,  # (B, V, N, P) bool
    project_res: Sequence[int],
    scene_dims: Tuple[int, int, int],
    dataset: str,
) -> torch.Tensor:
    """Lift multi-scale 2D features to the 3D grid, summed over scales.

    Returns (B, X, Y, Z, C) float32, the JAX package's layout: for
    KITTI/TartanAir the flat voxel order reshapes directly to (X, Y, Z);
    for NYU the flat order is world (X, Y, Z_up), e.g. (60, 60, 36), and
    the scene layout `scene_dims` is (X, Z_up, Y), e.g. (60, 36, 60).
    """
    maps = [x_rgb[f"1_{scale}"] for scale in project_res]
    if projected_pix.shape[1] == 2:
        x3d = flosp_stereo_lift(maps, projected_pix, fov_mask, project_res)
    else:
        x3d = None
        for x2d, scale in zip(maps, project_res):
            pix = projected_pix // scale if scale > 1 else projected_pix
            feats, valid = flosp_gather_flat(x2d, pix, fov_mask)
            fused = multiview_cosine_fuse(feats, valid)  # (B, N, C)
            x3d = fused if x3d is None else x3d + fused
    B, N, C = x3d.shape
    if dataset == "NYU":
        X, Y, Z = scene_dims
        return x3d.reshape(B, X, Z, Y, C).transpose(2, 3)
    return x3d.reshape(B, *scene_dims, C)
