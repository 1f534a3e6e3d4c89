"""SFA: multi-scale FLoSP lifting with Stereo-SFA cross-view fusion.

Counterpart of `occdepth_tpu/models/sfa.py` for the KITTI/TartanAir grid
layout (flat voxel order reshapes directly to (X, Y, Z)).
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from occdepth_tpu_torch.ops.flosp_gather import (
    flosp_gather_flat,
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

    Returns (B, X, Y, Z, C) float32 — the JAX package's layout.
    """
    if dataset == "NYU":
        raise NotImplementedError("the NYU (X, Z, Y) layout is not ported yet")
    x3d = None
    for scale in project_res:
        pix = projected_pix // scale if scale > 1 else projected_pix
        feats, valid = flosp_gather_flat(x_rgb[f"1_{scale}"], pix, fov_mask)
        fused = multiview_cosine_fuse(feats, valid)  # (B, N, C)
        x3d = fused if x3d is None else x3d + fused
    B, N, C = x3d.shape
    return x3d.reshape(B, *scene_dims, C)
