"""Grid-sample helpers: the OAD frustum->voxel resample's normaliser and
the NYU virtual view's 2D sample.

The OAD resample itself is `F.grid_sample` on the 5-D frustum volume; this
module keeps the analytic all-ones sample of
`occdepth_tpu/ops/grid_sample.py::grid_sample_3d_ones`, the multi-camera
mean's normaliser, which needs no volume read at all.  `grid_sample_2d`
is the JAX package's `grid_sample_2d` (bilinear, border padding,
align_corners=False) with one grid shared by the batch, which is what the
virtual right view warps with: `F.grid_sample` has the same semantics.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def grid_sample_3d_ones(vol_shape: Tuple[int, int, int],
                        grid: torch.Tensor) -> torch.Tensor:
    """F.grid_sample of an all-ones (D, H, W) volume at `grid` (zeros
    padding, align_corners=False), computed analytically: the sum over the
    8 corners of the corner weight times its in-bounds flag.  (...,3) ->
    (...).
    """
    D, H, W = vol_shape

    def axis_w(coord, size):
        i = ((coord + 1.0) * size - 1.0) / 2.0
        c0 = torch.floor(i)
        w = i - c0
        lo_ok = ((c0 >= 0) & (c0 <= size - 1)).to(i.dtype)
        hi_ok = ((c0 + 1 >= 0) & (c0 + 1 <= size - 1)).to(i.dtype)
        return (1.0 - w) * lo_ok + w * hi_ok

    g = grid.float()
    return axis_w(g[..., 0], W) * axis_w(g[..., 1], H) * axis_w(g[..., 2], D)


def grid_sample_2d(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of (B, C, H, W) maps at one (h, w, 2) grid of
    normalized (x, y) coordinates shared by the batch, border padding,
    align_corners=False: (B, C, h, w) in img's dtype."""
    return F.grid_sample(img, grid.to(img.dtype).expand(img.shape[0], -1,
                                                         -1, -1),
                         mode="bilinear", padding_mode="border",
                         align_corners=False)
