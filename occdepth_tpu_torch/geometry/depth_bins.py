"""Depth discretization (UD / LID / SID) on torch tensors.

Counterpart of `occdepth_tpu/geometry/depth_bins.py::bin_depths` with
`target=False` (the loss targets belong to the training slice).
"""
from __future__ import annotations

import math

import torch


def bin_depths(depth_map: torch.Tensor, mode: str, depth_min: float,
               depth_max: float, num_bins: int) -> torch.Tensor:
    """Metric depths -> continuous bin indices (non-finite where the depth
    lies outside the discretization's domain)."""
    if mode == "UD":
        bin_size = (depth_max - depth_min) / num_bins
        indices = (depth_map - depth_min) / bin_size
    elif mode == "LID":
        bin_size = 2 * (depth_max - depth_min) / (num_bins * (1 + num_bins))
        indices = -0.5 + 0.5 * torch.sqrt(
            1 + 8 * (depth_map - depth_min) / bin_size
        )
    elif mode == "SID":
        indices = (
            num_bins
            * (torch.log(1 + depth_map) - math.log(1 + depth_min))
            / (math.log(1 + depth_max) - math.log(1 + depth_min))
        )
    else:
        raise NotImplementedError(mode)
    return indices
