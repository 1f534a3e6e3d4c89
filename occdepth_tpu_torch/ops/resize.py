"""Bilinear resize with torch.nn.functional.interpolate semantics.

Counterpart of `occdepth_tpu/ops/resize.py::resize_bilinear`, on NCHW
tensors.  The JAX package builds dense interpolation matrices because TPU
gathers are slow; on the GPU the reference op is the natural path.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int],
                    align_corners: bool) -> torch.Tensor:
    """Bilinear resize of (N, C, H, W) to (N, C, size[0], size[1])."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=align_corners)
