"""Bilinear and nearest resize with torch.nn.functional.interpolate
semantics.

Counterparts of `occdepth_tpu/ops/resize.py::resize_bilinear` and
`resize_nearest`, on tensors whose last two dims are (H, W).  The JAX
package builds dense interpolation matrices because TPU gathers are slow;
on the GPU the reference op and plain index gathers are the natural path.
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


def resize_nearest(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Nearest resize of (..., H, W) to (..., size[0], size[1]) with the
    'nearest' (floor) convention, source index floor(i * in / out) taken in
    float32 as the JAX package takes it."""
    H_out, W_out = size
    H_in, W_in = x.shape[-2:]

    def index(n_out, n_in):
        i = torch.arange(n_out, dtype=torch.float32, device=x.device)
        i = torch.floor(i * (n_in / n_out)).long()
        return i.clamp_(0, n_in - 1)

    x = x.index_select(-2, index(H_out, H_in))
    return x.index_select(-1, index(W_out, W_in))
