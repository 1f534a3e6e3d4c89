"""The yardstick's peaks, the lift's bytes bounds and the FLOP count.

Peaks are NVIDIA's data sheet figures for one H100 SXM (dense): 989
TFLOP/s in bf16, 3.35 TB/s of HBM.  A roofline share is the least time the
bytes (or operations) could take at the peak over the measured device
time; each input byte is counted read once and each output byte written
once, whatever implements the work, so the share cannot pass 100% unless
the time misses part of the work.

The lift's bounds are a copy of the card smoke's bound arithmetic: the
forward reads the coordinates and masks once and each distinct map row
that an in-FOV point names once, and writes the fp32 (B, N, C) output
once; the backward reads the output gradient, the coordinates, the masks
and the named rows once and writes every element of each map's gradient
once.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def project_scales(config: dict) -> list:
    """The image scales the lift reads, from a configuration's keys."""
    return [1] + [s for s, k in ((2, "project_1_2"), (4, "project_1_4"),
                                 (8, "project_1_8")) if config[k]]


def map_shapes(img_hw, scales: Sequence[int]):
    """(h, w) of the decoder's map at each scale: each stride-2 stage
    rounds up."""
    out = []
    for s in scales:
        h, w = img_hw
        while s > 1:
            h, w, s = -(-h // 2), -(-w // 2), s // 2
        out.append((h, w))
    return out


def named_rows(pix: np.ndarray, fov: np.ndarray, scales, hw) -> int:
    """Distinct (view, scale, row) map rows that an in-FOV point of one
    sample names and that lie on the map.  pix (V, N, P, 2), fov (V, N, P)."""
    n = 0
    for s, (h, w) in zip(scales, hw):
        p = pix // s if s > 1 else pix
        on = fov & (p[..., 0] >= 0) & (p[..., 0] < w) & (p[..., 1] >= 0) \
            & (p[..., 1] < h)
        for v in range(pix.shape[0]):
            idx = p[v, ..., 1].astype(np.int64) * w + p[v, ..., 0]
            n += np.unique(idx[on[v]]).size
    return n


def lift_bytes(pix, fov, scales, img_hw, C, map_itemsize, batch) -> int:
    """The fused lift's bytes for `batch` samples that share one rig's
    projection (pix (V, N, P, 2) int32, fov (V, N, P) bool)."""
    hw = map_shapes(img_hw, scales)
    rows = named_rows(pix, fov, scales, hw)
    N = pix.shape[1]
    return batch * (pix.size * 4 + fov.size + rows * C * map_itemsize
                    + N * C * 4)


def lift_backward_bytes(pix, fov, scales, img_hw, C, map_itemsize,
                        batch) -> int:
    hw = map_shapes(img_hw, scales)
    rows = named_rows(pix, fov, scales, hw)
    N, V = pix.shape[1], pix.shape[0]
    maps = sum(V * C * h * w for h, w in hw)
    return batch * (N * C * 4 + pix.size * 4 + fov.size
                    + rows * C * map_itemsize + maps * map_itemsize)


def share_pct(n_bytes: float, seconds: float) -> float:
    """100 x (bytes at the HBM peak) / measured seconds."""
    return 100.0 * (n_bytes / HBM_BYTES_PER_S) / seconds


def counted_flops(fn) -> int:
    """FLOPs of the convolutions and matmuls that `fn()` runs (forward,
    and backward where `fn` runs one), by torch's FlopCounterMode."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())
