"""FLoSP gather and Stereo-SFA cross-view fusion.

Counterpart of `occdepth_tpu/ops/flosp_gather.py`.  Every (batch, view)
map of a scale becomes a channels-last table with a zero sentinel row, and
one `index_select` gathers all voxels' pattern pixels at once (the index of
an out-of-FOV point is the sentinel row, so the gather needs no branch).
Two-view fusion runs through kernel K1 (`ops/stereo_fuse.py`).
"""
from __future__ import annotations

import torch

from occdepth_tpu_torch.ops.stereo_fuse import stereo_cosine_fuse


def flosp_gather_flat(
    x2d: torch.Tensor,  # (B, V, C, h, w)
    pix: torch.Tensor,  # (B, V, N, P, 2) integer pixel coords at this scale
    fov_mask: torch.Tensor,  # (B, V, N, P) bool
) -> tuple:
    """Gather every map's pattern pixels and average the in-FOV ones.

    Returns ((B, V, N, C) float32 per-voxel means, (B, V, N) float32
    validity).  The gather reads the maps in their own dtype; the mean is
    taken in float32.
    """
    B, V, C, h, w = x2d.shape
    N, P = pix.shape[2], pix.shape[3]
    G = B * V
    # channels-last tables with a zero sentinel row at index h*w: one copy
    table = x2d.new_empty((G, h * w + 1, C))
    table[:, h * w].zero_()
    table[:, : h * w].unflatten(1, (h, w)).copy_(
        x2d.reshape(G, C, h, w).permute(0, 2, 3, 1)
    )
    pix = pix.long()
    idx = pix[..., 1] * w + pix[..., 0]
    idx = torch.where(fov_mask, idx, torch.full_like(idx, h * w))
    offsets = torch.arange(G, device=idx.device) * (h * w + 1)
    idx = idx.reshape(G, N * P) + offsets[:, None]
    gathered = table.reshape(G * (h * w + 1), C).index_select(
        0, idx.reshape(-1)
    ).reshape(B, V, N, P, C)
    if P == 1:
        # single-point pattern (pattern_id 0, the flagship): sentinel rows
        # are exact zeros, so the mean is the gathered value itself
        return gathered[:, :, :, 0].float(), fov_mask[..., 0].float()
    total = gathered.float().sum(dim=3)
    counts = fov_mask.sum(dim=-1).float()
    denom = torch.where(counts > 0, counts, torch.ones_like(counts))
    feats = torch.where(counts[..., None] > 0, total / denom[..., None],
                        torch.zeros_like(total))
    return feats, (counts > 0).float()


def multiview_cosine_fuse(feats: torch.Tensor, valid: torch.Tensor,
                          eps: float = 1e-8) -> torch.Tensor:
    """Stereo-SFA fusion with cosine-similarity weights.

    Voxels seen by both views are weighted by the cosine similarity of
    their per-view features; voxels seen by one view keep that view's
    feature.  feats (B, V, N, C) float32, valid (B, V, N) float32 in
    {0, 1} -> (B, N, C) float32.  Two views go through kernel K1 on CUDA.
    Every config has one or two lift views (the JAX package's general
    pairwise loop has no caller with more).
    """
    V = feats.shape[1]
    if V == 1:
        return feats[:, 0]
    if V != 2:
        raise ValueError(f"multiview_cosine_fuse: {V} views (1 or 2 supported)")
    return stereo_cosine_fuse(feats[:, 0], feats[:, 1], valid[:, 0],
                              valid[:, 1], eps)
