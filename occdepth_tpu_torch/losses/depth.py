"""OAD depth distillation loss.

Counterpart of `occdepth_tpu/losses/depth.py` (the reference's
occdepth/loss/depth_loss.py).  The GT depth map is nearest-resized to a
multiple of the downsample factor, min-pooled per patch (zeros read as
1e5), binned *uniformly* with the d_bound step (the reference bins targets
UD though the DepthNet grid is LID, kept as is), one-hot encoded, and
compared with the softmaxed depth distribution by BCE over foreground
pixels only, in fp32.
"""
from __future__ import annotations

from typing import Tuple

import torch

from occdepth_tpu_torch.ops.resize import resize_nearest

_LOG_CLAMP = 100.0
_TINY = 1e-37


def clamped_log(x: torch.Tensor) -> torch.Tensor:
    """log(x) clamped at -100 (torch BCE) with a FINITE gradient: the
    softmax over the depth bins underflows to exact fp32 zero on real
    images, where a plain max(log(x), -100) backward is 0 * inf = NaN."""
    safe = x > _TINY
    return torch.where(safe, torch.log(torch.where(safe, x, 1.0)),
                       -_LOG_CLAMP)


def _downsampled_gt_bins(gt: torch.Tensor, downsample: int,
                         d_bound: Tuple[float, float, float],
                         depth_channels: int) -> torch.Tensor:
    """(B', H, W) metric depth -> (B'*h*w, D) one-hot bin target."""
    Bp, H, W = gt.shape
    h, w = H // downsample, W // downsample
    patches = gt.reshape(Bp, h, downsample, w, downsample)
    patches = patches.permute(0, 1, 3, 2, 4).reshape(Bp, h, w, -1)
    patches = torch.where(patches == 0.0, 1e5, patches)
    mind = patches.amin(dim=-1)  # (B', h, w)

    idx = (mind - (d_bound[0] - d_bound[2])) / d_bound[2]
    idx = torch.where((idx < depth_channels + 1) & (idx >= 0.0), idx, 0.0)
    idx = idx.int().reshape(-1)  # truncation, as astype(int32)
    bins = torch.arange(1, depth_channels + 1, dtype=torch.int32,
                        device=gt.device)
    return (idx[:, None] == bins[None, :]).float()


def depth_cls_loss(
    depth_labels: torch.Tensor,  # (B, n_cam, H, W) metric GT depth
    depth_preds: torch.Tensor,  # (B, n_cam, h, w, D) softmaxed distribution
    downsample: int,
    d_bound: Tuple[float, float, float],
) -> torch.Tensor:
    depth_channels = int((d_bound[1] - d_bound[0]) / d_bound[2])
    B, n_cam, h, w, D = depth_preds.shape
    gt = depth_labels.reshape(-1, *depth_labels.shape[2:])  # (B', H, W)
    gt = resize_nearest(gt, (h * downsample, w * downsample))
    labels = _downsampled_gt_bins(gt, downsample, d_bound, depth_channels)

    preds = depth_preds.reshape(-1, D).float()  # (B'*h*w, D)
    fg = (labels.amax(dim=1) > 0.0).float()  # (B'*h*w,)
    p = preds.clamp(0.0, 1.0)
    bce = -(labels * clamped_log(p) + (1.0 - labels) * clamped_log(1.0 - p))
    return (bce * fg[:, None]).sum() / fg.sum().clamp(min=1.0)
