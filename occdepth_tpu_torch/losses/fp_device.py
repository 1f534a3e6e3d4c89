"""Frustum-proportion (fp) loss with the frustum masks built on the device.

Counterpart of `occdepth_tpu/losses/fp_device.py`.  The data side ships
only the (F, C) ground-truth class histograms; the loss projects every
voxel centre with the batch's calibration, bins its centre pixel into the
frustum_size x frustum_size image tiles, and sums the predicted class mass
per frustum.  The sum is a one-hot matmul, which is deterministic on CUDA
(a scatter-add with fp32 atomics would change from run to run).

Reference quirks kept: the frustums use the unflipped projections and only
the centre pattern point; pixel = round(x*f/z + c) rounds half to even.
NYU's target is (X, Z_up, Y), so its voxels are taken in world (X, Y,
Z_up) order, and with depth (`use_depth_gt`) the virtual right camera,
the real one shifted by the baseline, frames voxels too, as the host's
histograms do.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from occdepth_tpu_torch.config import OccDepthConfig
from occdepth_tpu_torch.data.batch import vox_origin_for
from occdepth_tpu_torch.data.nyu import VIRTUAL_BASELINE


def _axis_bounds(dim: int, size: int, device) -> Tuple[torch.Tensor, ...]:
    """Per-tile [start, end) pixel bounds along one image axis, float32
    from float64, as the JAX package builds them."""
    b = np.arange(size, dtype=np.float64) / size
    start = torch.from_numpy((b * dim).astype(np.float32)).to(device)
    end = torch.from_numpy(((b + 1.0 / size) * dim).astype(np.float32)).to(device)
    return start, end


def _project_centers(vol_dim: Tuple[int, int, int], voxel_size: float,
                     vox_origin: torch.Tensor, cam_E: torch.Tensor,
                     cam_k: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Voxel centres -> rounded centre pixel (px, py) and camera depth z,
    each (V, N), for the V cameras of one sample."""
    dev = cam_E.device
    axes = [(torch.arange(n, dtype=torch.float32, device=dev) + 0.5)
            * voxel_size for n in vol_dim]
    gx, gy, gz = torch.meshgrid(*axes, indexing="ij")
    pts = torch.stack([gx.reshape(-1), gy.reshape(-1), gz.reshape(-1)],
                      dim=1) + vox_origin[None, :].float()  # (N, 3)
    rot = cam_E[:, :3, :3].float()
    trans = cam_E[:, :3, 3].float()
    cam = pts[None] @ rot.transpose(1, 2) + trans[:, None, :]  # (V, N, 3)
    z = cam[..., 2]
    k = cam_k.float()
    px = torch.round(cam[..., 0] * k[:, None, 0, 0] / z + k[:, None, 0, 2])
    py = torch.round(cam[..., 1] * k[:, None, 1, 1] / z + k[:, None, 1, 2])
    return px, py, z


def _tile_index(p: torch.Tensor, start: torch.Tensor,
                end: torch.Tensor) -> torch.Tensor:
    """Index of the [start, end) interval holding each pixel, -1 if none."""
    inside = (p[..., None] >= start) & (p[..., None] < end)
    return torch.where(inside.any(dim=-1), inside.int().argmax(dim=-1), -1)


def frustum_proportion_loss_device(
    cfg: OccDepthConfig,
    logits: torch.Tensor,  # (B, X, Y, Z, C) logits
    batch: Dict[str, torch.Tensor],
) -> torch.Tensor:
    """Per-frustum KL between predicted class mass and the GT histogram.

    Needs in `batch`: target, cam_k, T_velo_2_cam, frustums_class_dists
    (and vox_origin for NYU and TartanAir).
    """
    nyu = cfg.dataset == "NYU"
    B, C = logits.shape[0], logits.shape[-1]
    target = batch["target"]
    if nyu:  # (X, Z_up, Y) -> world (X, Y, Z_up)
        logits, target = logits.transpose(2, 3), target.transpose(2, 3)
    vol_dim = tuple(target.shape[1:])
    voxel_size = cfg.voxel_size_meters * cfg.output_scale
    img_H, img_W = cfg.img_shape
    size = cfg.frustum_size
    dev = logits.device
    sx, ex = _axis_bounds(img_W, size, dev)
    sy, ey = _axis_bounds(img_H, size, dev)
    if "vox_origin" in batch:
        origins = batch["vox_origin"].float()
    else:
        origins = torch.as_tensor(vox_origin_for(cfg), dtype=torch.float32,
                                  device=dev).expand(B, 3)

    prob = torch.softmax(logits.float(), dim=-1).reshape(B, -1, C)  # (B, N, C)
    valid_t = target.reshape(B, -1) != 255
    n_tiles = size * size
    cum_prob = logits.new_zeros((n_tiles, C), dtype=torch.float32)
    for b in range(B):
        cam_E, cam_k = batch["T_velo_2_cam"][b].float(), batch["cam_k"][b]
        if nyu and cfg.use_depth_gt:  # the virtual right camera
            shift = torch.eye(4, device=dev)
            shift[0, 3] = -VIRTUAL_BASELINE
            cam_E = torch.cat([cam_E, (shift @ cam_E[0])[None]])
            cam_k = torch.cat([cam_k, cam_k[:1]])
        px, py, z = _project_centers(vol_dim, voxel_size, origins[b], cam_E,
                                     cam_k)
        ix, iy = _tile_index(px, sx, ex), _tile_index(py, sy, ey)
        tile = torch.where((ix >= 0) & (iy >= 0) & (z > 0), iy * size + ix,
                           n_tiles)  # (V, N); n_tiles = outside every tile
        # (N, F) membership, OR over the views: a voxel counts once per tile
        member = torch.zeros((tile.shape[1], n_tiles + 1), dtype=torch.bool,
                             device=dev)
        member.scatter_(1, tile.t().long(), True)
        member = member[:, :n_tiles] & valid_t[b][:, None]
        cum_prob = cum_prob + member.float().t() @ prob[b]

    batch_cnt = batch["frustums_class_dists"].float().sum(dim=0)  # (F, C)
    total_cnt = batch_cnt.sum(dim=1)
    total_prob = cum_prob.sum(dim=1)
    nonempty = (total_prob > 0) & (total_cnt > 0)
    target_prop = batch_cnt / total_cnt.clamp(min=1e-30)[:, None]
    p = cum_prob / total_prob.clamp(min=1e-30)[:, None]
    kl_el = torch.where(
        target_prop > 0,
        target_prop * (torch.log(target_prop.clamp(min=1e-30))
                       - torch.log(p.clamp(min=1e-30))),
        0.0,
    )
    kl = torch.where(nonempty, kl_el.sum(dim=1), 0.0)
    n = nonempty.float().sum()
    return kl.sum() / n.clamp(min=1.0)
