"""FlospDepth (OAD): occupancy-aware depth branch, NCHW.

Counterpart of `occdepth_tpu/models/flosp_depth.py` with the reference's
module names (depth_net.0.{reduce_conv, mlp, se, depth_conv, depth_pred}).
A camera-aware DepthNet predicts a per-pixel distribution over LID depth
bins; `F.grid_sample` resamples that frustum volume into the voxel grid
(float32, zeros padding, align_corners=False — the reference op the JAX
package restructures for TPU gathers), and the cameras are averaged with
the analytic resampled-ones mask (`agg_voxel_mode: mean`) or summed
(`sum`).  NYU's voxel bounds start at the batch's first `vox_origin`, and
its weight volume leaves in the scene's (X, Z_up, Y) layout.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from occdepth_tpu_torch.config import FlospDepthConfig
from occdepth_tpu_torch.geometry.frustum import FrustumGridSpec, frustum_grid
from occdepth_tpu_torch.models.layers import Conv2d, Linear, batch_norm2d
from occdepth_tpu_torch.ops.grid_sample import grid_sample_3d_ones


class BasicBlock(nn.Module):
    """mmdet ResNet BasicBlock: two 3x3 conv-BN with identity skip."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = Conv2d(channels, channels, 3, padding=1, bias=False)
        self.bn1 = batch_norm2d(channels)
        self.conv2 = Conv2d(channels, channels, 3, padding=1, bias=False)
        self.bn2 = batch_norm2d(channels)

    def forward(self, x):
        h = torch.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        return torch.relu(h + x)


class Mlp(nn.Module):
    def __init__(self, in_f: int, hidden: int, out_f: int):
        super().__init__()
        self.fc1 = Linear(in_f, hidden)
        self.fc2 = Linear(hidden, out_f)

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(x)))


class SELayer(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv_reduce = Conv2d(channels, channels, 1)
        self.conv_expand = Conv2d(channels, channels, 1)

    def forward(self, x, x_se):
        gate = self.conv_expand(torch.relu(self.conv_reduce(x_se)))
        return x * torch.sigmoid(gate)


class DepthNet(nn.Module):
    """Camera-aware depth distribution net."""

    def __init__(self, in_channels: int, mid_channels: int,
                 depth_channels: int):
        super().__init__()
        self.reduce_conv = nn.Sequential(
            Conv2d(in_channels, mid_channels, 3, 1, 1),
            batch_norm2d(mid_channels),
            nn.ReLU(),
        )
        self.mlp = Mlp(1, mid_channels, mid_channels)
        self.se = SELayer(mid_channels)
        self.depth_conv = nn.Sequential(
            *[BasicBlock(mid_channels) for _ in range(3)]
        )
        self.depth_pred = Conv2d(mid_channels, depth_channels, 1)

    def forward(self, feat, scaled_pixel_size):
        """feat (B', C, h, w); scaled_pixel_size (B', 1) -> (B', D, h, w)."""
        x = self.reduce_conv(feat)
        x_se = self.mlp(scaled_pixel_size)[..., None, None]
        x = self.se(x, x_se)
        return self.depth_pred(self.depth_conv(x))


def grid_spec(conf: FlospDepthConfig, project_scale: int) -> FrustumGridSpec:
    grid_size = tuple(
        int((row[1] - row[0]) / row[2] / project_scale)
        for row in (conf.x_bound, conf.y_bound, conf.z_bound)
    )
    pc_range = (
        conf.x_bound[0], conf.y_bound[0], conf.z_bound[0],
        conf.x_bound[1], conf.y_bound[1], conf.z_bound[1],
    )
    return FrustumGridSpec(
        grid_size=grid_size, pc_range=pc_range,
        num_bins=conf.depth_channels, depth_min=conf.d_bound[0],
        depth_max=conf.d_bound[1], mode=conf.disc_mode,
        final_dim=conf.final_dim,
    )


class FlospDepth(nn.Module):
    """Depth branch producing the per-voxel occupancy weight volume."""

    def __init__(self, conf: FlospDepthConfig, project_scale: int,
                 in_channels: int, dataset: str, return_depth: bool):
        super().__init__()
        if conf.agg_voxel_mode not in ("mean", "sum"):
            raise ValueError(f"agg_voxel_mode={conf.agg_voxel_mode}")
        self.conf = conf
        self.dataset = dataset
        self.return_depth = return_depth
        self.spec = grid_spec(conf, project_scale)
        self.depth_net = nn.Sequential(
            DepthNet(in_channels, conf.mid_channels, conf.depth_channels)
        )

    def forward(self, img_feat, cam_k, T_velo_2_cam, ida_mats,
                vox_origin=None):
        """img_feat (B, V, C, h, w); cam_k (B, V, 3, 3); T_velo_2_cam and
        ida_mats (B, V, 4, 4); vox_origin (B, 3), read for NYU only.

        Returns the (B, X, Y, Z) float32 weight volume (NYU: (B, X, Z_up,
        Y), the scene layout), plus the (B, V, D, h, w) float32 depth
        distribution if `return_depth`.
        """
        B, V, C, h, w = img_feat.shape
        D = self.conf.depth_channels

        # camera-aware scale: ||(1/fx, 1/fy)|| * 1000; inv_ex skips the
        # singularity check that would synchronise with the device
        inv_k = torch.linalg.inv_ex(cam_k.float())[0]
        pixel_size = torch.sqrt(inv_k[..., 0, 0] ** 2 + inv_k[..., 1, 1] ** 2)
        scaled_pixel_size = (pixel_size * 1000.0).reshape(B * V, 1)

        feat = img_feat.reshape(B * V, C, h, w)
        logits = self.depth_net[0](feat, scaled_pixel_size.to(feat.dtype))
        depth = torch.softmax(logits.float(), dim=1)  # (B*V, D, h, w)

        # the volume is stored in the compute dtype, as the JAX package's
        # gather tables are, and sampled in float32
        vol = depth.to(feat.dtype).float().unsqueeze(1)  # (B*V, 1, D, h, w)
        cam_to_img = torch.cat(
            [cam_k.float(), cam_k.new_zeros((B, V, 3, 1), dtype=torch.float32)],
            dim=-1,
        )
        # NYU's voxel bounds move with the scene: the first sample's origin
        # serves the whole batch, as in the reference
        pc_min = vox_origin[0] if self.dataset == "NYU" else None
        grids = frustum_grid(self.spec, T_velo_2_cam, cam_to_img, ida_mats,
                             pc_min)
        X, Y, Z = self.spec.grid_size
        voxel = F.grid_sample(
            vol, grids.reshape(B * V, X, Y, Z, 3), mode="bilinear",
            padding_mode="zeros", align_corners=False,
        ).reshape(B, V, X, Y, Z)

        if V == 1:
            agg = voxel[:, 0]
        elif self.conf.agg_voxel_mode == "sum":
            agg = voxel.sum(dim=1)
        else:  # mean over the cameras that see the voxel
            masks = grid_sample_3d_ones((D, h, w), grids).sum(dim=1)
            agg = voxel.sum(dim=1)
            agg = torch.where(
                masks > 0, agg / torch.where(masks > 0, masks,
                                             torch.ones_like(masks)), agg
            )
        if self.dataset == "NYU":  # world (X, Y, Z_up) -> (X, Z_up, Y)
            agg = agg.transpose(2, 3)
        if self.return_depth:
            return agg, depth.reshape(B, V, D, h, w)
        return agg
