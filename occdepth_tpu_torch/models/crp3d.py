"""CRP (context relation prior) bottleneck module, NCDHW.

Counterpart of `occdepth_tpu/models/crp3d.py` with the reference's module
names.  The relations' products sigmoid(P) @ mega run through kernel K2
(`ops/crp_matmul.py`) on CUDA, all of them in one launch.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn

from occdepth_tpu_torch.models.layers import Conv3d
from occdepth_tpu_torch.models.unet3d_blocks import ASPP3D, Process
from occdepth_tpu_torch.ops.crp_matmul import crp_relation_matmul


class CPMegaVoxels(nn.Module):
    """Context-prior mega-voxel relations at the UNet3D bottleneck."""

    def __init__(self, feature: int, size: Tuple[int, int, int],
                 n_relations: int = 4, bn_momentum: float = 0.0003):
        super().__init__()
        self.size = tuple(size)
        self.n_relations = n_relations
        self.context_feature = feature * 2
        X, Y, Z = self.size
        self.flatten_size = X * Y * Z
        self.flatten_context_size = (X // 2) * (Y // 2) * (Z // 2)
        # stride-2 "mega context" conv; the reference pads (size+1) % 2 per
        # dim so odd dims still halve exactly
        padding = tuple((s + 1) % 2 for s in self.size)
        self.mega_context = nn.Sequential(
            Conv3d(feature, self.context_feature, 3, stride=2,
                   padding=padding)
        )
        self.context_prior_logits = nn.ModuleList([
            nn.Sequential(Conv3d(feature, self.flatten_context_size, 1))
            for _ in range(n_relations)
        ])
        self.aspp = ASPP3D(feature)
        self.resize = nn.Sequential(
            Conv3d(self.context_feature * n_relations + feature, feature, 1,
                   bias=False),
            Process(feature, bn_momentum, dilations=(1,)),
        )

    def forward(self, x) -> Dict[str, torch.Tensor]:
        """x (B, f, X, Y, Z) -> {"x": (B, f, X, Y, Z),
        "P_logits": (B, n_rel, M, N) in x's dtype}."""
        B = x.shape[0]
        M, N = self.flatten_context_size, self.flatten_size
        x_agg = self.aspp(x)
        # (B, ctx, M) conv output read as (B, M, ctx) through strides
        mega = self.mega_context(x_agg).reshape(
            B, self.context_feature, M).transpose(1, 2)
        # the loss's (B, n_rel, M, N) layout, read as (B, n_rel, N, M)
        logits = torch.stack([conv(x_agg).reshape(B, M, N)
                              for conv in self.context_prior_logits], dim=1)
        rels = crp_relation_matmul(logits.transpose(2, 3), mega)
        # (B, n_rel, N, ctx) -> channels r * ctx + c, the reference's cat order
        rels = rels.to(x.dtype).transpose(2, 3).reshape(
            B, self.n_relations * self.context_feature, *self.size)
        h = self.resize(torch.cat([x, rels], dim=1))
        return {"x": h, "P_logits": logits}
