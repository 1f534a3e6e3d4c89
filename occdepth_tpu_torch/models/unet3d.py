"""3D UNet decoders, NCDHW.

Counterparts of `occdepth_tpu/models/unet3d.py::UNet3DKitti` (KITTI and
TartanAir) and `::UNet3DNYU`, with the reference's module names.  KITTI:
at project_scale 2 a final Upsample doubles the grid to full size, at
project_scale 1 a stride-1 Convblock3d keeps it; the optional occluded head
reads the same full-grid features as the SSC head.  NYU: no full-resolution
stage, the SSC head reads the 1:4 grid at `feature` channels, and the CRP
sits at the ceil(s / 4) bottleneck (15x9x15 for the 60x36x60 grid).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn

from occdepth_tpu_torch import tracing
from occdepth_tpu_torch.models.crp3d import CPMegaVoxels
from occdepth_tpu_torch.models.unet3d_blocks import (
    Convblock3d,
    Downsample,
    Process,
    SegmentationHead,
    Upsample,
)


class UNet3DKitti(nn.Module):
    def __init__(self, n_classes: int, feature: int,
                 full_scene_size: Tuple[int, int, int],
                 project_scale: int = 2, context_prior: bool = True,
                 n_relations: int = 4, cascade_cls: bool = True,
                 occluded_cls: bool = False, bn_momentum: float = 0.1):
        super().__init__()
        if project_scale not in (1, 2):
            raise ValueError(f"project_scale {project_scale}")
        f = feature
        self.process_l1 = nn.Sequential(Process(f, bn_momentum),
                                        Downsample(f, bn_momentum))
        self.process_l2 = nn.Sequential(Process(f * 2, bn_momentum),
                                        Downsample(f * 2, bn_momentum))
        self.up_13_l2 = Upsample(f * 4, f * 2, bn_momentum)
        self.up_12_l1 = Upsample(f * 2, f, bn_momentum)
        full = Convblock3d if project_scale == 1 else Upsample
        self.up_l1_lfull = full(f, f // 2, bn_momentum)
        self.ssc_head = SegmentationHead(f // 2, n_classes, (1, 2, 3),
                                         cascade_cls=cascade_cls)
        self.occluded_head = SegmentationHead(
            f // 2, n_classes, (1, 2, 3),
            occluded_only=True) if occluded_cls else None
        self.context_prior = context_prior
        if context_prior:
            size_l3 = tuple(s // project_scale // 4 for s in full_scene_size)
            self.CP_mega_voxels = CPMegaVoxels(
                f * 4, size_l3, n_relations=n_relations,
                bn_momentum=bn_momentum,
            )

    def _encode(self, x3d, dtype):
        x3d_l1 = x3d.to(dtype=dtype, memory_format=torch.contiguous_format)
        x3d_l2 = self.process_l1(x3d_l1)
        return x3d_l1, x3d_l2, self.process_l2(x3d_l2)

    def _decode(self, x3d_l3, x3d_l2, x3d_l1):
        x3d_up_l2 = self.up_13_l2(x3d_l3) + x3d_l2
        x3d_up_l1 = self.up_12_l1(x3d_up_l2) + x3d_l1
        return self.up_l1_lfull(x3d_up_l1)

    def _heads(self, x3d_full) -> Dict[str, torch.Tensor]:
        ssc, occ = self.ssc_head(x3d_full)
        res = {}
        if self.occluded_head is not None:
            res["occluded_logit"] = self.occluded_head(x3d_full)
        res["ssc_logit"] = ssc
        if occ is not None:
            res["occ_logit"] = occ
        return res

    def forward(self, x3d, stage=tracing.call,
                dtype=None) -> Dict[str, torch.Tensor]:
        """x3d (B, f, X, Y, Z), cast to `dtype` (default its own) and made
        contiguous first -> NCDHW ssc_logit, occ_logit and occluded_logit
        where enabled (+P_logits); `stage` runs the parts between the spans
        and the spans' stages (`OccDepthModel.forward`)."""
        res: Dict[str, torch.Tensor] = {}
        x3d_l1, x3d_l2, x3d_l3 = stage(None, self._encode, x3d,
                                       dtype or x3d.dtype)
        if self.context_prior:
            ret = stage("model.crp", self.CP_mega_voxels, x3d_l3)
            x3d_l3 = ret["x"]
            res["P_logits"] = ret["P_logits"]
        x3d_full = stage(None, self._decode, x3d_l3, x3d_l2, x3d_l1)
        res.update(stage("model.heads", self._heads, x3d_full))
        return res


class UNet3DNYU(nn.Module):
    """NYU 3D decoder (reference unet3d_nyu.py): the output stays at the
    input's 1:4 scale."""

    def __init__(self, n_classes: int, feature: int,
                 full_scene_size: Tuple[int, int, int],
                 context_prior: bool = True, n_relations: int = 4,
                 cascade_cls: bool = True, bn_momentum: float = 0.1):
        super().__init__()
        f = feature
        self.process_1_4 = nn.Sequential(Process(f, bn_momentum),
                                         Downsample(f, bn_momentum))
        self.process_1_8 = nn.Sequential(Process(f * 2, bn_momentum),
                                         Downsample(f * 2, bn_momentum))
        self.up_1_16_1_8 = Upsample(f * 4, f * 2, bn_momentum)
        self.up_1_8_1_4 = Upsample(f * 2, f, bn_momentum)
        self.ssc_head_1_4 = SegmentationHead(f, n_classes, (1, 2, 3),
                                             cascade_cls=cascade_cls)
        self.context_prior = context_prior
        if context_prior:
            size_1_16 = tuple(-(-s // 4) for s in full_scene_size)
            self.CP_mega_voxels = CPMegaVoxels(
                f * 4, size_1_16, n_relations=n_relations,
                bn_momentum=bn_momentum,
            )

    def _encode(self, x3d, dtype):
        x3d_1_4 = x3d.to(dtype=dtype, memory_format=torch.contiguous_format)
        x3d_1_8 = self.process_1_4(x3d_1_4)
        return x3d_1_4, x3d_1_8, self.process_1_8(x3d_1_8)

    def _decode(self, x3d_1_16, x3d_1_8, x3d_1_4):
        x3d_up_1_8 = self.up_1_16_1_8(x3d_1_16) + x3d_1_8
        return self.up_1_8_1_4(x3d_up_1_8) + x3d_1_4

    def _heads(self, x3d_up_1_4) -> Dict[str, torch.Tensor]:
        ssc, occ = self.ssc_head_1_4(x3d_up_1_4)
        return {"ssc_logit": ssc} if occ is None else {"ssc_logit": ssc,
                                                      "occ_logit": occ}

    def forward(self, x3d, stage=tracing.call,
                dtype=None) -> Dict[str, torch.Tensor]:
        """x3d (B, f, X, Z, Y) -> NCDHW ssc_logit and occ_logit where
        enabled (+P_logits); `stage` and `dtype` as in
        `UNet3DKitti.forward`."""
        res: Dict[str, torch.Tensor] = {}
        x3d_1_4, x3d_1_8, x3d_1_16 = stage(None, self._encode, x3d,
                                           dtype or x3d.dtype)
        if self.context_prior:
            ret = stage("model.crp", self.CP_mega_voxels, x3d_1_16)
            x3d_1_16 = ret["x"]
            res["P_logits"] = ret["P_logits"]
        x3d_up_1_4 = stage(None, self._decode, x3d_1_16, x3d_1_8, x3d_1_4)
        res.update(stage("model.heads", self._heads, x3d_up_1_4))
        return res
