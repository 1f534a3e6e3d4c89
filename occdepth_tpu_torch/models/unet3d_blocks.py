"""3D building blocks: DDR bottleneck, Process/Up/Downsample, Convblock3d,
ASPP, heads.

Counterpart of `occdepth_tpu/models/unet3d_blocks.py` in NCDHW with the
reference's module names.  Torch's (D, H, W) spatial order is the grid's
(X, Y, Z), so a (1, 1, 3) kernel factorizes along Z.  Convolutions are the
native conv3d / conv_transpose3d.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn

from occdepth_tpu_torch.models.layers import (
    Conv3d,
    ConvTranspose3d,
    batch_norm3d,
)


class Bottleneck3D(nn.Module):
    """DDR factorized 3D residual bottleneck.

    1x1x1 -> (1,1,3) -> (1,3,1) -> (3,1,1) -> 1x1x1 with additive
    inter-branch fusion; avg-pool shortcuts when stride != 1.
    """

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: Tuple[int, int, int] = (1, 1, 1),
                 expansion: int = 4, with_projection: bool = False,
                 bn_momentum: float = 0.0003):
        super().__init__()
        d, s = dilation, stride

        def bn(c):
            return batch_norm3d(c, momentum=bn_momentum)

        self.conv1 = Conv3d(inplanes, planes, 1, bias=False)
        self.bn1 = bn(planes)
        self.conv2 = Conv3d(planes, planes, (1, 1, 3), (1, 1, s),
                            padding=(0, 0, d[0]), dilation=(1, 1, d[0]),
                            bias=False)
        self.bn2 = bn(planes)
        self.conv3 = Conv3d(planes, planes, (1, 3, 1), (1, s, 1),
                            padding=(0, d[1], 0), dilation=(1, d[1], 1),
                            bias=False)
        self.bn3 = bn(planes)
        self.conv4 = Conv3d(planes, planes, (3, 1, 1), (s, 1, 1),
                            padding=(d[2], 0, 0), dilation=(d[2], 1, 1),
                            bias=False)
        self.bn4 = bn(planes)
        self.conv5 = Conv3d(planes, planes * expansion, 1, bias=False)
        self.bn5 = bn(planes * expansion)
        self.stride = s
        if s != 1:
            def shortcut(k):
                return nn.Sequential(
                    nn.AvgPool3d(kernel_size=k, stride=k),
                    Conv3d(planes, planes, 1, bias=False),
                    bn(planes),
                )

            self.downsample2 = shortcut((1, s, 1))
            self.downsample3 = shortcut((s, 1, 1))
            self.downsample4 = shortcut((s, 1, 1))
        self.downsample = None
        if with_projection:
            self.downsample = nn.Sequential(
                nn.AvgPool3d(2, 2),
                Conv3d(inplanes, planes * expansion, 1, bias=False),
                bn(planes * expansion),
            )

    def forward(self, x):
        out1 = torch.relu(self.bn1(self.conv1(x)))
        out2 = self.bn2(self.conv2(out1))
        out3 = self.bn3(self.conv3(torch.relu(out2)))
        if self.stride != 1:
            out2 = self.downsample2(out2)
        out3 = out3 + out2
        out4 = self.bn4(self.conv4(torch.relu(out3)))
        if self.stride != 1:
            out2 = self.downsample3(out2)
            out3 = self.downsample4(out3)
        out4 = out4 + out2 + out3
        out5 = self.bn5(self.conv5(torch.relu(out4)))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(out5 + residual)


class Process(nn.Module):
    """Sequence of dilated DDR bottlenecks."""

    def __init__(self, feature: int, bn_momentum: float = 0.1,
                 dilations: Sequence[int] = (1, 2, 3)):
        super().__init__()
        self.main = nn.Sequential(*[
            Bottleneck3D(feature, feature // 4, dilation=(d, d, d),
                         bn_momentum=bn_momentum)
            for d in dilations
        ])

    def forward(self, x):
        return self.main(x)


class Downsample(nn.Module):
    """Stride-2 DDR bottleneck with projection shortcut."""

    def __init__(self, feature: int, bn_momentum: float = 0.1,
                 expansion: int = 8):
        super().__init__()
        self.main = Bottleneck3D(
            feature, feature // 4, stride=2, expansion=expansion,
            with_projection=True, bn_momentum=bn_momentum,
        )

    def forward(self, x):
        return self.main(x)


class Upsample(nn.Module):
    """ConvTranspose3d(k3, s2, p1, output_padding 1) + BN + ReLU.

    The JAX package writes the same transposed conv as lax padding (1, 2)
    per dim; both double each spatial dim.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 bn_momentum: float = 0.1):
        super().__init__()
        self.main = nn.Sequential(
            ConvTranspose3d(in_channels, out_channels, 3, 2, padding=1,
                            output_padding=1),
            batch_norm3d(out_channels, momentum=bn_momentum),
            nn.ReLU(),
        )

    def forward(self, x):
        return self.main(x)


class Convblock3d(nn.Module):
    """Stride-1 ConvTranspose3d(k3, p1) + BN + ReLU, the full-grid block of
    project_scale 1 (the JAX package's lax padding (1, 1) per dim); the
    spatial dims stay as they are."""

    def __init__(self, in_channels: int, out_channels: int,
                 bn_momentum: float = 0.1):
        super().__init__()
        self.main = nn.Sequential(
            ConvTranspose3d(in_channels, out_channels, 3, 1, padding=1),
            batch_norm3d(out_channels, momentum=bn_momentum),
            nn.ReLU(),
        )

    def forward(self, x):
        return self.main(x)


class ASPP3D(nn.Module):
    """Residual multi-dilation ASPP."""

    def __init__(self, planes: int, dilations: Sequence[int] = (1, 2, 3)):
        super().__init__()

        def conv(d):
            return Conv3d(planes, planes, 3, padding=d, dilation=d,
                          bias=False)

        self.conv1 = nn.ModuleList([conv(d) for d in dilations])
        self.bn1 = nn.ModuleList([batch_norm3d(planes) for _ in dilations])
        self.conv2 = nn.ModuleList([conv(d) for d in dilations])
        self.bn2 = nn.ModuleList([batch_norm3d(planes) for _ in dilations])

    def forward(self, x):
        y = None
        for c1, b1, c2, b2 in zip(self.conv1, self.bn1, self.conv2, self.bn2):
            h = b2(c2(torch.relu(b1(c1(x)))))
            y = h if y is None else y + h
        return torch.relu(y + x)


class SegmentationHead(ASPP3D):
    """conv0 -> ASPP block -> class conv.

    With `cascade_cls` an occupancy (2-class) conv is added whose float32
    softmax is concatenated before the class conv; returns
    (ssc_logit, occ_logit), occ_logit None without the cascade.
    `occluded_only` is the occluded-voxel head: the 2-class conv alone,
    returning its logit.
    """

    def __init__(self, planes: int, n_classes: int,
                 dilations: Sequence[int] = (1, 2, 3),
                 cascade_cls: bool = True, occluded_only: bool = False):
        super().__init__(planes, dilations)
        self.cascade_cls = cascade_cls
        self.occluded_only = occluded_only
        self.conv0 = Conv3d(planes, planes, 3, padding=1)
        if cascade_cls or occluded_only:
            self.occ_classes = Conv3d(planes, 2, 3, padding=1)
        if not occluded_only:
            self.conv_classes = Conv3d(planes + (2 if cascade_cls else 0),
                                       n_classes, 3, padding=1)

    def forward(self, x):
        x = super().forward(torch.relu(self.conv0(x)))
        if self.occluded_only:
            return self.occ_classes(x)
        if not self.cascade_cls:
            return self.conv_classes(x), None
        occ = self.occ_classes(x)
        occ_softmax = torch.softmax(occ.float(), dim=1).to(x.dtype)
        return self.conv_classes(torch.cat([x, occ_softmax], dim=1)), occ
