"""The benchmark's plain reference of the OccDepth network (float32).

A frozen copy of the reference OccDepth forward semantics in plain
PyRef: no kernel, operator or module of the program under test, no JAX.
It takes the benchmark's inputs and weights (the reference checkpoint's
state_dict names, which the program's model loads too) and works out for
itself everything the program derives from them: the SFA lift's gathers
and stereo fusion, the OAD frustum grid, the CRP relations.

  * RefEfficientNet / RefUNet2D  -- unet2d.py:24-255 + gen-efficientnet
  * SFA lifting                  -- SFA.py:12-106 (functional, no params)
  * RefFlospDepth / RefDepthNet  -- flosp_depth/flosp_depth.py:201-608
  * RefFrustumGridGenerator      -- f2v/frustum_grid_generator.py:8-152
  * RefUNet3DKitti (+CRP, heads) -- unet3d_kitti.py, modules.py, CRP3D.py;
    at project_scale 1 (TartanAir) the full-grid block is a stride-1
    ConvTranspose3d(k3, p1) + BN + ReLU under the Upsample's names.

kornia note: the reference builds its voxel grid with kornia-0.5.0
`create_meshgrid3d(depth=X, height=Z, width=Y)` + `permute(0,1,3,2,4)`
(frustum_grid_generator.py:32-42), which yields grid[0, ix, iy, iz] ==
(ix, iy, iz); this file constructs that field directly and replicates
kornia's `transform_points` / `convert_points_from_homogeneous` (1/w scale
only where |w| > 1e-8, else 1.0).

Run it in float32 with TF32 off (`float32_exact`), so that a matmul or a
convolution on the GPU is not computed in TF32.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

# EfficientNet-B0 stages: (expand_ratio, channels, repeats, stride, kernel)
B0_STAGES = (
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
)
# width and depth multipliers of the variants
VARIANTS = {
    "tf_efficientnet_b0_ns": (1.0, 1.0),
    "tf_efficientnet_b3_ns": (1.2, 1.4),
    "tf_efficientnet_b4_ns": (1.4, 1.8),
    "tf_efficientnet_b5_ns": (1.6, 2.2),
    "tf_efficientnet_b7_ns": (2.0, 3.1),
}


def _round_channels(chs: float, multiplier: float, divisor: int = 8) -> int:
    chs *= multiplier
    new = max(divisor, int(chs + divisor / 2) // divisor * divisor)
    if new < 0.9 * chs:
        new += divisor
    return int(new)


def variant_channels(name: str) -> dict:
    """Stage output, stem and head channels and repeats of a variant."""
    w, d = VARIANTS[name]
    return {
        "stem": _round_channels(32, w),
        "stages": tuple(_round_channels(c, w) for (_, c, _, _, _) in B0_STAGES),
        "head": _round_channels(1280, w),
        "repeats": tuple(int(math.ceil(d * r)) for (_, _, r, _, _) in B0_STAGES),
    }


@contextlib.contextmanager
def float32_exact():
    """TF32 off for matmuls and cuDNN convolutions inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


# ---------------------------------------------------------------------------
# 2D backbone (gen-efficientnet tf_*_ns semantics, torch.hub naming)
# ---------------------------------------------------------------------------


def tf_same_pad(x, k, s):
    """TF-SAME asymmetric padding (extra on bottom/right)."""
    ih, iw = x.shape[-2:]
    pad_h = max((math.ceil(ih / s) - 1) * s + k - ih, 0)
    pad_w = max((math.ceil(iw / s) - 1) * s + k - iw, 0)
    return F.pad(
        x, (pad_w // 2, pad_w - pad_w // 2, pad_h // 2, pad_h - pad_h // 2)
    )


class _SE(nn.Module):
    def __init__(self, chs, reduced):
        super().__init__()
        self.conv_reduce = nn.Conv2d(chs, reduced, 1)
        self.conv_expand = nn.Conv2d(reduced, chs, 1)

    def forward(self, x):
        se = x.mean((2, 3), keepdim=True)
        se = self.conv_expand(F.silu(self.conv_reduce(se)))
        return x * torch.sigmoid(se)


class _DSBlock(nn.Module):
    """DepthwiseSeparableConv (stage-0, expand==1)."""

    def __init__(self, in_chs, out_chs, k):
        super().__init__()
        bn = lambda c: nn.BatchNorm2d(c, eps=1e-3)
        self.conv_dw = nn.Conv2d(in_chs, in_chs, k, 1, groups=in_chs,
                                 bias=False)
        self.bn1 = bn(in_chs)
        self.se = _SE(in_chs, max(1, int(in_chs * 0.25)))
        self.conv_pw = nn.Conv2d(in_chs, out_chs, 1, bias=False)
        self.bn2 = bn(out_chs)
        self.k = k
        self.has_skip = in_chs == out_chs

    def forward(self, x):
        sc = x
        h = F.silu(self.bn1(self.conv_dw(tf_same_pad(x, self.k, 1))))
        h = self.se(h)
        h = self.bn2(self.conv_pw(h))
        return h + sc if self.has_skip else h


class _MBBlock(nn.Module):
    """InvertedResidual (expand>1)."""

    def __init__(self, in_chs, out_chs, expand, k, stride):
        super().__init__()
        mid = in_chs * expand
        bn = lambda c: nn.BatchNorm2d(c, eps=1e-3)
        self.conv_pw = nn.Conv2d(in_chs, mid, 1, bias=False)
        self.bn1 = bn(mid)
        self.conv_dw = nn.Conv2d(mid, mid, k, stride, groups=mid, bias=False)
        self.bn2 = bn(mid)
        self.se = _SE(mid, max(1, int(in_chs * 0.25)))
        self.conv_pwl = nn.Conv2d(mid, out_chs, 1, bias=False)
        self.bn3 = bn(out_chs)
        self.k, self.stride = k, stride
        self.has_skip = stride == 1 and in_chs == out_chs

    def forward(self, x):
        sc = x
        h = F.silu(self.bn1(self.conv_pw(x)))
        h = tf_same_pad(h, self.k, self.stride)
        h = F.silu(self.bn2(self.conv_dw(h)))
        h = self.se(h)
        h = self.bn3(self.conv_pwl(h))
        return h + sc if self.has_skip else h


class RefEfficientNet(nn.Module):
    """gen-efficientnet trunk; returns the UNet2D feature taps.

    state_dict keys: conv_stem / bn1 / blocks.{si}.{bi}.* / conv_head —
    the torch.hub model tree the converter's `_map_efficientnet` expects.
    Feature taps mirror Encoder.forward (unet2d.py:188-196): input,
    stage0..2, stage4, conv_head output (features[0,4,5,6,8,11]).
    """

    def __init__(self, variant):
        super().__init__()
        cfg = variant_channels(variant)
        self.conv_stem = nn.Conv2d(3, cfg["stem"], 3, 2, bias=False)
        self.bn1 = nn.BatchNorm2d(cfg["stem"], eps=1e-3)
        blocks = []
        in_chs = cfg["stem"]
        for si, (expand, _, _, stride, kernel) in enumerate(B0_STAGES):
            out_chs = cfg["stages"][si]
            stage = []
            for bi in range(cfg["repeats"][si]):
                s = stride if bi == 0 else 1
                if expand == 1:
                    stage.append(_DSBlock(in_chs, out_chs, kernel))
                else:
                    stage.append(_MBBlock(in_chs, out_chs, expand, kernel, s))
                in_chs = out_chs
            blocks.append(nn.Sequential(*stage))
        self.blocks = nn.Sequential(*blocks)
        self.conv_head = nn.Conv2d(in_chs, cfg["head"], 1, bias=False)

    def forward(self, x):
        taps = [x]
        h = F.silu(self.bn1(self.conv_stem(tf_same_pad(x, 3, 2))))
        stage_outs = []
        for stage in self.blocks:
            h = stage(h)
            stage_outs.append(h)
        head = self.conv_head(h)
        return (taps[0], stage_outs[0], stage_outs[1], stage_outs[2],
                stage_outs[4], head)


class RefUpSampleBN(nn.Module):
    """UpSampleBN with the reference's `_net` naming (unet2d.py:24-46)."""

    def __init__(self, skip_input, out_f):
        super().__init__()
        self._net = nn.Sequential(
            nn.Conv2d(skip_input, out_f, 3, 1, 1), nn.BatchNorm2d(out_f),
            nn.LeakyReLU(),
            nn.Conv2d(out_f, out_f, 3, 1, 1), nn.BatchNorm2d(out_f),
            nn.LeakyReLU(),
        )

    def forward(self, x, skip):
        up = F.interpolate(x, size=skip.shape[2:], mode="bilinear",
                           align_corners=True)
        return self._net(torch.cat([up, skip], dim=1))


class RefDecoderBN(nn.Module):
    """DecoderBN (unet2d.py:51-182), incl. the padded-1x1 conv2 quirk."""

    def __init__(self, variant, out_feature, return_up_feats=1):
        super().__init__()
        cfg = variant_channels(variant)
        # MODEL_CHANNELS[variant] == [3, stage0, stage1, stage2, stage4]
        mc = [3, cfg["stages"][0], cfg["stages"][1], cfg["stages"][2],
              cfg["stages"][4]]
        features = cfg["head"]
        self.return_up_feats = r = return_up_feats
        self.conv2 = nn.Conv2d(features, features, 1, 1, padding=1)
        if r <= 16:
            self.up16 = RefUpSampleBN(features + mc[4], features // 2)
            self.resize_output_1_16 = nn.Conv2d(features // 2, out_feature, 1)
        if r <= 8:
            self.up8 = RefUpSampleBN(features // 2 + mc[3], features // 4)
            self.resize_output_1_8 = nn.Conv2d(features // 4, out_feature, 1)
        if r <= 4:
            self.up4 = RefUpSampleBN(features // 4 + mc[2], features // 8)
            self.resize_output_1_4 = nn.Conv2d(features // 8, out_feature, 1)
        if r <= 2:
            self.up2 = RefUpSampleBN(features // 8 + mc[1], features // 16)
            self.resize_output_1_2 = nn.Conv2d(features // 16, out_feature, 1)
        if r <= 1:
            self.up1 = RefUpSampleBN(features // 16 + mc[0], features // 32)
            self.resize_output_1_1 = nn.Conv2d(features // 32, out_feature, 1)

    def forward(self, taps):
        x_in, b0, b1, b2, b4, head = taps
        x = self.conv2(head)
        res = {}
        r = self.return_up_feats
        if r <= 16:
            x = self.up16(x, b4)
            res["1_16"] = self.resize_output_1_16(x)
        if r <= 8:
            x = self.up8(x, b2)
            res["1_8"] = self.resize_output_1_8(x)
        if r <= 4:
            x = self.up4(x, b1)
            res["1_4"] = self.resize_output_1_4(x)
        if r <= 2:
            x = self.up2(x, b0)
            res["1_2"] = self.resize_output_1_2(x)
        if r <= 1:
            x = self.up1(x, x_in)
            res["1_1"] = self.resize_output_1_1(x)
        return res


class RefEncoderWrap(nn.Module):
    def __init__(self, variant):
        super().__init__()
        self.original_model = RefEfficientNet(variant)

    def forward(self, x):
        return self.original_model(x)


class RefUNet2D(nn.Module):
    def __init__(self, variant, out_feature, return_up_feats=1):
        super().__init__()
        self.encoder = RefEncoderWrap(variant)
        self.decoder = RefDecoderBN(variant, out_feature, return_up_feats)

    def forward(self, x):
        return self.decoder(self.encoder(x))


# ---------------------------------------------------------------------------
# 3D decoder blocks (modules.py / DDR.py / CRP3D.py naming)
# ---------------------------------------------------------------------------


class RefBottleneck3D(nn.Module):
    """DDR Bottleneck3D (DDR.py:10-139) with reference key naming."""

    def __init__(self, inplanes, planes, stride=1, dilation=(1, 1, 1),
                 expansion=4, with_projection=False, bn_momentum=0.0003):
        super().__init__()
        d = dilation
        bn = lambda c: nn.BatchNorm3d(c, momentum=bn_momentum)
        self.conv1 = nn.Conv3d(inplanes, planes, 1, bias=False)
        self.bn1 = bn(planes)
        self.conv2 = nn.Conv3d(planes, planes, (1, 1, 3), (1, 1, stride),
                               padding=(0, 0, d[0]), dilation=(1, 1, d[0]),
                               bias=False)
        self.bn2 = bn(planes)
        self.conv3 = nn.Conv3d(planes, planes, (1, 3, 1), (1, stride, 1),
                               padding=(0, d[1], 0), dilation=(1, d[1], 1),
                               bias=False)
        self.bn3 = bn(planes)
        self.conv4 = nn.Conv3d(planes, planes, (3, 1, 1), (stride, 1, 1),
                               padding=(d[2], 0, 0), dilation=(d[2], 1, 1),
                               bias=False)
        self.bn4 = bn(planes)
        self.conv5 = nn.Conv3d(planes, planes * expansion, 1, bias=False)
        self.bn5 = bn(planes * expansion)
        self.stride = stride
        if stride != 1:
            mk = lambda k: nn.Sequential(
                nn.AvgPool3d(kernel_size=k, stride=k),
                nn.Conv3d(planes, planes, 1, bias=False),
                bn(planes),
            )
            self.downsample2 = mk((1, stride, 1))
            self.downsample3 = mk((stride, 1, 1))
            self.downsample4 = mk((stride, 1, 1))
        self.downsample = None
        if with_projection:
            self.downsample = nn.Sequential(
                nn.AvgPool3d(2, 2),
                nn.Conv3d(inplanes, planes * expansion, 1, bias=False),
                bn(planes * expansion),
            )

    def forward(self, x):
        relu = torch.relu
        out1 = relu(self.bn1(self.conv1(x)))
        out2 = self.bn2(self.conv2(out1))
        out3 = self.bn3(self.conv3(relu(out2)))
        if self.stride != 1:
            out2 = self.downsample2(out2)
        out3 = out3 + out2
        out4 = self.bn4(self.conv4(relu(out3)))
        if self.stride != 1:
            out2 = self.downsample3(out2)
            out3 = self.downsample4(out3)
        out4 = out4 + out2 + out3
        out5 = self.bn5(self.conv5(relu(out4)))
        residual = x if self.downsample is None else self.downsample(x)
        return relu(out5 + residual)


class RefProcess(nn.Module):
    """Process (modules.py:252-268): self.main = Sequential of bottlenecks."""

    def __init__(self, feature, bn_momentum, dilations=(1, 2, 3)):
        super().__init__()
        self.main = nn.Sequential(*[
            RefBottleneck3D(feature, feature // 4, dilation=(i, i, i),
                              bn_momentum=bn_momentum)
            for i in dilations
        ])

    def forward(self, x):
        return self.main(x)


class RefDownsample(nn.Module):
    """Downsample (modules.py:316-340)."""

    def __init__(self, feature, bn_momentum, expansion=8):
        super().__init__()
        self.main = RefBottleneck3D(
            feature, feature // 4, stride=2, expansion=expansion,
            with_projection=True, bn_momentum=bn_momentum,
        )

    def forward(self, x):
        return self.main(x)


class RefUpsample3D(nn.Module):
    """Upsample (modules.py:271-291): ConvT3d s2 + BN + ReLU."""

    def __init__(self, in_channels, out_channels, bn_momentum, stride=2):
        super().__init__()
        self.main = nn.Sequential(
            nn.ConvTranspose3d(in_channels, out_channels, 3, stride, padding=1,
                               output_padding=stride - 1),
            nn.BatchNorm3d(out_channels, momentum=bn_momentum),
            nn.ReLU(),
        )

    def forward(self, x):
        return self.main(x)


class RefASPP(nn.Module):
    """ASPP 3D (modules.py:6-49)."""

    def __init__(self, planes, dils=(1, 2, 3)):
        super().__init__()
        self.conv1 = nn.ModuleList([
            nn.Conv3d(planes, planes, 3, padding=d, dilation=d, bias=False)
            for d in dils
        ])
        self.bn1 = nn.ModuleList([nn.BatchNorm3d(planes) for _ in dils])
        self.conv2 = nn.ModuleList([
            nn.Conv3d(planes, planes, 3, padding=d, dilation=d, bias=False)
            for d in dils
        ])
        self.bn2 = nn.ModuleList([nn.BatchNorm3d(planes) for _ in dils])

    def forward(self, x):
        y = None
        for c1, b1, c2, b2 in zip(self.conv1, self.bn1, self.conv2, self.bn2):
            h = b2(c2(torch.relu(b1(c1(x)))))
            y = h if y is None else y + h
        return torch.relu(y + x)


class RefCPMegaVoxels(nn.Module):
    """CPMegaVoxels (CRP3D.py:9-97) with native naming."""

    def __init__(self, feature, size, n_relations=4, bn_momentum=0.0003):
        super().__init__()
        self.size = size
        self.n_relations = n_relations
        self.feature = feature
        self.context_feature = feature * 2
        self.flatten_size = size[0] * size[1] * size[2]
        self.flatten_context_size = (size[0] // 2) * (size[1] // 2) * (
            size[2] // 2)
        padding = tuple((s + 1) % 2 for s in size)
        self.mega_context = nn.Sequential(
            nn.Conv3d(feature, self.context_feature, 3, stride=2,
                      padding=padding)
        )
        self.context_prior_logits = nn.ModuleList([
            nn.Sequential(nn.Conv3d(feature, self.flatten_context_size, 1))
            for _ in range(n_relations)
        ])
        self.aspp = RefASPP(feature)
        self.resize = nn.Sequential(
            nn.Conv3d(self.context_feature * n_relations + feature, feature,
                      1, bias=False),
            RefProcess(feature, bn_momentum, dilations=(1,)),
        )

    def forward(self, x):
        bs = x.shape[0]
        x_agg = self.aspp(x)
        mega = self.mega_context(x_agg).reshape(bs, self.context_feature, -1)
        mega = mega.permute(0, 2, 1)
        logits, rels = [], []
        for conv in self.context_prior_logits:
            lg = conv(x_agg).reshape(
                bs, self.flatten_context_size, self.flatten_size
            )
            logits.append(lg.unsqueeze(1))
            rels.append(torch.bmm(torch.sigmoid(lg.permute(0, 2, 1)), mega))
        ctx = torch.cat(rels, dim=2).permute(0, 2, 1).reshape(
            bs, -1, *self.size
        )
        h = self.resize(torch.cat([x, ctx], dim=1))
        return {"x": h, "P_logits": torch.cat(logits, dim=1)}


class RefSegHeadCascade(nn.Module):
    """SegmentationHeadCascadeCLS (modules.py:109-175); with cascade=False
    the plain SegmentationHead (modules.py:51-106) — no occupancy branch,
    as in the released non-cascade NYU config."""

    def __init__(self, planes, n_classes, dils=(1, 2, 3), cascade=True):
        super().__init__()
        self.cascade = cascade
        self.conv0 = nn.Conv3d(planes, planes, 3, padding=1)
        self.conv1 = nn.ModuleList([
            nn.Conv3d(planes, planes, 3, padding=d, dilation=d, bias=False)
            for d in dils
        ])
        self.bn1 = nn.ModuleList([nn.BatchNorm3d(planes) for _ in dils])
        self.conv2 = nn.ModuleList([
            nn.Conv3d(planes, planes, 3, padding=d, dilation=d, bias=False)
            for d in dils
        ])
        self.bn2 = nn.ModuleList([nn.BatchNorm3d(planes) for _ in dils])
        if cascade:
            self.occ_classes = nn.Conv3d(planes, 2, 3, padding=1)
            self.conv_classes = nn.Conv3d(planes + 2, n_classes, 3, padding=1)
        else:
            self.conv_classes = nn.Conv3d(planes, n_classes, 3, padding=1)

    def forward(self, x):
        x = torch.relu(self.conv0(x))
        y = None
        for c1, b1, c2, b2 in zip(self.conv1, self.bn1, self.conv2, self.bn2):
            h = b2(c2(torch.relu(b1(c1(x)))))
            y = h if y is None else y + h
        x = torch.relu(y + x)
        if not self.cascade:
            return self.conv_classes(x), None
        occ = self.occ_classes(x)
        x = torch.cat([x, torch.softmax(occ, dim=1)], dim=1)
        return self.conv_classes(x), occ


class RefSegHeadOccluded(nn.Module):
    """SegmentationHeadOccludedCLS (modules.py:178-235)."""

    def __init__(self, planes, dils=(1, 2, 3)):
        super().__init__()
        self.conv0 = nn.Conv3d(planes, planes, 3, padding=1)
        self.conv1 = nn.ModuleList([
            nn.Conv3d(planes, planes, 3, padding=d, dilation=d, bias=False)
            for d in dils
        ])
        self.bn1 = nn.ModuleList([nn.BatchNorm3d(planes) for _ in dils])
        self.conv2 = nn.ModuleList([
            nn.Conv3d(planes, planes, 3, padding=d, dilation=d, bias=False)
            for d in dils
        ])
        self.bn2 = nn.ModuleList([nn.BatchNorm3d(planes) for _ in dils])
        self.occ_classes = nn.Conv3d(planes, 2, 3, padding=1)

    def forward(self, x):
        x = torch.relu(self.conv0(x))
        y = None
        for c1, b1, c2, b2 in zip(self.conv1, self.bn1, self.conv2, self.bn2):
            h = b2(c2(torch.relu(b1(c1(x)))))
            y = h if y is None else y + h
        x = torch.relu(y + x)
        return self.occ_classes(x)


class RefUNet3DKitti(nn.Module):
    """UNet3D KITTI (unet3d_kitti.py:14-126) with reference naming."""

    def __init__(self, n_classes, feature, context_prior=True, n_relations=4,
                 size_l3=(4, 4, 2), bn_momentum=0.1, occluded_cls=False,
                 project_scale=2):
        super().__init__()
        self.process_l1 = nn.Sequential(
            RefProcess(feature, bn_momentum),
            RefDownsample(feature, bn_momentum),
        )
        self.process_l2 = nn.Sequential(
            RefProcess(feature * 2, bn_momentum),
            RefDownsample(feature * 2, bn_momentum),
        )
        self.up_13_l2 = RefUpsample3D(feature * 4, feature * 2, bn_momentum)
        self.up_12_l1 = RefUpsample3D(feature * 2, feature, bn_momentum)
        self.up_l1_lfull = RefUpsample3D(feature, feature // 2, bn_momentum,
                                         stride=project_scale)
        self.ssc_head = RefSegHeadCascade(feature // 2, n_classes)
        self.context_prior = context_prior
        if context_prior:
            self.CP_mega_voxels = RefCPMegaVoxels(
                feature * 4, size_l3, n_relations=n_relations,
                bn_momentum=bn_momentum,
            )
        self.occluded_cls = occluded_cls
        if occluded_cls:
            self.occluded_head = RefSegHeadOccluded(feature // 2)

    def forward(self, x3d_l1):
        res = {}
        x3d_l2 = self.process_l1(x3d_l1)
        x3d_l3 = self.process_l2(x3d_l2)
        if self.context_prior:
            ret = self.CP_mega_voxels(x3d_l3)
            x3d_l3 = ret["x"]
            res.update(ret)
        x3d_up_l2 = self.up_13_l2(x3d_l3) + x3d_l2
        x3d_up_l1 = self.up_12_l1(x3d_up_l2) + x3d_l1
        x3d_up_lfull = self.up_l1_lfull(x3d_up_l1)
        ssc_logit, occ_logit = self.ssc_head(x3d_up_lfull)
        res["ssc_logit"] = ssc_logit
        res["occ_logit"] = occ_logit
        if self.occluded_cls:
            res["occluded_logit"] = self.occluded_head(x3d_up_lfull)
        return res


# ---------------------------------------------------------------------------
# FlospDepth / OAD branch (flosp_depth.py + f2v)
# ---------------------------------------------------------------------------


def _dehom(points, eps=1e-8):
    """kornia convert_points_from_homogeneous: 1/w only where |w| > eps."""
    w = points[..., -1:]
    scale = torch.where(torch.abs(w) > eps, 1.0 / w, torch.ones_like(w))
    return scale * points[..., :-1]


def _transform_points(trans, points):
    """kornia transform_points: hom -> matmul -> dehom."""
    ones = torch.ones_like(points[..., :1])
    ph = torch.cat([points, ones], dim=-1)
    out = (trans @ ph.unsqueeze(-1)).squeeze(-1)
    return _dehom(out)


def bin_depths(depth_map, mode, depth_min, depth_max, num_bins):
    """f2v/utils/depth_utils.py:5-43 (continuous indices, target=False)."""
    if mode == "UD":
        bin_size = (depth_max - depth_min) / num_bins
        return (depth_map - depth_min) / bin_size
    if mode == "LID":
        bin_size = 2 * (depth_max - depth_min) / (num_bins * (1 + num_bins))
        return -0.5 + 0.5 * torch.sqrt(
            1 + 8 * (depth_map - depth_min) / bin_size
        )
    if mode == "SID":
        return (
            num_bins
            * (torch.log(1 + depth_map) - math.log(1 + depth_min))
            / (math.log(1 + depth_max) - math.log(1 + depth_min))
        )
    raise NotImplementedError(mode)


class RefFrustumGridGenerator(nn.Module):
    """FrustumGridGenerator (f2v/frustum_grid_generator.py:8-152)."""

    def __init__(self, grid_size, pc_range, disc_cfg, final_dim):
        super().__init__()
        self.grid_size = grid_size  # (X, Y, Z)
        self.disc_cfg = disc_cfg
        self.final_dim = final_dim  # (H, W)
        pc = torch.tensor(pc_range, dtype=torch.float32).reshape(2, 3)
        self.pc_min = pc[0]
        self.voxel_size = (pc[1] - pc[0]) / torch.tensor(
            grid_size, dtype=torch.float32
        )
        X, Y, Z = grid_size
        ix, iy, iz = torch.meshgrid(
            torch.arange(X, dtype=torch.float32),
            torch.arange(Y, dtype=torch.float32),
            torch.arange(Z, dtype=torch.float32),
            indexing="ij",
        )
        # kornia create_meshgrid3d + XZY->XYZ permute + 0.5 (see module doc)
        # buffers, not state: they follow the module to its device
        self.register_buffer(
            "voxel_grid", torch.stack([ix, iy, iz], dim=-1) + 0.5,  # (X,Y,Z,3)
            persistent=False)
        self.register_buffer("grid_to_lidar", torch.tensor(
            [
                [self.voxel_size[0], 0, 0, self.pc_min[0]],
                [0, self.voxel_size[1], 0, self.pc_min[1]],
                [0, 0, self.voxel_size[2], self.pc_min[2]],
                [0, 0, 0, 1],
            ],
            dtype=torch.float32,
        ), persistent=False)

    def forward(self, lidar_to_cam, cam_to_img, ida_mats):
        """(B,4,4), (B,3,4), (B,4,4) -> (B, X, Y, Z, 3) normalized grid."""
        B = lidar_to_cam.shape[0]
        trans = (lidar_to_cam @ self.grid_to_lidar).reshape(B, 1, 1, 1, 4, 4)
        voxel_grid = self.voxel_grid.unsqueeze(0).expand(B, -1, -1, -1, -1)
        camera_grid = _transform_points(trans, voxel_grid)

        # project_to_image (transform_utils.py:5-26)
        proj = cam_to_img.reshape(B, 1, 1, 1, 3, 4)
        ph = torch.cat(
            [camera_grid, torch.ones_like(camera_grid[..., :1])], dim=-1
        )
        pt = (proj @ ph.unsqueeze(-1)).squeeze(-1)
        image_grid = _dehom(pt)
        image_depths = pt[..., -1] - proj[..., 2, 3]

        image_depths = bin_depths(image_depths, **self.disc_cfg)
        frustum_grid = torch.cat(
            [image_grid, image_depths.unsqueeze(-1)], dim=-1
        )
        frustum_grid = _transform_points(
            ida_mats.reshape(B, 1, 1, 1, 4, 4), frustum_grid
        )

        # normalize_coords with shape (num_bins, H, W) flipped -> (W, H, D)
        H, W = self.final_dim
        denom = torch.tensor(
            [W - 1, H - 1, self.disc_cfg["num_bins"] - 1],
            dtype=torch.float32, device=frustum_grid.device,
        )
        frustum_grid = frustum_grid / denom * 2.0 - 1.0
        frustum_grid = torch.where(torch.isfinite(frustum_grid),
                                   frustum_grid, -2.0)
        return frustum_grid


class RefBasicBlock(nn.Module):
    """mmdet ResNet BasicBlock (two conv-BN, identity skip)."""

    def __init__(self, channels):
        super().__init__()
        self.conv1 = nn.Conv2d(channels, channels, 3, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(channels)
        self.conv2 = nn.Conv2d(channels, channels, 3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(channels)

    def forward(self, x):
        h = torch.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        return torch.relu(h + x)


class RefMlp(nn.Module):
    def __init__(self, in_f, hidden, out_f):
        super().__init__()
        self.fc1 = nn.Linear(in_f, hidden)
        self.fc2 = nn.Linear(hidden, out_f)

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(x)))


class RefSELayerFD(nn.Module):
    """flosp_depth SELayer (flosp_depth.py:186-198)."""

    def __init__(self, channels):
        super().__init__()
        self.conv_reduce = nn.Conv2d(channels, channels, 1)
        self.conv_expand = nn.Conv2d(channels, channels, 1)

    def forward(self, x, x_se):
        x_se = self.conv_expand(torch.relu(self.conv_reduce(x_se)))
        return x * torch.sigmoid(x_se)


class RefDepthNet(nn.Module):
    """DepthNet (flosp_depth.py:201-257)."""

    def __init__(self, in_channels, mid_channels, depth_channels):
        super().__init__()
        self.reduce_conv = nn.Sequential(
            nn.Conv2d(in_channels, mid_channels, 3, 1, 1),
            nn.BatchNorm2d(mid_channels),
            nn.ReLU(inplace=True),
        )
        self.mlp = RefMlp(1, mid_channels, mid_channels)
        self.se = RefSELayerFD(mid_channels)
        self.depth_conv = nn.Sequential(
            RefBasicBlock(mid_channels),
            RefBasicBlock(mid_channels),
            RefBasicBlock(mid_channels),
        )
        self.depth_pred = nn.Conv2d(mid_channels, depth_channels, 1)

    def forward(self, x, sweep_intrins):
        inv = torch.inverse(sweep_intrins)
        pixel_size = torch.norm(
            torch.stack([inv[..., 0, 0], inv[..., 1, 1]], dim=-1), dim=-1
        ).reshape(-1, 1)
        scaled_pixel_size = pixel_size * 1000.0
        x = self.reduce_conv(x)
        x_se = self.mlp(scaled_pixel_size)[..., None, None]
        x = self.se(x, x_se)
        x = self.depth_conv(x)
        return self.depth_pred(x)


class RefFlospDepth(nn.Module):
    """FlospDepth (flosp_depth.py:324-608) for the KITTI static-bounds path."""

    def __init__(self, conf, project_scale, in_channels, return_depth):
        super().__init__()
        self.conf = conf
        self.return_depth = return_depth
        depth_channels = int(
            (conf.d_bound[1] - conf.d_bound[0]) / conf.d_bound[2]
        )
        self.depth_net = nn.Sequential(
            RefDepthNet(in_channels, conf.mid_channels, depth_channels)
        )
        grid_size = tuple(
            int((row[1] - row[0]) / row[2] / project_scale)
            for row in (conf.x_bound, conf.y_bound, conf.z_bound)
        )
        pc_range = [
            conf.x_bound[0], conf.y_bound[0], conf.z_bound[0],
            conf.x_bound[1], conf.y_bound[1], conf.z_bound[1],
        ]
        self.grid_generator = RefFrustumGridGenerator(
            grid_size, pc_range,
            {
                "mode": conf.disc_mode,
                "num_bins": depth_channels,
                "depth_min": conf.d_bound[0],
                "depth_max": conf.d_bound[1],
            },
            conf.final_dim,
        )

    def forward(self, img_feat, cam_k, T_velo_2_cam, ida_mats):
        """img_feat (B, V, C, h, w); calib tensors (B, V, ...)."""
        bs, n_cams, c, h, w = img_feat.shape
        flat = img_feat.reshape(bs * n_cams, c, h, w)
        intrins_mat = cam_k.new_zeros(bs, n_cams, 4, 4)
        intrins_mat[:, :, :3, :3] = cam_k
        intrins_mat[:, :, 3, 3] = 1
        depth_logits = self.depth_net[0](flat, intrins_mat)
        depth = depth_logits.softmax(1)
        depth = depth.unsqueeze(1).reshape(
            bs, n_cams, 1, depth.shape[1], depth.shape[2], depth.shape[3]
        )
        feats, masks = [], []
        for i in range(n_cams):
            grid = self.grid_generator(
                T_velo_2_cam[:, i], intrins_mat[:, i, :3, :], ida_mats[:, i]
            )
            feats.append(F.grid_sample(depth[:, i], grid,
                                       mode="bilinear", padding_mode="zeros",
                                       align_corners=False))
            if n_cams > 1:
                masks.append(
                    F.grid_sample(torch.ones_like(depth[:, i]), grid,
                                  mode="bilinear", padding_mode="zeros",
                                  align_corners=False)
                )
        if n_cams == 1:
            agg = feats[0]
        else:
            agg = sum(feats)
            m = sum(masks)
            agg = torch.where(m > 0, agg / torch.where(m > 0, m, 1.0), agg)
        if self.return_depth:
            return agg, depth.squeeze(2)
        return agg


# ---------------------------------------------------------------------------
# SFA lifting (functional; SFA.py:12-106)
# ---------------------------------------------------------------------------


def sfa(x2d, projected_pix, fov_mask, scene_dims, dataset):
    """One sample, one scale: (V, C, h, w) + (V, N, P, 2) -> (C, X, Y, Z).

    Replicates SFA.forward: zero-sentinel gather, pattern mean, NaN->0,
    pairwise cosine fusion, dataset reshape.
    """
    n_views, c, h, w = x2d.shape
    feats, weights = [], []
    for v in range(n_views):
        src = x2d[v].reshape(c, -1)
        src = torch.cat(
            [src, torch.zeros(c, 1, dtype=src.dtype, device=src.device)], dim=1)
        pix_x = projected_pix[v, :, :, 0]
        pix_y = projected_pix[v, :, :, 1]
        idx = pix_y * w + pix_x
        m = fov_mask[v]
        wts = torch.where(m, torch.ones_like(idx), torch.zeros_like(idx))
        idx = torch.where(m, idx, torch.full_like(idx, h * w)).long()
        gathered = None
        for k in range(idx.shape[1]):
            g = torch.gather(src, 1, idx[:, k].expand(c, -1))
            gathered = g if gathered is None else gathered + g
        # SFA divides by the count and maps the 0/0 of an unseen voxel to
        # 0; dividing by 1 there gives the same value (its gathered sum is
        # the zero sentinel's) and a finite gradient
        cnt = wts.sum(1)
        seen = cnt > 0
        f = gathered / torch.where(seen, cnt, 1)
        mv = seen.to(f.dtype)
        feats.append(f)
        weights.append(mv)
    if n_views == 1:
        fused = feats[0]
    else:
        fused = torch.zeros_like(feats[0])
        for i in range(n_views):
            for j in range(i + 1, n_views):
                wij = weights[i] * weights[j]
                cos = torch.cosine_similarity(feats[i], feats[j], 0) * wij
                wi = cos + (weights[i] - weights[j] > 0).float()
                wj = cos + (weights[j] - weights[i] > 0).float()
                fused = fused + wi * feats[i] + wj * feats[j]
        fused = fused / (n_views * (n_views - 1))
    X, Y, Z = scene_dims
    if dataset == "NYU":
        x3d = fused.reshape(c, X, Z, Y).permute(0, 1, 3, 2)
    else:
        x3d = fused.reshape(c, X, Y, Z)
    return x3d


# ---------------------------------------------------------------------------
# Full network (OccDepth.py:208-376 semantics)
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# Full network (OccDepth.py:208-376 semantics)
# ---------------------------------------------------------------------------


class RefOccDepth(nn.Module):
    """The whole stereo network (KITTI and TartanAir): 2D UNet per view,
    SFA lift summed over the projected scales, the OAD depth gate where
    `trans_2d_to_3d` is flosp_depth, the 3D UNet with CRP and the heads.

    `cfg` is a `portbench.reference.config.RefConfig`.  `forward` takes the
    benchmark's batch in the program's layouts and returns the program's
    output layouts:

        img (B, V, H, W, 3) normalized RGB; projected_pix (B, V, N, P, 2);
        fov_mask (B, V, N, P); cam_k (B, V, 3, 3); T_velo_2_cam and
        ida_mats (B, V, 4, 4)
        -> ssc_logit and occ_logit (B, X, Y, Z, n) channels-last, P_logits
        (B, n_relations, M, N), depth_pred (B, V, h, w, D)
    """

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.net_rgb = RefUNet2D(
            cfg.backbone_2d_name, cfg.feature_2d_oc, cfg.return_up_feats
        )
        size_l3 = tuple(s // cfg.project_scale // 4
                        for s in cfg.full_scene_size)
        self.net_3d_decoder = RefUNet3DKitti(
            cfg.n_classes, cfg.feature, context_prior=cfg.context_prior,
            n_relations=cfg.n_relations, size_l3=size_l3,
            occluded_cls=cfg.occluded_cls, project_scale=cfg.project_scale,
        )
        if cfg.trans_2d_to_3d == "flosp_depth":
            self.flosp_depth = RefFlospDepth(
                cfg.flosp_depth_conf, cfg.project_scale, cfg.feature,
                return_depth=cfg.with_depth_gt,
            )

    def forward(self, batch):
        cfg = self.cfg
        img = batch["img"].permute(0, 1, 4, 2, 3)
        projected_pix, fov_mask = batch["projected_pix"], batch["fov_mask"]
        B, V = img.shape[:2]
        x_rgb = []
        for v in range(V):
            # views > 0 run under torch.no_grad in the reference
            # (OccDepth.py:213-216); their batch statistics still train
            no_grad = cfg.share_2d_backbone_gradient and v > 0
            with torch.no_grad() if no_grad else contextlib.nullcontext():
                x_rgb.append(self.net_rgb(img[:, v]))

        scene_dims = tuple(s // cfg.project_scale
                           for s in cfg.full_scene_size)
        x3ds = []
        for i in range(B):
            x3d = None
            for scale in cfg.project_res:
                x2d = torch.stack(
                    [x_rgb[v][f"1_{scale}"][i] for v in range(V)]
                )
                pix = torch.div(
                    projected_pix[i], scale, rounding_mode="floor"
                ) if scale > 1 else projected_pix[i]
                lifted = sfa(x2d, pix, fov_mask[i], scene_dims, cfg.dataset)
                x3d = lifted if x3d is None else x3d + lifted
            x3ds.append(x3d)
        x3ds = torch.stack(x3ds)  # (B, C, X, Y, Z)

        out = {}
        if cfg.trans_2d_to_3d == "flosp_depth":
            key = f"1_{cfg.flosp_depth_conf.downsample_factor}"
            img_feat = torch.stack([x_rgb[v][key] for v in range(V)], dim=1)
            gate = self.flosp_depth(img_feat, batch["cam_k"],
                                    batch["T_velo_2_cam"], batch["ida_mats"])
            if cfg.with_depth_gt:
                gate, depth = gate
                out["depth_pred"] = depth.permute(0, 1, 3, 4, 2)
            x3ds = x3ds * gate * 100

        net = self.net_3d_decoder(x3ds)
        for key in ("ssc_logit", "occ_logit", "occluded_logit"):
            if net.get(key) is not None:
                out[key] = net[key].permute(0, 2, 3, 4, 1)
        if "P_logits" in net:
            out["P_logits"] = net["P_logits"]
        return out
