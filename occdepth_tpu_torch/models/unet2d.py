"""2D UNet: EfficientNet encoder + BN-upsample decoder (DecoderBN), NCHW.

Counterpart of `occdepth_tpu/models/unet2d.py`, with the reference's
module names (encoder.original_model, decoder.conv2, decoder.up{s}._net,
decoder.resize_output_1_{s}).  The 3x3 decoder convs are stock
convolutions: the JAX package's `decoder_conv_impl=auto` resolves to its
stock conv as well.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from occdepth_tpu_torch.models.efficientnet import EfficientNet, variant_channels
from occdepth_tpu_torch.models.layers import Conv2d, batch_norm2d
from occdepth_tpu_torch.ops.resize import resize_bilinear


class UpSampleBN(nn.Module):
    """Upsample-to-skip + concat + 2x (conv3x3, BN, LeakyReLU)."""

    def __init__(self, skip_input: int, out_f: int):
        super().__init__()
        self._net = nn.Sequential(
            Conv2d(skip_input, out_f, 3, 1, 1), batch_norm2d(out_f),
            nn.LeakyReLU(),
            Conv2d(out_f, out_f, 3, 1, 1), batch_norm2d(out_f),
            nn.LeakyReLU(),
        )

    def forward(self, x, skip):
        up = resize_bilinear(x, skip.shape[-2:], align_corners=True)
        return self._net(torch.cat([up, skip.to(up.dtype)], dim=1))


class Encoder(nn.Module):
    def __init__(self, variant: str, dw_grad: str = "xla"):
        super().__init__()
        self.original_model = EfficientNet(variant, dw_grad)

    def forward(self, x):
        return self.original_model(x)


class DecoderBN(nn.Module):
    """DecoderBN, including the reference's padded 1x1 `conv2`: padding=1
    grows each spatial dim by 2, and the bilinear resize to the next skip's
    size absorbs it."""

    def __init__(self, variant: str, out_feature: int,
                 return_up_feats: int = 1):
        super().__init__()
        cfg = variant_channels(variant)
        mc = [3, cfg["stages"][0], cfg["stages"][1], cfg["stages"][2],
              cfg["stages"][4]]
        f = cfg["head"]
        self.return_up_feats = return_up_feats
        self.scales = [s for s in (16, 8, 4, 2, 1) if return_up_feats <= s]
        self.conv2 = Conv2d(f, f, 1, 1, padding=1)
        skips = {16: mc[4], 8: mc[3], 4: mc[2], 2: mc[1], 1: mc[0]}
        cin = f
        for s in self.scales:
            cout = f * s // 32  # f/2 at 1_16 ... f/32 at 1_1
            setattr(self, f"up{s}", UpSampleBN(cin + skips[s], cout))
            setattr(self, f"resize_output_1_{s}",
                    Conv2d(cout, out_feature, 1))
            cin = cout

    def forward(self, taps) -> Dict[str, torch.Tensor]:
        x_in, b0, b1, b2, b4, head = taps
        skip = {16: b4, 8: b2, 4: b1, 2: b0, 1: x_in}
        x = self.conv2(head)
        res = {}
        for s in self.scales:
            x = getattr(self, f"up{s}")(x, skip[s])
            res[f"1_{s}"] = getattr(self, f"resize_output_1_{s}")(x)
        return res


class UNet2D(nn.Module):
    """Encoder + DecoderBN producing {'1_1', '1_2', '1_4', '1_8', '1_16'}."""

    def __init__(self, backbone_2d_name: str = "tf_efficientnet_b3_ns",
                 out_feature: int = 32, return_up_feats: int = 1,
                 dw_conv_grad: str = "xla"):
        super().__init__()
        self.encoder = Encoder(backbone_2d_name, dw_conv_grad)
        self.decoder = DecoderBN(backbone_2d_name, out_feature,
                                 return_up_feats)

    def forward(self, img) -> Dict[str, torch.Tensor]:
        return self.decoder(self.encoder(img))
