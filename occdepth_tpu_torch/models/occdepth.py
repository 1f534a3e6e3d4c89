"""OccDepth top-level model: 2D backbone -> SFA lift -> OAD -> 3D UNet.

Counterpart of `occdepth_tpu/models/occdepth.py::OccDepthModel`,
KITTI/TartanAir stereo, in eval and train mode.  The public boundary keeps
the JAX package's layouts:

    batch (all tensors on one device):
        img:            (B, V, H, W, 3) normalized RGB
        projected_pix:  (B, V, N, P, 2) integer pixels at project_scale
        fov_mask:       (B, V, N, P) bool
        cam_k:          (B, V, 3, 3)
        T_velo_2_cam:   (B, V, 4, 4)
        ida_mats:       (B, V, 4, 4)
    returns:
        ssc_logit:  (B, X, Y, Z, n_classes) float32
        occ_logit:  (B, X, Y, Z, 2) float32            [cascade_cls]
        P_logits:   (B, n_relations, M, N) float32     [context_prior]
        depth_pred: (B, V, h, w, D) float32            [with_depth_gt]

The channels-last outputs are permuted views of NCDHW float32 tensors.

In train mode with several views the backbone runs once per view, as the
reference does, so BatchNorm batch statistics are per view and the running
statistics advance view 0 first.  Under `share_2d_backbone_gradient` views
after the first run under `torch.no_grad()`: the same gradient as the JAX
package's `stop_gradient`, without building their backward graph.

Numerics follow `compute_dtype` (see models/layers.py): the image is cast
once, convolutions run in that dtype, while BatchNorm, the softmaxes, the
SFA fusion, the CRP accumulation and the frustum grid-sample run in
float32, and logits leave as float32.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from occdepth_tpu_torch.config import OccDepthConfig
from occdepth_tpu_torch.models.flosp_depth import FlospDepth
from occdepth_tpu_torch.models.sfa import sfa_lift
from occdepth_tpu_torch.models.unet2d import UNet2D
from occdepth_tpu_torch.models.unet3d import UNet3DKitti

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class OccDepthModel(nn.Module):
    """End-to-end SSC model for one config."""

    def __init__(self, cfg: OccDepthConfig):
        super().__init__()
        if cfg.dataset == "NYU":
            raise NotImplementedError("the NYU model is not ported yet")
        if cfg.occluded_cls:
            raise NotImplementedError("the occluded head is not ported yet")
        self.cfg = cfg
        self.compute_dtype = _DTYPES[cfg.compute_dtype]
        self.net_rgb = UNet2D(cfg.backbone_2d_name, cfg.feature_2d_oc,
                              cfg.return_up_feats, cfg.dw_conv_grad)
        self.net_3d_decoder = UNet3DKitti(
            cfg.n_classes, cfg.feature, cfg.full_scene_size,
            project_scale=cfg.project_scale,
            context_prior=cfg.context_prior, n_relations=cfg.n_relations,
            cascade_cls=cfg.cascade_cls,
        )
        if cfg.trans_2d_to_3d == "flosp_depth":
            self.flosp_depth = FlospDepth(
                cfg.flosp_depth_conf, cfg.project_scale, cfg.feature,
                cfg.dataset, return_depth=cfg.with_depth_gt,
            )

    def backbone_features(self, img: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(B, V, H, W, 3) views -> {'1_s': (B, V, C, h, w)}."""
        B, V, H, W, _ = img.shape

        def nchw(x):
            return x.permute(0, 3, 1, 2).to(
                dtype=self.compute_dtype, memory_format=torch.contiguous_format)

        if not (self.training and V > 1):
            # all views in one call (frozen BN at eval)
            x = nchw(img.reshape(B * V, H, W, 3))
            return {k: v.reshape(B, V, *v.shape[1:])
                    for k, v in self.net_rgb(x).items()}
        per_view = []
        for view in range(V):
            if self.cfg.share_2d_backbone_gradient and view > 0:
                with torch.no_grad():
                    per_view.append(self.net_rgb(nchw(img[:, view])))
            else:
                per_view.append(self.net_rgb(nchw(img[:, view])))
        return {k: torch.stack([f[k] for f in per_view], dim=1)
                for k in per_view[0]}

    def forward(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        dtype = self.compute_dtype
        feats = self.backbone_features(batch["img"])  # '1_s': (B, V, C, h, w)

        # ---- FLoSP lift + Stereo-SFA fusion (float32) ----
        x3d = sfa_lift(
            {f"1_{s}": feats[f"1_{s}"] for s in cfg.project_res},
            batch["projected_pix"], batch["fov_mask"], cfg.project_res,
            cfg.scene_dims(cfg.project_scale), cfg.dataset,
        )  # (B, X, Y, Z, C)
        x3d = x3d.permute(0, 4, 1, 2, 3)

        out: Dict[str, torch.Tensor] = {}
        # ---- OAD depth branch ----
        if cfg.trans_2d_to_3d == "flosp_depth":
            key = f"1_{cfg.flosp_depth_conf.downsample_factor}"
            result = self.flosp_depth(feats[key], batch["cam_k"],
                                      batch["T_velo_2_cam"],
                                      batch["ida_mats"])
            if cfg.with_depth_gt:
                weight, depth = result
                out["depth_pred"] = depth.permute(0, 1, 3, 4, 2)
            else:
                weight = result
            x3d = x3d * weight[:, None] * 100.0

        # ---- 3D UNet + heads ----
        x3d = x3d.to(dtype=dtype, memory_format=torch.contiguous_format)
        net_out = self.net_3d_decoder(x3d)
        out["ssc_logit"] = net_out["ssc_logit"].float().permute(0, 2, 3, 4, 1)
        if "occ_logit" in net_out:
            out["occ_logit"] = net_out["occ_logit"].float().permute(
                0, 2, 3, 4, 1)
        if "P_logits" in net_out:
            out["P_logits"] = net_out["P_logits"].float()
        return out
