"""OccDepth top-level model: 2D backbone -> SFA lift -> OAD -> 3D UNet.

Counterpart of `occdepth_tpu/models/occdepth.py::OccDepthModel`:
KITTI/TartanAir stereo and NYU RGB-D, in eval and train mode.  The public
boundary keeps the JAX package's layouts:

    batch (all tensors on one device):
        img:            (B, V, H, W, 3) normalized RGB
        projected_pix:  (B, Vl, N, P, 2) integer pixels at project_scale
                        (Vl = lift views: NYU adds the virtual right view)
        fov_mask:       (B, Vl, N, P) bool
        cam_k:          (B, V, 3, 3)
        T_velo_2_cam:   (B, V, 4, 4)
        ida_mats:       (B, V, 4, 4)
        vox_origin:     (B, 3)                          [NYU, TartanAir]
        gt_depth:       (B, 1, H, W) metric depth       [NYU RGB-D]
        virtual_bf:     (B,) baseline x focal           [NYU RGB-D]
    returns (NYU grids are (X, Z_up, Y), the target's layout):
        ssc_logit:  (B, X, Y, Z, n_classes) float32
        occ_logit:  (B, X, Y, Z, 2) float32            [cascade_cls]
        occluded_logit: (B, X, Y, Z, 2) float32        [occluded_cls]
        P_logits:   (B, n_relations, M, N) float32     [context_prior]
        depth_pred: (B, V, h, w, D) float32            [with_depth_gt]

The channels-last outputs are permuted views of NCDHW float32 tensors.

NYU with depth (`use_depth_gt`) lifts a second, virtual right view: the
left features of every projected scale warped by the disparity
baseline x focal / depth (`_virtual_view`).  As in the reference, and so
in the JAX package, sample 0's disparity is broadcast over the batch, so
a batch of NYU frames is not the concatenation of its frames one by one;
the port's evaluation stays batched, as the JAX package's does for NYU.

In train mode with several views the backbone runs once per view, as the
reference does, so BatchNorm batch statistics are per view and the running
statistics advance view 0 first.  Under `share_2d_backbone_gradient` views
after the first run under `torch.no_grad()`: the same gradient as the JAX
package's `stop_gradient`, without building their backward graph.

Each stage runs under a span (`tracing.py`): `model.backbone_2d` (each
2D UNet call), `model.virtual_view`, `model.lift`, `model.oad` and
`model.decoder_3d`, inside which the decoders open `model.crp` and
`model.heads`.  Every stage but the lift, and the glue between them
(the decoders' parts around `model.crp`, the first with the decoder's
input cast, the outputs' casts), is a function of tensors run through
the forward's `stage` runner: by default `tracing.call`, the function
inside its span; the serving pipeline passes a runner that replays each
as a CUDA graph.  The lift stays an eager call: its operators' host
events are what the profiler attributes its kernels to.

Numerics follow `compute_dtype` (see models/layers.py): the image is cast
once, convolutions run in that dtype, while BatchNorm, the softmaxes, the
SFA fusion, the CRP accumulation and the frustum grid-sample run in
float32, and logits leave as float32.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from occdepth_tpu_torch import tracing
from occdepth_tpu_torch.config import OccDepthConfig
from occdepth_tpu_torch.models.flosp_depth import FlospDepth
from occdepth_tpu_torch.models.sfa import sfa_lift
from occdepth_tpu_torch.models.unet2d import UNet2D
from occdepth_tpu_torch.models.unet3d import UNet3DKitti, UNet3DNYU
from occdepth_tpu_torch.ops.grid_sample import grid_sample_2d
from occdepth_tpu_torch.ops.resize import resize_bilinear

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _virtual_view(feat: torch.Tensor, gt_depth: torch.Tensor, scale: int,
                  bf: torch.Tensor) -> torch.Tensor:
    """Right-view features synthesised by disparity warping, float32.

    feat (B, C, h, w) float32 left-view features at one scale, gt_depth
    (B, 1, H, W) metric depth, bf () baseline x focal -> (B, C, h, w).
    The JAX package's `_virtual_view` (reference
    OccDepth.generate_virtual_img) with its quirks: the grid is
    `-1 + (2 / n) * arange(n)`, not grid_sample's align_corners=False
    centres; an infinite disparity (zero depth) becomes 0; sample 0's
    disparity map warps every sample of the batch.
    """
    B, C, h, w = feat.shape
    depth = resize_bilinear(gt_depth, (h, w), align_corners=False)[:, 0]
    grid_dx = (bf / scale) / depth
    grid_dx = torch.where(torch.isinf(grid_dx), 0.0, grid_dx) * 2.0 / w
    ys = -1.0 + (2.0 / h) * torch.arange(h, dtype=torch.float32,
                                         device=feat.device)
    xs = -1.0 + (2.0 / w) * torch.arange(w, dtype=torch.float32,
                                         device=feat.device)
    gx = xs[None, :] + grid_dx[0]  # the reference's dx[0]
    gy = ys[:, None].expand(h, w)
    return grid_sample_2d(feat, torch.stack([gx, gy], dim=-1))


class OccDepthModel(nn.Module):
    """End-to-end SSC model for one config."""

    def __init__(self, cfg: OccDepthConfig):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = _DTYPES[cfg.compute_dtype]
        self.net_rgb = UNet2D(cfg.backbone_2d_name, cfg.feature_2d_oc,
                              cfg.return_up_feats, cfg.dw_conv_grad,
                              cfg.decoder_conv_impl)
        if cfg.dataset == "NYU":
            self.net_3d_decoder = UNet3DNYU(
                cfg.n_classes, cfg.feature, cfg.full_scene_size,
                context_prior=cfg.context_prior,
                n_relations=cfg.n_relations, cascade_cls=cfg.cascade_cls,
            )
        else:
            self.net_3d_decoder = UNet3DKitti(
                cfg.n_classes, cfg.feature, cfg.full_scene_size,
                project_scale=cfg.project_scale,
                context_prior=cfg.context_prior,
                n_relations=cfg.n_relations, cascade_cls=cfg.cascade_cls,
                occluded_cls=cfg.occluded_cls,
            )
        if cfg.trans_2d_to_3d == "flosp_depth":
            self.flosp_depth = FlospDepth(
                cfg.flosp_depth_conf, cfg.project_scale, cfg.feature,
                cfg.dataset, return_depth=cfg.with_depth_gt,
            )

    def unused_parameter_names(self) -> list:
        """Parameters that no output of this config depends on: the
        decoder's `resize_output_1_{s}` heads of the scales that neither
        the lift (`project_res`) nor the OAD depth branch reads.  They get
        no gradient in any step, so DDP leaves them out of its buckets."""
        cfg = self.cfg
        read = set(cfg.project_res)
        if cfg.trans_2d_to_3d == "flosp_depth":
            read.add(cfg.flosp_depth_conf.downsample_factor)
        return [f"net_rgb.decoder.resize_output_1_{s}.{p}"
                for s in self.net_rgb.decoder.scales if s not in read
                for p in ("weight", "bias")]

    def _backbone(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(B', H, W, 3) images -> the 2D UNet's {'1_s': (B', C, h, w)}."""
        return self.net_rgb(x.permute(0, 3, 1, 2).to(
            dtype=self.compute_dtype, memory_format=torch.contiguous_format))

    def backbone_features(self, img: torch.Tensor,
                          stage=tracing.call) -> Dict[str, torch.Tensor]:
        """(B, V, H, W, 3) views -> {'1_s': (B, V, C, h, w)}."""
        B, V, H, W, _ = img.shape

        def net_rgb(x):
            return stage("model.backbone_2d", self._backbone, x)

        if not (self.training and V > 1):
            # all views in one call (frozen BN at eval)
            return {k: v.reshape(B, V, *v.shape[1:])
                    for k, v in net_rgb(img.reshape(B * V, H, W, 3)).items()}
        per_view = []
        for view in range(V):
            if self.cfg.share_2d_backbone_gradient and view > 0:
                with torch.no_grad():
                    per_view.append(net_rgb(img[:, view]))
            else:
                per_view.append(net_rgb(img[:, view]))
        return {k: torch.stack([f[k] for f in per_view], dim=1)
                for k in per_view[0]}

    def _virtual_views(self, gt_depth, virtual_bf, *maps):
        """The maps of `project_res`, each (B, V, C, h, w), with the
        virtual right view of view 0 appended, warped in float32."""
        bf = virtual_bf.reshape(-1)[0].float()
        gt_depth = gt_depth.float()
        return tuple(
            torch.cat([m, _virtual_view(m[:, 0].float(), gt_depth, scale,
                                        bf).to(self.compute_dtype)[:, None]],
                      dim=1)
            for m, scale in zip(maps, self.cfg.project_res))

    def _oad(self, x3d, feat, cam_k, T_velo_2_cam, ida_mats, vox_origin):
        """The OAD depth branch's weight volume applied to the lifted
        (B, C, X, Y, Z) grid -> (the gated grid, depth or None)."""
        result = self.flosp_depth(feat, cam_k, T_velo_2_cam, ida_mats,
                                  vox_origin)
        weight, depth = result if self.cfg.with_depth_gt else (result, None)
        return x3d * weight[:, None] * 100.0, depth

    @staticmethod
    def _outputs(net_out):
        """The decoder's NCDHW outputs -> the model's float32 outputs."""
        out = {"ssc_logit": net_out["ssc_logit"].float().permute(
            0, 2, 3, 4, 1)}
        for key in ("occ_logit", "occluded_logit"):
            if key in net_out:
                out[key] = net_out[key].float().permute(0, 2, 3, 4, 1)
        if "P_logits" in net_out:
            out["P_logits"] = net_out["P_logits"].float()
        return out

    def forward(self, batch: Dict[str, torch.Tensor],
                stage=tracing.call) -> Dict[str, torch.Tensor]:
        """`stage(name, fn, *args)` runs each stage (`tracing.call`: fn
        inside the span `name`)."""
        cfg = self.cfg
        feats = self.backbone_features(batch["img"], stage)

        # ---- NYU virtual right view from RGB-D, warped in float32 ----
        if cfg.dataset == "NYU" and cfg.use_depth_gt and "gt_depth" in batch:
            keys = [f"1_{s}" for s in cfg.project_res]
            feats.update(zip(keys, stage(
                "model.virtual_view", self._virtual_views, batch["gt_depth"],
                batch["virtual_bf"], *[feats[k] for k in keys])))

        # ---- FLoSP lift + Stereo-SFA fusion (float32) ----
        with tracing.span("model.lift"):
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
            v = 1 if cfg.dataset == "NYU" else feats[key].shape[1]
            x3d, depth = stage(
                "model.oad", self._oad, x3d, feats[key][:, :v],
                batch["cam_k"][:, :v], batch["T_velo_2_cam"][:, :v],
                batch["ida_mats"][:, :v], batch.get("vox_origin"))
            if depth is not None:
                out["depth_pred"] = depth.permute(0, 1, 3, 4, 2)

        # ---- 3D UNet + heads ----
        with tracing.span("model.decoder_3d"):
            net_out = self.net_3d_decoder(x3d, stage, self.compute_dtype)
        out.update(stage(None, self._outputs, net_out))
        return out
