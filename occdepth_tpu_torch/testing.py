"""Reduced-size configs, seeded random weights and the fp32-noise-aware
comparison helpers for tests and smoke runs."""
from __future__ import annotations

import copy
import math

import torch
import torch.nn as nn

from occdepth_tpu_torch.config import FlospDepthConfig, OccDepthConfig

TINY_IMG_KITTI = (64, 96)


def tiny_kitti_config(**overrides) -> OccDepthConfig:
    """KITTI stereo flosp_depth + CRP + cascade at toy sizes (the same
    config as `occdepth_tpu.testing.tiny_kitti_config`)."""
    fd = FlospDepthConfig(
        x_bound=(0.0, 6.4, 0.2),
        y_bound=(-3.2, 3.2, 0.2),
        z_bound=(-1.6, 1.6, 0.2),
        d_bound=(2.0, 10.0, 0.5),
        final_dim=TINY_IMG_KITTI,
        mid_channels=16,
    )
    base = dict(
        dataset="kitti",
        full_scene_size=(32, 32, 16),
        project_scale=2,
        scene_size_m=(6.4, 6.4, 3.2),
        voxel_size_m=0.2,
        img_shape_hw=TINY_IMG_KITTI,
        feature=16,
        feature_2d_oc=16,
        n_classes=20,
        frustum_size=2,
        use_stereo_depth_gt=True,
        multi_view_mode=True,
        cascade_cls=True,
        context_prior=True,
        trans_2d_to_3d="flosp_depth",
        flosp_depth_override=fd,
        compute_dtype="float32",
        backbone_2d_name="tf_efficientnet_b3_ns",
    )
    base.update(overrides)
    return OccDepthConfig(**base)


@torch.no_grad()
def randomize_weights(model: nn.Module, seed: int) -> nn.Module:
    """Seeded random weights that keep activations O(1) at any depth.

    Conv/linear weights are N(0, 1/fan_in), biases N(0, 0.01^2);
    BatchNorm gets non-trivial affine parameters and running statistics so
    that a forward pass exercises the statistics handling.  Draws come
    from one CPU `torch.Generator` in module order, so a seed gives the same
    weights on every device.
    """
    g = torch.Generator().manual_seed(seed)

    def normal(shape, std, mean=0.0):
        return torch.randn(shape, generator=g) * std + mean

    for m in model.modules():
        if isinstance(m, nn.modules.batchnorm._BatchNorm):
            c = m.num_features
            m.weight.copy_(normal(c, 0.1, 1.0))
            m.bias.copy_(normal(c, 0.1))
            m.running_mean.copy_(normal(c, 0.1))
            m.running_var.copy_(torch.rand(c, generator=g) * 0.5 + 0.75)
        elif isinstance(m, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose3d,
                            nn.Linear)):
            w = m.weight
            if isinstance(m, nn.ConvTranspose3d):
                fan_in = w.shape[0] * math.prod(w.shape[2:]) // 8
            else:
                fan_in = math.prod(w.shape[1:])
            w.copy_(normal(w.shape, math.sqrt(1.0 / max(fan_in, 1))))
            if m.bias is not None:
                m.bias.copy_(normal(m.bias.shape, 0.01))
    return model


@torch.no_grad()
def perturbed_copy(model: nn.Module, seed: int,
                   rel: float = 1e-7) -> nn.Module:
    """A deep copy whose parameters are scaled by (1 + rel * N(0, 1)):
    an fp32-rounding-sized change, the yardstick of a network's own fp32
    gradient noise."""
    out = copy.deepcopy(model)
    g = torch.Generator().manual_seed(seed)
    for p in out.parameters():
        p.mul_(1.0 + rel * torch.randn(p.shape, generator=g).to(p.device))
    return out


def noise_aware_worst(ours: dict, ref: dict, perturbed: list, rtol: float,
                      noise_mult: float) -> list:
    """[(err / tol, name, err, tol), ...] worst first, with L2 norms per
    named tensor: err = |ours - ref|, tol = max(rtol * |ref| + 1e-6,
    noise_mult * max over `perturbed` of |ours - perturbed|)."""
    worst = []
    for name, t in ours.items():
        t = t.detach().double().cpu()
        r = torch.as_tensor(ref[name]).double().cpu()
        err = float(torch.linalg.vector_norm(t - r))
        noise = max(float(torch.linalg.vector_norm(
            t - torch.as_tensor(q[name]).double().cpu())) for q in perturbed)
        tol = max(rtol * float(torch.linalg.vector_norm(r)) + 1e-6,
                  noise_mult * noise)
        ratio = err / tol if math.isfinite(err) else math.inf  # NaN fails
        worst.append((ratio, name, err, tol))
    worst.sort(reverse=True)
    return worst


def count_flips(a: dict, b: dict, threshold: float) -> int:
    """Elements whose values differ by more than `threshold` over the
    named tensors of `a` (e.g. AdamW first-step updates of opposite sign)."""
    return sum(int(((a[n].detach().cpu() - torch.as_tensor(b[n]).cpu()
                     ).abs() > threshold).sum()) for n in a)
