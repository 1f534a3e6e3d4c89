"""FLoSP gather and Stereo-SFA cross-view fusion.

Counterpart of `occdepth_tpu/ops/flosp_gather.py`.  Every (batch, view)
map of a scale becomes a channels-last table with a zero sentinel row, and
one `index_select` gathers all voxels' pattern pixels at once (the index of
an out-of-FOV point is the sentinel row, so the gather needs no branch).
`multiview_cosine_fuse` runs two-view fusion through kernel K1
(`ops/stereo_fuse.py`).

`flosp_stereo_lift` is the two-view lift of every scale in one kernel
(`csrc/stereo_fuse.cu`, `occ_flosp_stereo_lift`): gather, mean over the
pattern points, K1's fusion and the sum over scales, writing the (B, N, C)
grid once.  Its plain version `flosp_stereo_lift_reference` is the
per-scale loop above.  The lift is the registered operator
`occdepth::flosp_stereo_lift` (`torch.library.custom_op`), so a traced or
exported program calls the kernel by name: its CUDA implementation is the
kernel launch, its CPU implementation the plain version, and its
registered gradient autograd of the plain version, recomputed from the
saved inputs.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from occdepth_tpu_torch.ops import cuda_lib
from occdepth_tpu_torch.ops.conv2d_shift import to_padded_channels_last
from occdepth_tpu_torch.ops.stereo_fuse import (
    stereo_cosine_fuse,
    stereo_cosine_fuse_reference,
)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_SCALES = 8  # csrc/stereo_fuse.cu


def flosp_gather_flat(
    x2d: torch.Tensor,  # (B, V, C, h, w)
    pix: torch.Tensor,  # (B, V, N, P, 2) integer pixel coords at this scale
    fov_mask: torch.Tensor,  # (B, V, N, P) bool
) -> tuple:
    """Gather every map's pattern pixels and average the in-FOV ones.

    Returns ((B, V, N, C) float32 per-voxel means, (B, V, N) float32
    validity).  The gather reads the maps in their own dtype; the mean is
    taken in float32.
    """
    B, V, C, h, w = x2d.shape
    N, P = pix.shape[2], pix.shape[3]
    G = B * V
    # channels-last tables with a zero sentinel row at index h*w: one copy
    table = x2d.new_empty((G, h * w + 1, C))
    table[:, h * w].zero_()
    table[:, : h * w].unflatten(1, (h, w)).copy_(
        x2d.reshape(G, C, h, w).permute(0, 2, 3, 1)
    )
    pix = pix.long()
    idx = pix[..., 1] * w + pix[..., 0]
    idx = torch.where(fov_mask, idx, torch.full_like(idx, h * w))
    offsets = torch.arange(G, device=idx.device) * (h * w + 1)
    idx = idx.reshape(G, N * P) + offsets[:, None]
    gathered = table.reshape(G * (h * w + 1), C).index_select(
        0, idx.reshape(-1)
    ).reshape(B, V, N, P, C)
    if P == 1:
        # single-point pattern (pattern_id 0, the flagship): sentinel rows
        # are exact zeros, so the mean is the gathered value itself
        return gathered[:, :, :, 0].float(), fov_mask[..., 0].float()
    total = gathered.float().sum(dim=3)
    counts = fov_mask.sum(dim=-1).float()
    denom = torch.where(counts > 0, counts, torch.ones_like(counts))
    feats = torch.where(counts[..., None] > 0, total / denom[..., None],
                        torch.zeros_like(total))
    return feats, (counts > 0).float()


def multiview_cosine_fuse(feats: torch.Tensor, valid: torch.Tensor,
                          eps: float = 1e-8) -> torch.Tensor:
    """Stereo-SFA fusion with cosine-similarity weights.

    Voxels seen by both views are weighted by the cosine similarity of
    their per-view features; voxels seen by one view keep that view's
    feature.  feats (B, V, N, C) float32, valid (B, V, N) float32 in
    {0, 1} -> (B, N, C) float32.  Two views go through kernel K1 on CUDA.
    Every config has one or two lift views (the JAX package's general
    pairwise loop has no caller with more).
    """
    V = feats.shape[1]
    if V == 1:
        return feats[:, 0]
    if V != 2:
        raise ValueError(f"multiview_cosine_fuse: {V} views (1 or 2 supported)")
    return stereo_cosine_fuse(feats[:, 0], feats[:, 1], valid[:, 0],
                              valid[:, 1], eps)


def flosp_stereo_lift_reference(
    maps: Sequence[torch.Tensor],  # per scale (B, 2, C, h_s, w_s)
    projected_pix: torch.Tensor,  # (B, 2, N, P, 2) int, project-scale coords
    fov_mask: torch.Tensor,  # (B, 2, N, P) bool
    project_res: Sequence[int],
    eps: float = 1e-8,
) -> torch.Tensor:
    """Plain version of `flosp_stereo_lift`: per scale, `flosp_gather_flat`,
    then the plain 2-view fusion, summed over scales in `project_res`
    order.  Returns (B, N, C) float32."""
    x3d = None
    for x2d, scale in zip(maps, project_res):
        pix = projected_pix // scale if scale > 1 else projected_pix
        feats, valid = flosp_gather_flat(x2d, pix, fov_mask)
        fused = stereo_cosine_fuse_reference(
            feats[:, 0], feats[:, 1], valid[:, 0], valid[:, 1], eps)
        x3d = fused if x3d is None else x3d + fused
    return x3d


def flosp_stereo_lift(
    maps: Sequence[torch.Tensor],
    projected_pix: torch.Tensor,
    fov_mask: torch.Tensor,
    project_res: Sequence[int],
    eps: float = 1e-8,
) -> torch.Tensor:
    """Lift two views' multi-scale maps to the voxel grid, fused and summed.

    Args:
        maps: one (B, 2, C, h_s, w_s) map per scale of `project_res`, all
            float32 or all bfloat16, any strides (a channels-last map is
            read in place, any other is packed to channels-last first).
        projected_pix: (B, 2, N, P, 2) int32 pixel coordinates at project
            scale (divided by each scale with floor division).
        fov_mask: (B, 2, N, P) bool.

    Returns (B, N, C) float32, contiguous.  On CUDA one kernel launch.
    """
    maps = tuple(maps)
    if len(maps) != len(project_res):
        raise ValueError(f"flosp_stereo_lift: {len(maps)} maps for scales "
                         f"{tuple(project_res)}")
    return torch.ops.occdepth.flosp_stereo_lift(
        list(maps), projected_pix, fov_mask, [int(s) for s in project_res],
        float(eps))


_LIFT_SCHEMA = ("(Tensor[] maps, Tensor projected_pix, Tensor fov_mask, "
                "int[] project_res, float eps) -> Tensor")


@torch.library.custom_op("occdepth::flosp_stereo_lift", mutates_args=(),
                         device_types="cuda", schema=_LIFT_SCHEMA)
def _lift_op(maps, projected_pix, fov_mask, project_res, eps):
    """The operator's CUDA implementation: one kernel launch."""
    return _launch_lift(maps, projected_pix, fov_mask, project_res, eps)


@_lift_op.register_kernel("cpu")
def _lift_cpu(maps, projected_pix, fov_mask, project_res, eps):
    return flosp_stereo_lift_reference(maps, projected_pix, fov_mask,
                                       project_res, eps)


@_lift_op.register_fake
def _lift_fake(maps, projected_pix, fov_mask, project_res, eps):
    B, _, C = maps[0].shape[:3]
    return maps[0].new_empty((B, projected_pix.shape[2], C),
                             dtype=torch.float32)


def _lift_setup(ctx, inputs, output):
    maps, projected_pix, fov_mask, ctx.project_res, ctx.eps = inputs
    ctx.save_for_backward(projected_pix, fov_mask, *maps)


def _lift_backward(ctx, grad_out):
    """Every map's gradient: autograd of the plain version, recomputed."""
    pix, fov, *maps = ctx.saved_tensors
    _, vjp = torch.func.vjp(
        lambda *m: flosp_stereo_lift_reference(m, pix, fov, ctx.project_res,
                                               ctx.eps), *maps)
    return [g.contiguous() for g in vjp(grad_out)], None, None, None, None


_lift_op.register_autograd(_lift_backward, setup_context=_lift_setup)


def channels_last_map(x2d: torch.Tensor) -> torch.Tensor:
    """x2d (B, V, C, h, w) with unit channel stride: x2d itself when it
    has one, else a channels-last copy (on CUDA by K3's packing kernel,
    rows padded to a multiple of 8 channels) viewed as (B, V, C, h, w)."""
    if x2d.stride(2) == 1 or x2d.shape[2] == 1:
        return x2d
    B, V, C, h, w = x2d.shape
    packed = to_padded_channels_last(x2d.reshape(B * V, C, h, w))
    return packed.view(B, V, h, w, -1)[..., :C].permute(0, 1, 4, 2, 3)


def _launch_lift(maps, projected_pix, fov_mask, project_res, eps):
    """The kernel launch behind `flosp_stereo_lift` (CUDA tensors)."""
    dev = maps[0].device
    B, V, C = maps[0].shape[:3]
    N, P = projected_pix.shape[2], projected_pix.shape[3]
    if V != 2 or not 1 <= len(maps) <= MAX_SCALES:
        raise ValueError(f"flosp_stereo_lift: {V} views, {len(maps)} scales "
                         f"(2 views, 1-{MAX_SCALES} scales supported)")
    for name, t in [(f"map {i}", m) for i, m in enumerate(maps)] + [
            ("projected_pix", projected_pix), ("fov_mask", fov_mask)]:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"flosp_stereo_lift: {name} on {t.device}")
    for i, m in enumerate(maps):
        if m.dtype not in _DTYPE_CODE or m.dtype != maps[0].dtype:
            raise TypeError(f"flosp_stereo_lift: map {i} is {m.dtype}")
        if m.dim() != 5 or m.shape[:3] != (B, V, C):
            raise ValueError(f"flosp_stereo_lift: map {i} shape "
                             f"{tuple(m.shape)}")
    if projected_pix.dtype != torch.int32 or fov_mask.dtype != torch.bool:
        raise TypeError(f"flosp_stereo_lift: projected_pix "
                        f"{projected_pix.dtype}, fov_mask {fov_mask.dtype} "
                        "(int32 and bool expected)")
    if (projected_pix.shape != (B, V, N, P, 2)
            or fov_mask.shape != (B, V, N, P)):
        raise ValueError(f"flosp_stereo_lift: projected_pix "
                         f"{tuple(projected_pix.shape)}, fov_mask "
                         f"{tuple(fov_mask.shape)}")
    maps = [channels_last_map(m) for m in maps]
    pix, fov = projected_pix.contiguous(), fov_mask.contiguous()
    geom = []
    for m, scale in zip(maps, project_res):
        geom += [m.stride(0), m.stride(1), m.stride(3), m.stride(4),
                 m.shape[3], m.shape[4], int(scale)]
    out = torch.empty((B, N, C), dtype=torch.float32, device=dev)
    rc = cuda_lib.library().occ_flosp_stereo_lift(
        (ctypes.c_void_p * len(maps))(*(m.data_ptr() for m in maps)),
        (ctypes.c_longlong * len(geom))(*geom), len(maps), pix.data_ptr(),
        fov.data_ptr(), out.data_ptr(), _DTYPE_CODE[maps[0].dtype], B, N, P,
        C, eps, torch.cuda.current_stream(dev).cuda_stream,
    )
    cuda_lib.check(rc, "flosp_stereo_lift")
    flosp_stereo_lift.launches += 1
    return out


flosp_stereo_lift.launches = 0
