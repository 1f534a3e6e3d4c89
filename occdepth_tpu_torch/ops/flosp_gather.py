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
kernel launch, its CPU implementation the plain version.  Its registered
gradient is the operator `occdepth::flosp_stereo_lift_backward`, the
closed form of the maps' gradient: on CUDA the deterministic kernel
`occ_flosp_stereo_lift_backward` (same source), on the CPU its plain
version `flosp_stereo_lift_backward_reference`.
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


def flosp_stereo_lift_backward_reference(
    maps: Sequence[torch.Tensor],  # per scale (B, 2, C, h_s, w_s)
    projected_pix: torch.Tensor,  # (B, 2, N, P, 2) int, project-scale coords
    fov_mask: torch.Tensor,  # (B, 2, N, P) bool
    project_res: Sequence[int],
    eps: float,
    grad_out: torch.Tensor,  # (B, N, C) float32
) -> list:
    """Plain version of the lift's backward: each map's gradient, with the
    map's shape and dtype and channels-last strides (`_grad_like`).

    Per batch item b, voxel n and scale s, with g = grad_out[b, n], f_v view
    v's mean over its in-FOV points (0 when it has none), m_v = [count_v >
    0], k_v = max(|f_v|, eps), c = (f0.f1) / (k0 k1) m0 m1 and w_v = c +
    [m_v > m_other] (the forward is (w0 f0 + w1 f1) / 2):

        df_v = w_v g / 2 + a m0 m1 (f_o / (k_v k_o)
                                   - [|f_v| > eps] (f0.f1) f_v / (k_v^3 k_o)),
        a = (g.f0 + g.f1) / 2,

    and each in-FOV point of view v adds df_v / count_v to the map row it
    names at scale s.  An in-FOV point whose flat index falls off the map
    adds nothing (its view's mean is NaN, as the kernel's forward reads it).
    Sums run in float32 in ascending (n, p) order per row (`index_add_` on
    the CPU) and are rounded once to the map's dtype.
    """
    g = grad_out.float()
    B, N, C = g.shape
    grads = []
    for x2d, scale in zip(maps, project_res):
        _, V, _, h, w = x2d.shape
        pix = (projected_pix // scale if scale > 1 else projected_pix).long()
        idx = pix[..., 1] * w + pix[..., 0]  # (B, 2, N, P)
        on_map = (idx >= 0) & (idx < h * w)
        flat = (torch.where(on_map, idx, 0)
                + torch.arange(B * V, device=idx.device).view(B, V, 1, 1)
                * (h * w))
        table = x2d.permute(0, 1, 3, 4, 2).reshape(B * V * h * w, C).float()
        rows = table.index_select(0, flat.reshape(-1)).view(*flat.shape, C)
        rows = torch.where((fov_mask & on_map)[..., None], rows,
                           torch.where(fov_mask, float("nan"), 0.0)[..., None])
        count = fov_mask.sum(-1).float()  # (B, 2, N)
        f = torch.where(count[..., None] > 0,
                        rows.sum(3) / count.clamp(min=1)[..., None], 0.0)
        m = (count > 0).float()
        s01 = (f[:, 0] * f[:, 1]).sum(-1)
        n = torch.linalg.vector_norm(f, dim=-1)  # (B, 2, N)
        k = n.clamp(min=eps)
        cos = s01 / (k[:, 0] * k[:, 1]) * (m[:, 0] * m[:, 1])
        a = (0.5 * ((g * f[:, 0]).sum(-1) + (g * f[:, 1]).sum(-1))
             * (m[:, 0] * m[:, 1]))
        df = []
        for v in (0, 1):
            o = 1 - v
            alpha = 0.5 * (cos + (m[:, v] - m[:, o] > 0).float())
            gamma = a / (k[:, v] * k[:, o])
            beta = torch.where(n[:, v] > eps,
                               -a * s01 / (k[:, v] ** 3 * k[:, o]), 0.0)
            df.append(alpha[..., None] * g + beta[..., None] * f[:, v]
                      + gamma[..., None] * f[:, o])
        per_point = torch.stack(df, 1) / count.clamp(min=1)[..., None]
        # every point adds to its row, the others to a spare row past the
        # maps' rows (no masked indexing: nothing waits for the device)
        take = fov_mask & on_map
        contrib = torch.where(take[..., None], per_point[:, :, :, None],
                              0.0)
        acc = torch.zeros(B * V * h * w + 1, C, dtype=torch.float32,
                          device=g.device)
        acc.index_add_(0, torch.where(take, flat, B * V * h * w).reshape(-1),
                       contrib.reshape(-1, C))
        grads.append(acc[:-1].view(B, V, h, w, C).to(x2d.dtype)
                     .permute(0, 1, 4, 2, 3))
    return grads


def _grad_like(x2d: torch.Tensor) -> torch.Tensor:
    """An uninitialised gradient for map x2d: its shape and dtype, a dense
    (B, V, h, w, C) buffer viewed as (B, V, C, h, w), whose rows the
    backward kernel writes whole."""
    B, V, C, h, w = x2d.shape
    return x2d.new_empty((B, V, h, w, C)).permute(0, 1, 4, 2, 3)


def flosp_stereo_lift_backward(
    maps: Sequence[torch.Tensor],
    projected_pix: torch.Tensor,
    fov_mask: torch.Tensor,
    project_res: Sequence[int],
    grad_out: torch.Tensor,
    eps: float = 1e-8,
) -> list:
    """Each map's gradient given the lift's output gradient `grad_out`
    (B, N, C) float32: the lift's registered gradient, callable alone.
    Returns one tensor per map with its shape and dtype, channels-last
    whatever the map's layout.  On CUDA one call of the deterministic
    kernel (two calls give equal bits)."""
    return torch.ops.occdepth.flosp_stereo_lift_backward(
        list(maps), projected_pix, fov_mask, [int(s) for s in project_res],
        float(eps), grad_out)


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
    """Every map's gradient, through the backward operator."""
    pix, fov, *maps = ctx.saved_tensors
    grads = torch.ops.occdepth.flosp_stereo_lift_backward(
        maps, pix, fov, ctx.project_res, ctx.eps, grad_out)
    return list(grads), None, None, None, None


_lift_op.register_autograd(_lift_backward, setup_context=_lift_setup)

_LIFT_BWD_SCHEMA = ("(Tensor[] maps, Tensor projected_pix, Tensor fov_mask, "
                    "int[] project_res, float eps, Tensor grad_out) "
                    "-> Tensor[]")


@torch.library.custom_op("occdepth::flosp_stereo_lift_backward",
                         mutates_args=(), device_types="cuda",
                         schema=_LIFT_BWD_SCHEMA)
def _lift_bwd_op(maps, projected_pix, fov_mask, project_res, eps, grad_out):
    """The backward operator's CUDA implementation: one kernel call."""
    return _launch_lift_backward(maps, projected_pix, fov_mask, project_res,
                                 eps, grad_out)


@_lift_bwd_op.register_kernel("cpu")
def _lift_bwd_cpu(maps, projected_pix, fov_mask, project_res, eps, grad_out):
    return flosp_stereo_lift_backward_reference(
        maps, projected_pix, fov_mask, project_res, eps, grad_out)


@_lift_bwd_op.register_fake
def _lift_bwd_fake(maps, projected_pix, fov_mask, project_res, eps,
                   grad_out):
    return [_grad_like(m) for m in maps]


def channels_last_map(x2d: torch.Tensor) -> torch.Tensor:
    """x2d (B, V, C, h, w) with unit channel stride: x2d itself when it
    has one, else a channels-last copy (on CUDA by K3's packing kernel,
    rows padded to a multiple of 8 channels) viewed as (B, V, C, h, w)."""
    if x2d.stride(2) == 1 or x2d.shape[2] == 1:
        return x2d
    B, V, C, h, w = x2d.shape
    packed = to_padded_channels_last(x2d.reshape(B * V, C, h, w))
    return packed.view(B, V, h, w, -1)[..., :C].permute(0, 1, 4, 2, 3)


def _checked_inputs(name, maps, projected_pix, fov_mask, project_res):
    """The kernels' inputs checked on CUDA: (channels-last maps, contiguous
    pix and fov, per-scale geometry for the C entry points)."""
    dev = maps[0].device
    B, V, C = maps[0].shape[:3]
    N, P = projected_pix.shape[2], projected_pix.shape[3]
    if V != 2 or not 1 <= len(maps) <= MAX_SCALES:
        raise ValueError(f"{name}: {V} views, {len(maps)} scales "
                         f"(2 views, 1-{MAX_SCALES} scales supported)")
    for what, t in [(f"map {i}", m) for i, m in enumerate(maps)] + [
            ("projected_pix", projected_pix), ("fov_mask", fov_mask)]:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name}: {what} on {t.device}")
    for i, m in enumerate(maps):
        if m.dtype not in _DTYPE_CODE or m.dtype != maps[0].dtype:
            raise TypeError(f"{name}: map {i} is {m.dtype}")
        if m.dim() != 5 or m.shape[:3] != (B, V, C):
            raise ValueError(f"{name}: map {i} shape {tuple(m.shape)}")
    if projected_pix.dtype != torch.int32 or fov_mask.dtype != torch.bool:
        raise TypeError(f"{name}: projected_pix {projected_pix.dtype}, "
                        f"fov_mask {fov_mask.dtype} (int32 and bool "
                        "expected)")
    if (projected_pix.shape != (B, V, N, P, 2)
            or fov_mask.shape != (B, V, N, P)):
        raise ValueError(f"{name}: projected_pix "
                         f"{tuple(projected_pix.shape)}, fov_mask "
                         f"{tuple(fov_mask.shape)}")
    maps = [channels_last_map(m) for m in maps]
    geom = []
    for m, scale in zip(maps, project_res):
        geom += [m.stride(0), m.stride(1), m.stride(3), m.stride(4),
                 m.shape[3], m.shape[4], int(scale)]
    return (maps, projected_pix.contiguous(), fov_mask.contiguous(),
            (ctypes.c_longlong * len(geom))(*geom))


def _pointers(tensors):
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def _launch_lift(maps, projected_pix, fov_mask, project_res, eps):
    """The kernel launch behind `flosp_stereo_lift` (CUDA tensors)."""
    packed, pix, fov, geom = _checked_inputs(
        "flosp_stereo_lift", maps, projected_pix, fov_mask, project_res)
    dev = maps[0].device
    B, _, C = maps[0].shape[:3]
    N, P = pix.shape[2], pix.shape[3]
    out = torch.empty((B, N, C), dtype=torch.float32, device=dev)
    rc = cuda_lib.library().occ_flosp_stereo_lift(
        _pointers(packed), geom, len(maps), pix.data_ptr(), fov.data_ptr(),
        out.data_ptr(), _DTYPE_CODE[maps[0].dtype], B, N, P, C, eps,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    cuda_lib.check(rc, "flosp_stereo_lift")
    flosp_stereo_lift.launches += 1
    return out


def _launch_lift_backward(maps, projected_pix, fov_mask, project_res, eps,
                          grad_out):
    """The kernel call behind `flosp_stereo_lift_backward` (CUDA tensors):
    the gradient of each map the operator received (not of its packed
    copy), written channels-last: whole rows, 16 bytes a lane where they
    allow it."""
    name = "flosp_stereo_lift_backward"
    packed, pix, fov, geom = _checked_inputs(
        name, maps, projected_pix, fov_mask, project_res)
    dev = maps[0].device
    B, _, C = maps[0].shape[:3]
    N, P = pix.shape[2], pix.shape[3]
    if (grad_out.device != dev or grad_out.dtype != torch.float32
            or tuple(grad_out.shape) != (B, N, C)):
        raise ValueError(f"{name}: grad_out {tuple(grad_out.shape)} "
                         f"{grad_out.dtype} on {grad_out.device} ((B, N, C) "
                         f"float32 on {dev} expected)")
    gout = grad_out.contiguous()
    grads = [_grad_like(m) for m in maps]
    rows = sum(B * 2 * m.shape[3] * m.shape[4] for m in maps)
    lib = cuda_lib.library()
    work = torch.empty(lib.occ_flosp_stereo_lift_backward_workspace(
        B * 2 * len(maps) * N * P, rows, C), dtype=torch.uint8, device=dev)
    rc = lib.occ_flosp_stereo_lift_backward(
        _pointers(packed), geom, _pointers(grads), len(maps), pix.data_ptr(),
        fov.data_ptr(), gout.data_ptr(), work.data_ptr(),
        _DTYPE_CODE[maps[0].dtype], B, N, P, C, eps,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    cuda_lib.check(rc, name)
    flosp_stereo_lift_backward.launches += 1
    return grads


flosp_stereo_lift.launches = 0
flosp_stereo_lift_backward.launches = 0
