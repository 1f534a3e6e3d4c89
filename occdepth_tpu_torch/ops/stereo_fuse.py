"""K1: Stereo-SFA cosine fusion of two views (kernel `csrc/stereo_fuse.cu`).

Counterpart of `occdepth_tpu/ops/pallas_kernels.py::stereo_cosine_fuse`.
The model's lift runs this fusion inside the fused lift
(`ops/flosp_gather.py::flosp_stereo_lift`, which shares the kernel's
per-row code); this wrapper is the fusion alone.  For CPU tensors the
wrapper runs the plain PyTorch version; for CUDA tensors it launches the
kernel or raises.  On CUDA with gradients enabled the kernel is the
forward of an autograd Function whose backward is a kernel too,
`occ_stereo_cosine_fuse_backward` (`stereo_cosine_fuse_backward`): the
closed form of the features' and masks' gradients per row, the same
device function as the fused lift's backward.  Its plain version
`stereo_cosine_fuse_backward_reference` is that closed form in PyTorch
(the JAX package has no backward kernel: it differentiates the jnp
formula, and the CPU tests hold the closed form to that VJP).
"""
from __future__ import annotations

import torch

from occdepth_tpu_torch.ops import cuda_lib


def stereo_cosine_fuse_reference(
    f0: torch.Tensor, f1: torch.Tensor, m0: torch.Tensor, m1: torch.Tensor,
    eps: float = 1e-8,
) -> torch.Tensor:
    """Plain version: (..., C) features x2 + (...) masks -> (..., C) fp32."""
    n0 = torch.clamp(torch.linalg.vector_norm(f0, dim=-1), min=eps)
    n1 = torch.clamp(torch.linalg.vector_norm(f1, dim=-1), min=eps)
    cos = (f0 * f1).sum(-1) / (n0 * n1) * (m0 * m1)
    w0 = cos + (m0 - m1 > 0).to(cos.dtype)
    w1 = cos + (m1 - m0 > 0).to(cos.dtype)
    return (w0[..., None] * f0 + w1[..., None] * f1) * 0.5


def stereo_cosine_fuse_backward_reference(
    f0: torch.Tensor, f1: torch.Tensor, m0: torch.Tensor, m1: torch.Tensor,
    grad_out: torch.Tensor, eps: float = 1e-8,
) -> tuple:
    """Plain version of K1's backward: (df0, df1, dm0, dm1) in float32.

    With g = grad_out, k_v = max(|f_v|, eps), c = (f0.f1) / (k0 k1), cos =
    c m0 m1, w_v = cos + [m_v > m_other] (the forward is (w0 f0 + w1 f1) /
    2) and a = (g.f0 + g.f1) / 2:

        df_v = w_v g / 2 + a m0 m1 (f_o / (k_v k_o)
                                   - [|f_v| > eps] (f0.f1) f_v / (k_v^3 k_o)),
        dm0 = a c m1,   dm1 = a c m0

    (the steps [m_v > m_other] have no gradient; [|f_v| > eps] is the
    subgradient of the clamp and of the norm at zero, as torch's
    autograd takes it).
    """
    g = grad_out.float()
    n0 = torch.linalg.vector_norm(f0, dim=-1)
    n1 = torch.linalg.vector_norm(f1, dim=-1)
    k0, k1 = n0.clamp(min=eps), n1.clamp(min=eps)
    s01 = (f0 * f1).sum(-1)
    c = s01 / (k0 * k1)
    cos = c * (m0 * m1)
    a = 0.5 * ((g * f0).sum(-1) + (g * f1).sum(-1))
    am = a * (m0 * m1)
    alpha0 = 0.5 * (cos + (m0 - m1 > 0).float())
    alpha1 = 0.5 * (cos + (m1 - m0 > 0).float())
    gamma = am / (k0 * k1)
    beta0 = torch.where(n0 > eps, -am * s01 / (k0 ** 3 * k1), 0.0)
    beta1 = torch.where(n1 > eps, -am * s01 / (k1 ** 3 * k0), 0.0)
    df0 = alpha0[..., None] * g + beta0[..., None] * f0 + gamma[..., None] * f1
    df1 = alpha1[..., None] * g + beta1[..., None] * f1 + gamma[..., None] * f0
    return df0, df1, a * c * m1, a * c * m0


def stereo_cosine_fuse(
    f0: torch.Tensor, f1: torch.Tensor, m0: torch.Tensor, m1: torch.Tensor,
    eps: float = 1e-8,
) -> torch.Tensor:
    """Fuse two views' per-voxel features.

    Args:
        f0, f1: (B, N, C) or (N, C) float32.  The two may be strided views
            of one (B, V, N, C) tensor: only the channel stride must be 1,
            and both must share strides.
        m0, m1: (B, N) or (N,) float32 masks in {0, 1}, sharing strides.

    Returns (B, N, C) or (N, C) float32, contiguous.
    """
    if f0.device.type == "cpu":
        return stereo_cosine_fuse_reference(f0, f1, m0, m1, eps)
    args = (f0, f1, m0, m1)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _StereoFuseFn.apply(*args, eps)
    return _launch(*args, eps)


class _StereoFuseFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, f0, f1, m0, m1, eps):
        ctx.save_for_backward(f0, f1, m0, m1)
        ctx.eps = eps
        return _launch(f0, f1, m0, m1, eps)

    @staticmethod
    def backward(ctx, grad_out):
        need = ctx.needs_input_grad[:4]
        grads = stereo_cosine_fuse_backward(
            *ctx.saved_tensors, grad_out, ctx.eps, masks=need[2] or need[3])
        return tuple(g if n else None for g, n in zip(grads, need)) + (None,)


def stereo_cosine_fuse_backward(
    f0: torch.Tensor, f1: torch.Tensor, m0: torch.Tensor, m1: torch.Tensor,
    grad_out: torch.Tensor, eps: float = 1e-8, masks: bool = True,
) -> tuple:
    """K1's backward: (df0, df1, dm0, dm1) given the output's gradient, in
    the shapes of the inputs (dm0 and dm1 None when `masks` is false).
    For CPU tensors the plain closed form; for CUDA tensors one launch of
    the kernel `occ_stereo_cosine_fuse_backward`, or an exception."""
    if f0.device.type == "cpu":
        grads = stereo_cosine_fuse_backward_reference(f0, f1, m0, m1,
                                                      grad_out, eps)
        return grads if masks else grads[:2] + (None, None)
    return _launch_backward(f0, f1, m0, m1, grad_out, eps, masks)


def _checked(f0, f1, m0, m1):
    """The kernels' inputs as (B, N, C) / (B, N), checked; and whether
    they were 2-D."""
    squeeze = f0.dim() == 2
    if squeeze:
        f0, f1, m0, m1 = (t.unsqueeze(0) for t in (f0, f1, m0, m1))
    B, N, C = f0.shape
    for name, t in (("f0", f0), ("f1", f1), ("m0", m0), ("m1", m1)):
        if t.device != f0.device or t.device.type != "cuda":
            raise ValueError(f"stereo_cosine_fuse: {name} on {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"stereo_cosine_fuse: {name} is {t.dtype}, "
                            "expected float32")
    if f1.shape != (B, N, C) or m0.shape != (B, N) or m1.shape != (B, N):
        raise ValueError(
            "stereo_cosine_fuse: shapes "
            f"{tuple(f0.shape)} {tuple(f1.shape)} {tuple(m0.shape)} "
            f"{tuple(m1.shape)}"
        )
    if f0.stride() != f1.stride() or (C > 1 and f0.stride(2) != 1):
        raise ValueError(
            f"stereo_cosine_fuse: feature strides {f0.stride()} "
            f"{f1.stride()} (channels must be unit-stride, views alike)"
        )
    if m0.stride() != m1.stride():
        raise ValueError(
            f"stereo_cosine_fuse: mask strides {m0.stride()} {m1.stride()}"
        )
    return (f0, f1, m0, m1), squeeze


def _launch(f0, f1, m0, m1, eps):
    """The kernel launch behind `stereo_cosine_fuse` (CUDA tensors)."""
    (f0, f1, m0, m1), squeeze = _checked(f0, f1, m0, m1)
    B, N, C = f0.shape
    out = torch.empty((B, N, C), dtype=torch.float32, device=f0.device)
    rc = cuda_lib.library().occ_stereo_cosine_fuse(
        f0.data_ptr(), f1.data_ptr(), m0.data_ptr(), m1.data_ptr(),
        out.data_ptr(), B, N, C, f0.stride(0), f0.stride(1), m0.stride(0),
        m0.stride(1), eps, torch.cuda.current_stream(f0.device).cuda_stream,
    )
    cuda_lib.check(rc, "stereo_cosine_fuse")
    stereo_cosine_fuse.launches += 1
    return out[0] if squeeze else out


def _launch_backward(f0, f1, m0, m1, grad_out, eps, masks):
    """The kernel launch behind `stereo_cosine_fuse_backward` (CUDA
    tensors): df0 and df1 contiguous, dm0 and dm1 when `masks`."""
    shapes = (f0.shape, m0.shape)
    (f0, f1, m0, m1), _ = _checked(f0, f1, m0, m1)
    B, N, C = f0.shape
    g = grad_out.reshape(B, N, C)
    if g.device != f0.device or g.dtype != torch.float32:
        raise ValueError(f"stereo_cosine_fuse_backward: grad_out {g.dtype} "
                         f"on {g.device}")
    g = g.contiguous()
    df0, df1 = (torch.empty((B, N, C), dtype=torch.float32, device=f0.device)
                for _ in range(2))
    dm = [torch.empty((B, N), dtype=torch.float32, device=f0.device)
          if masks else None for _ in range(2)]
    rc = cuda_lib.library().occ_stereo_cosine_fuse_backward(
        f0.data_ptr(), f1.data_ptr(), m0.data_ptr(), m1.data_ptr(),
        g.data_ptr(), df0.data_ptr(), df1.data_ptr(),
        *(d.data_ptr() if d is not None else None for d in dm), B, N, C,
        f0.stride(0), f0.stride(1), m0.stride(0), m0.stride(1), eps,
        torch.cuda.current_stream(f0.device).cuda_stream,
    )
    cuda_lib.check(rc, "stereo_cosine_fuse_backward")
    stereo_cosine_fuse_backward.launches += 1
    return (df0.view(shapes[0]), df1.view(shapes[0]),
            *(d.view(shapes[1]) if d is not None else None for d in dm))


stereo_cosine_fuse.launches = 0
stereo_cosine_fuse_backward.launches = 0
