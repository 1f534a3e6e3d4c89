"""K1: Stereo-SFA cosine fusion of two views (kernel `csrc/stereo_fuse.cu`).

Counterpart of `occdepth_tpu/ops/pallas_kernels.py::stereo_cosine_fuse`.
The model's lift runs this fusion inside the fused lift
(`ops/flosp_gather.py::flosp_stereo_lift`, which shares the kernel's
per-row code); this wrapper is the fusion alone.  For CPU tensors the
wrapper runs the plain PyTorch version; for CUDA tensors it launches the
kernel or raises.  On CUDA with gradients enabled
the kernel is the forward of an autograd Function whose backward is the
gradient of the plain version, recomputed from the saved inputs: the JAX
package has no backward kernel either (it differentiates the jnp formula).
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
        inputs = [t.detach().requires_grad_(need) for t, need in
                  zip(ctx.saved_tensors, ctx.needs_input_grad[:4])]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            out = stereo_cosine_fuse_reference(*inputs, ctx.eps)
        grads = iter(torch.autograd.grad(out, wanted, grad_out))
        return tuple(next(grads) if t.requires_grad else None
                     for t in inputs) + (None,)


def _launch(f0, f1, m0, m1, eps):
    """The kernel launch behind `stereo_cosine_fuse` (CUDA tensors)."""
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
    out = torch.empty((B, N, C), dtype=torch.float32, device=f0.device)
    rc = cuda_lib.library().occ_stereo_cosine_fuse(
        f0.data_ptr(), f1.data_ptr(), m0.data_ptr(), m1.data_ptr(),
        out.data_ptr(), B, N, C, f0.stride(0), f0.stride(1), m0.stride(0),
        m0.stride(1), eps, torch.cuda.current_stream(f0.device).cuda_stream,
    )
    cuda_lib.check(rc, "stereo_cosine_fuse")
    stereo_cosine_fuse.launches += 1
    return out[0] if squeeze else out


stereo_cosine_fuse.launches = 0
