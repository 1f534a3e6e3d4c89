"""Port kernels K1/K2/K4: plain versions vs the JAX Pallas kernels
(interpret mode on the CPU), their autograd, and the CUDA kernels vs the
plain versions (`cuda` marker, skipped without a card).

JAX is imported inside the tests that compare with it, so the `cuda` cases
also run on a GPU host without JAX:
    python -m pytest tests/test_torch_port_kernels.py -m cuda --noconftest
"""
import numpy as np
import pytest
import torch

from occdepth_tpu_torch.ops.crp_matmul import (
    crp_relation_matmul,
    crp_relation_matmul_reference,
)
from occdepth_tpu_torch.ops.dw_conv import (
    dw_conv2d_fastgrad,
    dw_filter_grad,
    dw_filter_grad_reference,
    use_fast_dw_grad,
)
from occdepth_tpu_torch.ops.stereo_fuse import (
    stereo_cosine_fuse,
    stereo_cosine_fuse_reference,
)


def _fuse_inputs(rng, N, C):
    f0 = rng.randn(N, C).astype(np.float32)
    f1 = rng.randn(N, C).astype(np.float32)
    m0 = (rng.rand(N) > 0.3).astype(np.float32)
    m1 = (rng.rand(N) > 0.3).astype(np.float32)
    return f0 * m0[:, None], f1 * m1[:, None], m0, m1


def test_stereo_fuse_plain_matches_pallas_interpret():
    jnp = pytest.importorskip("jax.numpy")
    from occdepth_tpu.ops.pallas_kernels import stereo_cosine_fuse as jax_fuse

    rng = np.random.RandomState(4)
    f0, f1, m0, m1 = _fuse_inputs(rng, 4096, 32)
    ref = jax_fuse(
        jnp.asarray(f0), jnp.asarray(f1), jnp.asarray(m0), jnp.asarray(m1),
        block_n=1024, interpret=True,
    )
    out = stereo_cosine_fuse(*(torch.from_numpy(a) for a in (f0, f1, m0, m1)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_crp_matmul_plain_matches_pallas_interpret():
    jnp = pytest.importorskip("jax.numpy")
    from occdepth_tpu.ops.pallas_kernels import crp_relation_matmul as jax_crp

    rng = np.random.RandomState(5)
    N, M, C = 1024, 256, 64
    p = rng.randn(N, M).astype(np.float32)
    mega = rng.randn(M, C).astype(np.float32)
    ref = jax_crp(jnp.asarray(p), jnp.asarray(mega), block_n=256,
                  interpret=True)
    out = crp_relation_matmul(torch.from_numpy(p), torch.from_numpy(mega))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


def test_wrappers_take_plain_path_on_cpu():
    """On CPU tensors the wrappers run the plain versions and launch
    nothing (batched, strided inputs as the model passes them)."""
    rng = np.random.RandomState(6)
    feats = torch.from_numpy(rng.randn(2, 2, 50, 8).astype(np.float32))
    valid = torch.from_numpy((rng.rand(2, 2, 50) > 0.5).astype(np.float32))
    logits = torch.from_numpy(rng.randn(2, 16, 40).astype(np.float32))
    mega = torch.from_numpy(rng.randn(2, 8, 16).astype(np.float32))
    before = (stereo_cosine_fuse.launches, crp_relation_matmul.launches)
    fused = stereo_cosine_fuse(feats[:, 0], feats[:, 1], valid[:, 0],
                               valid[:, 1])
    rel = crp_relation_matmul(logits.transpose(1, 2), mega.transpose(1, 2))
    assert (stereo_cosine_fuse.launches, crp_relation_matmul.launches) == before
    assert fused.shape == (2, 50, 8) and rel.shape == (2, 40, 8)
    torch.testing.assert_close(
        rel, torch.sigmoid(logits.transpose(1, 2)) @ mega.transpose(1, 2))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the GPU host)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("C", [32, 40])
def test_stereo_fuse_kernel_matches_plain(cuda_device, C):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    valid = (torch.rand(2, 2, 3001, device=cuda_device, generator=g) > 0.3
             ).float()
    feats = torch.randn(2, 2, 3001, C, device=cuda_device,
                        generator=g) * valid[..., None]
    args = (feats[:, 0], feats[:, 1], valid[:, 0], valid[:, 1])
    before = stereo_cosine_fuse.launches
    out = stereo_cosine_fuse(*args)
    torch.cuda.synchronize()
    assert stereo_cosine_fuse.launches == before + 1
    torch.testing.assert_close(out, stereo_cosine_fuse_reference(*args),
                               atol=1e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 4096, 512, 256), (1, 100, 37, 70)])
def test_crp_matmul_kernel_matches_plain(cuda_device, dtype, shape):
    B, N, M, C = shape
    g = torch.Generator(device=cuda_device).manual_seed(1)
    logits = torch.randn(B, M, N, device=cuda_device, generator=g).to(dtype)
    mega = torch.randn(B, C, M, device=cuda_device, generator=g).to(dtype)
    args = (logits.transpose(1, 2), mega.transpose(1, 2))
    out = crp_relation_matmul(*args)
    ref = crp_relation_matmul_reference(*args)
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() <= 2e-5 * ref.abs().max().item()


@pytest.mark.cuda
def test_kernels_raise_on_unsupported_input(cuda_device):
    f = torch.randn(4, 8, device=cuda_device, dtype=torch.float64)
    m = torch.ones(4, device=cuda_device, dtype=torch.float64)
    with pytest.raises(TypeError):
        stereo_cosine_fuse(f, f, m, m)
    p = torch.randn(4, 8, device=cuda_device)
    with pytest.raises(TypeError):
        crp_relation_matmul(p, torch.randn(8, 3, device=cuda_device,
                                           dtype=torch.bfloat16))


def _dw_inputs(rng, shape):
    x = rng.randn(*shape).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    return x, g


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("shape", [(2, 24, 16, 20), (1, 40, 13, 19)],
                         ids=["even", "odd"])
def test_dw_filter_grad_plain_matches_pallas_interpret(k, shape):
    """K4's plain version (NCHW, (C, 1, k, k)) vs the JAX package's Pallas
    kernel in interpret mode and its fp32 reference (NHWC, (k, k, 1, C))."""
    jnp = pytest.importorskip("jax.numpy")
    from occdepth_tpu.ops.dw_conv import (
        dw_filter_grad_pallas,
        dw_filter_grad_reference as jax_reference,
    )

    rng = np.random.RandomState(9 + k)
    x, g = _dw_inputs(rng, shape)
    ours = dw_filter_grad(torch.from_numpy(x), torch.from_numpy(g), k, k)
    assert ours.shape == (shape[1], 1, k, k) and ours.dtype == torch.float32
    xh, gh = (jnp.asarray(a.transpose(0, 2, 3, 1)) for a in (x, g))
    for ref in (dw_filter_grad_pallas(xh, gh, k, k, interpret=True),
                jax_reference(xh, gh, k, k)):
        ref = np.asarray(ref).transpose(3, 2, 0, 1)  # (k,k,1,C) -> (C,1,k,k)
        np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("k", [3, 5])
def test_dw_conv2d_fastgrad_matches_stock_autograd(k):
    rng = np.random.RandomState(k)
    x0 = torch.from_numpy(rng.randn(2, 12, 11, 14).astype(np.float32))
    w0 = torch.from_numpy(rng.randn(12, 1, k, k).astype(np.float32))
    cot = torch.from_numpy(rng.randn(2, 12, 11, 14).astype(np.float32))
    grads = []
    for fn in (dw_conv2d_fastgrad,
               lambda x, w: torch.nn.functional.conv2d(
                   x, w, None, 1, k // 2, 1, x.shape[1])):
        x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
        out = fn(x, w)
        out.backward(cot)
        grads.append((out.detach(), x.grad, w.grad))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_dw_conv2d_fastgrad_bf16_returns_weight_dtype():
    """dw comes back in the weight's compute dtype (bf16), rounded once
    from the fp32 sums, as the JAX package's VJP returns it."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(1, 8, 9, 10).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.randn(8, 1, 3, 3).astype(np.float32)).bfloat16()
    w.requires_grad_()
    cot = torch.from_numpy(rng.randn(1, 8, 9, 10).astype(np.float32)).bfloat16()
    dw_conv2d_fastgrad(x, w).backward(cot)
    assert w.grad.dtype == torch.bfloat16
    ref = dw_filter_grad_reference(x.float(), cot.float(), 3, 3)
    assert torch.equal(w.grad, ref.bfloat16())


@pytest.mark.parametrize("mode,k,stride,expected", [
    ("pallas", 3, 1, True), ("pallas", 5, 1, True), ("pallas", 3, 2, False),
    ("pallas", 4, 1, False), ("xla", 3, 1, False), ("auto", 5, 1, False),
])
def test_use_fast_dw_grad_gate(mode, k, stride, expected):
    from occdepth_tpu.ops.dw_conv import use_fast_dw_grad as jax_gate

    assert use_fast_dw_grad(mode, k, stride) is expected
    assert jax_gate(mode, k, stride) is expected
    with pytest.raises(ValueError):
        use_fast_dw_grad("fused", k, stride)


def test_encoder_routes_stride1_dw_convs_through_k4():
    """22 of the b3 encoder's 26 depthwise convs are stride-1 (4 blocks
    open a stage with stride 2): exactly those take K4 under 'pallas'."""
    from occdepth_tpu_torch.models.efficientnet import DWConv2d, EfficientNet

    for mode, n in (("pallas", 22), ("xla", 0)):
        enc = EfficientNet("tf_efficientnet_b3_ns", dw_grad=mode)
        dws = [m for m in enc.modules() if isinstance(m, DWConv2d)]
        assert len(dws) == 26
        assert sum(m.fast_grad for m in dws) == n
        assert all(m.stride[0] == 1 for m in dws if m.fast_grad)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,k", [((1, 40, 185, 610), 3),
                                     ((2, 288, 47, 153), 5),
                                     ((1, 2304, 12, 39), 3),
                                     ((1, 7, 5, 3), 5)])
def test_dw_filter_grad_kernel_matches_plain(cuda_device, dtype, shape, k):
    g = torch.Generator(device=cuda_device).manual_seed(2)
    x = torch.randn(*shape, device=cuda_device, generator=g).to(dtype)
    gy = torch.randn(*shape, device=cuda_device, generator=g).to(dtype)
    before = dw_filter_grad.launches
    out = dw_filter_grad(x, gy, k, k)
    again = dw_filter_grad(x, gy, k, k)
    torch.cuda.synchronize()
    assert dw_filter_grad.launches == before + 2
    assert torch.equal(out, again)  # fixed-order reduction: deterministic
    ref = dw_filter_grad_reference(x.float(), gy.float(), k, k)
    assert (out - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()
    # strided (channels-last) inputs through their strides
    xc = x.contiguous(memory_format=torch.channels_last)
    gc = gy.contiguous(memory_format=torch.channels_last)
    assert (dw_filter_grad(xc, gc, k, k) - ref).abs().max().item() <= \
        1e-4 * ref.abs().max().item()


@pytest.mark.cuda
def test_kernel_autograd_functions_have_grad_fn(cuda_device):
    f = torch.randn(2, 50, 8, device=cuda_device, requires_grad=True)
    m = torch.ones(2, 50, device=cuda_device)
    assert stereo_cosine_fuse(f, f * 2, m, m).grad_fn is not None
    p = torch.randn(40, 16, device=cuda_device, requires_grad=True)
    mega = torch.randn(16, 8, device=cuda_device)
    assert crp_relation_matmul(p, mega).grad_fn is not None
    x = torch.randn(1, 4, 6, 6, device=cuda_device, requires_grad=True)
    w = torch.randn(4, 1, 3, 3, device=cuda_device, requires_grad=True)
    before = dw_filter_grad.launches
    dw_conv2d_fastgrad(x, w).sum().backward()
    assert dw_filter_grad.launches == before + 1
    ref = dw_filter_grad_reference(x.detach(), torch.ones_like(x), 3, 3)
    torch.testing.assert_close(w.grad, ref, rtol=1e-5, atol=1e-5)
