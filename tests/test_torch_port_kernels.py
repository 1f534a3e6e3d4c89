"""Port kernels K1/K2/K3/K4/K5/K6: plain versions vs the JAX Pallas kernels
(interpret mode on the CPU), their autograd, and the CUDA kernels vs the
plain versions (`cuda` marker, skipped without a card), the fused stereo
lift (K1 with the gather and the scale sum) and K2 batched over relations
among them.

JAX is imported inside the tests that compare with it, so the `cuda` cases
also run on a GPU host without JAX:
    python -m pytest tests/test_torch_port_kernels.py -m cuda --noconftest
"""
import numpy as np
import pytest
import torch

from occdepth_tpu_torch.ops.conv2d_shift import (
    conv3x3,
    conv3x3_packed_reference,
    conv3x3_reference,
    pack_conv3x3_weight,
    padded_channels,
    resolve_conv_impl,
    to_padded_channels_last,
)
from occdepth_tpu_torch.ops.crp_matmul import (
    crp_relation_matmul,
    crp_relation_matmul_reference,
)
from occdepth_tpu_torch.ops.crp_matmul import (
    pad_for_tma,
    tma_reads,
    wgmma_path,
)
from occdepth_tpu_torch.ops.dw_conv import (
    MAX_CLUSTER,
    BLOCKS_PER_SM,
    MAX_WARPS,
    SMEM_BYTES,
    dw_conv2d_fastgrad,
    dw_filter_grad,
    dw_filter_grad_reference,
    dw_plan,
    plan_bands,
    staged_span,
    use_fast_dw_grad,
)
from occdepth_tpu_torch.ops.flosp_gather import (
    flosp_stereo_lift,
    flosp_stereo_lift_backward,
    flosp_stereo_lift_backward_reference,
    flosp_stereo_lift_reference,
)
from occdepth_tpu_torch.ops.matmul_probe import (
    matmul_probe,
    matmul_probe_reference,
)
from occdepth_tpu_torch.ops.row_gather import row_gather, row_gather_reference
from occdepth_tpu_torch.ops.stereo_fuse import (
    stereo_cosine_fuse,
    stereo_cosine_fuse_reference,
)
from occdepth_tpu_torch.testing import lift_inputs


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


@pytest.mark.parametrize("B,M,C", [(1, 1350, 256), (2, 37, 70), (1, 512, 8)],
                         ids=["tartanair", "ragged", "aligned"])
def test_pad_mega_gives_tma_strides_and_zero_rows(B, M, C):
    """K2's mega in the CRP's layout (a transposed view of the (B, C, M)
    conv output) as the wgmma kernel's TMA reads it: the same values,
    strides (C * Mp, 1, Mp) with Mp = M rounded up to 8, the rows past M
    zero.  At TartanAir's M = 1,350 the view itself has a 2,700-byte
    stride, which TMA cannot read; the logits' layout still takes wgmma,
    in bf16 and (3xTF32) in fp32."""
    g = torch.Generator().manual_seed(3)
    mega = torch.randn(B, C, M, generator=g).bfloat16().transpose(1, 2)
    assert tma_reads(mega, 1) == (M % 8 == 0)
    out = pad_for_tma(mega, 1)
    Mp = -(-M // 8) * 8
    assert out.shape == (B, M, C) and out.dtype == torch.bfloat16
    assert out.stride() == (C * Mp, 1, Mp) and tma_reads(out, 1)
    assert torch.equal(out, mega)
    buf = out.as_strided((B, C, Mp), (C * Mp, Mp, 1))
    assert not buf[:, :, M:].any()
    logits = torch.empty(B, 4, M, 10800, dtype=torch.bfloat16)
    assert wgmma_path(logits.transpose(2, 3), mega)
    assert wgmma_path(logits.float().transpose(2, 3), mega.float())
    assert not wgmma_path(logits.float().transpose(2, 3), mega)


@pytest.mark.parametrize("B,N,M", [(1, 2025, 196), (2, 100, 37),
                                   (1, 4096, 512)],
                         ids=["nyu", "ragged", "aligned"])
def test_pad_logits_gives_tma_strides(B, N, M):
    """K2's logits in the CRP's layout (a transposed view of the (B, R, M,
    N) conv outputs) as the wgmma kernel's TMA reads them: the same
    values, strides (R * M * Np, M * Np, 1, Np) with Np = N rounded up to
    8, the columns past N zero.  At NYU's N = 2,025 voxels the view itself
    has a 4,050-byte stride, which TMA cannot read; it takes wgmma all the
    same."""
    R = 4
    g = torch.Generator().manual_seed(4)
    logits = torch.randn(B, R, M, N, generator=g).bfloat16().transpose(2, 3)
    assert tma_reads(logits, 2) == (N % 8 == 0)
    assert wgmma_path(logits, torch.empty(B, M, 8, dtype=torch.bfloat16))
    out = pad_for_tma(logits, 2)
    Np = -(-N // 8) * 8
    assert out.shape == (B, R, N, M) and out.dtype == torch.bfloat16
    assert out.stride() == (R * M * Np, M * Np, 1, Np)
    assert tma_reads(out, 2) and torch.equal(out, logits)
    buf = out.as_strided((B, R, M, Np), (R * M * Np, M * Np, Np, 1))
    assert not buf[..., N:].any()


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


# (B, C, H, W), k: the flagship encoder's ten distinct K4 convs (batch 1),
# batch 2, and ragged planes (H < k, W < k, W = 1, a 7x5x3 k5 plane)
FLAGSHIP_DW = [((1, 40, 185, 610), 3), ((1, 24, 185, 610), 3),
               ((1, 192, 93, 305), 3), ((1, 288, 47, 153), 5),
               ((1, 576, 24, 77), 3), ((1, 576, 24, 77), 5),
               ((1, 816, 24, 77), 5), ((1, 1392, 12, 39), 5),
               ((1, 1392, 12, 39), 3), ((1, 2304, 12, 39), 3)]
RAGGED_DW = [((2, 288, 47, 153), 5), ((2, 40, 185, 610), 3),
             ((2, 5, 2, 9), 5), ((3, 6, 11, 2), 5), ((2, 3, 7, 1), 3),
             ((1, 7, 5, 3), 5)]


@pytest.mark.parametrize("shape,k", FLAGSHIP_DW + RAGGED_DW)
def test_dw_plan_covers_each_row_once_and_stages_aligned_spans(shape, k):
    """K4's launch plan: every (b, c, row) of g in exactly one band, each
    band's staged x span holds the band's rows and halo rows, bulk copies
    16-byte aligned and inside the tensor (also for a view that starts
    three elements into its storage), the ragged rest copied apart, the slots
    large enough, clusters of 1-8 blocks, and the grid BLOCKS_PER_SM
    blocks per SM deep where the plane has rows enough to split, and no
    deeper through clusters."""
    B, C, H, W = shape
    P = (k - 1) // 2
    for es in (2, 4):
        plan = dw_plan(B, C, H, W, k, es)
        assert plan.cluster in (1, 2, 4, 8) and plan.cluster <= MAX_CLUSTER
        assert 1 <= plan.warps <= MAX_WARPS and plan.smem <= SMEM_BYTES
        assert plan.warps * 64 >= min(W, MAX_WARPS * 64)
        assert (C * plan.cluster >= BLOCKS_PER_SM * 132
                or plan.cluster == MAX_CLUSTER or 2 * plan.cluster > B * H)
        assert plan.cluster == 1 or C * plan.cluster < 2 * BLOCKS_PER_SM * 132
        bands = plan_bands(plan, B, C, H)
        per_block = {}
        for c, rank, i, b, h0, h1 in bands:
            per_block[c, rank] = per_block.get((c, rank), 0) + 1
        assert 1 <= plan.stages <= max(per_block.values())
        seen = np.zeros((B, C, H), np.int64)
        row, plane = W * es, H * W * es
        for offset in (0, 3 * es):  # a view may start inside its storage
            t0 = 4096 + offset
            t1 = t0 + B * C * plane
            for c, rank, i, b, h0, h1 in bands:
                if offset == 0:
                    seen[b, c, h0:h1] += 1
                assert 0 < h1 - h0 <= plan.band_rows
                xa, xb = max(h0 - P, 0), min(h1 + P, H)
                for (ra, rb), slot in (((xa, xb), plan.x_slot),
                                       ((h0, h1), plan.g_slot)):
                    pl = t0 + (b * C + c) * plane
                    s, e = pl + ra * row, pl + rb * row
                    base, lo, hi = staged_span(s, e, t0, t1)
                    assert base <= s and base % 16 == 0
                    assert hi == lo or (lo % 16 == 0 and hi % 16 == 0)
                    assert t0 <= lo <= hi <= t1
                    assert max(hi, e) - base <= slot and slot % 16 == 0
                    # bulk [lo, hi) and the ragged ends cover [s, e) once
                    ragged = max(0, min(lo, e) - s) + max(0, e - max(hi, s))
                    assert ragged + (min(hi, e) - max(lo, s)
                                     if hi > lo else 0) == e - s
                    assert ragged % es == 0 and ragged < 32
        assert (seen == 1).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,k", FLAGSHIP_DW + RAGGED_DW)
def test_dw_filter_grad_kernel_matches_plain(cuda_device, dtype, shape, k):
    g = torch.Generator(device=cuda_device).manual_seed(2)
    x = torch.randn(*shape, device=cuda_device, generator=g).to(dtype)
    gy = torch.randn(*shape, device=cuda_device, generator=g).to(dtype)
    before = dw_filter_grad.launches
    out = dw_filter_grad(x, gy, k, k)
    assert dw_filter_grad.launches == before + 1  # one launch per call
    again = dw_filter_grad(x, gy, k, k)
    torch.cuda.synchronize()
    assert dw_filter_grad.launches == before + 2
    assert torch.equal(out, again)  # fixed-order reduction: deterministic
    ref = dw_filter_grad_reference(x.float(), gy.float(), k, k)
    assert (out - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()
    # channels-last inputs are copied to NCHW first, and counted
    xc = x.contiguous(memory_format=torch.channels_last)
    gc = gy.contiguous(memory_format=torch.channels_last)
    copies = dw_filter_grad.copies
    assert (dw_filter_grad(xc, gc, k, k) - ref).abs().max().item() <= \
        1e-4 * ref.abs().max().item()
    if not xc.is_contiguous():
        assert dw_filter_grad.copies == copies + 2


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


def _conv_inputs(rng, B, Ci, H, W, Co):
    x = rng.randn(B, Ci, H, W).astype(np.float32)
    w = (rng.randn(Co, Ci, 3, 3) / np.sqrt(9 * Ci)).astype(np.float32)
    b = (0.1 * rng.randn(Co)).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("shape", [(2, 9, 13, 11, 6), (1, 8, 20, 35, 16)],
                         ids=["odd", "wide"])
def test_conv3x3_plain_matches_pallas_interpret(shape):
    """K3's plain version (NCHW, OIHW) vs the JAX package's Pallas kernel
    in interpret mode and its shifted-matmul version (NHWC, HWIO), fp32:
    sums of 9*Ci terms in another order, so 1e-5 * max|ref|."""
    jnp = pytest.importorskip("jax.numpy")
    from occdepth_tpu.ops.conv2d_shift import conv3x3_pallas, conv3x3_shift

    B, H, W, Ci, Co = shape
    x, w, b = _conv_inputs(np.random.RandomState(Ci), B, Ci, H, W, Co)
    ours = conv3x3(*(torch.from_numpy(a) for a in (x, w, b)))
    assert ours.shape == (B, Co, H, W) and ours.dtype == torch.float32
    xh = jnp.asarray(x.transpose(0, 2, 3, 1))
    wh = jnp.asarray(w.transpose(2, 3, 1, 0))
    for ref in (conv3x3_pallas(xh, wh, jnp.asarray(b), interpret=True),
                conv3x3_shift(xh, wh, jnp.asarray(b))):
        ref = np.asarray(ref).transpose(0, 3, 1, 2)
        err = np.abs(ours.numpy() - ref).max()
        assert err <= 1e-5 * np.abs(ref).max(), err


def test_conv3x3_cpu_plain_path_and_no_gradient():
    """On CPU tensors the wrapper runs the plain version and launches
    nothing; with grad mode on and an input that requires grad it raises,
    as the JAX package defines no gradient for K3."""
    x, w, b = (torch.from_numpy(a) for a in _conv_inputs(
        np.random.RandomState(0), 1, 5, 6, 7, 4))
    before = conv3x3.launches
    out = conv3x3(x, w, None)
    assert conv3x3.launches == before
    torch.testing.assert_close(
        out, torch.nn.functional.conv2d(x, w, None, 1, 1), rtol=1e-5,
        atol=1e-5)
    wg = w.clone().requires_grad_()
    with pytest.raises(NotImplementedError, match="decoder_conv_impl=pallas"):
        conv3x3(x, wg, b)
    with torch.no_grad():
        conv3x3(x, wg, b)
    # bf16 inputs: fp32 sums, fp32 bias, one rounding
    xb, wb = x.bfloat16(), w.bfloat16()
    ref = conv3x3_reference(xb.float(), wb.float(), b).bfloat16()
    assert torch.equal(conv3x3(xb, wb, b), ref)


@pytest.mark.parametrize("impl", ["auto", "xla", "shift", "pallas"])
@pytest.mark.parametrize("train", [False, True])
def test_resolve_conv_impl_matches_jax(impl, train):
    from occdepth_tpu.ops.conv2d_shift import resolve_conv_impl as jax_resolve

    assert resolve_conv_impl(impl, train) == jax_resolve(impl, train)


@pytest.mark.parametrize("shape", [(2, 11, 7, 13, 5), (2, 3, 5, 13, 24)],
                         ids=["ci11", "ci3"])
def test_conv3x3_packing_matches_plain_and_jax(shape):
    """The wrapper's packing (channels padded to a multiple of 8 with
    zeros, NHWC input, (Co, 3, 3, Cp) weight) and the plain conv of the
    packed operands vs `conv3x3_reference` and the JAX package's
    `conv3x3_shift`, fp32: sums of 9*Ci terms in another order, so 1e-5 *
    max|ref|."""
    jnp = pytest.importorskip("jax.numpy")
    from occdepth_tpu.ops.conv2d_shift import conv3x3_shift

    B, Ci, H, W, Co = shape
    x, w, b = _conv_inputs(np.random.RandomState(Ci + Co), B, Ci, H, W, Co)
    xt, wt, bt = (torch.from_numpy(a) for a in (x, w, b))
    Cp = padded_channels(Ci)
    assert Cp == {11: 16, 3: 8}[Ci]
    ref = conv3x3_reference(xt, wt, bt)
    jax_ref = np.asarray(conv3x3_shift(
        jnp.asarray(x.transpose(0, 2, 3, 1)),
        jnp.asarray(w.transpose(2, 3, 1, 0)), jnp.asarray(b)))
    wp = pack_conv3x3_weight(wt)
    assert wp.shape == (Co, 3, 3, Cp) and wp.is_contiguous()
    assert torch.equal(wp[..., :Ci], wt.permute(0, 2, 3, 1))
    assert not wp[..., Ci:].any()
    for xin in (xt, xt.contiguous(memory_format=torch.channels_last)):
        xp = to_padded_channels_last(xin)
        assert xp.shape == (B, H, W, Cp) and xp.is_contiguous()
        assert xp.data_ptr() % 16 == 0
        assert torch.equal(xp[..., :Ci], xt.permute(0, 2, 3, 1))
        assert not xp[..., Ci:].any()
        out = conv3x3_packed_reference(xp, wp, bt, Ci)
        assert out.shape == (B, Co, H, W)
        assert out.is_contiguous(memory_format=torch.channels_last)
        tol = 1e-5 * ref.abs().max().item()
        assert (out - ref).abs().max().item() <= tol
        assert np.abs(out.permute(0, 2, 3, 1).numpy() - jax_ref).max() <= tol
    bad = xp.clone()
    bad[..., -1] = 1.0  # a padded channel that is not zero
    with pytest.raises(ValueError, match="not zero"):
        conv3x3_packed_reference(bad, wp, bt, Ci)
    # channels-last with Ci % 8 == 0: the packed input is x's own memory
    x8 = torch.randn(2, 8, 3, 5).contiguous(memory_format=torch.channels_last)
    assert to_padded_channels_last(x8).data_ptr() == x8.data_ptr()


def test_upsample_bn_pallas_cpu_matches_shift():
    """UpSampleBN under `pallas` on the CPU (K3's plain path) gives the
    values of `shift` whatever the inputs' memory format."""
    from occdepth_tpu_torch.models.unet2d import UpSampleBN

    torch.manual_seed(0)
    pal = UpSampleBN(10 + 6, 8, "pallas").eval()
    shift = UpSampleBN(10 + 6, 8, "shift").eval()
    shift.load_state_dict(pal.state_dict())
    x, skip = torch.randn(2, 10, 4, 6), torch.randn(2, 6, 7, 11)
    with torch.no_grad():
        ref = shift(x, skip)
        for fmt in (torch.contiguous_format, torch.channels_last):
            out = pal(x.contiguous(memory_format=fmt),
                      skip.contiguous(memory_format=fmt))
            torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 99, 37, 70, 48), (1, 1672, 5, 77, 768),
                                   (2, 16, 3, 130, 64), (1, 3, 1, 1, 5),
                                   (2, 216, 11, 153, 96), (1, 99, 9, 77, 48),
                                   (2, 384, 6, 153, 192)])
def test_conv3x3_kernel_matches_plain(cuda_device, dtype, shape):
    """fp32 (3xTF32, against the plain version with TF32 off): sums in
    another order and the split's 2^-21 per product, 1e-4 * max|ref|;
    bf16: the plain version in fp32 on the same bf16 inputs, one bf16
    rounding of the output apart, 2^-7 * max|ref|.  The redesign's edges: W = 77 and
    153 against the 16-column tile, Ci = 99 and 3 (padded channels), Ci =
    216 and 1672 (a partial 64-channel chunk; fp32: 52 chunks of 32, each
    promoted out of the tensor cores' accumulator), Co = 5, 48, 64, 96,
    192 and 768 (each column tile width, bf16's 48/96/192 and fp32's
    48/96/128, partly filled), NCHW and channels-last inputs, with and
    without bias."""
    B, Ci, H, W, Co = shape
    g = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn(B, Ci, H, W, device=cuda_device, generator=g).to(dtype)
    w = (torch.randn(Co, Ci, 3, 3, device=cuda_device, generator=g)
         / (9 * Ci) ** 0.5).to(dtype)
    b = 0.1 * torch.randn(Co, device=cuda_device, generator=g)
    rtol = 1e-4 if dtype == torch.float32 else 2 ** -7
    ref = conv3x3_reference(x.float(), w.float(), b)
    before = conv3x3.launches
    out = conv3x3(x, w, b)
    torch.cuda.synchronize()
    assert conv3x3.launches == before + 1
    assert out.dtype == dtype and out.shape == (B, Co, H, W)
    assert out.is_contiguous(memory_format=torch.channels_last)
    tol = rtol * ref.abs().max().item()
    assert (out.float() - ref).abs().max().item() <= tol
    # channels-last input through its strides, and no bias
    xc = x.contiguous(memory_format=torch.channels_last)
    ref0 = conv3x3_reference(x.float(), w.float(), None)
    assert (conv3x3(xc, w, None).float() - ref0).abs().max().item() <= \
        rtol * ref0.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pack_kernel_matches_cpu_packing(cuda_device, dtype):
    """K3's packing kernel (`to_padded_channels_last` on the card) equals
    the CPU packing bit for bit: NCHW, channels-last with C % 8 != 0, a
    strided view, and more than one 64-pixel x 64-channel tile."""
    g = torch.Generator(device=cuda_device).manual_seed(9)
    x = torch.randn(2, 99, 37, 70, device=cuda_device, generator=g).to(dtype)
    for xin in (x, x.contiguous(memory_format=torch.channels_last),
                x[:, 3:80, 1::2, ::3], x[:1, :8]):
        out = to_padded_channels_last(xin)
        ref = to_padded_channels_last(xin.cpu())
        assert out.is_contiguous() and out.data_ptr() % 16 == 0
        assert torch.equal(out.cpu(), ref)


@pytest.mark.cuda
def test_conv3x3_raises_on_unsupported_input(cuda_device):
    x = torch.randn(1, 4, 5, 6, device=cuda_device)
    w = torch.randn(3, 4, 3, 3, device=cuda_device)
    with pytest.raises(TypeError):
        conv3x3(x, w.bfloat16())
    with pytest.raises(ValueError):
        conv3x3(x, w.transpose(2, 3))  # not contiguous
    with pytest.raises(ValueError):
        conv3x3(x, w, torch.zeros(3, device=cuda_device, dtype=torch.float64))
    with pytest.raises(NotImplementedError):
        conv3x3(x, w.requires_grad_())


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(300, 32, 8192), (97, 104, 4099),
                                   (1000, 33, 5000), (7, 1, 100)])
def test_row_gather_kernel_matches_plain(cuda_device, dtype, shape):
    """Bit for bit, NaN rows included: indices span [-2R, 2R), so some
    count from the end and some are out of range; C = 33 and 1 take the
    element-wise path (rows not a multiple of 16 bytes)."""
    R, C, T = shape
    g = torch.Generator(device=cuda_device).manual_seed(6)
    table = torch.randn(R, C, device=cuda_device, generator=g).to(dtype)
    idx = torch.randint(-2 * R, 2 * R, (T,), device=cuda_device, generator=g,
                        dtype=torch.int32)
    before = row_gather.launches
    out = row_gather(table, idx)
    torch.cuda.synchronize()
    assert row_gather.launches == before + 1
    assert out.dtype == dtype and out.shape == (T, C)
    assert torch.equal(_bits(out), _bits(row_gather_reference(table, idx)))
    assert out.isnan().any() and not out.isnan().all()


@pytest.mark.cuda
def test_row_gather_raises_on_unsupported_input(cuda_device):
    table = torch.randn(10, 8, device=cuda_device)
    idx = torch.zeros(4, dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        row_gather(table, idx.long())
    with pytest.raises(TypeError):
        row_gather(table.double(), idx)
    with pytest.raises(ValueError):
        row_gather(table.t(), idx)  # not contiguous
    with pytest.raises(ValueError):
        row_gather(table, idx.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 48, 16, 3), (32, 144, 48, 2),
                                   (16, 512, 64, 2), (80, 80, 80, 5),
                                   (8192, 432, 16, 4), (8192, 144, 48, 3),
                                   (2048, 512, 512, 2)])
def test_matmul_probe_kernel_matches_plain(cuda_device, shape):
    """One bf16 rounding of fp32 sums taken in another order: 2^-7 *
    max|ref|.  (80, 80, 80) takes a partial row tile and 16-column panels;
    the last three are the head probes' im2col, dzpack and lanefold
    shapes (128-, 48- and 16-column panels, k not a multiple of 64)."""
    m, k, n, steps = shape
    g = torch.Generator(device=cuda_device).manual_seed(7)
    p = torch.randn(1, m, k, device=cuda_device, generator=g).bfloat16()
    w = torch.randn(k, n, device=cuda_device, generator=g).bfloat16()
    before = matmul_probe.launches
    out = matmul_probe(p, w, steps)
    torch.cuda.synchronize()
    assert matmul_probe.launches == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == (steps, m, n)
    ref = matmul_probe_reference(p, w, steps).float()
    assert (out.float() - ref).abs().max().item() <= \
        2 ** -7 * ref.abs().max().item()


@pytest.mark.cuda
def test_matmul_probe_raises_on_unsupported_input(cuda_device):
    p = torch.randn(1, 32, 32, device=cuda_device).bfloat16()
    w = torch.randn(32, 16, device=cuda_device).bfloat16()
    with pytest.raises(TypeError):
        matmul_probe(p.float(), w.float(), 2)
    with pytest.raises(ValueError):
        matmul_probe(p[:, :24], w, 2)  # m not a multiple of 16
    with pytest.raises(ValueError):
        matmul_probe(p.transpose(1, 2), w, 2)  # p not contiguous


@pytest.mark.cuda
@pytest.mark.parametrize("shift,group_rows", [(0, 8), (3, 8), (0, 24),
                                              (1, 24), (2, 24)])
def test_hopper_helpers_tma_swizzle_and_wgmma(cuda_device, shift,
                                              group_rows):
    """csrc/hopper.cuh on its own: one TMA load of an (8 g + 8) x 64 bf16
    tile lands 128B-swizzled (row r's 16-byte chunk c at chunk c ^ (r %
    8)), bit for bit, and one wgmma m64n16 product over k = 64 whose A
    operand starts `shift` rows into the tile with its 8-row groups g rows
    apart (conv3x3's halo reads: shifts 0-2, g = 24) matches the float32
    product (exact bf16 products, sums of 64 in another order: 1e-5 *
    max|ref|)."""
    from occdepth_tpu_torch.ops import cuda_lib

    g = torch.Generator(device=cuda_device).manual_seed(8)
    a = torch.randn(8 * group_rows + 8, 64, device=cuda_device,
                    generator=g).bfloat16()
    b = torch.randn(16, 64, device=cuda_device, generator=g).bfloat16()
    dump = torch.empty(64, 64, dtype=torch.bfloat16, device=cuda_device)
    d = torch.empty(64, 16, device=cuda_device)
    rc = cuda_lib.library().occ_hopper_selftest(
        a.data_ptr(), b.data_ptr(), dump.data_ptr(), d.data_ptr(), shift,
        group_rows, torch.cuda.current_stream(cuda_device).cuda_stream)
    cuda_lib.check(rc, "hopper_selftest")
    torch.cuda.synchronize()
    r = torch.arange(64)[:, None]
    c = torch.arange(8)[None, :]
    expect = torch.empty(64, 8, 8, dtype=torch.bfloat16)
    expect[r, c ^ (r % 8)] = a[:64].cpu().view(64, 8, 8)[r, c]
    assert torch.equal(dump.cpu().view(torch.int16),
                       expect.view(64, 64).view(torch.int16))
    m = torch.arange(64, device=cuda_device)
    ref = a[(m // 8) * group_rows + shift + m % 8].float() @ b.float().t()
    assert (d - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


@pytest.mark.cuda
def test_hopper_helpers_ldmatrix_trans_and_rs_wgmma(cuda_device):
    """csrc/hopper.cuh's register-A path on its own: a TMA-loaded (k, m)
    tile read by `ldmatrix_x4_trans` into A fragments and four
    `wgmma_bf16_rs` m64n256k16 products against a K-major B match the
    float32 product (exact bf16 products, sums of 64 in another order:
    1e-5 * max|ref|)."""
    from occdepth_tpu_torch.ops import cuda_lib

    g = torch.Generator(device=cuda_device).manual_seed(10)
    at = torch.randn(64, 64, device=cuda_device, generator=g).bfloat16()
    b = torch.randn(256, 64, device=cuda_device, generator=g).bfloat16()
    d = torch.empty(64, 256, device=cuda_device)
    rc = cuda_lib.library().occ_hopper_selftest_rs(
        at.data_ptr(), b.data_ptr(), d.data_ptr(),
        torch.cuda.current_stream(cuda_device).cuda_stream)
    cuda_lib.check(rc, "hopper_selftest_rs")
    torch.cuda.synchronize()
    ref = at.float().t() @ b.float().t()
    assert (d - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


def _tf32_selftest(a, b, rs):
    """hopper_selftest.cu's TF32 product d = a @ b^T on the card."""
    from occdepth_tpu_torch.ops import cuda_lib

    d = torch.empty(64, b.shape[0], device=a.device)
    rc = cuda_lib.library().occ_hopper_selftest_tf32(
        a.data_ptr(), b.data_ptr(), d.data_ptr(), b.shape[0], rs,
        torch.cuda.current_stream(a.device).cuda_stream)
    cuda_lib.check(rc, "hopper_selftest_tf32")
    torch.cuda.synchronize()
    return d


@pytest.mark.cuda
@pytest.mark.parametrize("n", [48, 96, 128])
@pytest.mark.parametrize("rs", [0, 1], ids=["ss", "rs"])
def test_hopper_helpers_tf32_wgmma(cuda_device, n, rs):
    """csrc/hopper.cuh's TF32 products on their own: a (64, 32) A and an
    (n, 32) B of TF32 values land by TMA, K-major and 128B-swizzled, and
    four m64nNk8 k-slices multiply them, A by descriptor (SS) or as
    register fragments loaded from the swizzled tile (RS: the fragment
    layout that K2's and K3's fp32 paths load).  Products of TF32 values
    are exact in fp32, sums of 32 in another order: 1e-5 * max|ref|.  On
    a mismatch an identity B shows which A element each (row, k) position
    received."""
    from occdepth_tpu_torch.ops.tf32 import to_tf32_rna

    g = torch.Generator(device=cuda_device).manual_seed(14)
    a = to_tf32_rna(torch.randn(64, 32, device=cuda_device, generator=g))
    b = to_tf32_rna(torch.randn(n, 32, device=cuda_device, generator=g))
    d = _tf32_selftest(a, b, rs)
    ref = a @ b.t()
    err = (d - ref).abs().max().item()
    if err > 1e-5 * ref.abs().max().item():
        code = torch.arange(64 * 32, device=cuda_device,
                            dtype=torch.float32).view(64, 32)  # TF32-exact
        seen = _tf32_selftest(code, torch.eye(n, 32, device=cuda_device),
                              rs)[:, :32].long()
        bad = (seen != code.long()).nonzero()[:6].tolist()
        pytest.fail(f"TF32 {'RS' if rs else 'SS'} n={n}: error {err}; "
                    "(row, k) <- (row, k) read: " + ", ".join(
                        f"{m, k} <- {divmod(int(seen[m, k]), 32)}"
                        for m, k in bad))


@pytest.mark.cuda
def test_split_tf32_kernel_matches_plain(cuda_device):
    """tf32_split.cu vs the plain split (`ops/tf32.py`) bit for bit: K2's
    mega as its wrapper passes it, (B, C, M) with M = 1,350 padded to
    1,352, and K3's OIHW weights read as (Co, 9, Ci) (Ci = 99 padded to
    104), on values with ties at the TF32 rounding point, magnitudes from
    1e-30 to 1e30, and signed zeros."""
    from occdepth_tpu_torch.ops.tf32 import split_tf32_packed

    g = torch.Generator(device=cuda_device).manual_seed(15)
    mega = torch.randn(2, 256, 1350, device=cuda_device, generator=g)
    mega *= 10.0 ** torch.randint(-30, 31, mega.shape, device=cuda_device,
                                  generator=g)
    bits = mega.view(torch.int32)
    bits[:, :, ::7] = (bits[:, :, ::7] & -0x2000) | 0x1000  # ties
    mega[0, 0, :2] = torch.tensor([0.0, -0.0], device=cuda_device)
    w = torch.randn(48, 99, 3, 3, device=cuda_device, generator=g)
    for x, d2p in ((mega, 1352), (w.view(48, 99, 9).transpose(1, 2), 104)):
        out = split_tf32_packed(x, d2p)
        ref = split_tf32_packed(x.cpu(), d2p)
        assert out.shape == ref.shape == (2, *x.shape[:2], d2p)
        assert torch.equal(out.cpu().view(torch.int32), ref.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 4, 4096, 512, 256),
                                   (1, 3, 200, 72, 70),
                                   (2, 2, 136, 520, 300),
                                   (1, 2, 100, 37, 70)])
def test_crp_matmul_relations_kernel_matches_plain(cuda_device, dtype,
                                                   shape):
    """K2 batched over relations, operands laid out as the CRP passes them
    ((B, R, M, N) logits and (B, C, M) mega read transposed), one launch:
    within 2e-5 * max|ref| (fp32 sums of M terms in another order; in bf16
    the split sigmoid's 2^-18 per term).  bf16 takes the wgmma kernel
    (the logits padded where N is not a multiple of 8, mega where M is
    not): a partial voxel tile and C < 256, two channel tiles with M not a
    multiple of 64, N = 100 on padded logits."""
    B, R, N, M, C = shape
    g = torch.Generator(device=cuda_device).manual_seed(11)
    logits = torch.randn(B, R, M, N, device=cuda_device,
                         generator=g).to(dtype)
    mega = torch.randn(B, C, M, device=cuda_device, generator=g).to(dtype)
    args = (logits.transpose(2, 3), mega.transpose(1, 2))
    assert wgmma_path(*args)
    path = "wgmma_tf32" if dtype == torch.float32 else "wgmma_bf16"
    before = (crp_relation_matmul.launches, crp_relation_matmul.paths[path])
    out = crp_relation_matmul(*args)
    torch.cuda.synchronize()
    assert (crp_relation_matmul.launches,
            crp_relation_matmul.paths[path]) == (before[0] + 1,
                                                 before[1] + 1)
    assert out.shape == (B, R, N, C) and out.dtype == torch.float32
    assert out.transpose(2, 3).is_contiguous()
    ref = crp_relation_matmul_reference(*args)
    assert (out - ref).abs().max().item() <= 2e-5 * ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("B,M", [(1, 1350), (2, 1350), (1, 1345)])
def test_crp_matmul_tartanair_shape_takes_wgmma(cuda_device, B, M):
    """K2 at TartanAir's CRP shape, (B, 4, 10,800, 1,350) @ (B, 1,350,
    256) in bf16 and the model's layout: the wgmma kernel on the padded
    mega (one launch), within 2e-5 * max|ref| of the plain version; M =
    1,345 also leaves the last 64-mega-voxel chunk ragged."""
    g = torch.Generator(device=cuda_device).manual_seed(12)
    R, N, C = 4, 10800, 256
    logits = torch.randn(B, R, M, N, device=cuda_device,
                         generator=g).bfloat16()
    mega = torch.randn(B, C, M, device=cuda_device, generator=g).bfloat16()
    args = (logits.transpose(2, 3), mega.transpose(1, 2))
    assert wgmma_path(*args) and not tma_reads(args[1], 1)
    before = crp_relation_matmul.launches
    out = crp_relation_matmul(*args)
    torch.cuda.synchronize()
    assert crp_relation_matmul.launches == before + 1
    assert out.shape == (B, R, N, C) and out.dtype == torch.float32
    ref = crp_relation_matmul_reference(*args)
    assert (out - ref).abs().max().item() <= 2e-5 * ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,C", [(1, 800), (2, 800), (1, 1600)])
def test_crp_matmul_nyu_shape_takes_wgmma(cuda_device, B, C, dtype):
    """K2 at NYU's CRP shape, (B, 4, 2,025, 196) @ (B, 196, C) in the
    model's layout, C = 800 (b4) and 1,600 (b7): neither operand's stride
    is a 16-byte multiple in bf16, so bf16 takes the wgmma kernel on
    padded copies of both; fp32 takes the 3xTF32 kernel on the logits
    padded to 2,028 (an 8,100-byte stride) and mega's TF32 split (784
    bytes a row: no padding).  C = 800 = 3 x 256 + 32 ends in a partial
    column tile; one launch, within 2e-5 * max|ref| of the plain
    version."""
    g = torch.Generator(device=cuda_device).manual_seed(13)
    R, N, M = 4, 2025, 196
    logits = torch.randn(B, R, M, N, device=cuda_device, generator=g).to(dtype)
    mega = torch.randn(B, C, M, device=cuda_device, generator=g).to(dtype)
    args = (logits.transpose(2, 3), mega.transpose(1, 2))
    assert wgmma_path(*args) and not tma_reads(args[0], 2)
    assert tma_reads(args[1], 1) == (dtype == torch.float32)
    before = crp_relation_matmul.launches
    out = crp_relation_matmul(*args)
    torch.cuda.synchronize()
    assert crp_relation_matmul.launches == before + 1
    assert out.shape == (B, R, N, C) and out.dtype == torch.float32
    ref = crp_relation_matmul_reference(*args)
    assert (out - ref).abs().max().item() <= 2e-5 * ref.abs().max().item()


def _lift_case(dev, dtype, layout, B, N, P, C, hw, seed):
    """`lift_inputs` on the card: maps in `dtype` and `layout`."""
    scales = (1, 2, 4, 8)
    maps, pix, fov = lift_inputs(np.random.RandomState(seed), B, N, P, C, hw,
                                 scales)
    tmaps = []
    for s in scales:
        t = torch.from_numpy(maps[s]).to(dev, dtype).permute(0, 1, 4, 2, 3)
        tmaps.append(t.contiguous() if layout == "nchw" else t)
    return (tmaps, torch.from_numpy(pix).to(dev),
            torch.from_numpy(fov).to(dev), scales)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [(2, 20000, 1, 32, (93, 305)),
                                  (1, 3001, 4, 24, (37, 61)),
                                  (2, 777, 3, 20, (21, 37)),
                                  (2, 5000, 1, 100, (60, 80)),
                                  (1, 5000, 1, 200, (60, 80))],
                         ids=["serve_like", "p4_c24", "p3_c20", "nyu_c100",
                              "nyu_c200"])
def test_flosp_stereo_lift_kernel_matches_plain(cuda_device, dtype, layout,
                                               case):
    """The fused lift vs its plain version (flosp_gather_flat, the plain
    fusion, the sum over scales) in one launch: fp32 row sums and scale
    sums in another order, 1e-5 absolute (as K1).  C = 32 and 24 move 16
    bytes a thread; C = 20 in bf16 (40-byte rows) one element a thread, as
    NYU's b4 C = 100 in bf16 (200-byte rows, four elements a lane of 32);
    its b7 C = 200 moves 16 bytes a thread.
    Points on every map's last row and column, out of FOV, and voxels
    seen by one view only (`lift_inputs`)."""
    B, N, P, C, hw = case
    maps, pix, fov, scales = _lift_case(cuda_device, dtype, layout, B, N, P,
                                        C, hw, seed=P)
    before = flosp_stereo_lift.launches
    out = flosp_stereo_lift(maps, pix, fov, scales)
    torch.cuda.synchronize()
    assert flosp_stereo_lift.launches == before + 1
    assert out.shape == (B, N, C) and out.is_contiguous()
    ref = flosp_stereo_lift_reference(maps, pix, fov, scales)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [(2, 20000, 1, 32, (93, 305), False),
                                  (1, 3001, 4, 24, (37, 61), True),
                                  (2, 777, 3, 20, (21, 37), False),
                                  (2, 5000, 1, 100, (60, 80), False),
                                  (1, 5000, 1, 200, (60, 80), True)],
                         ids=["serve_like", "p4_c24_off_map", "p3_c20",
                              "nyu_c100", "nyu_c200_off_map"])
def test_flosp_stereo_lift_backward_kernel_matches_plain(cuda_device, dtype,
                                                        layout, case):
    """The lift's backward kernel vs its plain version
    (`flosp_stereo_lift_backward_reference`) in one call, on `lift_inputs`'
    edge cases (and in-FOV points past every map, whose voxels' rows read
    NaN in both): fp32 sums of each row's terms in another order, within
    1e-5 of max(1, max|ref|); bf16 one rounding of those sums apart (2^-7
    of each value).  Each gradient has its map's shape and dtype,
    channels-last, and a second call gives the same bits."""
    B, N, P, C, hw, off_map = case
    maps, pix, fov, scales = _lift_case(cuda_device, dtype, layout, B, N, P,
                                        C, hw, seed=P + 7)
    if off_map:  # view 1: y at the last row, x past the right edge at
        # every scale; view 0 in FOV on the map, so its rows read the NaN
        for v, xy in ((1, [hw[1] + 76, hw[0] - 1]), (0, [1, 1])):
            pix[:, v, -3:, 0] = torch.tensor(xy, dtype=pix.dtype,
                                             device=pix.device)
            fov[:, v, -3:, 0] = True
    cot = torch.randn(B, N, C, device=cuda_device,
                      generator=torch.Generator(cuda_device).manual_seed(P))
    before = flosp_stereo_lift_backward.launches
    got = flosp_stereo_lift_backward(maps, pix, fov, scales, cot)
    again = flosp_stereo_lift_backward(maps, pix, fov, scales, cot)
    torch.cuda.synchronize()
    assert flosp_stereo_lift_backward.launches == before + 2
    want = flosp_stereo_lift_backward_reference(maps, pix, fov, scales, 1e-8,
                                                cot)
    for a, a2, b, m in zip(got, again, want, maps):
        assert a.shape == m.shape and a.dtype == m.dtype
        assert a.stride() == b.stride()
        assert a.permute(0, 1, 3, 4, 2).is_contiguous()
        assert torch.equal(_bits(a), _bits(a2))
        scale = max(1.0, b.float().nan_to_num().abs().max().item())
        torch.testing.assert_close(
            a.float(), b.float(), equal_nan=True, atol=1e-5 * scale,
            rtol=0 if dtype == torch.float32 else 2 ** -7)
    assert off_map == any(torch.isnan(b.float()).any() for b in want)


@pytest.mark.cuda
def test_flosp_stereo_lift_backward_is_bitwise_repeatable(cuda_device):
    """Two calls at TartanAir's grid (691,200 voxels, C = 32, bf16, a
    480x640 image) give equal bits: no floating-point atomics."""
    maps, pix, fov, scales = _lift_case(cuda_device, torch.bfloat16, "nchw",
                                        1, 691200, 1, 32, (480, 640), seed=3)
    cot = torch.randn(1, 691200, 32, device=cuda_device)
    first = flosp_stereo_lift_backward(maps, pix, fov, scales, cot)
    second = flosp_stereo_lift_backward(maps, pix, fov, scales, cot)
    assert all(torch.equal(_bits(a), _bits(b))
               for a, b in zip(first, second))


@pytest.mark.cuda
def test_flosp_stereo_lift_gradient_matches_plain_autograd(cuda_device):
    maps, pix, fov, scales = _lift_case(cuda_device, torch.float32, "nchw",
                                        1, 2000, 1, 32, (37, 61), seed=5)
    leaves = [m.clone().requires_grad_() for m in maps]
    cot = torch.randn(1, 2000, 32, device=cuda_device)
    out = flosp_stereo_lift(leaves, pix, fov, scales)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, leaves, cot)
    want = torch.autograd.grad(
        flosp_stereo_lift_reference(leaves, pix, fov, scales), leaves, cot)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_lift_and_fuse_raise_on_unsupported_input(cuda_device):
    maps, pix, fov, scales = _lift_case(cuda_device, torch.float32, "nchw",
                                        1, 100, 1, 8, (21, 37), seed=1)
    with pytest.raises(TypeError):
        flosp_stereo_lift(maps, pix.long(), fov, scales)
    with pytest.raises(TypeError):
        flosp_stereo_lift(maps, pix, fov.float(), scales)
    with pytest.raises(TypeError):
        flosp_stereo_lift([maps[0].bfloat16()] + maps[1:], pix, fov, scales)
    with pytest.raises(TypeError):
        flosp_stereo_lift([m.double() for m in maps], pix, fov, scales)
    with pytest.raises(ValueError):
        flosp_stereo_lift([m[:, :1] for m in maps], pix[:, :1], fov[:, :1],
                          scales)
    with pytest.raises(ValueError):
        flosp_stereo_lift(maps, pix.cpu(), fov, scales)
    f = torch.randn(2, 8, 50, device=cuda_device).transpose(1, 2)
    m = torch.ones(2, 50, device=cuda_device)
    with pytest.raises(ValueError):  # channels not unit-stride
        stereo_cosine_fuse(f, f, m, m)
    p = torch.randn(2, 3, 64, 32, device=cuda_device).bfloat16()
    with pytest.raises(ValueError):  # mega must be (B, M, C) for 4-D logits
        crp_relation_matmul(p, torch.randn(2, 3, 32, 8, device=cuda_device
                                           ).bfloat16())
    with pytest.raises(ValueError):
        crp_relation_matmul(p, torch.randn(2, 31, 8, device=cuda_device
                                           ).bfloat16())


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["flosp_stereo_lift",
                                "flosp_stereo_lift_backward",
                                "crp_relation_matmul", "conv3x3"])
def test_registered_ops_pass_opcheck_on_cuda(cuda_device, op):
    """The operators' CUDA implementations (the kernels) against their fake
    implementations (shapes, strides, dtypes) and the autograd
    registration, on small card inputs, fp32 and bf16.  The lift's
    gradient is its deterministic backward kernel (the backward operator),
    so eager and traced runs agree in both dtypes."""
    g = torch.Generator(device=cuda_device).manual_seed(3)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, device=cuda_device, generator=g).to(dtype)

    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        if op == "flosp_stereo_lift":
            maps, pix, fov, scales = _lift_case(cuda_device, dtype, "nchw", 2,
                                                300, 1, 32, (21, 37), seed=2)
            cases.append(([m.requires_grad_() for m in maps], pix, fov,
                          list(scales), 1e-8))
        elif op == "flosp_stereo_lift_backward":
            maps, pix, fov, scales = _lift_case(cuda_device, dtype,
                                                "channels_last", 2, 300, 1,
                                                32, (21, 37), seed=4)
            cases.append((maps, pix, fov, list(scales), 1e-8,
                          randn(2, 300, 32)))
        elif op == "crp_relation_matmul":
            cases.append((randn(2, 4, 512, 64, dtype=dtype).requires_grad_(),
                          randn(2, 64, 32, dtype=dtype).requires_grad_()))
        else:
            cases.append((randn(2, 12, 20, 24, dtype=dtype),
                          randn(16, 12, 3, 3, dtype=dtype), randn(16)))
    for args in cases:
        torch.library.opcheck(getattr(torch.ops.occdepth, op).default, args)


@pytest.mark.cuda
def test_exported_program_launches_the_kernels_on_cuda(cuda_device, tmp_path):
    """A tiny model (two views, CRP, decoder_conv_impl=pallas) exported on
    the card, saved and loaded: each forward of the loaded program
    launches the fused lift and K2 once and K3 as often as the eager
    forward does, and its logits equal the eager ones within 1e-5 of
    their largest (fp32 sums that cuDNN may order differently for the
    traced graph's tensors)."""
    from occdepth_tpu_torch.data.batch import make_synthetic_batch
    from occdepth_tpu_torch.models import OccDepthModel
    from occdepth_tpu_torch.scripts.export_model import (
        INPUT_KEYS,
        export_forward,
        load_exported,
    )
    from occdepth_tpu_torch.testing import randomize_weights, tiny_kitti_config

    torch.backends.cudnn.allow_tf32 = False
    cfg = tiny_kitti_config(decoder_conv_impl="pallas")
    model = randomize_weights(OccDepthModel(cfg), seed=4).to(cuda_device)
    model.eval()
    batch = {k: torch.from_numpy(v).to(cuda_device) for k, v in
             make_synthetic_batch(cfg, batch_size=1, seed=5).items()
             if k in INPUT_KEYS}
    counters = (flosp_stereo_lift, crp_relation_matmul, conv3x3)
    before = [f.launches for f in counters]
    with torch.no_grad():
        eager = model(batch)["ssc_logit"]
    eager_launches = [f.launches - b for f, b in zip(counters, before)]
    assert eager_launches[:2] == [1, 1] and eager_launches[2] > 0
    path = str(tmp_path / "tiny.pt2")
    torch.export.save(export_forward(cfg, model, batch), path)
    program = load_exported(path).module()
    before = [f.launches for f in counters]
    with torch.no_grad():
        out = program(batch)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(counters, before)] == eager_launches
    assert (out - eager).abs().max().item() <= 1e-5 * eager.abs().max().item()
