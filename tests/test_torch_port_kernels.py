"""Port kernels K1/K2: plain versions vs the JAX Pallas kernels (interpret
mode on the CPU), and the CUDA kernels vs the plain versions (`cuda`
marker, skipped without a card).

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
