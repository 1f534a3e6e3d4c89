"""The 3xTF32 arithmetic of K2's and K3's fp32 paths, on the CPU.

On the card fp32 K2 (`csrc/crp_matmul.cu`) and K3 (`csrc/conv3x3.cu`)
multiply on the tensor cores as three TF32 products, hi.hi + hi.lo +
lo.hi, of operands split by `ops/tf32.py`.  Here, with the same inputs
made by numpy for both frameworks:

  * the plain split: hi and lo are TF32 (low 13 bits zero), hi is x
    rounded to nearest with ties away from zero, and hi + lo = x within
    2^-22 |x|; the packed split of the B operand (`split_tf32_packed`, the
    wrappers' layout: mega (2, B, C, Mp), the weights (2, Co, 9, Cp)) pads
    with zeros;
  * that arithmetic emulated in fp32 on those packed operands (products of
    TF32 values are exact in fp32) is held to the JAX package's Pallas
    kernels in interpret mode within chip_smoke's K2_RTOL and
    K3_RTOL["float32"], and one TF32 product (1xTF32) is shown outside
    them, so the tolerances would catch that shortcut;
  * which kernel and which copies fp32 operands get: the tensor-core path
    for voxel-contiguous logits, NYU's N = 2,025 logits padded to 2,028,
    TartanAir's M = 1,350 mega to 1,352, KITTI's as they are.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from chip_smoke import K2_RTOL, K3_RTOL
from occdepth_tpu_torch.ops.crp_matmul import (
    pad_for_tma,
    tma_reads,
    wgmma_path,
)
from occdepth_tpu_torch.ops.tf32 import (
    split_tf32,
    split_tf32_packed,
    to_tf32_rna,
)


def _bits(t):
    return t.contiguous().view(torch.int32)


def test_split_tf32_is_exact_to_2_pow_minus_22():
    """hi and lo carry 10 mantissa bits each, hi is x rounded to nearest
    (ties away from zero: the low 13 bits exactly 0x1000 round up in
    magnitude), and |x - hi - lo| <= 2^-22 |x| over magnitudes 1e-30 to
    1e30 of both signs."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy((rng.randn(100_000) * 10.0 ** rng.randint(
        -30, 31, 100_000)).astype(np.float32))
    hi, lo = split_tf32(x)
    assert not (_bits(hi) & 0x1FFF).any() and not (_bits(lo) & 0x1FFF).any()
    err = (x.double() - hi.double() - lo.double()).abs()
    assert (err <= 2.0 ** -22 * x.double().abs()).all()
    assert ((x.double() - hi.double()).abs()
            <= 2.0 ** -11 * x.double().abs()).all()
    # ties: 1 + 2^-11 and -(1 + 2^-11) are halfway between TF32 neighbours
    tie = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 2.0 ** -12,
                        0.0, -0.0])
    assert to_tf32_rna(tie).tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10),
                                         1.0, 0.0, -0.0]


@pytest.mark.parametrize("shape,d2p", [((2, 70, 37), 40), ((3, 9, 99), 104)],
                         ids=["mega", "weights"])
def test_split_tf32_packed_layout_and_zero_padding(shape, d2p):
    """The plain packed split: (2, D0, D1, d2p), [0] and [1] the split of
    the strided input, zeros past D2 (what TMA reads as the padding)."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn(shape[0], shape[2], shape[1], generator=g).transpose(1, 2)
    out = split_tf32_packed(x, d2p)
    hi, lo = split_tf32(x)
    assert out.shape == (2, *shape[:2], d2p) and out.is_contiguous()
    assert torch.equal(out[0, ..., :shape[2]], hi)
    assert torch.equal(out[1, ..., :shape[2]], lo)
    assert not out[..., shape[2]:].any()
    with pytest.raises(ValueError):
        split_tf32_packed(x, shape[2] - 1)


def _three(a_hi, a_lo, b_hi, b_lo):
    """The kernels' three TF32 products in their order, summed in fp32."""
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def crp_tf32(p, mega, three=True):
    """K2's fp32 kernel emulated: (N, M) logits, (M, C) mega; the sigmoid
    split in registers, mega through the wrapper's packed split."""
    M = p.shape[1]
    s = torch.sigmoid(p)
    g = split_tf32_packed(mega.t()[None], -(-M // 4) * 4)[:, 0, :, :M]
    g_hi, g_lo = g[0].t(), g[1].t()
    if not three:  # one TF32 product
        return to_tf32_rna(s) @ g_hi
    return _three(*split_tf32(s), g_hi, g_lo)


def conv3x3_tf32(x, w, b, three=True):
    """K3's fp32 kernel emulated in the port's layouts (x (B, Ci, H, W), w
    OIHW): nine taps, the input split per tap, the weights through the
    wrapper's packed split (2, Co, 9, Cp)."""
    B, Ci, H, W = x.shape
    Co = w.shape[0]
    wp = split_tf32_packed(w.reshape(Co, Ci, 9).transpose(1, 2),
                           -(-Ci // 8) * 8)[..., :Ci]
    xp = F.pad(x, (1, 1, 1, 1)).permute(0, 2, 3, 1)
    acc = 0
    for tap in range(9):
        a = xp[:, tap // 3:tap // 3 + H, tap % 3:tap % 3 + W]
        b_hi, b_lo = wp[0, :, tap].t(), wp[1, :, tap].t()
        if three:
            acc = acc + _three(*split_tf32(a), b_hi, b_lo)
        else:
            acc = acc + to_tf32_rna(a) @ b_hi
    return (acc + b).permute(0, 3, 1, 2)


def test_crp_3xtf32_holds_to_pallas_and_1xtf32_does_not():
    """K2's 3xTF32 emulation at N = 512 vs the JAX kernel
    (`crp_relation_matmul`, interpret mode) within K2_RTOL x max|ref|;
    1xTF32 is ~15x over it."""
    jnp = pytest.importorskip("jax.numpy")
    from occdepth_tpu.ops.pallas_kernels import crp_relation_matmul

    rng = np.random.RandomState(2)
    N, M, C = 512, 256, 64
    p = rng.randn(N, M).astype(np.float32)
    mega = rng.randn(M, C).astype(np.float32)
    ref = np.asarray(crp_relation_matmul(jnp.asarray(p), jnp.asarray(mega),
                                         block_n=256, interpret=True))
    tol = K2_RTOL * np.abs(ref).max()
    tp, tm = torch.from_numpy(p), torch.from_numpy(mega)
    assert np.abs(crp_tf32(tp, tm).numpy() - ref).max() <= tol
    assert np.abs(crp_tf32(tp, tm, three=False).numpy() - ref).max() > 5 * tol


def test_conv3x3_3xtf32_holds_to_pallas_and_1xtf32_does_not():
    """K3's 3xTF32 emulation vs the JAX kernel (`conv3x3_pallas`,
    interpret mode; NHWC, HWIO) at Ci = 64 (576-term sums) within
    K3_RTOL["float32"] x max|ref|; 1xTF32 is ~3x over it."""
    jnp = pytest.importorskip("jax.numpy")
    from occdepth_tpu.ops.conv2d_shift import conv3x3_pallas

    rng = np.random.RandomState(3)
    B, Ci, H, W, Co = 1, 64, 8, 16, 32
    x = rng.randn(B, Ci, H, W).astype(np.float32)
    w = (rng.randn(Co, Ci, 3, 3) / np.sqrt(9 * Ci)).astype(np.float32)
    b = (0.1 * rng.randn(Co)).astype(np.float32)
    ref = np.asarray(conv3x3_pallas(
        jnp.asarray(x.transpose(0, 2, 3, 1)),
        jnp.asarray(w.transpose(2, 3, 1, 0)), jnp.asarray(b),
        interpret=True)).transpose(0, 3, 1, 2)
    tol = K3_RTOL["float32"] * np.abs(ref).max()
    args = [torch.from_numpy(a) for a in (x, w, b)]
    assert np.abs(conv3x3_tf32(*args).numpy() - ref).max() <= tol
    assert np.abs(conv3x3_tf32(*args, three=False).numpy() - ref).max() \
        > 2 * tol


@pytest.mark.parametrize("name,N,M,C,padded", [
    ("kitti", 4096, 512, 256, ()),
    ("tartanair", 10800, 1350, 256, ("mega",)),
    ("nyu", 2025, 196, 800, ("logits",)),
])
def test_fp32_operands_take_tensor_cores_with_tma_copies(name, N, M, C,
                                                         padded):
    """fp32 logits in the CRP's layout (a transposed view of the (B, R, M,
    N) conv outputs) take the 3xTF32 kernel at every dataset's shape; TMA
    needs 16-byte strides, 4 fp32 elements: NYU's N = 2,025 logits go as a
    (1, 4, 196, 2,028) copy, TartanAir's M = 1,350 mega as a (1, 256,
    1,352) one (in the wrapper, the split's own buffer), KITTI's as they
    are.  Other logits layouts take the SIMT kernel."""
    R = 4
    logits = torch.zeros(1, R, M, N).transpose(2, 3)
    mega = torch.zeros(1, C, M).transpose(1, 2)
    assert wgmma_path(logits, mega)
    assert not wgmma_path(logits.contiguous(), mega)
    reads = {"logits": tma_reads(logits, 2), "mega": tma_reads(mega, 1)}
    assert {k for k, v in reads.items() if not v} == set(padded)
    for key, t, dim in (("logits", logits, 2), ("mega", mega, 1)):
        if key not in padded:
            continue
        out = pad_for_tma(t, dim)
        n = t.shape[dim]
        np_ = {"logits": 2028, "mega": 1352}[key]
        assert np_ == -(-n // 4) * 4
        strides = {"logits": (R * M * np_, M * np_, 1, np_),
                   "mega": (C * np_, 1, np_)}[key]
        assert out.shape == t.shape and out.stride() == strides
        assert tma_reads(out, dim) and torch.equal(out, t)
