"""K4: filter gradient of a stride-1 SAME depthwise conv (kernel
`csrc/dw_filter_grad.cu`), and the depthwise conv whose backward uses it.

Counterpart of `occdepth_tpu/ops/dw_conv.py`:

    dw[c, 0, dr, dc] = sum_{b,h,w} x_pad[b, c, h+dr, w+dc] * g[b, c, h, w]

`dw_conv2d_fastgrad` is a stock depthwise conv forward whose backward takes
dx from PyTorch's own convolution backward and dw from K4, as the JAX
package's custom VJP takes dx from XLA and dw from its Pallas kernel.  For
CPU tensors `dw_filter_grad` runs the plain PyTorch version; for CUDA
tensors it launches the kernel or raises.

The kernel takes contiguous NCHW planes (the encoder's layout); the wrapper
copies anything else to that layout and counts the copy on
`dw_filter_grad.copies`.  `dw_plan` is the launch's pure-Python plan:
warps per block, blocks per channel (a thread-block cluster), band height
and the ring of bulk-copy slots; `plan_bands` and `staged_span` mirror how
the kernel walks and stages the bands, for the CPU tests.
"""
from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F

from occdepth_tpu_torch.ops import cuda_lib

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_SIZES = (3, 5)  # the EfficientNets' depthwise filters
H100_SMS = 132
MAX_CLUSTER = 8  # the portable cluster size
MAX_WARPS = 16
MAX_STAGES = 3
COLS = 2  # adjacent output columns a lane owns (the kernel's kCols)
BLOCKS_PER_SM = 2  # the grid's aim before a channel's plane is split
BANDS_PER_BLOCK = 2  # the ring's depth for planes of more than a slot
SLOT_BYTES = 32 * 1024  # a band's x and g rows, at most (one ring slot)
SMEM_BYTES = 232448  # a block's most shared memory on sm_90
K4_RTOL = 1e-4  # x max|ref|: fp32 sums of up to 113k terms in another order


def dw_filter_grad_reference(x: torch.Tensor, g: torch.Tensor, kh: int,
                             kw: int) -> torch.Tensor:
    """Plain version: (B, C, H, W) x and g -> (C, 1, kh, kw) float32, the
    k*k shifted multiply-sums of the zero-padded input in float32."""
    B, C, H, W = x.shape
    pt, pl = (kh - 1) // 2, (kw - 1) // 2
    xp = F.pad(x.float(), (pl, kw - 1 - pl, pt, kh - 1 - pt))
    gf = g.float()
    taps = [
        (xp[:, :, dr:dr + H, dc:dc + W] * gf).sum(dim=(0, 2, 3))
        for dr in range(kh) for dc in range(kw)
    ]
    return torch.stack(taps, dim=1).reshape(C, 1, kh, kw)


def _align(n: int, a: int) -> int:
    return -(-n // a) * a


@dataclasses.dataclass(frozen=True)
class DwPlan:
    """One K4 launch: `cluster` blocks of `warps` warps per channel, bands
    of `band_rows` rows of g (their x rows plus the k - 1 halo rows), a
    ring of `stages` slots of `x_slot` + `g_slot` bytes each."""

    warps: int
    cluster: int
    band_rows: int
    n_bands: int  # per (batch, channel) plane
    stages: int
    x_slot: int
    g_slot: int
    smem: int  # a block's dynamic shared memory, as the kernel lays it out


def _header_bytes(k: int) -> int:
    """The kernel's mbarriers and partial sums ahead of the slots."""
    return _align(8 * 4 + 4 * (MAX_WARPS + 1) * k * k, 128)


@functools.lru_cache(maxsize=256)
def dw_plan(B: int, C: int, H: int, W: int, k: int, elem_size: int,
            sms: int = H100_SMS) -> DwPlan:
    """The launch for a (B, C, H, W) conv with a k x k filter.

    A warp per group of 64 columns (each lane owns COLS = 2; at most
    MAX_WARPS warps, wider planes give each warp several groups).  A block
    per channel, and blocks per channel (a cluster) doubled up to 8 only
    while the grid has fewer than BLOCKS_PER_SM blocks per SM: a
    cluster's launch and barriers cost more than the small planes' work.
    Then bands: planes larger than a slot are cut into about
    BANDS_PER_BLOCK bands per block, so that the ring overlaps copies
    with arithmetic, smaller ones into one band per block.  A slot holds
    at most SLOT_BYTES.
    """
    groups = -(-W // (32 * COLS))
    if groups <= MAX_WARPS:
        warps = groups
    else:  # the fewest idle group slots, then the most warps
        warps = min(range(MAX_WARPS // 2, MAX_WARPS + 1),
                    key=lambda d: (-(-groups // d) * d - groups, -d))
    cluster = 1
    while (cluster < MAX_CLUSTER and C * cluster < BLOCKS_PER_SM * sms
           and 2 * cluster <= B * H):
        cluster *= 2
    row_bytes = W * elem_size
    per_block = BANDS_PER_BLOCK if 2 * H * row_bytes > SLOT_BYTES else 1
    rows = -(-H // min(H, -(-per_block * cluster // B)))
    rows = max(1, min(rows, (SLOT_BYTES // row_bytes - (k - 1)) // 2))
    n_bands = -(-H // rows)
    x_slot = _align((rows + k - 1) * row_bytes + 32, 16)
    g_slot = _align(rows * row_bytes + 32, 16)
    fixed = _header_bytes(k)
    stages = min(MAX_STAGES, -(-B * n_bands // cluster))
    while stages > 1 and fixed + stages * (x_slot + g_slot) > SMEM_BYTES:
        stages -= 1
    smem = fixed + stages * (x_slot + g_slot)
    if smem > SMEM_BYTES:
        raise ValueError(f"dw_filter_grad: a {W}-wide row of {elem_size}-"
                         "byte elements exceeds shared memory")
    return DwPlan(warps, cluster, rows, n_bands, stages, x_slot, g_slot,
                  smem)


def plan_bands(plan: DwPlan, B: int, C: int, H: int) -> list:
    """(channel, block rank, i, batch, h0, h1): the i-th band of each block
    of the grid, in the kernel's order (bands rank, rank + cluster, ... of
    the B * n_bands of a channel)."""
    out = []
    total = B * plan.n_bands
    for c in range(C):
        for rank in range(plan.cluster):
            for i, j in enumerate(range(rank, total, plan.cluster)):
                b, band = divmod(j, plan.n_bands)
                h0 = band * plan.band_rows
                out.append((c, rank, i, b, h0, min(h0 + plan.band_rows, H)))
    return out


def staged_span(s: int, e: int, t0: int, t1: int) -> tuple:
    """(base, lo, hi) for the bytes [s, e) of a band staged from a tensor
    occupying [t0, t1), as the kernel's `make_span` computes them: slot
    byte 0 holds global byte `base` (s rounded down to 16), [lo, hi) is
    the bulk copy (16-byte aligned, inside [t0, t1)), the rest of [s, e) is
    copied element by element."""
    base = s & ~15
    lo = base if base >= t0 else (s + 15) & ~15
    up = (e + 15) & ~15
    hi = up if up <= t1 else e & ~15
    if hi <= lo:
        lo = hi = e
    return base, lo, hi


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def dw_filter_grad(x: torch.Tensor, g: torch.Tensor, kh: int,
                   kw: int) -> torch.Tensor:
    """Filter gradient of a stride-1 SAME depthwise conv.

    Args:
        x: (B, C, H, W) conv input, float32 or bfloat16.
        g: (B, C, H, W) output cotangent, same dtype.
        kh, kw: odd filter size (square, 3 or 5, on CUDA).

    Returns (C, 1, kh, kw) float32.  On CUDA: one launch, deterministic
    (every sum in a fixed order); x and g that are not contiguous NCHW are
    copied first, one count on `dw_filter_grad.copies` each.
    """
    if x.device.type == "cpu":
        return dw_filter_grad_reference(x, g, kh, kw)
    B, C, H, W = x.shape
    for name, t in (("x", x), ("g", g)):
        if t.device != x.device or t.device.type != "cuda":
            raise ValueError(f"dw_filter_grad: {name} on {t.device}")
        if t.dtype not in _DTYPE_CODE:
            raise TypeError(f"dw_filter_grad: {name} is {t.dtype}")
    if g.dtype != x.dtype or g.shape != x.shape:
        raise ValueError(f"dw_filter_grad: x {x.dtype} {tuple(x.shape)}, "
                         f"g {g.dtype} {tuple(g.shape)}")
    if kh != kw or kh not in _KERNEL_SIZES:
        raise ValueError(f"dw_filter_grad: filter {kh}x{kw} (square "
                         f"{_KERNEL_SIZES} on CUDA)")
    if x.numel() == 0:
        return torch.zeros((C, 1, kh, kw), dtype=torch.float32,
                           device=x.device)
    plan = dw_plan(B, C, H, W, kh, x.element_size(),
                   _sm_count(x.device.index or 0))
    if not x.is_contiguous():
        x = x.contiguous()
        dw_filter_grad.copies += 1
    if not g.is_contiguous():
        g = g.contiguous()
        dw_filter_grad.copies += 1
    out = torch.empty((C, 1, kh, kw), dtype=torch.float32, device=x.device)
    rc = cuda_lib.library().occ_dw_filter_grad(
        x.data_ptr(), g.data_ptr(), out.data_ptr(), _DTYPE_CODE[x.dtype], kh,
        B, C, H, W, plan.warps, plan.cluster, plan.band_rows, plan.stages,
        plan.x_slot, plan.g_slot,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    cuda_lib.check(rc, "dw_filter_grad")
    dw_filter_grad.launches += 1
    return out


dw_filter_grad.launches = 0
dw_filter_grad.copies = 0


class _DwConvFastGrad(torch.autograd.Function):
    """Stride-1 SAME depthwise conv: stock forward, dw from K4."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        kh, kw = w.shape[-2:]
        return F.conv2d(x, w, None, 1, (kh // 2, kw // 2), 1, x.shape[1])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        kh, kw = w.shape[-2:]
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.ops.aten.convolution_backward(
                g, x, w, None, [1, 1], [kh // 2, kw // 2], [1, 1], False,
                [0, 0], x.shape[1], [True, False, False],
            )[0]
        if ctx.needs_input_grad[1]:
            # returned in the weight's (compute) dtype: bf16 rounds the fp32
            # sums once, as the JAX package's VJP does
            dw = dw_filter_grad(x, g, kh, kw).to(w.dtype)
        return dx, dw


def dw_conv2d_fastgrad(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Stride-1 SAME depthwise conv; forward == F.conv2d, backward through
    K4 for the filter.

    x (B, C, H, W), w (C, 1, k, k) with k odd, both in the compute dtype
    (the caller casts the float32 parameter, as the layers do).
    """
    return _DwConvFastGrad.apply(x, w)


def use_fast_dw_grad(mode: str, kernel: int, stride: int) -> bool:
    """Whether a depthwise conv takes `dw_conv2d_fastgrad`.  `mode` is
    cfg.dw_conv_grad: 'pallas' selects K4 for stride-1 odd-kernel convs,
    'xla' and 'auto' keep PyTorch's own autograd; strided and even-kernel
    convs always keep it."""
    if mode not in ("pallas", "xla", "auto"):
        raise ValueError(
            f"dw_conv_grad={mode!r}: expected 'pallas', 'xla' or 'auto'"
        )
    if stride != 1 or kernel % 2 != 1:
        return False
    return mode == "pallas"
