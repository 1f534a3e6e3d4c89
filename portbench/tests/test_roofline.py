"""The yardstick's bytes and FLOP counts against hand-worked counts at
small shapes, and the bound that keeps every share at or under 100%."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from portbench.core import roofline


def test_map_shapes_round_up_each_stage():
    assert roofline.map_shapes((370, 1220), (1, 2, 4, 8)) == [
        (370, 1220), (185, 610), (93, 305), (47, 153)]


def test_lift_bytes_by_hand():
    # one view, two points, P = 1, C = 4 bf16 channels, an 8x8 image at
    # scales 1 and 2: the points at (2, 2) and (3, 3) name two rows at
    # scale 1 and one, (1, 1), at scale 2
    pix = np.array([[[[2, 2]], [[3, 3]]]], np.int32)  # (V=1, N=2, P=1, 2)
    fov = np.ones((1, 2, 1), bool)
    n = roofline.lift_bytes(pix, fov, (1, 2), (8, 8), 4, 2, batch=3)
    rows = 2 + 1
    per_sample = pix.size * 4 + fov.size + rows * 4 * 2 + 2 * 4 * 4
    assert n == 3 * per_sample
    # the backward writes every element of both maps' gradients
    nb = roofline.lift_backward_bytes(pix, fov, (1, 2), (8, 8), 4, 2, 1)
    assert nb == (2 * 4 * 4 + pix.size * 4 + fov.size + rows * 4 * 2
                  + (64 + 16) * 4 * 2)


def test_lift_bound_never_above_a_plain_implementations_traffic():
    """The bound counts each named row once; any implementation reads at
    least those rows, so bound time <= measured time and the share <= 100%
    unless the time misses work."""
    rs = np.random.RandomState(0)
    V, N, C, hw = 2, 500, 8, (16, 24)
    pix = np.stack([rs.randint(-2, 26, size=(V, N, 1)),
                    rs.randint(-2, 18, size=(V, N, 1))], -1).astype(np.int32)
    fov = rs.rand(V, N, 1) > 0.3
    n = roofline.lift_bytes(pix, fov, (1, 2, 4, 8), hw, C, 2, 1)
    maps = sum(V * C * h * w * 2 for h, w in
               roofline.map_shapes(hw, (1, 2, 4, 8)))
    whole = pix.size * 4 + fov.size + maps + N * C * 4
    assert 0 < n <= whole
    assert roofline.share_pct(n, n / roofline.HBM_BYTES_PER_S) == \
        pytest.approx(100.0)
    assert roofline.share_pct(n, 2 * n / roofline.HBM_BYTES_PER_S) == \
        pytest.approx(50.0)


def test_flop_counter_by_hand():
    x = torch.randn(2, 3, 10, 12)
    w = torch.randn(5, 3, 3, 3)
    m = torch.randn(4, 6, 7)
    k = torch.randn(4, 7, 9)

    def work():
        F.conv2d(x, w, padding=1)
        torch.bmm(m, k)

    conv = 2 * 2 * 5 * 10 * 12 * 3 * 3 * 3
    mm = 2 * 4 * 6 * 7 * 9
    assert roofline.counted_flops(work) == conv + mm


def test_flop_counter_counts_the_backward():
    x = torch.randn(1, 4, 8, 8, requires_grad=True)
    w = torch.randn(6, 4, 1, 1, requires_grad=True)

    def work():
        F.conv2d(x, w).sum().backward()

    fwd = 2 * 6 * 4 * 64
    assert roofline.counted_flops(work) == 3 * fwd
