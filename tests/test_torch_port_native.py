"""The port's native preprocessing library (`occdepth_tpu_torch/native_ext`)
against its plain NumPy versions and the JAX package's bindings (CPU).

Every comparison runs the same seeded NumPy inputs through the port's C++
binding, the port's plain version and `occdepth_tpu.native_ext`, and is
exact (integer outputs).  Also: the per-frustum class histograms of the
data path against their plain loop, the build's lock under two processes
and its error when g++ fails.
"""
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

import occdepth_tpu.native_ext as jax_ne
from occdepth_tpu.geometry.frustums_mask import (
    compute_frustum_class_dists as jax_frustum_dists,
)
from occdepth_tpu_torch import native_ext as ne
from occdepth_tpu_torch.geometry.frustums_mask import (
    compute_frustum_class_dists,
    compute_frustum_class_dists_plain,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _labels(seed, shape):
    rng = np.random.RandomState(seed)
    lab = rng.choice([0, 1, 2, 3, 7, 200, 255], size=shape,
                     p=[0.55, 0.1, 0.1, 0.05, 0.04, 0.01, 0.15])
    # a few mostly-empty and mostly-255 slabs, so both "empty" winners show
    lab[: shape[0] // 4] = np.where(rng.rand(*lab[: shape[0] // 4].shape)
                                    < 0.97, 0, lab[: shape[0] // 4])
    lab[-(shape[0] // 4):] = np.where(
        rng.rand(*lab[-(shape[0] // 4):].shape) < 0.97, 255,
        lab[-(shape[0] // 4):])
    return lab.astype(np.uint8)


@pytest.mark.parametrize("ds,shape", [(2, (16, 8, 16)), (4, (16, 8, 16)),
                                      (8, (32, 16, 24)), (16, (64, 16, 32))])
def test_downsample_label(ds, shape):
    label = _labels(ds, shape)
    native = ne.downsample_label(label, ds)
    plain = ne.downsample_label_plain(label, ds)
    ref = jax_ne.downsample_label(label, ds)
    assert native.shape == tuple(s // ds for s in shape)
    np.testing.assert_array_equal(native, plain)
    np.testing.assert_array_equal(native, ref)
    np.testing.assert_array_equal(plain, jax_ne._downsample_label_np(label,
                                                                     ds))
    assert {0, 255} <= set(np.unique(native).tolist())
    assert ne.downsample_label(label, 1) is label


def test_rle_decode_and_overflow():
    rng = np.random.RandomState(1)
    n = 400
    vals = rng.choice(np.r_[0:37, 255, 40, 90], size=n).astype(np.uint32)
    runs = rng.randint(0, 30, size=n).astype(np.uint32)
    rle = np.stack([vals, runs], 1).reshape(-1)
    total = int(runs.sum())
    cmap = np.arange(37, dtype=np.uint8) % 12
    native = ne.rle_decode(rle, cmap, total + 5)
    np.testing.assert_array_equal(native, ne.rle_decode_plain(rle, cmap,
                                                              total + 5))
    np.testing.assert_array_equal(native, jax_ne.rle_decode(rle, cmap,
                                                            total + 5))
    assert (native[total:] == 0).all()
    # a trailing unpaired entry is ignored by all three
    odd = np.r_[rle, np.uint32(3)]
    np.testing.assert_array_equal(ne.rle_decode(odd, cmap, total),
                                  ne.rle_decode_plain(odd, cmap, total))
    for fn in (ne.rle_decode, ne.rle_decode_plain, jax_ne.rle_decode):
        with pytest.raises(ValueError, match="RLE overflow"):
            fn(rle, cmap, total - 1)


def test_voxel_vote_with_out_of_range_indices():
    rng = np.random.RandomState(2)
    n = 3000
    vi = rng.randint(-2, 9, size=(n, 3)).astype(np.int32)
    ci = rng.randint(0, 5, size=n).astype(np.int32)
    grid = (7, 5, 6)
    nb, nc = ne.voxel_vote(vi, ci, grid, 5)
    pb, pc = ne.voxel_vote_plain(vi, ci, grid, 5)
    jb, jc = jax_ne.voxel_vote(vi, ci, grid, 5)
    for a, b in ((nb, pb), (nc, pc), (nb, jb), (nc, jc)):
        assert a.dtype == b.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
    assert 0 < nb.sum() < nb.size
    # class ids outside [0, n_classes) occupy a voxel but cast no vote
    bad = np.array([[1, 1, 1], [1, 1, 1], [2, 2, 2]], np.int32)
    cls = np.array([7, 3, -1], np.int32)
    for fn in (ne.voxel_vote, ne.voxel_vote_plain):
        b, c = fn(bad, cls, grid, 5)
        assert b[1, 1, 1] == b[2, 2, 2] == 1
        assert c[1, 1, 1] == 3 and c[2, 2, 2] == 0
    # shapes the C loop would read past are refused before the call
    with pytest.raises(ValueError):
        ne.voxel_vote(vi[:, :2], ci, grid, 5)
    with pytest.raises(ValueError):
        ne.voxel_vote(vi, ci[:-1], grid, 5)


def test_pack_and_unpack_bits():
    rng = np.random.RandomState(3)
    bits = (rng.rand(8 * 1001) > 0.5).astype(np.uint8)
    packed = ne.pack_bits(bits)
    np.testing.assert_array_equal(packed, ne.pack_bits_plain(bits))
    np.testing.assert_array_equal(packed, jax_ne.pack_bits(bits))
    np.testing.assert_array_equal(packed, np.packbits(bits))
    np.testing.assert_array_equal(ne.unpack_bits(packed), bits)
    np.testing.assert_array_equal(ne.unpack_bits_plain(packed), bits)
    np.testing.assert_array_equal(jax_ne.unpack_bits(packed), bits)


def _projections(seed, V, N, W, H):
    rng = np.random.RandomState(seed)
    pix = rng.randint(-10, W + 10, size=(V, N, 1, 2)).astype(np.int64)
    pz = rng.randn(V, N).astype(np.float32)
    # extreme projections (z -> 0+) far past int32: invalid, never wrapped
    far = rng.rand(V, N) < 0.05
    pix[..., 0, 0][far] = rng.choice([2 ** 33 + 3, -(2 ** 35), 2 ** 40],
                                     size=int(far.sum()))
    pix[..., 0, 1][far[::-1]] = 2 ** 32 + 7
    return pix, pz


@pytest.mark.parametrize("V", [1, 2])
def test_frustum_class_dists_binding(V):
    N, C, size, W, H = 4000, 5, 4, 64, 48
    pix, pz = _projections(10 + V, V, N, W, H)
    rng = np.random.RandomState(V)
    cls = rng.randint(0, C, size=N).astype(np.int32)
    cls[rng.rand(N) > 0.9] = 255
    px, py = pix[:, :, 0, 0], pix[:, :, 0, 1]
    native = ne.frustum_class_dists(px, py, pz, cls, size, W, H, C)
    ref = jax_ne.frustum_class_dists(px, py, pz, cls, size, W, H, C)
    plain = compute_frustum_class_dists_plain(
        pix, pz, cls.reshape(20, 20, 10), W, H, "kitti", C, size)
    assert native.dtype == np.float64 and native.shape == (size * size, C)
    np.testing.assert_array_equal(native, ref)
    np.testing.assert_array_equal(native, plain)
    assert 0 < native.sum() < N * V
    with pytest.raises(ValueError):
        ne.frustum_class_dists(px, py[:, :-1], pz, cls, size, W, H, C)
    with pytest.raises(ValueError):
        ne.frustum_class_dists(px, py, pz, cls[:-1], size, W, H, C)
    assert ne.frustum_class_dists(np.zeros((9, 4), np.int32),
                                  np.zeros((9, 4), np.int32),
                                  np.ones((9, 4), np.float32),
                                  np.zeros(4, np.int32), 2, 8, 8, 3) is None


@pytest.mark.parametrize("dataset,V", [("kitti", 2), ("NYU", 2),
                                       ("tartanair", 9)])
def test_compute_frustum_class_dists_native_vs_plain(dataset, V):
    """The data path's histograms (the native pass; more than 8 views take
    the plain loop) against the plain loop and the JAX package's."""
    X, Y, Z = (10, 6, 8) if dataset == "NYU" else (10, 8, 6)
    N, C, size, W, H = X * Y * Z, 6, 4, 40, 30
    pix, pz = _projections(V, V, N, W, H)
    rng = np.random.RandomState(20 + V)
    target = rng.randint(0, C, size=(X, Y, Z)).astype(np.int32)
    target[rng.rand(X, Y, Z) > 0.85] = 255
    pix32 = np.clip(pix, -1, W + H).astype(np.int32)
    ours = compute_frustum_class_dists(pix32, pz, target, W, H, dataset, C,
                                       size)
    plain = compute_frustum_class_dists_plain(pix32, pz, target, W, H,
                                              dataset, C, size)
    ref = jax_frustum_dists(pix32, pz, target, W, H, dataset, C, size)
    np.testing.assert_array_equal(ours, plain)
    np.testing.assert_array_equal(ours, ref)


def test_build_lock_two_processes(tmp_path):
    """Two processes building into one empty directory at once: one
    compiles, the other waits on the lock and loads the same library; no
    temporary file is left behind."""
    build_dir = tmp_path / "native"
    go = tmp_path / "go"
    code = textwrap.dedent(f"""
        import os, time
        from occdepth_tpu_torch import native_ext as ne
        ne._target()  # the compiler queries, before the start line
        while not os.path.exists({str(go)!r}):
            time.sleep(0.005)
        path, seconds = ne.build(build_dir={str(build_dir)!r})
        import ctypes
        ctypes.CDLL(path).pack_bits_u8
        print(path, seconds)
    """)
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=dict(os.environ,
                                                  PYTHONPATH=REPO))
             for _ in range(2)]
    time.sleep(0.5)
    go.write_text("")
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    paths = [out.split()[0] for out, _ in outs]
    seconds = sorted(float(out.split()[1]) for out, _ in outs)
    assert paths[0] == paths[1]
    assert seconds[0] == 0.0 < seconds[1]  # exactly one compiled
    assert sorted(os.listdir(build_dir)) == [".lock",
                                             os.path.basename(paths[0])]


def test_build_raises_when_gxx_fails(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text('extern "C" void f() { not c++ }\n')
    monkeypatch.setattr(ne, "SRC", str(bad))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        ne.build(build_dir=str(tmp_path / "out"))
    assert os.listdir(tmp_path / "out") == [".lock"]
