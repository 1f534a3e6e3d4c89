"""ctypes bindings of the port's native preprocessing library, with plain
NumPy versions beside them.

The counterpart of `occdepth_tpu/native_ext.py`: majority label pooling,
RLE decoding, the per-voxel class vote, SemanticKITTI bit (un)packing and
the per-frustum class histograms run in host C++
(`native/preprocess_kernels.cpp`, a plain `extern "C"` interface, no
pybind11).  The library is compiled with g++ at its first use, never at
import, into `build/native/` at the repo root (listed in .gitignore),
named by a hash of the source, the flags and what `-march=native` means
on this host, so a checkout copied to another machine builds its own.
Concurrent first uses (pytest-xdist workers, torchrun ranks, the
`Loader`'s threads) compile once: the build holds a file lock, writes a
temporary file and renames it into place.

There is no quiet fallback: when the library cannot be built, the
bindings raise.  Each binding's plain NumPy version (`*_plain`) has the
same contract; the tests hold one to the other.

    python -m occdepth_tpu_torch.native_ext build   # force a build
"""
from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import subprocess
import tempfile
import time
from typing import Optional, Tuple

import numpy as np

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native",
                   "preprocess_kernels.cpp")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "build", "native",
)
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")


@functools.lru_cache(maxsize=None)
def _target() -> bytes:
    """The compiler's version and what -march=native resolves to here."""
    out = b""
    for cmd in (["g++", "--version"],
                ["g++", "-march=native", "-Q", "--help=target"]):
        try:
            out += subprocess.run(cmd, capture_output=True,
                                  check=True).stdout
        except (OSError, subprocess.CalledProcessError) as e:
            raise RuntimeError(f"g++ is needed to build {SRC}: {e}") from e
    return out


def library_path(build_dir: str = BUILD_DIR) -> str:
    """Where the library of this source, these flags and this host lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SRC, "rb") as f:
        h.update(f.read())
    h.update(_target())
    return os.path.join(build_dir,
                        f"libocc_preprocess-{h.hexdigest()[:16]}.so")


def build(force: bool = False, build_dir: str = BUILD_DIR) -> tuple:
    """Compile the library unless it exists (or `force`).

    Returns (library path, seconds spent compiling: 0 when another process
    or an earlier run had built it).  Raises when g++ fails.
    """
    lib_path = library_path(build_dir)
    if os.path.exists(lib_path) and not force:
        return lib_path, 0.0
    os.makedirs(build_dir, exist_ok=True)
    with open(os.path.join(build_dir, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(lib_path) and not force:
            return lib_path, 0.0  # built while this process waited
        t0 = time.perf_counter()
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
        os.close(fd)
        try:
            proc = subprocess.run(["g++", *CXX_FLAGS, SRC, "-o", tmp],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"g++ failed ({proc.returncode}) on {SRC}:\n"
                    f"{proc.stderr[-4000:]}")
            os.replace(tmp, lib_path)  # a reader never sees half a file
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        return lib_path, time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded library (built first if needed) with its argtypes set."""
    lib = ctypes.CDLL(build()[0])
    i64 = ctypes.c_int64

    def ptr(dtype):
        return np.ctypeslib.ndpointer(dtype, flags="C_CONTIGUOUS")

    u8p, u32p, i32p = ptr(np.uint8), ptr(np.uint32), ptr(np.int32)
    f32p, i64p = ptr(np.float32), ptr(np.int64)
    lib.downsample_label_u8.argtypes = [u8p, i64, i64, i64, i64, u8p]
    lib.downsample_label_u8.restype = None
    lib.rle_decode_u8.argtypes = [u32p, i64, u8p, i64, u8p, i64]
    lib.rle_decode_u8.restype = i64
    lib.voxel_vote_u8.argtypes = [
        i32p, i32p, i64, i64, i64, i64, i64, i32p, u8p, u8p,
    ]
    lib.voxel_vote_u8.restype = None
    lib.unpack_bits_u8.argtypes = [u8p, i64, u8p]
    lib.unpack_bits_u8.restype = None
    lib.pack_bits_u8.argtypes = [u8p, i64, u8p]
    lib.pack_bits_u8.restype = None
    lib.frustum_class_dists_i32.argtypes = [
        i32p, i32p, f32p, i32p, i64, i64, i64, i64, i64, i64, i64p,
    ]
    lib.frustum_class_dists_i32.restype = None
    return lib


# ---------------------------------------------------------------------------
# Majority pooling (reference NYU/preprocess.py:102-143; KITTI's 1_8 labels)
# ---------------------------------------------------------------------------

def downsample_label(label: np.ndarray, ds: int) -> np.ndarray:
    """Majority-pool (X, Y, Z) uint8 labels by `ds`.

    Per ds^3 block: when zeros and 255s together exceed 95% of it, the
    block is 0 or 255, whichever is more frequent (ties 255); otherwise
    the most frequent label in 1..254 (ties the smallest).
    """
    if ds == 1:
        return label
    lab = np.ascontiguousarray(label, dtype=np.uint8)
    X, Y, Z = lab.shape
    out = np.empty((X // ds, Y // ds, Z // ds), np.uint8)
    library().downsample_label_u8(lab, X, Y, Z, ds, out)
    return out


def downsample_label_plain(label: np.ndarray, ds: int) -> np.ndarray:
    """`downsample_label` in NumPy: a one-hot histogram per block (its
    temporaries are (blocks, ds^3, 256) bools: keep the shapes small)."""
    if ds == 1:
        return label
    label = np.ascontiguousarray(label, dtype=np.uint8)
    X, Y, Z = label.shape
    sx, sy, sz = X // ds, Y // ds, Z // ds
    blocks = label[: sx * ds, : sy * ds, : sz * ds].reshape(
        sx, ds, sy, ds, sz, ds
    ).transpose(0, 2, 4, 1, 3, 5).reshape(sx, sy, sz, -1)
    n = blocks.shape[-1]
    counts = (
        blocks[..., None] == np.arange(256, dtype=blocks.dtype)
    ).sum(axis=3)
    zero_count = counts[..., 0] + counts[..., 255]
    empty = zero_count > 0.95 * n
    zero_winner = np.where(counts[..., 0] > counts[..., 255], 0, 255)
    sem = counts[..., 1:255]
    sem_winner = sem.argmax(axis=-1) + 1
    return np.where(empty, zero_winner, sem_winner).astype(np.uint8)


# ---------------------------------------------------------------------------
# NYU RLE decoding (reference NYU/preprocess.py:49-77)
# ---------------------------------------------------------------------------

def rle_decode(rle: np.ndarray, class_map: np.ndarray,
               n_voxels: int) -> np.ndarray:
    """Decode uint32 (value, run) pairs into `n_voxels` uint8 labels,
    remapping values through `class_map` (255 and values past the map
    become 255).  Raises ValueError when the runs overflow `n_voxels`."""
    rle = np.ascontiguousarray(rle, dtype=np.uint32)
    cmap = np.ascontiguousarray(class_map, dtype=np.uint8)
    out = np.zeros(n_voxels, np.uint8)
    written = library().rle_decode_u8(rle, rle.size, cmap, cmap.size, out,
                                      n_voxels)
    if written > n_voxels:
        raise ValueError(f"RLE overflow: {written} > {n_voxels}")
    return out


def rle_decode_plain(rle: np.ndarray, class_map: np.ndarray,
                     n_voxels: int) -> np.ndarray:
    """`rle_decode` in NumPy, one slice assignment per run."""
    rle = np.ascontiguousarray(rle, dtype=np.uint32)
    cmap = np.ascontiguousarray(class_map, dtype=np.uint8)
    out = np.zeros(n_voxels, np.uint8)
    idx = 0
    n_pairs = rle.size // 2
    for v, r in zip(rle[:2 * n_pairs:2], rle[1:2 * n_pairs:2]):
        lab = 255 if (v == 255 or v >= cmap.size) else cmap[v]
        if idx + int(r) > n_voxels:
            raise ValueError(f"RLE overflow: {idx + int(r)} > {n_voxels}")
        out[idx: idx + r] = lab
        idx += int(r)
    return out


# ---------------------------------------------------------------------------
# TartanAir per-voxel class vote (reference tartanair/export_voxels.py:
# 110-168, its depth2voxel scatter)
# ---------------------------------------------------------------------------

def voxel_vote(vox_idx: np.ndarray, cls: np.ndarray,
               grid: Tuple[int, int, int],
               n_classes: int) -> Tuple[np.ndarray, np.ndarray]:
    """Scatter (N, 3) voxel indices with class ids into an (X, Y, Z) grid:
    (occupied uint8, majority class uint8; ties the smallest class).
    Points outside the grid are dropped; class ids outside
    [0, n_classes) mark the voxel occupied but cast no vote."""
    vox_idx = np.ascontiguousarray(vox_idx, dtype=np.int32)
    cls = np.ascontiguousarray(cls, dtype=np.int32).reshape(-1)
    if vox_idx.ndim != 2 or vox_idx.shape[1] != 3 or (
            cls.size != vox_idx.shape[0]):
        raise ValueError(f"voxel_vote: vox_idx {vox_idx.shape} must be "
                         f"(N, 3) and cls {cls.shape} (N,)")
    X, Y, Z = grid
    counts = np.empty((X * Y * Z * n_classes,), np.int32)
    binary = np.empty((X, Y, Z), np.uint8)
    vcls = np.empty((X, Y, Z), np.uint8)
    library().voxel_vote_u8(
        vox_idx.reshape(-1), cls, vox_idx.shape[0], X, Y, Z, n_classes,
        counts, binary.reshape(-1), vcls.reshape(-1),
    )
    return binary, vcls


def voxel_vote_plain(vox_idx: np.ndarray, cls: np.ndarray,
                     grid: Tuple[int, int, int],
                     n_classes: int) -> Tuple[np.ndarray, np.ndarray]:
    """`voxel_vote` in NumPy (`np.add.at` into a dense count grid)."""
    vox_idx = np.asarray(vox_idx, dtype=np.int32)
    cls = np.asarray(cls, dtype=np.int32)
    X, Y, Z = grid
    binary = np.zeros((X, Y, Z), np.uint8)
    counts = np.zeros((X, Y, Z, n_classes), np.int32)
    ok = (
        (vox_idx[:, 0] >= 0) & (vox_idx[:, 0] < X)
        & (vox_idx[:, 1] >= 0) & (vox_idx[:, 1] < Y)
        & (vox_idx[:, 2] >= 0) & (vox_idx[:, 2] < Z)
    )
    vi = vox_idx[ok]
    ci = cls[ok]
    binary[vi[:, 0], vi[:, 1], vi[:, 2]] = 1
    votes = (ci >= 0) & (ci < n_classes)
    vi, ci = vi[votes], ci[votes]
    np.add.at(counts, (vi[:, 0], vi[:, 1], vi[:, 2], ci), 1)
    vcls = np.where(binary > 0, counts.argmax(axis=-1), 0).astype(np.uint8)
    return binary, vcls


# ---------------------------------------------------------------------------
# Per-frustum class histograms (reference helpers.compute_local_frustums,
# occdepth/data/utils/helpers.py:183-260), one pass over the voxels
# ---------------------------------------------------------------------------

def frustum_class_dists(
    px: np.ndarray, py: np.ndarray, pz: np.ndarray, cls: np.ndarray,
    size: int, img_W: int, img_H: int, n_classes: int,
) -> Optional[np.ndarray]:
    """(size^2, n_classes) float64 class counts of the image tiles.

    px/py (V, N) pixel coordinates, pz (V, N) depths, cls (N,) labels
    (255 = ignore); a voxel seen by several views in one tile counts once.
    Returns None for V > 8: the caller takes its NumPy loop
    (`geometry/frustums_mask.py`).
    """
    V, N = px.shape
    if py.shape != (V, N) or pz.shape != (V, N) or cls.size != N:
        raise ValueError(f"frustum_class_dists: px {px.shape}, py "
                         f"{py.shape}, pz {pz.shape} must be (V, N) and cls "
                         f"{cls.shape} hold N labels")
    if V > 8:
        return None
    # clip BEFORE narrowing to int32: extreme projections (z ~ 0+) can
    # exceed int32 and must stay invalid rather than wrap into range;
    # clipping to [-1, dim] keeps the validity predicate exact
    px = np.ascontiguousarray(np.clip(px, -1, img_W), dtype=np.int32)
    py = np.ascontiguousarray(np.clip(py, -1, img_H), dtype=np.int32)
    pz = np.ascontiguousarray(pz, dtype=np.float32)
    cls = np.ascontiguousarray(cls.reshape(-1), dtype=np.int32)
    out = np.zeros(size * size * n_classes, np.int64)
    library().frustum_class_dists_i32(
        px.reshape(-1), py.reshape(-1), pz.reshape(-1), cls, V, N, size,
        img_W, img_H, n_classes, out,
    )
    return out.reshape(size * size, n_classes).astype(np.float64)


# ---------------------------------------------------------------------------
# SemanticKITTI voxel bitmaps (reference semantic_kitti/io_data.py:10-42)
# ---------------------------------------------------------------------------

def unpack_bits(packed: np.ndarray) -> np.ndarray:
    """1 byte -> 8 voxels, MSB first."""
    packed = np.ascontiguousarray(packed, dtype=np.uint8).reshape(-1)
    out = np.empty(packed.size * 8, np.uint8)
    library().unpack_bits_u8(packed, packed.size, out)
    return out


def unpack_bits_plain(packed: np.ndarray) -> np.ndarray:
    return np.unpackbits(np.ascontiguousarray(packed, dtype=np.uint8))


def pack_bits(bits: np.ndarray) -> np.ndarray:
    """8 voxels -> 1 byte, MSB first (a trailing partial byte is dropped)."""
    bits = np.ascontiguousarray(bits.reshape(-1), dtype=np.uint8)
    out = np.empty(bits.size // 8, np.uint8)
    library().pack_bits_u8(bits, bits.size // 8, out)
    return out


def pack_bits_plain(bits: np.ndarray) -> np.ndarray:
    bits = np.ascontiguousarray(bits.reshape(-1), dtype=np.uint8)
    return np.packbits(bits[: bits.size // 8 * 8])


if __name__ == "__main__":
    import sys

    if sys.argv[1:] != ["build"]:
        raise SystemExit("usage: python -m occdepth_tpu_torch.native_ext "
                         "build")
    path, seconds = build(force=True)
    print(f"{path} ({seconds:.2f} s)")
