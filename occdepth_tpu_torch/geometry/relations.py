"""Context-prior relation ground truth (CP mega matrix), NumPy.

A copy of `occdepth_tpu/geometry/relations.py`.  Per relation channel r,
voxel row n (label L_n) and supervoxel column m with the eight child
labels C_m = {c}:

  r=0 "non non same":  exists c != 255 with L_n != 255, c == L_n, c != 0
  r=1 "non non diff":  exists c != 255 with L_n != 255, c != L_n, c != 0, L_n != 0
  r=2 "empty empty":   exists c != 255 with L_n != 255, c == L_n == 0
  r=3 "nonempty empty": exists c != 255 with L_n != 255, c != L_n, (c==0 or L_n==0)

binary mode (n_relations == 2):
  r=0 "diff": exists c != 255 with L_n != 255 and c != L_n
  r=1 "same": exists c != 255 with L_n != 255 and c == L_n
"""
from __future__ import annotations

import numpy as np


def _child_labels(target: np.ndarray) -> np.ndarray:
    """The 8 child labels of each 2x2x2 supervoxel, in the reference's order
    (0,0,0) (1,0,0) (0,1,0) (0,0,1) (1,1,0) (1,0,1) (0,1,1) (1,1,1).

    Returns (M, 8) with M = prod(shape//2), supervoxels flattened row-major.
    """
    sx, sy, sz = (s // 2 for s in target.shape)
    t = target[: sx * 2, : sy * 2, : sz * 2]
    blocks = t.reshape(sx, 2, sy, 2, sz, 2).transpose(0, 2, 4, 1, 3, 5)
    blocks = blocks.reshape(sx * sy * sz, 2, 2, 2)
    order = [(0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1),
             (1, 1, 0), (1, 0, 1), (0, 1, 1), (1, 1, 1)]
    return np.stack([blocks[:, i, j, k] for (i, j, k) in order], axis=1)


def _cp_mega_matrix_broadcast(
    label_row: np.ndarray, children: np.ndarray, is_binary: bool
) -> np.ndarray:
    """(N, M, 8) broadcast form, correct for any label values."""
    row = label_row[:, None, None]
    col = children[None, :, :]
    row_valid = row != 255
    col_valid = col != 255
    if is_binary:
        diff = (row_valid & col_valid & (col != row)).any(axis=2)
        same = (row_valid & col_valid & (col == row)).any(axis=2)
        matrix = np.stack([diff, same])
    else:
        r0 = (row_valid & col_valid & (col == row) & (col != 0)).any(axis=2)
        r1 = (
            row_valid & col_valid & (col != row) & (col != 0) & (row != 0)
        ).any(axis=2)
        r2 = (row_valid & col_valid & (row == col) & (col == 0)).any(axis=2)
        r3 = (
            row_valid & col_valid & (row != col) & ((row == 0) | (col == 0))
        ).any(axis=2)
        matrix = np.stack([r0, r1, r2, r3])
    return matrix.astype(np.uint8)


def compute_cp_mega_matrix(target: np.ndarray,
                           is_binary: bool = False) -> np.ndarray:
    """Relation ground truth of one (X, Y, Z) label grid (255 = invalid).

    Returns (n_rel, N, M) uint8 with N = X*Y*Z, M = prod(dims//2).
    """
    label_row = target.reshape(-1)  # (N,)
    children = _child_labels(target)  # (M, 8)

    # per-supervoxel class-presence bitmask (labels < 32, 255 excluded):
    # every relation becomes an O(N*M) bit test; labels in [32, 255) would
    # alias bits, so they take the broadcast form
    if np.any((label_row >= 32) & (label_row != 255)):
        return _cp_mega_matrix_broadcast(label_row, children, is_binary)
    ch = np.minimum(children, 31).astype(np.uint32)
    mask = np.bitwise_or.reduce(
        np.where(children != 255, np.uint32(1) << ch, np.uint32(0)), axis=1
    )  # (M,)

    L = label_row
    rv = (L != 255)[:, None]  # (N, 1) row valid
    Lbit = (np.uint32(1) << np.minimum(L, 31).astype(np.uint32))[:, None]
    present_L = (mask[None, :] & Lbit) != 0  # (N, M) some valid c == L_n
    if is_binary:
        diff = rv & ((mask[None, :] & ~Lbit) != 0)  # some valid c != L_n
        same = rv & present_L
        matrix = np.stack([diff, same])
    else:
        nonzero_mask = mask & ~np.uint32(1)  # presence of valid c != 0
        Lnz = (L != 0)[:, None]
        has_empty = (mask[None, :] & np.uint32(1)) != 0
        r0 = rv & Lnz & present_L
        r1 = rv & Lnz & ((nonzero_mask[None, :] & ~Lbit) != 0)
        r2 = rv & ~Lnz & has_empty
        r3 = rv & np.where(Lnz, has_empty, (nonzero_mask != 0)[None, :])
        matrix = np.stack([r0, r1, r2, r3])
    return matrix.astype(np.uint8)
