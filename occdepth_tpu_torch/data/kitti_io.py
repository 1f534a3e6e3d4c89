"""SemanticKITTI voxel IO: bit unpack, label remap, calib parsing.

A copy of `occdepth_tpu/data/kitti_io.py` (reference
occdepth/data/semantic_kitti/io_data.py and kitti_dataset.py:428-450);
the bit (un)packing runs in the port's native library, as the JAX
package's does.  The learning maps are dataset metadata from the
semantic-kitti.yaml spec.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np

from occdepth_tpu_torch.native_ext import unpack_bits


# raw semantic-kitti label id -> train id (0 empty, 1..19 classes)
LEARNING_MAP: Dict[int, int] = {
    0: 0, 1: 0, 10: 1, 11: 2, 13: 5, 15: 3, 16: 5, 18: 4, 20: 5, 30: 6,
    31: 7, 32: 8, 40: 9, 44: 10, 48: 11, 49: 12, 50: 13, 51: 14, 52: 0,
    60: 9, 70: 15, 71: 16, 72: 17, 80: 18, 81: 19, 99: 0, 252: 1, 253: 7,
    254: 6, 255: 8, 256: 5, 257: 5, 258: 4, 259: 5,
}
# train id -> raw label id (for benchmark submissions)
LEARNING_MAP_INV: Dict[int, int] = {
    0: 0, 1: 10, 2: 11, 3: 15, 4: 18, 5: 20, 6: 30, 7: 31, 8: 32, 9: 40,
    10: 44, 11: 48, 12: 49, 13: 50, 14: 51, 15: 70, 16: 71, 17: 72,
    18: 80, 19: 81,
}

SCENE_DIMS = (256, 256, 32)
TRAIN_SEQUENCES = ["00", "01", "02", "03", "04", "05", "06", "07", "09", "10"]
VAL_SEQUENCES = ["08"]
TEST_SEQUENCES = ["11", "12", "13", "14", "15", "16", "17", "18", "19", "20", "21"]


def get_remap_lut() -> np.ndarray:
    """LUT raw->train id; raw classes mapping to 0 (except true empty)
    become 255 invalid (io_data.py:81-100)."""
    maxkey = max(LEARNING_MAP.keys())
    lut = np.zeros(maxkey + 100, dtype=np.int32)
    lut[list(LEARNING_MAP.keys())] = list(LEARNING_MAP.values())
    lut[lut == 0] = 255
    lut[0] = 0
    return lut


def get_inv_map() -> np.ndarray:
    inv = np.zeros(20, dtype=np.int32)
    inv[list(LEARNING_MAP_INV.keys())] = list(LEARNING_MAP_INV.values())
    return inv


def read_label(path: str) -> np.ndarray:
    """uint16 semantic labels, flattened 256*256*32."""
    return np.fromfile(path, dtype=np.uint16).astype(np.float32)


def read_invalid(path: str) -> np.ndarray:
    return unpack_bits(np.fromfile(path, dtype=np.uint8))


def read_occupancy(path: str) -> np.ndarray:
    return unpack_bits(np.fromfile(path, dtype=np.uint8)).astype(np.float32)


def read_occluded(path: str) -> np.ndarray:
    return unpack_bits(np.fromfile(path, dtype=np.uint8))


def read_calib(calib_path: str) -> Dict[str, np.ndarray]:
    """Parse a KITTI odometry calib.txt -> {P2, P3, Tr} matrices."""
    raw = {}
    with open(calib_path) as f:
        for line in f:
            if line.strip() == "":
                break
            key, value = line.split(":", 1)
            raw[key] = np.array([float(x) for x in value.split()])
    out = {
        "P2": raw["P2"].reshape(3, 4),
        "P3": raw["P3"].reshape(3, 4),
    }
    Tr = np.identity(4)
    Tr[:3, :4] = raw["Tr"].reshape(3, 4)
    out["Tr"] = Tr
    return out


def camera_geometry(calib: Dict[str, np.ndarray]):
    """Per-camera intrinsics + lidar->cam transforms for cam2 and cam3.

    Derives T_velo_2_cam_i = K_i^-1 @ (P_i @ Tr) per view, the reference's
    "external parameter transformation" fix (kitti_dataset.py:136-148).
    """
    P = np.stack([calib["P2"], calib["P3"]])
    Tr = calib["Tr"]
    cam_k = P[:, :3, :3]
    T = []
    for i in range(2):
        proj = P[i] @ Tr
        Ti = np.identity(4)
        Ti[:3, :4] = np.linalg.inv(cam_k[i]) @ proj
        T.append(Ti)
    return cam_k, np.stack(T)


COLOR_MAP_BGR = {
    0: (0, 0, 0), 1: (245, 150, 100), 2: (245, 230, 100), 3: (150, 60, 30),
    4: (180, 30, 80), 5: (255, 0, 0), 6: (30, 30, 255), 7: (200, 40, 255),
    8: (90, 30, 150), 9: (255, 0, 255), 10: (255, 150, 255),
    11: (75, 0, 75), 12: (75, 0, 175), 13: (0, 200, 255), 14: (50, 120, 255),
    15: (0, 175, 0), 16: (0, 60, 135), 17: (80, 240, 150), 18: (150, 240, 255),
    19: (0, 0, 255),
}
