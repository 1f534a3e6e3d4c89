"""Offline NYUv2 label preprocessing CLI.

Counterpart of `occdepth_tpu/scripts/preprocess_nyu.py` (reference
occdepth/data/NYU/preprocess.py): read each RLE-compressed voxel scan
`NYU<split>/<name>.bin` (float32[3] voxel origin, float32[16] camera
pose, then uint32 (37-class value, run) pairs), decode it to the
240x144x240 grid with the 37 -> 12 class remap, majority-pool it to 1/4
and 1/16, and pickle {cam_pose, voxel_origin, name, target_1_4,
target_1_16} to `base/NYU<split>/<name>.pkl` under data_preprocess_root.
The decoding and the pooling run in the port's native library; scans
whose pickle exists are skipped.

    python -m occdepth_tpu_torch.scripts.preprocess_nyu --config <yaml> [k=v ...]
"""
from __future__ import annotations

import argparse
import glob
import os
import pickle
import time

import numpy as np

from occdepth_tpu_torch.config import load_config, parse_overrides
from occdepth_tpu_torch.native_ext import downsample_label, rle_decode

SCENE_SIZE = (240, 144, 240)

# 37-class NYU ids -> 12 SSC train classes (NYU/preprocess.py:11-49)
SEG_CLASS_MAP = np.array([
    0, 1, 2, 3, 4, 11, 5, 6, 7, 8, 8, 10, 10, 10, 11, 11, 9, 8, 11, 11,
    11, 11, 11, 11, 11, 11, 11, 10, 10, 11, 8, 10, 11, 9, 11, 11, 11,
], np.uint8)


def read_rle_bin(path: str):
    """.bin layout: float32[3] vox_origin, float32[16] cam_pose, uint32[] RLE."""
    with open(path, "rb") as f:
        vox_origin = np.fromfile(f, np.float32, 3)
        cam_pose = np.fromfile(f, np.float32, 16).reshape(4, 4)
        rle = np.fromfile(f, np.uint32)
    return vox_origin, cam_pose, rle


def preprocess_scan(path: str) -> dict:
    vox_origin, cam_pose, rle = read_rle_bin(path)
    n_vox = SCENE_SIZE[0] * SCENE_SIZE[1] * SCENE_SIZE[2]
    target_1_1 = rle_decode(rle, SEG_CLASS_MAP, n_vox).reshape(SCENE_SIZE)
    return {
        "cam_pose": cam_pose,
        "voxel_origin": vox_origin,
        "name": os.path.splitext(os.path.basename(path))[0],
        "target_1_4": downsample_label(target_1_1, 4),
        "target_1_16": downsample_label(target_1_1, 16),
    }


def preprocess(data_root: str, out_root: str) -> list:
    """Pickle every scan of NYUtrain and NYUtest; returns the paths
    written (skipped scans are not listed)."""
    written = []
    for split in ("train", "test"):
        root = os.path.join(data_root, "NYU" + split)
        base_dir = os.path.join(out_root, "base", "NYU" + split)
        os.makedirs(base_dir, exist_ok=True)
        for scan in sorted(glob.glob(os.path.join(root, "*.bin"))):
            name = os.path.splitext(os.path.basename(scan))[0]
            out_path = os.path.join(base_dir, name + ".pkl")
            if os.path.exists(out_path):
                continue
            data = preprocess_scan(scan)
            with open(out_path, "wb") as f:
                pickle.dump(data, f)
            print("wrote", out_path)
            written.append(out_path)
    return written


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)
    cfg = load_config(args.config, parse_overrides(args.overrides))
    t0 = time.perf_counter()
    written = preprocess(cfg.data_root, cfg.data_preprocess_root)
    seconds = time.perf_counter() - t0
    print(f"preprocess_nyu: {len(written)} scans in {seconds:.3f} s "
          f"({seconds / max(1, len(written)):.4f} s/frame)")
    return written


if __name__ == "__main__":
    main()
