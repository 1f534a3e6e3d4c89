"""Offline SemanticKITTI label preprocessing CLI.

Counterpart of `occdepth_tpu/scripts/preprocess_kitti.py` (reference
occdepth/data/semantic_kitti/preprocess.py): remap each frame's raw
`voxels/<frame>.label` through the learning map (0 -> empty, unmapped ->
255), set the voxels of `<frame>.invalid` to 255, and write
`labels/<seq>/<frame>_1_1.npy` plus the majority-pooled
`<frame>_1_8.npy` under data_preprocess_root.  The pooling runs in the
port's native library (numba in the reference); frames whose two files
exist are skipped.

    python -m occdepth_tpu_torch.scripts.preprocess_kitti \\
        --config occdepth_tpu_torch/configs/semantic_kitti/multicam_flospdepth_crp_stereodepth_cascadecls.yaml \\
        [--sequences 00,08] [data_root=... data_preprocess_root=...]
"""
from __future__ import annotations

import argparse
import glob
import os
import time

import numpy as np

from occdepth_tpu_torch.config import load_config, parse_overrides
from occdepth_tpu_torch.data import kitti_io
from occdepth_tpu_torch.native_ext import downsample_label

SEQUENCES = ["00", "01", "02", "03", "04", "05", "06", "07", "08", "09", "10"]


def preprocess(data_root: str, out_root: str, sequences=SEQUENCES) -> list:
    """Write the labels of `sequences`; returns the `_1_1.npy` paths
    written (skipped frames are not listed)."""
    remap_lut = kitti_io.get_remap_lut()
    written = []
    for seq in sequences:
        seq_path = os.path.join(data_root, "dataset", "sequences", seq)
        label_paths = sorted(glob.glob(os.path.join(seq_path, "voxels",
                                                    "*.label")))
        invalid_paths = sorted(glob.glob(os.path.join(seq_path, "voxels",
                                                      "*.invalid")))
        out_dir = os.path.join(out_root, "labels", seq)
        os.makedirs(out_dir, exist_ok=True)
        for label_path, invalid_path in zip(label_paths, invalid_paths):
            frame_id = os.path.splitext(os.path.basename(label_path))[0]
            out_1_1 = os.path.join(out_dir, frame_id + "_1_1.npy")
            out_1_8 = os.path.join(out_dir, frame_id + "_1_8.npy")
            if os.path.exists(out_1_1) and os.path.exists(out_1_8):
                continue
            raw = np.fromfile(label_path, dtype=np.uint16)
            invalid = kitti_io.read_invalid(invalid_path)
            label = remap_lut[raw.astype(np.int64)].astype(np.int32)
            label[invalid == 1] = 255
            label = label.reshape(kitti_io.SCENE_DIMS)
            np.save(out_1_1, label.astype(np.uint8))
            np.save(out_1_8, downsample_label(label.astype(np.uint8), 8))
            print("wrote", out_1_1)
            written.append(out_1_1)
    return written


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--sequences", default=",".join(SEQUENCES),
                    help="comma-separated (all by default)")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)
    cfg = load_config(args.config, parse_overrides(args.overrides))
    t0 = time.perf_counter()
    written = preprocess(cfg.data_root, cfg.data_preprocess_root,
                         args.sequences.split(","))
    seconds = time.perf_counter() - t0
    print(f"preprocess_kitti: {len(written)} frames in {seconds:.3f} s "
          f"({seconds / max(1, len(written)):.4f} s/frame)")
    return written


if __name__ == "__main__":
    main()
