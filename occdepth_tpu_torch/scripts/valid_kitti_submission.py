"""Validate a SemanticKITTI SSC submission archive or directory.

The port's copy of `occdepth_tpu/scripts/valid_kitti_submission.py`
(reference occdepth/scripts/valid_kitti_submission.py:29-279), on the
port's `kitti_io`: checks the zip/directory structure
(sequences/11..21/predictions/*.label), each file's voxel count (256 x 256
x 32 uint16) and that every label is a valid raw id:

    python -m occdepth_tpu_torch.scripts.valid_kitti_submission PATH[.zip]
"""
from __future__ import annotations

import argparse
import os
import zipfile

import numpy as np

from occdepth_tpu_torch.data.kitti_io import LEARNING_MAP_INV, TEST_SEQUENCES

N_VOXELS = 256 * 256 * 32
VALID_RAW_IDS = set(LEARNING_MAP_INV.values())


def _check_label_bytes(data: bytes, name: str, errors: list) -> None:
    if len(data) != N_VOXELS * 2:
        errors.append(
            f"{name}: expected {N_VOXELS * 2} bytes (uint16 x 256x256x32), "
            f"got {len(data)}"
        )
        return
    labels = np.frombuffer(data, dtype=np.uint16)
    bad = set(np.unique(labels).tolist()) - VALID_RAW_IDS
    if bad:
        errors.append(f"{name}: invalid raw label ids {sorted(bad)[:10]}")


def validate_dir(root: str) -> list:
    errors = []
    for seq in TEST_SEQUENCES:
        pred_dir = os.path.join(root, "sequences", seq, "predictions")
        if not os.path.isdir(pred_dir):
            errors.append(f"missing directory sequences/{seq}/predictions")
            continue
        files = [f for f in os.listdir(pred_dir) if f.endswith(".label")]
        if not files:
            errors.append(f"sequences/{seq}/predictions has no .label files")
        for fname in sorted(files):
            with open(os.path.join(pred_dir, fname), "rb") as f:
                _check_label_bytes(f.read(), f"{seq}/{fname}", errors)
    return errors


def validate_zip(path: str) -> list:
    errors = []
    with zipfile.ZipFile(path) as zf:
        by_seq = {}
        for n in set(zf.namelist()):
            parts = n.strip("/").split("/")
            if (
                len(parts) == 4 and parts[0] == "sequences"
                and parts[2] == "predictions" and parts[3].endswith(".label")
            ):
                by_seq.setdefault(parts[1], []).append(n)
        for seq in TEST_SEQUENCES:
            if seq not in by_seq:
                errors.append(f"zip missing sequences/{seq}/predictions/*.label")
                continue
            for n in sorted(by_seq[seq]):
                _check_label_bytes(zf.read(n), n, errors)
    return errors


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("path", help=".zip archive or submission directory")
    args = ap.parse_args(argv)
    errors = (validate_zip(args.path) if args.path.endswith(".zip")
              else validate_dir(args.path))
    if errors:
        for e in errors:
            print("ERROR:", e)
        raise SystemExit(1)
    print("submission OK")


if __name__ == "__main__":
    main()
