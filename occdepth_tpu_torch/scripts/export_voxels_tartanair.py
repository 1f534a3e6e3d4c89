"""Offline TartanAir voxel-label export CLI.

Counterpart of `occdepth_tpu/scripts/export_voxels_tartanair.py`
(reference occdepth/data/tartanair/export_voxels.py): unproject each
depth map of `depth_left/`, remap the simulator's segmentation ids of
`seg_left/` to the 14 SSC classes, majority-vote a (120, 48, 120) voxel
grid (the port's native scatter in place of numba), majority-pool it to
1/4, and pickle {vox_origin, cam_k, T_velo_2_cam, target_1_1,
target_1_4, fov masks} to
`labels/<scene>/<difficulty>/<seq>/voxels_left/<frame>.pkl` under
data_preprocess_root.  Every 5th frame is exported, with roll/pitch-only
("center") camera poses from `pose_left.txt`; `--workers` frames are
exported in parallel processes.

    python -m occdepth_tpu_torch.scripts.export_voxels_tartanair \\
        --config occdepth_tpu_torch/configs/tartanair/flosp_crp_cascadecls.yaml \\
        [--scene office --difficulty Easy --workers 4 --sequences P000,P005] [k=v ...]
"""
from __future__ import annotations

import argparse
import glob
import os
import pickle
import time
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context

import numpy as np

from occdepth_tpu_torch.config import load_config, parse_overrides
from occdepth_tpu_torch.native_ext import downsample_label, voxel_vote

VOX_ORIGIN = np.array([-6.0, -3.0, 0.0])  # camera coords
VOX_SHAPE = (120, 48, 120)
VOXEL_UNIT = 0.1
INTRINSICS = np.array([[320.0, 0, 320.0], [0, 320.0, 240.0], [0, 0, 1]])
T_BODY_CAM0 = np.array(
    [[0, 0, 1, 0], [1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, 1]], float
)
SEQUENCES = ["P000", "P001", "P002", "P003", "P004", "P005", "P006"]

# simulator seg-id -> (train class id); unmapped ids -> last class ("objs").
TARTANAIR_CLASS_DICT = {
    "empty": (0, [-1]),
    "ceiling": (1, [22, 147]),
    "floor": (2, [139]),
    "wall": (3, [90, 133, 144, 160, 172, 190, 193, 200, 208, 223, 224, 234,
                 244, 231, 239]),
    "window": (4, [101, 146, 231]),
    "chair": (5, [211]),
    "rug": (6, [50, 207]),
    "sofa": (7, [120, 197]),
    "screen": (8, [125, 253]),
    "tvs": (9, [148, 158]),
    "furn": (10, [232, 173, 115, 144, 145, 152, 189, 173, 185, 205]),
    "clock": (11, [28]),
    "bonsai": (12, [137, 249]),
    "objs": (13, [-1]),
}


def seg_remap_lut() -> np.ndarray:
    """256-entry LUT; later dict entries win, unmapped -> n_classes - 1
    (the linear-scan semantics of export_voxels.py find_new_seg:55-63)."""
    lut = np.full(256, len(TARTANAIR_CLASS_DICT) - 1, np.int32)
    for _, (cls_id, seg_ids) in TARTANAIR_CLASS_DICT.items():
        for sid in seg_ids:
            if 0 <= sid < 256:
                lut[sid] = cls_id
    return lut


def rollpitch_pose(pos_quat: np.ndarray) -> np.ndarray:
    """Roll/pitch-only camera pose (export_voxels.py:279-308)."""
    from scipy.spatial.transform import Rotation as R

    SO = R.from_quat(pos_quat[3:7]).as_matrix()
    euler_inv = R.from_matrix(np.linalg.inv(SO)).as_euler("zyx")
    euler_inv[0] = 0.0  # drop yaw
    SO_inv = R.from_euler("zyx", euler_inv).as_matrix()
    T_center_body = np.eye(4)
    T_center_body[:3, :3] = np.linalg.inv(SO_inv)
    return np.linalg.inv(T_BODY_CAM0) @ T_center_body @ T_BODY_CAM0


def read_center_poses(pose_path: str) -> np.ndarray:
    poses = []
    with open(pose_path) as f:
        for line in f:
            vals = np.array(line.split(), dtype=float)
            if vals.size >= 7:
                poses.append(rollpitch_pose(vals))
    return np.stack(poses)


def depth_voxel_indices(depth: np.ndarray, seg: np.ndarray,
                        cam_pose: np.ndarray):
    """Each pixel's (N, 3) int32 voxel index and remapped class id."""
    H, W = depth.shape
    gy, gx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    # NOTE: the reference's jitted meshgrid returns transposed-looking
    # grids; net effect is pixel (h, w) -> x from h, y from w.
    pt_cam = np.stack([
        (gy - INTRINSICS[0, 2]) * depth / INTRINSICS[0, 0],
        (gx - INTRINSICS[1, 2]) * depth / INTRINSICS[1, 1],
        depth,
    ], axis=-1)
    pt = pt_cam.reshape(-1, 3) @ cam_pose[:3, :3].T + cam_pose[:3, 3]
    vox_idx = np.rint((pt - VOX_ORIGIN) / VOXEL_UNIT).astype(np.int32)
    cls = seg_remap_lut()[np.clip(seg.reshape(-1), 0, 255)]
    return vox_idx, cls


def depth_to_voxels(depth: np.ndarray, seg: np.ndarray, cam_pose: np.ndarray):
    """Unproject + majority vote (export_voxels.py:110-168 depth2voxel)."""
    vox_idx, cls = depth_voxel_indices(depth, seg, cam_pose)
    return voxel_vote(vox_idx, cls, VOX_SHAPE, len(TARTANAIR_CLASS_DICT))


def export_frame(args):
    depth_path, seg_path, pose, out_path = args
    depth = np.load(depth_path)
    seg = np.load(seg_path)
    _, voxel_cls = depth_to_voxels(depth, seg, pose)
    target_1_4 = downsample_label(voxel_cls, 4)
    out = {
        "vox_origin": VOX_ORIGIN,
        "cam_k": INTRINSICS,
        "T_velo_2_cam": np.linalg.inv(pose),
        "fov_mask_1_1": voxel_cls.reshape(-1) > 0,
        "target_1_1": voxel_cls,
        "target_1_4": target_1_4,
        "fov_mask_1_4": target_1_4.reshape(-1) > 0,
    }
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
    return out_path


def export_sequence(data_root, out_root, scene, difficulty, sequence,
                    workers: int = 4) -> list:
    """Export every 5th frame of one sequence; returns the paths written."""
    seq_dir = os.path.join(data_root, scene, difficulty, sequence)
    out_dir = os.path.join(out_root, "labels", scene, difficulty, sequence,
                           "voxels_left")
    os.makedirs(out_dir, exist_ok=True)
    poses = read_center_poses(os.path.join(seq_dir, "pose_left.txt"))
    jobs = []
    for depth_path in sorted(glob.glob(os.path.join(
        seq_dir, "depth_left", "*.npy"
    ))):
        frame_id = os.path.basename(depth_path).split("_")[0]
        if int(frame_id) % 5 != 0:
            continue
        seg_path = os.path.join(seq_dir, "seg_left",
                                frame_id + "_left_seg.npy")
        out_path = os.path.join(out_dir, frame_id + ".pkl")
        jobs.append((depth_path, seg_path, poses[int(frame_id)], out_path))
    written = []
    if workers > 1:
        # spawned, not forked: the parent may hold BLAS threads
        with ProcessPoolExecutor(max_workers=workers,
                                 mp_context=get_context("spawn")) as pool:
            for p in pool.map(export_frame, jobs):
                print("wrote", p)
                written.append(p)
    else:
        for job in jobs:
            written.append(export_frame(job))
            print("wrote", written[-1])
    return written


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--scene", default="office")
    ap.add_argument("--difficulty", default="Easy")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--sequences", default=",".join(SEQUENCES),
                    help="comma-separated (all by default)")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)
    cfg = load_config(args.config, parse_overrides(args.overrides))
    t0 = time.perf_counter()
    written = []
    for seq in args.sequences.split(","):
        written += export_sequence(cfg.data_root, cfg.data_preprocess_root,
                                   args.scene, args.difficulty, seq,
                                   args.workers)
    seconds = time.perf_counter() - t0
    print(f"export_voxels_tartanair: {len(written)} frames in "
          f"{seconds:.3f} s ({seconds / max(1, len(written)):.4f} s/frame, "
          f"workers={args.workers})")
    return written


if __name__ == "__main__":
    main()
