"""TartanAir stereo indoor-sim dataset -> fixed-schema batches (NumPy, PIL).

A copy of `occdepth_tpu/data/tartanair.py` (reference occdepth/data/
tartanair/tartanair_dataset.py) on the port's own NumPy geometry:
quaternion pose files -> SE3, the NED -> camera axis remap, per-view
vox2pix at the full grid, and the pickled voxel targets written by the
export_voxels CLI.  The right view's extrinsic comes from the first poses
of `pose_left.txt` and `pose_right.txt`; augmentation draws come from a
per-(seed, epoch, index) RandomState.  Samples are equal, key for key, to
the JAX package's for the same tree, split, seed and epoch.
"""
from __future__ import annotations

import glob
import os
import pickle
from typing import Dict, List

import numpy as np

from occdepth_tpu_torch.config import OccDepthConfig
from occdepth_tpu_torch.data.augment import (
    color_jitter,
    flip_projected_pix,
    ida_matrix,
    normalize_rgb,
    sample_rng,
)
from occdepth_tpu_torch.data.kitti import collate as collate  # same schema
from occdepth_tpu_torch.geometry.frustums_mask import compute_frustum_class_dists
from occdepth_tpu_torch.geometry.projection import vox2pix
from occdepth_tpu_torch.geometry.relations import compute_cp_mega_matrix

IMG_W, IMG_H = 640, 480
INTRINSICS = np.array([[320.0, 0, 320.0], [0, 320.0, 240.0], [0, 0, 1]])
# camera axes inside the NED body frame (tartanair_dataset.py:83-90)
T_CAM_2_BODY = np.array(
    [[0, 0, 1, 0], [1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, 1]], float
)
TRAIN_SEQUENCES = ["P000", "P001", "P002", "P003", "P004", "P006"]
VAL_SEQUENCES = ["P005"]


def quat_to_se3(pos_quat: np.ndarray) -> np.ndarray:
    """[x y z qx qy qz qw] -> 4x4 SE3 (unnormalised quaternions allowed)."""
    x, y, z = pos_quat[:3]
    qx, qy, qz, qw = pos_quat[3:7]
    n = qx * qx + qy * qy + qz * qz + qw * qw
    s = 0.0 if n == 0 else 2.0 / n
    wx, wy, wz = s * qw * qx, s * qw * qy, s * qw * qz
    xx, xy, xz = s * qx * qx, s * qx * qy, s * qx * qz
    yy, yz, zz = s * qy * qy, s * qy * qz, s * qz * qz
    se = np.eye(4)
    se[:3, :3] = [
        [1 - (yy + zz), xy - wz, xz + wy],
        [xy + wz, 1 - (xx + zz), yz - wx],
        [xz - wy, yz + wx, 1 - (xx + yy)],
    ]
    se[:3, 3] = (x, y, z)
    return se


def read_poses(pose_path: str) -> np.ndarray:
    """(n, 4, 4) SE3 of a pose file's lines of at least 7 numbers."""
    poses = []
    with open(pose_path) as f:
        for line in f:
            vals = np.array(line.split(), dtype=float)
            if vals.size >= 7:
                poses.append(quat_to_se3(vals))
    return np.stack(poses)


class TartanAirDataset:
    """Map-style dataset of one scene and difficulty: train is sequences
    P000-P004 and P006, val P005 (sequences absent on disk are skipped)."""

    def __init__(
        self,
        cfg: OccDepthConfig,
        split: str,
        scene: str = "office",
        scene_difficulty: str = "Easy",
        color_jitter_params=(0.4, 0.4, 0.4),
        fliplr: float = 0.0,
        seed: int = 42,
    ):
        self.cfg = cfg
        self.split = split
        self.root = cfg.data_root
        self.label_root = os.path.join(cfg.data_preprocess_root, "labels")
        self.scene = scene
        self.difficulty = scene_difficulty
        self.fliplr = fliplr
        self.color_jitter_params = (
            color_jitter_params if split == "train" else None)
        self.epoch = 0
        self.seed = seed
        self.scene_size = (np.asarray(cfg.full_scene_size, float)
                           * cfg.voxel_size_meters)

        seqs = TRAIN_SEQUENCES if split == "train" else VAL_SEQUENCES
        self.scans: List[Dict] = []
        for seq in seqs:
            seq_dir = os.path.join(self.root, scene, scene_difficulty, seq)
            if not os.path.isdir(seq_dir):
                continue
            poses0 = read_poses(os.path.join(seq_dir, "pose_left.txt"))
            poses1 = read_poses(os.path.join(seq_dir, "pose_right.txt"))
            T_cam0_2_world = poses0[0] @ T_CAM_2_BODY
            T_cam1_2_world = poses1[0] @ T_CAM_2_BODY
            T_cam0_2_cams = np.stack([
                np.identity(4),
                np.linalg.inv(T_cam1_2_world) @ T_cam0_2_world,
            ])
            for voxel_path in sorted(glob.glob(os.path.join(
                self.label_root, scene, scene_difficulty, seq,
                "voxels_left", "*.pkl",
            ))):
                self.scans.append({
                    "sequence": seq,
                    "voxel_path": voxel_path,
                    "T_cam0_2_cams": T_cam0_2_cams,
                })

    def __len__(self):
        return len(self.scans)

    def reseed(self, epoch: int):
        """Select the epoch's augmentation draws (per-(epoch, index)
        RandomStates, so a resumed run replays an uninterrupted one)."""
        self.epoch = epoch

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        from PIL import Image

        cfg = self.cfg
        scan = self.scans[index]
        seq = scan["sequence"]
        frame_id = os.path.splitext(os.path.basename(scan["voxel_path"]))[0]

        with open(scan["voxel_path"], "rb") as f:
            pk = pickle.load(f)
        target = np.asarray(pk["target_1_1"], np.int32)
        target_1_4 = np.asarray(pk["target_1_4"], np.int32)
        vox_origin = np.asarray(pk["vox_origin"], np.float64)
        T_voxel_2_cam = np.asarray(pk["T_velo_2_cam"], np.float64)

        T_velo_2_cam = np.stack([
            scan["T_cam0_2_cams"][i] @ T_voxel_2_cam for i in range(2)])
        cam_k = np.stack([INTRINSICS, INTRINSICS])

        sample: Dict[str, np.ndarray] = {
            "frame_id": frame_id,
            "sequence": seq,
            "cam_k": cam_k.astype(np.float32),
            "T_velo_2_cam": T_velo_2_cam.astype(np.float32),
            "vox_origin": vox_origin.astype(np.float32),
            "target": target,
            "CP_mega_matrices": compute_cp_mega_matrix(
                target_1_4, cfg.n_relations == 2),
        }

        pix, fov, pz = [], [], []
        for v in range(2):
            p, f, z = vox2pix(
                T_velo_2_cam[v], cam_k[v], vox_origin, cfg.voxel_size_meters,
                IMG_W, IMG_H, tuple(self.scene_size - 1e-4), cfg.pattern_id,
            )
            pix.append(p)
            fov.append(f)
            pz.append(z)
        projected_pix = np.stack(pix).astype(np.int32)
        fov_mask = np.stack(fov)
        pix_z = np.stack(pz).astype(np.float32)

        if cfg.fp_loss:
            # the voxel masks are rebuilt on the device (losses/fp_device.py)
            dists = compute_frustum_class_dists(
                projected_pix, pix_z, target, IMG_W, IMG_H, "tartanair",
                cfg.n_classes, cfg.frustum_size,
            )
            sample["frustums_class_dists"] = dists.astype(np.float32)

        rng = sample_rng(self.seed, self.epoch, index)
        do_flip = self.split == "train" and rng.rand() < self.fliplr
        imgs, idas = [], []
        for side in ("left", "right"):
            img = Image.open(os.path.join(
                self.root, self.scene, self.difficulty, seq,
                f"image_{side}", f"{frame_id}_{side}.png",
            )).convert("RGB")
            img = np.asarray(img, np.float32)[:IMG_H, :IMG_W] / 255.0
            if self.color_jitter_params:
                img = color_jitter(img, rng, *self.color_jitter_params)
            if do_flip:
                img = np.ascontiguousarray(img[:, ::-1])
            imgs.append(normalize_rgb(img))
            idas.append(ida_matrix((0, 0, IMG_W, IMG_H), do_flip))
        if do_flip:
            projected_pix = flip_projected_pix(projected_pix, IMG_W)
        sample["img"] = np.stack(imgs)
        sample["ida_mats"] = np.stack(idas)
        sample["projected_pix"] = projected_pix
        sample["fov_mask"] = fov_mask
        return sample
