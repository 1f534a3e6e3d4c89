"""NYUv2 RGB-D dataset -> fixed-schema batches (NumPy, PIL).

A copy of `occdepth_tpu/data/nyu.py` (reference occdepth/data/NYU/
nyu_dataset.py) on the port's own NumPy geometry.  Samples come from the
offline-preprocessed pickles ({cam_pose, voxel_origin, target_1_4,
target_1_16}) under `<data_preprocess_root>/base/NYU<split>` and the
`NYU<split>/*.bin` scan list, `*_color.jpg` image and uint16 `*.png` depth
under `data_root`; the model trains and evaluates at the 1:4 grid
(60x36x60, (X, Z_up, Y)).  With depth (`use_depth_gt`) every sample also
projects the voxels into a virtual right camera VIRTUAL_BASELINE to the
right of the real one.  Augmentation draws come from a per-(seed, epoch,
index) RandomState.  Samples are equal, key for key, to the JAX package's
for the same tree, split, seed and epoch.
"""
from __future__ import annotations

import glob
import os
import pickle
from typing import Dict

import numpy as np

from occdepth_tpu_torch.config import OccDepthConfig
from occdepth_tpu_torch.data.augment import (
    color_jitter,
    flip_projected_pix,
    gaussian_blur,
    ida_matrix,
    normalize_rgb,
    sample_rng,
    strong_img_aug,
)
from occdepth_tpu_torch.data.kitti import collate as collate  # same schema
from occdepth_tpu_torch.geometry.frustums_mask import compute_frustum_class_dists
from occdepth_tpu_torch.geometry.projection import vox2pix
from occdepth_tpu_torch.geometry.relations import compute_cp_mega_matrix

IMG_W, IMG_H = 640, 480
SCENE_SIZE = (4.8, 4.8, 2.88)  # metres, world (X, Y, Z_up)
VOXEL_SIZE = 0.08  # metres, at the 1:4 grid
CAM_K = np.array([[518.8579, 0, 320], [0, 518.8579, 240], [0, 0, 1]])
VIRTUAL_BASELINE = 0.1  # metres (nyu_dataset.py:139-140)


def load_depth_png(path: str, max_depth: float = 10.0) -> np.ndarray:
    """uint16 png / 8000 -> metres, clamped to [0, max_depth]."""
    from PIL import Image

    depth = np.asarray(Image.open(path)).astype(np.float32) / 8000.0
    return np.clip(depth, 0.0, max_depth)


class NYUDataset:
    """Map-style dataset of one split ("train" or "test")."""

    def __init__(
        self,
        cfg: OccDepthConfig,
        split: str,
        color_jitter_params=(0.4, 0.4, 0.4),
        fliplr: float = 0.0,
        seed: int = 42,
    ):
        self.cfg = cfg
        self.split = split
        self.root = os.path.join(cfg.data_root, "NYU" + split)
        self.base_dir = os.path.join(cfg.data_preprocess_root, "base",
                                     "NYU" + split)
        self.fliplr = fliplr
        self.color_jitter_params = (
            color_jitter_params if split == "train" else None)
        self.epoch = 0
        self.seed = seed
        self.scan_names = sorted(glob.glob(os.path.join(self.root, "*.bin")))

    def __len__(self):
        return len(self.scan_names)

    def reseed(self, epoch: int):
        """Select the epoch's augmentation draws (per-(epoch, index)
        RandomStates, so a resumed run replays an uninterrupted one)."""
        self.epoch = epoch

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        from PIL import Image

        cfg = self.cfg
        name = os.path.splitext(os.path.basename(self.scan_names[index]))[0]
        with open(os.path.join(self.base_dir, name + ".pkl"), "rb") as f:
            data = pickle.load(f)

        cam_pose = np.asarray(data["cam_pose"], np.float64)
        T_world_2_cam = np.linalg.inv(cam_pose)
        vox_origin = np.asarray(data["voxel_origin"], np.float64)
        target = np.asarray(data["target_1_4"], np.int32)
        target_1_16 = np.asarray(data["target_1_16"], np.int32)

        sample: Dict[str, np.ndarray] = {
            "frame_id": name,
            "sequence": "NYU" + self.split,
            "cam_k": CAM_K[None].astype(np.float32),
            "T_velo_2_cam": T_world_2_cam[None].astype(np.float32),
            "vox_origin": vox_origin.astype(np.float32),
            "virtual_bf": np.float32(VIRTUAL_BASELINE * CAM_K[0, 0]),
            "target": target,
            "CP_mega_matrices": compute_cp_mega_matrix(
                target_1_16, cfg.n_relations == 2),
        }

        # projections: the real camera and, with depth, the virtual right one
        views = [T_world_2_cam]
        if cfg.use_depth_gt:
            T_cam0_2_cam1 = np.eye(4)
            T_cam0_2_cam1[0, 3] = -VIRTUAL_BASELINE
            views.append(T_cam0_2_cam1 @ T_world_2_cam)
        pix, fov, pz = [], [], []
        for T in views:
            p, f, z = vox2pix(T, CAM_K, vox_origin, VOXEL_SIZE, IMG_W, IMG_H,
                              SCENE_SIZE, cfg.pattern_id)
            pix.append(p)
            fov.append(f)
            pz.append(z)
        projected_pix = np.stack(pix).astype(np.int32)
        fov_mask = np.stack(fov)
        pix_z = np.stack(pz).astype(np.float32)

        if cfg.fp_loss:
            # the voxel masks are rebuilt on the device (losses/fp_device.py)
            dists = compute_frustum_class_dists(
                projected_pix, pix_z, target, IMG_W, IMG_H, "NYU",
                cfg.n_classes, cfg.frustum_size,
            )
            sample["frustums_class_dists"] = dists.astype(np.float32)

        img = Image.open(os.path.join(self.root, name + "_color.jpg"))
        img = np.asarray(img.convert("RGB"), np.float32) / 255.0
        gt_depth = None
        if cfg.use_depth_gt:
            gt_depth = load_depth_png(os.path.join(self.root, name + ".png"))

        rng = sample_rng(self.seed, self.epoch, index)
        do_flip = self.split == "train" and rng.rand() < self.fliplr
        if self.color_jitter_params:
            img = color_jitter(img, rng, *self.color_jitter_params)
        if do_flip:
            img = np.ascontiguousarray(img[:, ::-1])
            projected_pix = flip_projected_pix(projected_pix, IMG_W)
            if gt_depth is not None:
                gt_depth = np.ascontiguousarray(gt_depth[:, ::-1])

        img = normalize_rgb(img)
        if self.split == "train" and cfg.use_strong_img_aug:
            if rng.rand() < 0.3:
                img = gaussian_blur(img, rng)
            if rng.rand() < 0.3:
                img = strong_img_aug(img, rng)
        sample["img"] = img[None]  # (V=1, H, W, 3)
        sample["ida_mats"] = ida_matrix((0, 0, IMG_W, IMG_H), do_flip)[None]
        sample["projected_pix"] = projected_pix
        sample["fov_mask"] = fov_mask
        if gt_depth is not None:
            sample["gt_depth"] = gt_depth[None]
        return sample
