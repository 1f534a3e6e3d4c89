"""SemanticKITTI dataset -> fixed-schema batches (NumPy, PIL).

A copy of `occdepth_tpu/data/kitti.py` (reference occdepth/data/
semantic_kitti/kitti_dataset.py + collate.py + kitti_dm.py) on the port's
own NumPy geometry: vox2pix runs once per (sequence, scale) and is cached,
flips mirror the cached pixel coordinates, and collation stacks every
sample into static-shape arrays.  Samples and batches are equal, key for
key, to the JAX package's for the same tree, split, seed and epoch.
"""
from __future__ import annotations

import glob
import os
from typing import Dict, List

import numpy as np

from occdepth_tpu_torch.config import OccDepthConfig
from occdepth_tpu_torch.data import kitti_io
from occdepth_tpu_torch.data.augment import (
    sample_rng,
    color_jitter,
    flip_projected_pix,
    gaussian_blur,
    ida_matrix,
    normalize_rgb,
    strong_img_aug,
)
from occdepth_tpu_torch.geometry.frustums_mask import compute_frustum_class_dists
from occdepth_tpu_torch.geometry.projection import vox2pix
from occdepth_tpu_torch.geometry.relations import compute_cp_mega_matrix

IMG_W, IMG_H = 1220, 370
SCENE_SIZE = (51.2, 51.2, 6.4)
VOX_ORIGIN = np.array([0.0, -25.6, -2.0])
VOXEL_SIZE = 0.2


def load_depth_png(path: str, scale: float = 256.0) -> np.ndarray:
    """uint16 depth png -> metres (kitti_dataset.py:40-44)."""
    from PIL import Image

    depth = np.asarray(Image.open(path)).astype(np.float32)
    depth[depth > 0] /= scale
    return depth


class KittiDataset:
    """Map-style dataset returning fixed-schema per-sample dicts."""

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
        self.root = cfg.data_root
        self.label_root = os.path.join(cfg.data_preprocess_root, "labels")
        self.fliplr = fliplr
        self.color_jitter_params = color_jitter_params if split == "train" else None
        self.epoch = 0
        self.seed = seed
        self.n_views = 2 if cfg.multi_view_mode else 1

        seqs = {
            "train": kitti_io.TRAIN_SEQUENCES,
            "val": kitti_io.VAL_SEQUENCES,
            "test": kitti_io.TEST_SEQUENCES,
        }[split]

        self.scans: List[Dict] = []
        self._geom_cache: Dict[str, Dict] = {}
        for seq in seqs:
            calib = kitti_io.read_calib(
                os.path.join(self.root, "dataset", "sequences", seq, "calib.txt")
            )
            cam_k, T_velo_2_cam = kitti_io.camera_geometry(calib)
            for voxel_path in sorted(glob.glob(os.path.join(
                self.root, "dataset", "sequences", seq, "voxels", "*.bin"
            ))):
                frame_id = os.path.splitext(os.path.basename(voxel_path))[0]
                self.scans.append({
                    "sequence": seq,
                    "frame_id": frame_id,
                    "cam_k": cam_k,
                    "T_velo_2_cam": T_velo_2_cam,
                })

    def __len__(self):
        return len(self.scans)

    def reseed(self, epoch: int):
        """Advance the per-epoch augmentation stream.  Draws come from a
        per-(epoch, index) RandomState (augment.sample_rng), so a resumed
        run replays the same jitter/flip draws as an uninterrupted one
        and the stream is independent of dataloader worker scheduling."""
        self.epoch = epoch

    def _geometry(self, seq: str, cam_k, T_velo_2_cam):
        """Per-sequence cached vox2pix at output + project scales."""
        if seq in self._geom_cache:
            return self._geom_cache[seq]
        cfg = self.cfg
        out = {}
        for scale in {cfg.output_scale, cfg.project_scale}:
            pix, fov, pz = [], [], []
            for v in range(self.n_views):
                p, f, z = vox2pix(
                    T_velo_2_cam[v], cam_k[v], VOX_ORIGIN,
                    VOXEL_SIZE * scale, IMG_W, IMG_H, SCENE_SIZE,
                    cfg.pattern_id,
                )
                pix.append(p)
                fov.append(f)
                pz.append(z)
            out[scale] = (
                np.stack(pix).astype(np.int32),
                np.stack(fov),
                np.stack(pz).astype(np.float32),
            )
        self._geom_cache[seq] = out
        return out

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        from PIL import Image

        cfg = self.cfg
        scan = self.scans[index]
        seq, frame_id = scan["sequence"], scan["frame_id"]
        cam_k, T_velo_2_cam = scan["cam_k"], scan["T_velo_2_cam"]
        geom = self._geometry(seq, cam_k, T_velo_2_cam)

        sample: Dict[str, np.ndarray] = {
            "frame_id": frame_id,
            "sequence": seq,
            "cam_k": cam_k[: self.n_views].astype(np.float32),
            "T_velo_2_cam": T_velo_2_cam[: self.n_views].astype(np.float32),
        }

        pix_p, fov_p, _ = geom[cfg.project_scale]
        pix_o, _, pz_o = geom[cfg.output_scale]
        rng = sample_rng(self.seed, self.epoch, index)
        do_flip = self.split == "train" and rng.rand() < self.fliplr

        # labels
        target = None
        if self.split != "test":
            target = np.load(os.path.join(
                self.label_root, seq, frame_id + "_1_1.npy"
            )).astype(np.int32)
            sample["target"] = target
            if cfg.context_prior:
                t18 = np.load(os.path.join(
                    self.label_root, seq, frame_id + "_1_8.npy"
                )).astype(np.int32)
                sample["CP_mega_matrices"] = compute_cp_mega_matrix(
                    t18, cfg.n_relations == 2
                )

        # depth supervision
        gt_depth = None
        if self.split != "test" and cfg.use_stereo_depth_gt:
            path = os.path.join(
                cfg.data_stereo_depth_root, "dataset", "sequences", seq,
                "depth", frame_id + ".png",
            )
            gt_depth = [load_depth_png(path)[:IMG_H, :IMG_W]]
        elif self.split != "test" and cfg.use_lidar_depth_gt:
            gt_depth = [
                np.load(os.path.join(
                    cfg.data_lidar_depth_root, "dataset", "sequences", seq,
                    "lidar_depth", frame_id, f"{i}.npy",
                ))[:IMG_H, :IMG_W]
                for i in range(self.n_views)
            ]

        # images
        imgs, idas = [], []
        for v in range(self.n_views):
            cam_dir = "image_2" if v == 0 else "image_3"
            img = Image.open(os.path.join(
                self.root, "dataset", "sequences", seq, cam_dir,
                frame_id + ".png",
            )).convert("RGB")
            img = np.asarray(img, dtype=np.float32) / 255.0
            if self.color_jitter_params:
                img = color_jitter(img, rng, *self.color_jitter_params)
            img = img[:IMG_H, :IMG_W]
            if do_flip:
                img = img[:, ::-1]
                if gt_depth is not None and not (
                    cfg.use_stereo_depth_gt and v > 0
                ):
                    if v < len(gt_depth):
                        gt_depth[v] = np.ascontiguousarray(gt_depth[v][:, ::-1])
            img = normalize_rgb(img)
            # strong aug applies on the normalized image, like the
            # reference's torchvision pipeline (kitti_dataset.py:401-407)
            if self.split == "train" and cfg.use_strong_img_aug:
                if rng.rand() < 0.3:
                    img = gaussian_blur(img, rng)
                if rng.rand() < 0.3:
                    img = strong_img_aug(img, rng)
            imgs.append(img)
            idas.append(ida_matrix((0, 0, IMG_W, IMG_H), do_flip))
        sample["img"] = np.stack(imgs)
        sample["ida_mats"] = np.stack(idas)

        # fp-loss class histograms from the UNFLIPPED projections — the
        # reference computes frustums before image aug (kitti_dataset.py:
        # 316-333 vs :367-412); the voxel masks are rebuilt on device
        # inside the loss (losses/fp_device.py), so only this tiny table
        # ships with the batch.
        if self.split != "test" and cfg.fp_loss:
            dists = compute_frustum_class_dists(
                pix_o, pz_o, target, IMG_W, IMG_H, "kitti",
                cfg.n_classes, cfg.frustum_size,
            )
            sample["frustums_class_dists"] = dists.astype(np.float32)

        if do_flip:
            pix_p = flip_projected_pix(pix_p, IMG_W)
        sample["projected_pix"] = pix_p
        sample["fov_mask"] = fov_p

        if gt_depth is not None:
            sample["gt_depth"] = np.stack(gt_depth).astype(np.float32)

        if cfg.occluded_cls:
            occ_path = os.path.join(
                self.root, "dataset", "sequences", seq, "voxels",
                frame_id + ".occluded",
            )
            if os.path.exists(occ_path):
                sample["occluded"] = kitti_io.read_occluded(occ_path).reshape(
                    256, 256, 32
                ).astype(np.int32)
        return sample


def collate(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack per-sample dicts into one fixed-schema batch."""
    batch: Dict[str, np.ndarray] = {}
    keys = samples[0].keys()
    for k in keys:
        vals = [s[k] for s in samples]
        if k in ("frame_id", "sequence"):
            batch[k] = vals  # metadata, not fed to the model
        else:
            batch[k] = np.stack(vals)
    return batch


class Loader:
    """Minimal prefetching batch loader (thread-based; PIL releases the GIL).

    Plays the role of the Lightning DataModule + DataLoader
    (kitti_dm.py:8-143) with the JAX package's order: shuffling per epoch
    from RandomState(seed + epoch), fixed batch size (drops the last
    partial batch in train), background prefetch.

    With `world` > 1 (data parallel, `parallel/ddp.py`) `batch_size` is
    the global batch and rank `rank` loads and yields only its contiguous
    `batch_size // world` rows of each global batch, so the union of the
    ranks' batches is the one-process batch in the one-process order.  A
    ragged last global batch (drop_last=False) is padded to full size with
    its first sample before the split, and each rank's rows then carry a
    `sample_valid` (rows,) bool mask; every rank sees the same number of
    batches.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool,
                 seed: int = 42, num_workers: int = 2, drop_last=None,
                 rank: int = 0, world: int = 1):
        if batch_size % world:
            raise ValueError(f"global batch {batch_size} not divisible by "
                             f"the world's {world} ranks")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = num_workers
        self.drop_last = shuffle if drop_last is None else drop_last
        self.rank, self.world = rank, world
        self.epoch = 0

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def __iter__(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(order)
        self.epoch += 1
        n_batches = len(self)

        def make(bi):
            idxs = order[bi * self.batch_size: (bi + 1) * self.batch_size]
            if self.world == 1:
                return collate([self.dataset[int(i)] for i in idxs])
            valid = np.arange(self.batch_size) < len(idxs)
            idxs = np.resize(idxs, self.batch_size)
            idxs[~valid] = idxs[0]
            per = self.batch_size // self.world
            rows = slice(self.rank * per, (self.rank + 1) * per)
            batch = collate([self.dataset[int(i)] for i in idxs[rows]])
            if not valid.all():
                batch["sample_valid"] = valid[rows]
            return batch

        if self.num_workers <= 0:
            for bi in range(n_batches):
                yield make(bi)
            return

        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            futures = [
                pool.submit(make, bi) for bi in range(min(2, n_batches))
            ]
            next_submit = len(futures)
            for _ in range(n_batches):
                batch = futures.pop(0).result()
                if next_submit < n_batches:
                    futures.append(pool.submit(make, next_submit))
                    next_submit += 1
                yield batch
