"""Fixed-schema synthetic batches (NumPy).

`make_synthetic_batch` is `occdepth_tpu/data/batch.py::make_synthetic_batch`,
bit-identical to it for the same config and seed (the same RandomState
draws in the same order):

    img:                  (B, V, H, W, 3) float32 (normalized RGB)
    projected_pix:        (B, Vl, N, P, 2) int32 — at project_scale
    fov_mask:             (B, Vl, N, P) bool
    cam_k:                (B, V, 3, 3) float32
    T_velo_2_cam:         (B, V, 4, 4) float32
    ida_mats:             (B, V, 4, 4) float32
    vox_origin:           (B, 3) float32               [NYU/tartanair]
    virtual_bf:           (B,) float32                 [NYU]
  with_labels=True adds the training targets:
    gt_depth:             (B, Vd, H, W) float32        [if depth supervision]
    target:               (B, X, Y, Z) int32 (255 = invalid)
    CP_mega_matrices:     (B, n_rel, N8, M8) uint8     [if CRP]
    frustums_class_dists: (B, F, C) float32            [if fp loss]
    occluded:             (B, X, Y, Z) int32 in {0, 1} [if occluded_cls]
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from occdepth_tpu_torch.config import OccDepthConfig
from occdepth_tpu_torch.data.nyu import VIRTUAL_BASELINE
from occdepth_tpu_torch.geometry.frustums_mask import compute_frustum_class_dists
from occdepth_tpu_torch.geometry.projection import vox2pix
from occdepth_tpu_torch.geometry.relations import compute_cp_mega_matrix


def default_intrinsics(cfg: OccDepthConfig) -> np.ndarray:
    """Plausible intrinsics scaled to the configured image size."""
    H, W = cfg.img_shape
    if cfg.img_shape_hw is None:
        if cfg.dataset == "NYU":
            return np.array(
                [[518.8579, 0, 320], [0, 518.8579, 240], [0, 0, 1]]
            )
        return np.array(
            [[707.0912, 0, 601.8873], [0, 707.0912, 183.1104], [0, 0, 1]]
        )
    f = 0.9 * W
    return np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]])


def default_extrinsics(cfg: OccDepthConfig, view: int) -> np.ndarray:
    """A plausible world/lidar->cam matrix looking into the scene (+x)."""
    T = np.eye(4)
    # x-forward/y-left/z-up -> cam z-forward/x-right/y-down
    T[:3, :3] = np.array([[0, -1, 0], [0, 0, -1], [1, 0, 0]], float)
    sz = cfg.scene_size_meters[2]
    T[:3, 3] = [-0.06 - 0.54 * view, sz / 4, -0.27]
    return T


def vox_origin_for(cfg: OccDepthConfig) -> np.ndarray:
    sx, sy, sz = cfg.scene_size_meters
    if cfg.dataset == "kitti":
        if cfg.scene_size_m is None:
            return np.array([0.0, -25.6, -2.0])
        return np.array([0.0, -sy / 2, -sz / 2])
    if cfg.dataset == "NYU":
        return np.array([0.0, -sy / 2, 0.0])
    return np.array([-sx / 2, -sy / 2, -sz / 2])


def make_synthetic_batch(
    cfg: OccDepthConfig,
    batch_size: int = 1,
    seed: int = 0,
    with_labels: bool = False,
) -> Dict[str, np.ndarray]:
    """Random but geometrically consistent batch; `with_labels` adds the
    depth and label targets a train step needs."""
    rs = np.random.RandomState(seed)
    H, W = cfg.img_shape
    V = cfg.n_views
    Vl = cfg.n_lift_views

    cam_k = default_intrinsics(cfg)

    vox_origin = vox_origin_for(cfg)
    pix_list, fov_list = [], []
    for v in range(Vl):
        pp, fm, _ = vox2pix(
            default_extrinsics(cfg, v), cam_k, vox_origin,
            cfg.voxel_size_meters * cfg.project_scale,
            W, H, cfg.scene_size_meters, cfg.pattern_id,
        )
        pix_list.append(pp)
        fov_list.append(fm)
    projected_pix = np.stack(pix_list).astype(np.int32)
    fov_mask = np.stack(fov_list)

    def tile(a):
        return np.broadcast_to(a, (batch_size,) + a.shape).copy()

    batch: Dict[str, np.ndarray] = {
        "img": rs.randn(batch_size, V, H, W, 3).astype(np.float32),
        "projected_pix": tile(projected_pix),
        "fov_mask": tile(fov_mask),
        "cam_k": np.broadcast_to(
            cam_k.astype(np.float32), (batch_size, V, 3, 3)
        ).copy(),
        "T_velo_2_cam": tile(
            np.stack([default_extrinsics(cfg, v) for v in range(V)])
        ).astype(np.float32),
        "ida_mats": np.broadcast_to(
            np.eye(4, dtype=np.float32), (batch_size, V, 4, 4)
        ).copy(),
    }
    if cfg.dataset in ("NYU", "tartanair"):
        batch["vox_origin"] = np.broadcast_to(
            vox_origin.astype(np.float32), (batch_size, 3)
        ).copy()
    if cfg.dataset == "NYU":
        batch["virtual_bf"] = np.full(
            (batch_size,), 0.1 * 518.8579, np.float32
        )
    if with_labels:
        _add_labels(cfg, batch, rs, cam_k, vox_origin)
    return batch


def _add_labels(cfg: OccDepthConfig, batch: Dict[str, np.ndarray],
                rs: np.random.RandomState, cam_k: np.ndarray,
                vox_origin: np.ndarray) -> None:
    B = batch["img"].shape[0]
    H, W = cfg.img_shape
    V = cfg.n_views
    if cfg.with_depth_gt:
        Vd = 1 if (cfg.use_stereo_depth_gt or cfg.use_depth_gt) else V
        depth = rs.uniform(0.0, 40.0, size=(B, Vd, H, W))
        depth[depth < 2.0] = 0.0
        batch["gt_depth"] = depth.astype(np.float32)

    X, Y, Z = cfg.full_scene_size
    target = rs.choice(
        np.arange(cfg.n_classes + 1), size=(B, X, Y, Z),
        p=_label_probs(cfg.n_classes),
    ).astype(np.int32)
    target[target == cfg.n_classes] = 255
    batch["target"] = target
    if cfg.context_prior:
        # relation GT at the scale the CRP sees
        rel_scale = 8 if cfg.dataset == "kitti" else 4
        tgt = target[:, ::rel_scale, ::rel_scale, ::rel_scale]
        batch["CP_mega_matrices"] = np.stack(
            [compute_cp_mega_matrix(t, cfg.n_relations == 2) for t in tgt])
    if cfg.fp_loss:
        # histograms at output scale; the voxel masks are rebuilt on the
        # device inside the fp loss from the same calibration
        exts = [default_extrinsics(cfg, v) for v in range(V)]
        if cfg.dataset == "NYU" and cfg.use_depth_gt:
            shift = np.eye(4)
            shift[0, 3] = -VIRTUAL_BASELINE
            exts.append(shift @ exts[0])
        po, zo = [], []
        for T in exts:
            p, _, z = vox2pix(
                T, cam_k, vox_origin, cfg.voxel_size_meters * cfg.output_scale,
                W, H, cfg.scene_size_meters, cfg.pattern_id,
            )
            po.append(p)
            zo.append(z)
        pix_o = np.stack(po).astype(np.int64)
        pz_o = np.stack(zo).astype(np.float32)
        batch["frustums_class_dists"] = np.stack([
            compute_frustum_class_dists(pix_o, pz_o, t, W, H, cfg.dataset,
                                        cfg.n_classes, cfg.frustum_size)
            for t in target
        ]).astype(np.float32)
    if cfg.occluded_cls:
        batch["occluded"] = (rs.rand(B, X, Y, Z) > 0.5).astype(np.int32)


def _label_probs(n_classes: int) -> np.ndarray:
    p = np.full(n_classes + 1, 0.3 / n_classes)
    p[0] = 0.6  # mostly empty, like real scenes
    p[-1] = 0.1 + (0.3 - p[1:-1].sum() - 0.0)  # 255 share
    return p / p.sum()
