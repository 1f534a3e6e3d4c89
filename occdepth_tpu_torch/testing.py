"""Reduced-size configs, seeded random weights, synthetic on-disk
SemanticKITTI, TartanAir and NYU trees, the fp32-noise-aware comparison
helpers and the stereo-lift inputs for tests and smoke runs."""
from __future__ import annotations

import copy
import math
import os

import numpy as np
import torch
import torch.nn as nn

from occdepth_tpu_torch.config import FlospDepthConfig, OccDepthConfig
from occdepth_tpu_torch.native_ext import pack_bits

TINY_IMG_KITTI = (64, 96)
TINY_IMG_NYU = (64, 80)


def tiny_kitti_config(**overrides) -> OccDepthConfig:
    """KITTI stereo flosp_depth + CRP + cascade at toy sizes (the same
    config as `occdepth_tpu.testing.tiny_kitti_config`)."""
    fd = FlospDepthConfig(
        x_bound=(0.0, 6.4, 0.2),
        y_bound=(-3.2, 3.2, 0.2),
        z_bound=(-1.6, 1.6, 0.2),
        d_bound=(2.0, 10.0, 0.5),
        final_dim=TINY_IMG_KITTI,
        mid_channels=16,
    )
    base = dict(
        dataset="kitti",
        full_scene_size=(32, 32, 16),
        project_scale=2,
        scene_size_m=(6.4, 6.4, 3.2),
        voxel_size_m=0.2,
        img_shape_hw=TINY_IMG_KITTI,
        feature=16,
        feature_2d_oc=16,
        n_classes=20,
        frustum_size=2,
        use_stereo_depth_gt=True,
        multi_view_mode=True,
        cascade_cls=True,
        context_prior=True,
        trans_2d_to_3d="flosp_depth",
        flosp_depth_override=fd,
        compute_dtype="float32",
        backbone_2d_name="tf_efficientnet_b3_ns",
    )
    base.update(overrides)
    return OccDepthConfig(**base)


def tiny_tartanair_config(**overrides) -> OccDepthConfig:
    """TartanAir stereo flosp + CRP + cascade at toy sizes, project_scale 1
    (the same config as `occdepth_tpu.testing.tiny_tartanair_config`)."""
    base = dict(
        dataset="tartanair",
        full_scene_size=(16, 8, 16),
        project_scale=1,
        scene_size_m=(4.8, 2.4, 4.8),
        voxel_size_m=0.3,
        img_shape_hw=TINY_IMG_KITTI,
        feature=16,
        feature_2d_oc=16,
        n_classes=14,
        frustum_size=2,
        multi_view_mode=True,
        cascade_cls=True,
        context_prior=True,
        trans_2d_to_3d="flosp",
        project_1_8=False,
        compute_dtype="float32",
    )
    base.update(overrides)
    return OccDepthConfig(**base)


def tiny_nyu_config(**overrides) -> OccDepthConfig:
    """NYU RGB-D flosp (virtual stereo) + CRP + cascade at toy sizes (the
    same config as `occdepth_tpu.testing.tiny_nyu_config`): a 16x8x16
    (X, Z_up, Y) grid, CRP at 4x2x4."""
    base = dict(
        dataset="NYU",
        full_scene_size=(16, 8, 16),
        project_scale=1,
        scene_size_m=(4.8, 4.8, 2.4),
        voxel_size_m=0.3,
        img_shape_hw=TINY_IMG_NYU,
        feature=16,
        feature_2d_oc=16,
        n_classes=12,
        n_relations=4,
        frustum_size=2,
        use_depth_gt=True,
        multi_view_mode=False,
        cascade_cls=True,
        context_prior=True,
        trans_2d_to_3d="flosp",
        project_1_8=False,
        compute_dtype="float32",
    )
    base.update(overrides)
    return OccDepthConfig(**base)


def lift_points(rng: np.random.RandomState, B: int, N: int, P: int,
                hw: tuple) -> tuple:
    """Two-view pattern points with the edge cases of the FLoSP gather.

    Returns pix (B, 2, N, P, 2) int32 at the (H, W) = hw project scale and
    fov (B, 2, N, P) bool.  Coordinates span [-3, W + 3) x [-3, H + 3)
    (negative ones floor-divide), a point is in FOV only inside the image
    and then with probability 0.8; the first 5% of voxels sit on the last
    column and the next 5% on the last row (in FOV), and one voxel in 8 is
    out of view 1's FOV entirely (seen by view 0 alone) and one in 16 out
    of view 0's.
    """
    H, W = hw
    pix = np.stack([rng.randint(-3, W + 3, (B, 2, N, P)),
                    rng.randint(-3, H + 3, (B, 2, N, P))], -1)
    edge = max(1, N // 20)
    pix[:, :, :edge, :, 0] = W - 1
    pix[:, :, edge:2 * edge, :, 1] = H - 1
    inside = ((pix[..., 0] >= 0) & (pix[..., 0] < W) & (pix[..., 1] >= 0)
              & (pix[..., 1] < H))
    fov = inside & (rng.rand(B, 2, N, P) > 0.2)
    fov[:, :, :2 * edge] = inside[:, :, :2 * edge]
    fov[:, 1, 2 * edge::8] = False
    fov[:, 0, 2 * edge + 1::16] = False
    return pix.astype(np.int32), fov


def lift_inputs(rng: np.random.RandomState, B: int, N: int, P: int, C: int,
                hw: tuple, scales: tuple) -> tuple:
    """`lift_points` and one map per scale: (maps, pix, fov) with maps
    {scale: (B, 2, ceil(H/s), ceil(W/s), C) float32}, the JAX package's
    NHWC layout."""
    H, W = hw
    maps = {s: rng.randn(B, 2, -(-H // s), -(-W // s), C).astype(np.float32)
            for s in scales}
    return (maps, *lift_points(rng, B, N, P, hw))


def synthetic_dataset(cfg: OccDepthConfig, n: int, seed: int = 0,
                      with_labels: bool = True) -> list:
    """The n samples of `make_synthetic_batch(cfg, n, seed, with_labels)`
    as a list of per-sample dicts: a map-style dataset for `Loader` and
    `Trainer.fit`."""
    from occdepth_tpu_torch.data.batch import make_synthetic_batch

    batch = make_synthetic_batch(cfg, n, seed, with_labels)
    return [{k: v[i] for k, v in batch.items()} for i in range(n)]


@torch.no_grad()
def randomize_weights(model: nn.Module, seed: int) -> nn.Module:
    """Seeded random weights that keep activations O(1) at any depth.

    Conv/linear weights are N(0, 1/fan_in), biases N(0, 0.01^2);
    BatchNorm gets non-trivial affine parameters and running statistics so
    that a forward pass exercises the statistics handling.  Draws come
    from one CPU `torch.Generator` in module order, so a seed gives the same
    weights on every device.
    """
    g = torch.Generator().manual_seed(seed)

    def normal(shape, std, mean=0.0):
        return torch.randn(shape, generator=g) * std + mean

    for m in model.modules():
        if isinstance(m, nn.modules.batchnorm._BatchNorm):
            c = m.num_features
            m.weight.copy_(normal(c, 0.1, 1.0))
            m.bias.copy_(normal(c, 0.1))
            m.running_mean.copy_(normal(c, 0.1))
            m.running_var.copy_(torch.rand(c, generator=g) * 0.5 + 0.75)
        elif isinstance(m, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose3d,
                            nn.Linear)):
            w = m.weight
            if isinstance(m, nn.ConvTranspose3d):
                fan_in = w.shape[0] * math.prod(w.shape[2:]) // 8
            else:
                fan_in = math.prod(w.shape[1:])
            w.copy_(normal(w.shape, math.sqrt(1.0 / max(fan_in, 1))))
            if m.bias is not None:
                m.bias.copy_(normal(m.bias.shape, 0.01))
    return model


def freeze_batchnorm(model: nn.Module) -> nn.Module:
    """Put every BatchNorm on its running statistics for good: its
    `train()` keeps it in eval mode, so a train step (which calls
    `model.train()`) normalises with the running statistics.  With batch
    statistics the tiny configs' fp32 gradients are chaotic; with these
    they are well conditioned, which tight gradient checks need."""
    def stay_eval(self, mode=True):
        return nn.Module.train(self, False)

    for m in model.modules():
        if isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.train = stay_eval.__get__(m)
            m.eval()
    return model


@torch.no_grad()
def perturbed_copy(model: nn.Module, seed: int,
                   rel: float = 1e-7) -> nn.Module:
    """A deep copy whose parameters are scaled by (1 + rel * N(0, 1)):
    an fp32-rounding-sized change, the yardstick of a network's own fp32
    gradient noise."""
    out = copy.deepcopy(model)
    g = torch.Generator().manual_seed(seed)
    for p in out.parameters():
        p.mul_(1.0 + rel * torch.randn(p.shape, generator=g).to(p.device))
    return out


def noise_aware_worst(ours: dict, ref: dict, perturbed: list, rtol: float,
                      noise_mult: float) -> list:
    """[(err / tol, name, err, tol), ...] worst first, with L2 norms per
    named tensor: err = |ours - ref|, tol = max(rtol * |ref| + 1e-6,
    noise_mult * max over `perturbed` of |ours - perturbed|)."""
    worst = []
    for name, t in ours.items():
        t = t.detach().double().cpu()
        r = torch.as_tensor(ref[name]).double().cpu()
        err = float(torch.linalg.vector_norm(t - r))
        noise = max(float(torch.linalg.vector_norm(
            t - torch.as_tensor(q[name]).double().cpu())) for q in perturbed)
        tol = max(rtol * float(torch.linalg.vector_norm(r)) + 1e-6,
                  noise_mult * noise)
        ratio = err / tol if math.isfinite(err) else math.inf  # NaN fails
        worst.append((ratio, name, err, tol))
    worst.sort(reverse=True)
    return worst


def count_flips(a: dict, b: dict, threshold: float) -> int:
    """Elements whose values differ by more than `threshold` over the
    named tensors of `a` (e.g. AdamW first-step updates of opposite sign)."""
    return sum(int(((a[n].detach().cpu() - torch.as_tensor(b[n]).cpu()
                     ).abs() > threshold).sum()) for n in a)


def make_kitti_tree(base: str, n_frames: int = 2,
                    hw: tuple = (370, 1220)) -> None:
    """Build a synthetic full-resolution SemanticKITTI tree under `base`.

    A copy of `occdepth_tpu.testing.make_kitti_tree` (the same files from
    the same RandomState draws): 370x1220 stereo pairs, 256x256x32 voxel
    grids, preprocessed labels and stereo-depth maps.  Sequences 00 and 08
    (the val split) get `n_frames` frames each; the other train-split
    sequences (01-07, 09, 10) are symlinks of 00, so one epoch is
    10*n_frames train samples.  Writes `{base}/kitti`, `{base}/pre` and
    `{base}/stereo_depth`: data_root, data_preprocess_root and
    data_stereo_depth_root of a config.
    """
    from PIL import Image

    rng = np.random.RandomState(3)
    root = os.path.join(base, "kitti")
    pre = os.path.join(base, "pre")
    depth_root = os.path.join(base, "stereo_depth")
    H, W = hw
    frames = [f"{5 * i:06d}" for i in range(n_frames)]

    for seq_name in ("00", "08"):
        seq = os.path.join(root, "dataset", "sequences", seq_name)
        for d in ("voxels", "image_2", "image_3"):
            os.makedirs(os.path.join(seq, d), exist_ok=True)
        labels = os.path.join(pre, "labels", seq_name)
        os.makedirs(labels, exist_ok=True)
        ddir = os.path.join(
            depth_root, "dataset", "sequences", seq_name, "depth"
        )
        os.makedirs(ddir, exist_ok=True)
        with open(os.path.join(seq, "calib.txt"), "w") as f:
            P2 = "7.07 0 60.18 0 0 7.07 18.31 0 0 0 1 0"
            P3 = "7.07 0 60.18 -3.8 0 7.07 18.31 0 0 0 1 0"
            Tr = "0 -1 0 0 0 0 -1 0 1 0 0 -0.27"
            f.write(f"P2: {P2}\nP3: {P3}\nTr: {Tr}\n\n")
        for frame in frames:
            open(os.path.join(seq, "voxels", f"{frame}.bin"), "wb").write(
                pack_bits(
                    (rng.rand(256 * 256 * 32) > 0.5).astype(np.uint8)
                ).tobytes()
            )
            open(
                os.path.join(seq, "voxels", f"{frame}.occluded"), "wb"
            ).write(
                pack_bits(
                    (rng.rand(256 * 256 * 32) > 0.7).astype(np.uint8)
                ).tobytes()
            )
            img = (rng.rand(H + 6, W + 20, 3) * 255).astype(np.uint8)
            Image.fromarray(img).save(
                os.path.join(seq, "image_2", f"{frame}.png"))
            Image.fromarray(img).save(
                os.path.join(seq, "image_3", f"{frame}.png"))
            t11 = rng.choice(
                [0, 1, 5, 255], size=(256, 256, 32)
            ).astype(np.uint8)
            np.save(os.path.join(labels, f"{frame}_1_1.npy"), t11)
            np.save(
                os.path.join(labels, f"{frame}_1_8.npy"), t11[::8, ::8, ::8]
            )
            depth = (rng.rand(H, W) * 256 * 30).astype(np.uint16)
            Image.fromarray(depth).save(os.path.join(ddir, f"{frame}.png"))

    # train split is sequences 00-07, 09, 10 — symlink them to 00
    for seq_name in ("01", "02", "03", "04", "05", "06", "07", "09", "10"):
        for parent in (
            os.path.join(root, "dataset", "sequences"),
            os.path.join(pre, "labels"),
            os.path.join(depth_root, "dataset", "sequences"),
        ):
            dst = os.path.join(parent, seq_name)
            if not os.path.exists(dst):
                os.symlink("00", dst)


def write_kitti_raw(base: str, seed: int = 0) -> int:
    """Write the raw label files that `scripts/preprocess_kitti` reads
    beside every frame of a `make_kitti_tree` tree under `base`:
    `voxels/<frame>.label` (256x256x32 uint16 raw SemanticKITTI ids:
    mapped and unmapped ids up to z = 12, each 8x8 column with a dominant
    one, mostly empty above) and
    `<frame>.invalid` (packed bits, ~10% set).  Returns the frames
    written (sequences 00 and 08; the others link to 00)."""
    from occdepth_tpu_torch.data.kitti_io import LEARNING_MAP, SCENE_DIMS

    rng = np.random.RandomState(seed)
    ids = np.array(sorted(LEARNING_MAP) + [2, 5, 100], np.uint16)
    low = np.r_[0.5, np.full(ids.size - 1, 0.5 / (ids.size - 1))]
    n = 0
    for seq in ("00", "08"):
        vox = os.path.join(base, "kitti", "dataset", "sequences", seq,
                           "voxels")
        for path in sorted(os.listdir(vox)):
            if not path.endswith(".bin"):
                continue
            frame = path[:-4]
            label = np.zeros(SCENE_DIMS, np.uint16)
            label[:, :, :12] = rng.choice(ids, size=SCENE_DIMS[:2] + (12,),
                                          p=low)
            # each 8x8 column's dominant id covers ~40% of its low voxels
            dominant = np.repeat(np.repeat(rng.choice(
                ids[1:], size=(32, 32)), 8, 0), 8, 1)[:, :, None]
            mask = rng.rand(*SCENE_DIMS[:2], 12) < 0.4
            label[:, :, :12] = np.where(mask, dominant, label[:, :, :12])
            top = rng.rand(*SCENE_DIMS[:2], SCENE_DIMS[2] - 12) < 0.02
            label[:, :, 12:][top] = rng.choice(ids[1:], size=int(top.sum()))
            label.tofile(os.path.join(vox, frame + ".label"))
            invalid = (rng.rand(math.prod(SCENE_DIMS)) < 0.1).astype(np.uint8)
            pack_bits(invalid).tofile(os.path.join(vox, frame + ".invalid"))
            n += 1
    return n


TA_POSE_LEFT = "0.5 -0.2 0.1 0 0 0 1\n"
TA_POSE_RIGHT = "0.5 0.05 0.1 0 0 0 1\n"  # 0.25 m to the right
TA_TOY_GRID = (16, 8, 16)


def _ta_rig(grid, voxel_size) -> tuple:
    """(T_velo_2_cam, vox_origin) of a synthetic TartanAir tree.

    The toy grid keeps the JAX package's rig.  A full-size grid is viewed
    from 1 m in front of the centre of its low-x face, looking along +x
    with the grid's y axis vertical: 80% of the voxels lie in both views'
    FOV at (120, 48, 120) and 0.1 m, so the lift reads real rows.
    """
    X, Y, Z = grid
    T = np.eye(4)
    if tuple(grid) == TA_TOY_GRID:
        T[:3, :3] = [[0, -1, 0], [0, 0, -1], [1, 0, 0]]
        T[:3, 3] = [0.0, Y * voxel_size / 2, -0.3]
        return T, np.array([-2.4, -1.2, -2.4], np.float32)
    T[:3, :3] = [[0, 0, 1], [0, -1, 0], [1, 0, 0]]
    T[:3, 3] = [0.0, 0.0, X * voxel_size / 2 + 1.0]
    size = np.array(grid, float) * voxel_size
    return T, (-size / 2).astype(np.float32)


def tartanair_fov_share(grid, voxel_size) -> float:
    """Share of a synthetic tree's voxels inside both views' FOV, by the
    dataset's own geometry (pose files, axis remap, vox2pix)."""
    from occdepth_tpu_torch.data.tartanair import (
        IMG_H,
        IMG_W,
        INTRINSICS,
        T_CAM_2_BODY,
        quat_to_se3,
    )
    from occdepth_tpu_torch.geometry.projection import vox2pix

    T, origin = _ta_rig(grid, voxel_size)
    cams = [quat_to_se3(np.array(p.split(), float)) @ T_CAM_2_BODY
            for p in (TA_POSE_LEFT, TA_POSE_RIGHT)]
    size = np.array(grid, float) * voxel_size - 1e-4
    fov = [vox2pix(E @ T, INTRINSICS, origin, voxel_size, IMG_W, IMG_H,
                   tuple(size), 0)[1][:, 0]
           for E in (np.eye(4), np.linalg.inv(cams[1]) @ cams[0])]
    return float((fov[0] & fov[1]).mean())


def make_tartanair_tree(base: str, grid: tuple = TA_TOY_GRID,
                        voxel_size: float = 0.3, n_frames: int = 2) -> None:
    """Build a synthetic TartanAir tree under `base`: scene office/Easy,
    sequences P000 (train) and P005 (val), `n_frames` frames each.

    With the defaults it is `occdepth_tpu.testing.make_tartanair_tree`'s
    toy tree (the same files from the same RandomState draws): 16x8x16
    voxel pickles at 0.3 m.  `grid=(120, 48, 120), voxel_size=0.1` writes
    the shipped config's full size: 120x48x120 `target_1_1` and 30x12x30
    `target_1_4` grids (14 classes, mostly empty, 255 invalid) and a rig
    that sees the grid (`tartanair_fov_share`).  Images are 480x640 stereo
    PNGs either way.  Writes `{base}/ta` (images and poses) and
    `{base}/ta_pre` (voxel pickles): data_root and data_preprocess_root.
    """
    import pickle

    from PIL import Image

    rng = np.random.RandomState(42)
    X, Y, Z = grid
    toy = tuple(grid) == TA_TOY_GRID
    T, origin = _ta_rig(grid, voxel_size)
    labels = np.array([0, 1, 5, 255]) if toy else np.r_[0:14, 255]
    probs = None if toy else np.r_[0.6, np.full(13, 0.3 / 13), 0.1]
    root = os.path.join(base, "ta")
    pre = os.path.join(base, "ta_pre")
    for seq in ("P000", "P005"):
        seq_dir = os.path.join(root, "office", "Easy", seq)
        os.makedirs(os.path.join(seq_dir, "image_left"), exist_ok=True)
        os.makedirs(os.path.join(seq_dir, "image_right"), exist_ok=True)
        with open(os.path.join(seq_dir, "pose_left.txt"), "w") as f:
            f.write(TA_POSE_LEFT * 3)
        with open(os.path.join(seq_dir, "pose_right.txt"), "w") as f:
            f.write(TA_POSE_RIGHT * 3)
        vox_dir = os.path.join(pre, "labels", "office", "Easy", seq,
                               "voxels_left")
        os.makedirs(vox_dir, exist_ok=True)
        for frame in (f"{i:06d}" for i in range(n_frames)):
            for side in ("left", "right"):
                img = (rng.rand(480, 640, 3) * 255).astype(np.uint8)
                Image.fromarray(img).save(os.path.join(
                    seq_dir, f"image_{side}", f"{frame}_{side}.png"))
            data = {
                "target_1_1": rng.choice(labels, size=(X, Y, Z),
                                         p=probs).astype(np.uint8),
                "target_1_4": rng.choice(
                    labels, size=(X // 4, Y // 4, Z // 4),
                    p=probs).astype(np.uint8),
                "vox_origin": origin,
                "T_velo_2_cam": T.astype(np.float32),
            }
            with open(os.path.join(vox_dir, f"{frame}.pkl"), "wb") as f:
                pickle.dump(data, f)


def write_tartanair_raw(base: str, seq: str = "P005", n_frames: int = 10,
                        hw: tuple = (480, 640), seed: int = 0) -> None:
    """Write the raw files that `scripts/export_voxels_tartanair` reads
    for sequence `seq` of a tree under `base` (office/Easy):
    `depth_left/<frame>_left_depth.npy` (float32 metres, 1-9 m rising
    down the image, with noise), `seg_left/<frame>_left_seg.npy` (uint8
    simulator ids, mapped and unmapped, constant over 32x32 tiles) and
    `pose_left.txt` (`n_frames` lines of the tree's left pose, whose first
    line the dataset reads).  The export takes every 5th frame."""
    rng = np.random.RandomState(seed)
    H, W = hw
    seq_dir = os.path.join(base, "ta", "office", "Easy", seq)
    for d in ("depth_left", "seg_left"):
        os.makedirs(os.path.join(seq_dir, d), exist_ok=True)
    with open(os.path.join(seq_dir, "pose_left.txt"), "w") as f:
        f.write(TA_POSE_LEFT * n_frames)
    seg_ids = np.array([22, 139, 90, 101, 211, 50, 120, 125, 148, 232, 28,
                        137, 7, 99], np.uint8)
    ramp = np.linspace(1.0, 9.0, H, dtype=np.float32)[:, None]
    for i in range(n_frames):
        depth = ramp + rng.uniform(-0.3, 0.3, (H, W)).astype(np.float32)
        tiles = rng.choice(seg_ids, size=(-(-H // 32), -(-W // 32)))
        seg = np.repeat(np.repeat(tiles, 32, 0), 32, 1)[:H, :W]
        np.save(os.path.join(seq_dir, "depth_left",
                             f"{i:06d}_left_depth.npy"), depth)
        np.save(os.path.join(seq_dir, "seg_left", f"{i:06d}_left_seg.npy"),
                np.ascontiguousarray(seg))


def nyu_rig() -> tuple:
    """(cam_pose, voxel_origin) of a synthetic NYU tree: the camera 1 m
    behind the centre of the scene's low-x face at 1.44 m height, looking
    along +x with z up, so most of the 4.8 x 4.8 x 2.88 m grid lies in
    the real and the virtual view (`nyu_fov_share`)."""
    pose = np.eye(4)
    # camera axes in world: x right = -y, y down = -z, z forward = +x
    pose[:3, :3] = [[0, 0, 1], [-1, 0, 0], [0, -1, 0]]
    pose[:3, 3] = [-1.0, 0.0, 1.44]
    return pose.astype(np.float32), np.array([0.0, -2.4, 0.0], np.float32)


def nyu_fov_share() -> float:
    """Share of a synthetic NYU tree's voxels inside both the real and
    the virtual view's FOV, by the dataset's own geometry."""
    from occdepth_tpu_torch.data.nyu import (
        CAM_K,
        IMG_H,
        IMG_W,
        SCENE_SIZE,
        VIRTUAL_BASELINE,
        VOXEL_SIZE,
    )
    from occdepth_tpu_torch.geometry.projection import vox2pix

    pose, origin = nyu_rig()
    T = np.linalg.inv(pose.astype(np.float64))
    shift = np.eye(4)
    shift[0, 3] = -VIRTUAL_BASELINE
    fov = [vox2pix(E, CAM_K, origin.astype(np.float64), VOXEL_SIZE, IMG_W,
                   IMG_H, SCENE_SIZE, 0)[1][:, 0] for E in (T, shift @ T)]
    return float((fov[0] & fov[1]).mean())


def make_nyu_tree(base: str, n_frames: int = 2) -> None:
    """Build a synthetic full-size NYU tree under `base`: splits NYUtrain
    and NYUtest, `n_frames` frames each.

    Per frame: `NYU<split>/<name>.bin` (the scan list), a 480x640
    `<name>_color.jpg`, a uint16 `<name>.png` depth map (metres x 8000,
    0.5-8 m with a few zero holes) and the pickle
    `base/NYU<split>/<name>.pkl` with `cam_pose`, `voxel_origin`,
    `target_1_4` (60x36x60) and `target_1_16` (15x9x15) of 12 classes,
    mostly empty, 255 invalid.  The rig (`nyu_rig`) puts most voxels in
    view.  Pass `base` as data_root and data_preprocess_root.
    """
    import pickle

    from PIL import Image

    rng = np.random.RandomState(7)
    pose, origin = nyu_rig()
    labels = np.r_[0:12, 255]
    probs = np.r_[0.6, np.full(11, 0.3 / 11), 0.1]
    for split in ("train", "test"):
        root = os.path.join(base, "NYU" + split)
        pre = os.path.join(base, "base", "NYU" + split)
        os.makedirs(root, exist_ok=True)
        os.makedirs(pre, exist_ok=True)
        for i in range(n_frames):
            name = f"NYU{i + 1:04d}_0000"
            with open(os.path.join(root, name + ".bin"), "wb") as f:
                f.write(b"\0" * 16)
            img = (rng.rand(480, 640, 3) * 255).astype(np.uint8)
            Image.fromarray(img).save(os.path.join(root, name + "_color.jpg"))
            depth = rng.uniform(0.5, 8.0, (480, 640)) * 8000
            depth[rng.rand(480, 640) < 0.02] = 0.0
            Image.fromarray(depth.astype(np.uint16)).save(
                os.path.join(root, name + ".png"))
            data = {
                "cam_pose": pose,
                "voxel_origin": origin,
                "target_1_4": rng.choice(labels, size=(60, 36, 60),
                                         p=probs).astype(np.uint8),
                "target_1_16": rng.choice(labels, size=(15, 9, 15),
                                          p=probs).astype(np.uint8),
            }
            with open(os.path.join(pre, name + ".pkl"), "wb") as f:
                pickle.dump(data, f)


NYU_RAW_GRID = (240, 144, 240)


def write_nyu_raw(base: str, seed: int = 0) -> int:
    """Write the RLE voxel scan that `scripts/preprocess_nyu` reads over
    every `NYU<split>/<name>.bin` of a `make_nyu_tree` tree under `base`:
    float32[3] voxel origin and float32[16] camera pose (the tree's rig),
    then uint32 (value, run) pairs over the 240x144x240 grid: 37-class
    values, 255, and a few past the class map; each 16 x-slabs in turn
    are mostly empty, mixed, mostly 255 or mixed.  Returns the scans
    written."""
    rng = np.random.RandomState(seed)
    pose, origin = nyu_rig()
    slab = NYU_RAW_GRID[1] * NYU_RAW_GRID[2]
    values = np.r_[0:37, 255, 40].astype(np.uint32)
    n = 0
    for split in ("train", "test"):
        root = os.path.join(base, "NYU" + split)
        for name in sorted(os.listdir(root)):
            if not name.endswith(".bin"):
                continue
            pairs = []
            for x in range(NYU_RAW_GRID[0]):
                # one regime per 16 x-slabs: empty, mixed, 255, mixed
                p0, p255 = [(0.98, 0.01), (0.5, 0.05), (0.04, 0.95),
                            (0.5, 0.05)][x // 16 % 4]
                rest = 1.0 - p0 - p255
                probs = np.r_[p0, np.full(36, 0.97 * rest / 36), p255,
                              0.03 * rest]
                runs = rng.geometric(1 / 48, size=2 * slab // 48)
                runs = runs[: int(np.searchsorted(np.cumsum(runs), slab)) + 1]
                runs[-1] -= runs.sum() - slab
                vals = rng.choice(values, size=runs.size,
                                  p=probs / probs.sum())
                pairs.append(np.stack([vals, runs.astype(np.uint32)], 1))
            with open(os.path.join(root, name), "wb") as f:
                origin.astype(np.float32).tofile(f)
                pose.astype(np.float32).reshape(-1).tofile(f)
                np.concatenate(pairs).astype(np.uint32).tofile(f)
            n += 1
    return n
