"""Headless voxel visualisation (matplotlib; no mayavi/open3d dependency).

The port's copy of `occdepth_tpu/scripts/visualization/voxel_vis.py`, on
the port's `kitti_io` colors.  It plays the role of the reference's mayavi/open3d renderers — per-frame
semantic voxel renders with the reference's presentation features:

  * world-coordinate voxel scatter (vox_origin + voxel centres,
    kitti_vis_pred.py:9-32),
  * camera frustum wireframe — the 5-point pyramid of
    kitti_vis_pred.py:46-66 (KITTI: inv(T_velo_2_cam), d=7 m) and
    NYU_vis_pred.py:41-59 (cam_pose, d=0.75 m),
  * in-FOV voxels in full color, out-of-FOV dimmed to 2/3 brightness
    (kitti_vis_pred.py:117-124 lut `//3*2`),
  * optional ground-truth panel side by side,
  * batch/video variant: render every frame + assemble an animated GIF
    (the kitti_vis_pred_batch.py role).

Reads the per-frame pickles written by `generate_output` or `infer`.
matplotlib and PIL are imported only by the functions that render:

    python -m occdepth_tpu_torch.scripts.visualization.voxel_vis \\
        --input-dir PICKLES --output-dir PNGS [--dataset kitti|NYU|tartanair] \\
        [--with-target] [--gif seq.gif]
"""
from __future__ import annotations

import argparse
import glob
import os
import pickle

import numpy as np

from occdepth_tpu_torch.data.kitti_io import COLOR_MAP_BGR

# NYU panel colors, reference NYU_vis_pred.py:106-122 (RGBA -> RGB)
NYU_COLORS = np.array([
    [22, 191, 206], [214, 38, 40], [43, 160, 43], [158, 216, 229],
    [114, 158, 206], [204, 204, 91], [255, 186, 119], [147, 102, 188],
    [30, 119, 181], [188, 188, 33], [255, 127, 12], [196, 175, 214],
    [153, 153, 153],
], np.float32) / 255.0

DATASET_PRESETS = {
    # (n_classes, voxel_size_m, camera pyramid depth d [m], pose mode)
    "kitti": (20, 0.2, 7.0, "velo2cam"),
    "NYU": (12, 0.08, 0.75, "cam_pose"),
    "tartanair": (14, 0.1, 1.5, "velo2cam"),
}


def class_colors(n_classes: int, dataset: str) -> np.ndarray:
    if dataset == "NYU":
        cols = np.zeros((n_classes + 1, 3), np.float32)
        cols[1:len(NYU_COLORS) + 1] = NYU_COLORS[:n_classes]
        return cols[:n_classes]
    cols = np.zeros((max(n_classes, 20), 3), np.float32)
    for c in range(len(cols)):
        bgr = COLOR_MAP_BGR.get(c, (128, 128, 128))
        cols[c] = np.array(bgr[::-1], np.float32) / 255.0
    return cols[:n_classes]


def camera_wireframe(record: dict, d: float, mode: str):
    """5-point camera pyramid in voxel-origin-relative world coords.

    Reference kitti_vis_pred.py:46-66 / NYU_vis_pred.py:41-59.
    """
    cam_k = np.asarray(record["cam_k"], np.float64)
    f = float(cam_k[0, 0])
    # image size from the intrinsics' principal point (cx, cy) ~ centre
    w = 2.0 * float(cam_k[0, 2])
    h = 2.0 * float(cam_k[1, 2])
    x = d * w / (2 * f)
    y = d * h / (2 * f)
    tri = np.array([
        [0, 0, 0], [x, y, d], [-x, y, d], [-x, -y, d], [x, -y, d],
    ], np.float64)
    tri = np.hstack([tri, np.ones((5, 1))])
    if mode == "cam_pose" and "cam_pose" in record:
        pose = np.asarray(record["cam_pose"], np.float64)
    else:
        pose = np.linalg.inv(np.asarray(record["T_velo_2_cam"], np.float64))
    pts = (pose @ tri.T).T[:, :3]
    if "vox_origin" in record:
        pts = pts - np.asarray(record["vox_origin"], np.float64)[None]
    edges = [(0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (2, 3), (3, 4), (4, 1)]
    return pts, edges


def _voxel_scatter(ax, vol, fov_mask, cols, voxel_size, stride):
    """Scatter occupied voxels; in-FOV full color, out-of-FOV dimmed."""
    X, Y, Z = vol.shape
    fov = np.asarray(fov_mask).reshape(X, Y, Z)
    g = vol[::stride, ::stride, ::stride]
    fg = fov[::stride, ::stride, ::stride]
    occ = np.argwhere((g > 0) & (g != 255))
    if occ.size:
        labs = g[occ[:, 0], occ[:, 1], occ[:, 2]]
        infov = fg[occ[:, 0], occ[:, 1], occ[:, 2]]
        c = cols[labs % len(cols)].copy()
        c[~infov] *= 2.0 / 3.0  # reference lut `//3*2` dim for out-of-FOV
        pts = (occ * stride + 0.5) * voxel_size
        ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], c=c, s=2, marker="s",
                   linewidths=0)
    ax.set_box_aspect([vol.shape[0], vol.shape[1], max(1, vol.shape[2])])
    ax.set_axis_off()


def render_frame(record: dict, out_path: str, dataset: str = "kitti",
                 voxel_stride: int = 2, n_classes: int = None,
                 with_target: bool = False):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    preset = DATASET_PRESETS.get(dataset, DATASET_PRESETS["kitti"])
    n_cls = n_classes or preset[0]
    voxel_size, cam_d, pose_mode = preset[1], preset[2], preset[3]
    cols = class_colors(n_cls, dataset)

    y_pred = np.asarray(record["y_pred"])
    fov = record.get("fov_mask_1", np.ones(y_pred.size, bool))
    panels = [("prediction", y_pred)]
    if with_target and "target" in record:
        panels.append(("ground truth", np.asarray(record["target"])))

    fig = plt.figure(figsize=(8 * (len(panels) + 1) - 2, 7))
    for i, (title, vol) in enumerate(panels):
        ax = fig.add_subplot(1, len(panels) + 1, i + 1, projection="3d")
        _voxel_scatter(ax, vol, fov, cols, voxel_size, voxel_stride)
        try:
            pts, edges = camera_wireframe(record, cam_d, pose_mode)
            for a, b in edges:
                ax.plot(*zip(pts[a], pts[b]), color="k", linewidth=1.2)
        except KeyError:
            pass
        ax.set_title(title)

    # top-down (highest occupied voxel wins)
    ax2 = fig.add_subplot(1, len(panels) + 1, len(panels) + 1)
    occ3d = (y_pred > 0) & (y_pred != 255)
    top = np.zeros(y_pred.shape[:2], np.int32)
    for z in range(y_pred.shape[2]):  # low to high; higher overwrites
        m = occ3d[:, :, z]
        top[m] = y_pred[:, :, z][m]
    img = cols[top % len(cols)].copy()
    img[top == 0] = 1.0
    ax2.imshow(np.rot90(img), interpolation="nearest")
    ax2.set_title("top-down semantic map")
    ax2.axis("off")

    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)


def write_gif(png_paths, gif_path: str, fps: float = 4.0):
    """Assemble rendered frames into an animated GIF (the batch/video
    variant, reference kitti_vis_pred_batch.py)."""
    from PIL import Image

    frames = [Image.open(p).convert("P", palette=Image.ADAPTIVE)
              for p in png_paths]
    if not frames:
        return
    frames[0].save(
        gif_path, save_all=True, append_images=frames[1:],
        duration=int(1000 / fps), loop=0,
    )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--input-dir", required=True,
                    help="directory of generate_output pickles")
    ap.add_argument("--output-dir", required=True)
    ap.add_argument("--dataset", default="kitti",
                    choices=sorted(DATASET_PRESETS))
    ap.add_argument("--n-classes", type=int, default=None)
    ap.add_argument("--with-target", action="store_true",
                    help="side-by-side ground-truth panel")
    ap.add_argument("--gif", default=None,
                    help="also write an animated GIF at this path")
    ap.add_argument("--fps", type=float, default=4.0)
    ap.add_argument("--limit", type=int, default=0)
    args = ap.parse_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)
    paths = sorted(glob.glob(os.path.join(args.input_dir, "*.pkl")))
    if args.limit:
        paths = paths[: args.limit]
    pngs = []
    for p in paths:
        with open(p, "rb") as f:
            record = pickle.load(f)
        out = os.path.join(
            args.output_dir,
            os.path.splitext(os.path.basename(p))[0] + ".png",
        )
        render_frame(record, out, dataset=args.dataset,
                     n_classes=args.n_classes, with_target=args.with_target)
        pngs.append(out)
        print("wrote", out)
    if args.gif:
        write_gif(pngs, args.gif, args.fps)
        print("wrote", args.gif)


if __name__ == "__main__":
    main()
