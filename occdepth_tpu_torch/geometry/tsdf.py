"""Volumetric TSDF fusion (vectorized NumPy; no numba, no CUDA).

A copy of `occdepth_tpu/geometry/tsdf.py`, which re-implements the
reference's TSDF library (occdepth/data/utils/fusion.py: TSDFVolume with
vox2world / cam2pix / integrate, plus mesh and point-cloud export) as
vectorized NumPy: the reference's numba loops, and its *disabled* inline
CUDA integrate kernel (fusion.py:17,64-183), become single array
expressions.  Off the training and serving paths (SURVEY §2.3).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from occdepth_tpu_torch.geometry.projection import rigid_transform


def vox2world(vol_origin, vox_coords, vox_size, offsets=(0.5, 0.5, 0.5)):
    """Voxel grid coords -> world coords (fusion.py:201-217)."""
    vol_origin = np.asarray(vol_origin, np.float32)
    vox_coords = np.asarray(vox_coords, np.float32)
    off = np.asarray(offsets, np.float32)
    return vol_origin[None] + vox_size * vox_coords + vox_size * off[None]


def cam2pix(cam_pts, intr):
    """Camera coords -> rounded pixel coords (fusion.py:219-230)."""
    intr = np.asarray(intr, np.float32)
    fx, fy = intr[0, 0], intr[1, 1]
    cx, cy = intr[0, 2], intr[1, 2]
    z = cam_pts[:, 2]
    pix = np.empty((cam_pts.shape[0], 2), np.int64)
    pix[:, 0] = np.round(cam_pts[:, 0] * fx / z + cx)
    pix[:, 1] = np.round(cam_pts[:, 1] * fy / z + cy)
    return pix


def integrate_tsdf_arrays(tsdf_vol, dist, w_old, obs_weight):
    """Weighted running average of TSDF values (fusion.py:345-355)."""
    w_new = w_old + obs_weight
    tsdf_new = (w_old * tsdf_vol + obs_weight * dist) / w_new
    return tsdf_new, w_new


class TSDFVolume:
    """Fuse RGB-D frames into a TSDF voxel volume."""

    def __init__(self, vol_bnds: np.ndarray, voxel_size: float,
                 trunc_margin_factor: float = 5.0):
        vol_bnds = np.asarray(vol_bnds, np.float64).reshape(3, 2)
        self._voxel_size = float(voxel_size)
        self._trunc_margin = trunc_margin_factor * self._voxel_size
        self._vol_dim = np.ceil(
            (vol_bnds[:, 1] - vol_bnds[:, 0]) / voxel_size
        ).astype(int)
        self._vol_origin = vol_bnds[:, 0].astype(np.float32)

        dims = tuple(self._vol_dim)
        self._tsdf_vol = np.ones(dims, np.float32)
        self._weight_vol = np.zeros(dims, np.float32)
        self._color_vol = np.zeros(dims + (3,), np.float32)

        xv, yv, zv = np.meshgrid(
            np.arange(dims[0]), np.arange(dims[1]), np.arange(dims[2]),
            indexing="ij",
        )
        self.vox_coords = np.stack(
            [xv.reshape(-1), yv.reshape(-1), zv.reshape(-1)], axis=1
        )

    @property
    def voxel_size(self):
        return self._voxel_size

    @property
    def vol_dim(self):
        return self._vol_dim

    def integrate(self, color_im: Optional[np.ndarray], depth_im: np.ndarray,
                  cam_intr: np.ndarray, cam_pose: np.ndarray,
                  obs_weight: float = 1.0):
        """Integrate one RGB-D frame (fusion.py integrate, vectorized)."""
        H, W = depth_im.shape
        world_pts = vox2world(self._vol_origin, self.vox_coords,
                              self._voxel_size)
        cam_pts = rigid_transform(world_pts, np.linalg.inv(cam_pose))
        pix = cam2pix(cam_pts, cam_intr)
        pix_z = cam_pts[:, 2]

        valid = (
            (pix[:, 0] >= 0) & (pix[:, 0] < W)
            & (pix[:, 1] >= 0) & (pix[:, 1] < H) & (pix_z > 0)
        )
        depth_val = np.zeros(pix.shape[0], np.float32)
        depth_val[valid] = depth_im[pix[valid, 1], pix[valid, 0]]

        depth_diff = depth_val - pix_z
        valid_pts = (depth_val > 0) & (depth_diff >= -self._trunc_margin)
        dist = np.minimum(1.0, depth_diff / self._trunc_margin)

        idx = self.vox_coords[valid_pts]
        ix, iy, iz = idx[:, 0], idx[:, 1], idx[:, 2]
        w_old = self._weight_vol[ix, iy, iz]
        tsdf_old = self._tsdf_vol[ix, iy, iz]
        tsdf_new, w_new = integrate_tsdf_arrays(
            tsdf_old, dist[valid_pts], w_old, obs_weight
        )
        self._weight_vol[ix, iy, iz] = w_new
        self._tsdf_vol[ix, iy, iz] = tsdf_new

        if color_im is not None:
            old = self._color_vol[ix, iy, iz]
            new = color_im[pix[valid_pts, 1], pix[valid_pts, 0]].astype(
                np.float32
            )
            self._color_vol[ix, iy, iz] = (
                (w_old[:, None] * old + obs_weight * new) / w_new[:, None]
            )

    def get_volume(self) -> Tuple[np.ndarray, np.ndarray]:
        return self._tsdf_vol, self._color_vol

    def get_point_cloud(self) -> np.ndarray:
        """Extract the zero-crossing point cloud (fusion.py pointcloud).

        Uses marching cubes when scikit-image is available, else a
        vectorized per-axis zero-crossing interpolation (same surface, no
        triangulation).
        """
        try:
            from skimage import measure

            verts = measure.marching_cubes(self._tsdf_vol, level=0)[0]
        except ImportError:
            verts = _zero_crossings(self._tsdf_vol, self._weight_vol)
        return verts * self._voxel_size + self._vol_origin

    def get_mesh(self):
        """Marching-cubes mesh (verts, faces, norms, colors).

        Requires scikit-image (optional dependency, like the reference's
        mesh export path)."""
        from skimage import measure

        verts, faces, norms, _ = measure.marching_cubes(
            self._tsdf_vol, level=0
        )
        vi = np.round(verts).astype(int)
        vi = np.clip(vi, 0, np.asarray(self._tsdf_vol.shape) - 1)
        colors = self._color_vol[vi[:, 0], vi[:, 1], vi[:, 2]]
        verts = verts * self._voxel_size + self._vol_origin
        return verts, faces, norms, colors.astype(np.uint8)


def _zero_crossings(tsdf: np.ndarray, weight: np.ndarray) -> np.ndarray:
    """Sub-voxel zero-crossing points along each grid axis (observed voxels)."""
    pts = []
    observed = weight > 0
    for axis in range(3):
        a = np.take(tsdf, np.arange(tsdf.shape[axis] - 1), axis=axis)
        b = np.take(tsdf, np.arange(1, tsdf.shape[axis]), axis=axis)
        oa = np.take(observed, np.arange(tsdf.shape[axis] - 1), axis=axis)
        ob = np.take(observed, np.arange(1, tsdf.shape[axis]), axis=axis)
        cross = (np.sign(a) != np.sign(b)) & (a != b) & oa & ob
        idx = np.argwhere(cross).astype(np.float64)
        if idx.size == 0:
            continue
        frac = a[cross] / (a[cross] - b[cross])
        idx[:, axis] += frac
        pts.append(idx)
    if not pts:
        return np.zeros((0, 3))
    return np.concatenate(pts, axis=0)


def write_ply_mesh(path: str, verts, faces, norms, colors):
    """ASCII .ply mesh writer (fusion.py meshwrite)."""
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(verts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property float nx\nproperty float ny\nproperty float nz\n")
        f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write(f"element face {len(faces)}\n")
        f.write("property list uchar int vertex_index\nend_header\n")
        for v, n, c in zip(verts, norms, colors):
            f.write(
                f"{v[0]} {v[1]} {v[2]} {n[0]} {n[1]} {n[2]} "
                f"{int(c[0])} {int(c[1])} {int(c[2])}\n"
            )
        for face in faces:
            f.write(f"3 {face[0]} {face[1]} {face[2]}\n")


def write_ply_points(path: str, points: np.ndarray):
    """ASCII .ply point-cloud writer (fusion.py pcwrite)."""
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(points)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("end_header\n")
        for p in points:
            f.write(f"{p[0]} {p[1]} {p[2]}\n")
