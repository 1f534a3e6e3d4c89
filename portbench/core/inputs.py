"""Seeded inputs: the rig's calibration and projection, uint8 frames and
labelled train batches.

A frozen copy of the synthetic-batch and rig arithmetic (voxel centroids
projected through the rig's extrinsics and intrinsics, the FOV mask, the
label mix, the CRP relation matrices and the frustum class histograms),
driven by the configuration file's `rig` group.  Frames, depth and labels
are drawn on the device from the run's seed, in a few large calls; the
same seed gives the same inputs.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def sub_seed(seed: int, tag: int) -> int:
    """A 63-bit seed for stream `tag` of run seed `seed` (any int)."""
    state = np.random.SeedSequence([int(seed) % 2**64, tag]).generate_state(
        2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def generator(seed: int, tag: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def vox2pix(cam_E, cam_k, vox_origin, voxel_size, img_W, img_H, scene_size):
    """Voxel centroids (row-major over the (X, Y, Z) grid that
    ceil(scene_size / voxel_size) gives) -> centre pixels (N, 1, 2) int64
    round(x f / z + c), the FOV mask (N, 1) and camera depth (N,)."""
    vol_dim = tuple(int(np.ceil(s / voxel_size))
                    for s in np.asarray(scene_size, np.float64))
    xv, yv, zv = np.meshgrid(*(np.arange(n) for n in vol_dim), indexing="ij")
    coords = np.stack([xv.reshape(-1), yv.reshape(-1), zv.reshape(-1)],
                      axis=1).astype(np.float32)
    origin = np.asarray(vox_origin, np.float64).astype(np.float32)
    pts = origin[None, :] + voxel_size * (coords + 0.5)
    E = np.asarray(cam_E)
    cam = pts @ E[:3, :3].astype(np.float32).T + E[:3, 3].astype(
        np.float32)[None, :]
    k = np.asarray(cam_k)
    z = cam[:, 2]
    px = np.round(cam[:, 0] * float(k[0, 0]) / z + float(k[0, 2])).astype(
        np.int64)
    py = np.round(cam[:, 1] * float(k[1, 1]) / z + float(k[1, 2])).astype(
        np.int64)
    pix = np.stack([px, py], axis=1)[:, None, :]
    fov = ((px >= 0) & (px < img_W) & (py >= 0) & (py < img_H) & (z > 0))
    return pix, fov[:, None], z


class Rig:
    """One stereo rig of a configuration file: calibration and the voxel
    projections at the lift's scale (and at the output scale for the
    frustum histograms)."""

    def __init__(self, spec: dict):
        c, d, r = spec["config"], spec["derived"], spec["rig"]
        if c["pattern_id"] != 0:
            raise ValueError("only pattern_id 0 (the centre pixel) is drawn")
        self.spec = spec
        self.H, self.W = d["img_shape"]
        self.V = 2 if c["multi_view_mode"] else 1
        self.project_scale = c["project_scale"]
        self.output_scale = -(-c["project_scale"] // 2)
        self.cam_k = np.asarray(r["cam_k"], np.float64)
        self.extrinsics = [np.asarray(e, np.float64)
                           for e in r["T_velo_2_cam"][:self.V]]

    def projection(self, scale: int):
        """(pix (V, N, 1, 2) int32, fov (V, N, 1) bool, z (V, N) float32)
        for voxels of `voxel_size_m * scale`."""
        r, d = self.spec["rig"], self.spec["derived"]
        out = [vox2pix(E, self.cam_k, r["vox_origin"],
                       d["voxel_size_m"] * scale, self.W, self.H,
                       r["projection_scene_size_m"]) for E in self.extrinsics]
        return (np.stack([o[0] for o in out]).astype(np.int32),
                np.stack([o[1] for o in out]),
                np.stack([o[2] for o in out]).astype(np.float32))

    def calib(self, batch_size: int) -> Dict[str, np.ndarray]:
        """The rig's non-image inputs with a leading batch dimension."""
        pix, fov, _ = self.projection(self.project_scale)
        n = math.prod(s // self.project_scale
                      for s in self.spec["config"]["full_scene_size"])
        if pix.shape[1] != n:
            raise ValueError(f"rig projects {pix.shape[1]} voxels, the grid "
                             f"has {n}")

        def tile(a):
            return np.broadcast_to(a, (batch_size,) + a.shape).copy()

        out = {
            "projected_pix": tile(pix),
            "fov_mask": tile(fov),
            "cam_k": tile(np.stack([self.cam_k] * self.V).astype(np.float32)),
            "T_velo_2_cam": tile(np.stack(self.extrinsics).astype(np.float32)),
            "ida_mats": tile(np.stack([np.eye(4)] * self.V).astype(
                np.float32)),
        }
        if self.spec["rig"]["pass_vox_origin"]:
            out["vox_origin"] = tile(np.asarray(self.spec["rig"]["vox_origin"],
                                                np.float32))
        return out


def frames_u8(rig: Rig, n: int, seed: int, device) -> torch.Tensor:
    """(n, V, H, W, 3) uint8 frames drawn on the device."""
    g = generator(seed, 1, device)
    return torch.randint(0, 256, (n, rig.V, rig.H, rig.W, 3),
                         dtype=torch.uint8, device=device, generator=g)


def normalize(frames: torch.Tensor) -> torch.Tensor:
    """uint8 (..., 3) -> ImageNet-normalised float32, as the served path."""
    dev = frames.device
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=dev)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=dev)
    return (frames.float() / 255.0 - mean) / std


def label_probs(n_classes: int) -> np.ndarray:
    """Class mix of the labels: 60% empty, 30% spread over the classes,
    the rest invalid (the last entry, read as 255)."""
    p = np.full(n_classes + 1, 0.3 / n_classes)
    p[0] = 0.6
    p[-1] = 0.1 + (0.3 - p[1:-1].sum())
    return p / p.sum()


def cp_mega_matrix(t: torch.Tensor, n_relations: int) -> torch.Tensor:
    """Relation ground truth of one (X, Y, Z) label grid at the CRP's
    scale (255 invalid): (n_rel, N, M) uint8, N the voxels, M the 2x2x2
    supervoxels, row-major.  Relation r of voxel n (label L) and
    supervoxel m holds when some valid child label c of m satisfies:
    r0 c == L != 0; r1 c != L, c != 0, L != 0; r2 c == L == 0;
    r3 c != L and (c == 0 or L == 0); binary: r0 c != L, r1 c == L."""
    X, Y, Z = t.shape
    sx, sy, sz = X // 2, Y // 2, Z // 2
    kids = t[:sx * 2, :sy * 2, :sz * 2].reshape(sx, 2, sy, 2, sz, 2)
    kids = kids.permute(0, 2, 4, 1, 3, 5).reshape(sx * sy * sz, 8).long()
    L = t.reshape(-1).long()
    n_lab = int(max(int(L[L != 255].max()) if (L != 255).any() else 0,
                    int(kids[kids != 255].max()) if (kids != 255).any()
                    else 0)) + 1
    present = torch.zeros((kids.shape[0], n_lab + 1), dtype=torch.bool,
                          device=t.device)
    present.scatter_(1, torch.where(kids == 255, n_lab, kids), True)
    present = present[:, :n_lab]  # (M, labels) valid child labels
    rv = (L != 255)[:, None]
    Li = torch.where(L == 255, 0, L)
    present_L = present[:, Li].t()  # (N, M)
    if n_relations == 2:
        n_present = present.sum(1)[None, :]
        diff = rv & (n_present - present_L.long() > 0)
        return torch.stack([diff, rv & present_L]).to(torch.uint8)
    nz = present[:, 1:].sum(1)[None, :]  # distinct valid non-empty labels
    has_empty = present[:, 0][None, :]
    Lnz = (L != 0)[:, None] & rv
    r0 = Lnz & present_L
    r1 = Lnz & (nz - present_L.long() > 0)
    r2 = rv & ~Lnz & has_empty
    r3 = rv & torch.where(Lnz, has_empty, nz > 0)
    return torch.stack([r0, r1, r2, r3]).to(torch.uint8)


def frustum_class_dists(px: torch.Tensor, py: torch.Tensor, z: torch.Tensor,
                        target: torch.Tensor, img_W: int, img_H: int,
                        n_classes: int, size: int) -> torch.Tensor:
    """GT class counts (size^2, n_classes) of each image-tile frustum: per
    view, the voxels whose centre pixel lies in the image in front of the
    camera, binned by tile floor(p size / dim); a voxel that several views
    put in one tile counts once; invalid labels count nowhere."""
    cls = target.reshape(-1).long()
    ix = torch.div(px * size, img_W, rounding_mode="floor")
    iy = torch.div(py * size, img_H, rounding_mode="floor")
    valid = (px >= 0) & (px < img_W) & (py >= 0) & (py < img_H) & (z > 0)
    tile = torch.where(valid, iy * size + ix, -1)
    keep = cls != 255
    dists = torch.zeros(size * size * n_classes, dtype=torch.float64,
                        device=target.device)
    for v in range(px.shape[0]):
        new = (tile[v] >= 0) & keep
        for u in range(v):
            new &= tile[u] != tile[v]
        dists += torch.bincount((tile[v] * n_classes + cls)[new],
                                minlength=size * size * n_classes).double()
    return dists.reshape(size * size, n_classes)


def train_batches(spec: dict, rig: Rig, n: int, batch_size: int, seed: int,
                  device) -> list:
    """`n` labelled batches, each of `batch_size` distinct rows, in the
    program's layouts (on the device)."""
    c, d = spec["config"], spec["derived"]
    B, V, H, W = batch_size, rig.V, rig.H, rig.W
    dev = torch.device(device)
    calib = {k: torch.from_numpy(v).to(dev) for k, v in rig.calib(B).items()}
    X, Y, Z = c["full_scene_size"]
    nc = c["n_classes"]
    g = generator(seed, 2, dev)
    frames = frames_u8(rig, n * B, seed, dev).reshape(n, B, V, H, W, 3)
    probs = torch.tensor(label_probs(nc), dtype=torch.float32, device=dev)
    labels = torch.multinomial(probs, n * B * X * Y * Z, replacement=True,
                               generator=g).reshape(n, B, X, Y, Z)
    labels = torch.where(labels == nc, 255, labels).to(torch.int32)
    with_depth = bool(c.get("use_stereo_depth_gt") or c.get("use_depth_gt")
                      or c.get("use_lidar_depth_gt"))
    if with_depth:
        depth = torch.rand((n, B, 1, H, W), generator=g, device=dev) * 40.0
        depth = torch.where(depth < 2.0, 0.0, depth)
    if c["fp_loss"]:
        pix_o, _, z_o = rig.projection(rig.output_scale)
        px = torch.from_numpy(pix_o[:, :, 0, 0]).to(dev).long()
        py = torch.from_numpy(pix_o[:, :, 0, 1]).to(dev).long()
        z_o = torch.from_numpy(z_o).to(dev)
    rs = d["relation_scale"]
    out = []
    for i in range(n):
        b = dict(calib)
        b["img"] = normalize(frames[i])
        b["target"] = labels[i]
        if with_depth:
            b["gt_depth"] = depth[i]
        if c["context_prior"]:
            b["CP_mega_matrices"] = torch.stack([
                cp_mega_matrix(t[::rs, ::rs, ::rs], c["n_relations"])
                for t in labels[i]])
        if c["fp_loss"]:
            b["frustums_class_dists"] = torch.stack([
                frustum_class_dists(px, py, z_o, t, W, H, nc,
                                    c["frustum_size"])
                for t in labels[i]]).float()
        out.append(b)
    return out
