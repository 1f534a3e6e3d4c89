"""The reference's view of a configuration file (`portbench/configs/*.json`).

The reference reads the configuration as the benchmark stores it, not
through the program's config class: `config` holds the shipped YAML's keys
and the benchmark's overrides, `derived` the dataset constants the program
would look up (scene and voxel sizes, image size, the OAD depth bins, the
class weights).
"""
from __future__ import annotations

import math
from types import SimpleNamespace

import numpy as np


class RefConfig:
    """Attribute access to one configuration file's `config` and `derived`
    groups, with the few properties the reference network and losses use."""

    def __init__(self, spec: dict):
        self.spec = spec
        self._c = dict(spec["config"])
        self._d = dict(spec["derived"])

    def __getattr__(self, key):
        for group in (self.__dict__.get("_c", {}), self.__dict__.get("_d", {})):
            if key in group:
                v = group[key]
                return tuple(v) if isinstance(v, list) else v
        raise AttributeError(key)

    @property
    def project_res(self):
        res = [1]
        for s, key in ((2, "project_1_2"), (4, "project_1_4"),
                       (8, "project_1_8")):
            if self._c[key]:
                res.append(s)
        return tuple(res)

    @property
    def with_depth_gt(self) -> bool:
        c = self._c
        return bool(c.get("use_stereo_depth_gt") or c.get("use_lidar_depth_gt")
                    or c.get("use_depth_gt"))

    @property
    def n_views(self) -> int:
        return 2 if self._c["multi_view_mode"] else 1

    @property
    def output_scale(self) -> int:
        return -(-self._c["project_scale"] // 2)

    @property
    def img_shape(self):
        return tuple(self._d["img_shape"])

    @property
    def flosp_depth_conf(self):
        fd = dict(self._d["flosp_depth"])
        for k in ("x_bound", "y_bound", "z_bound", "d_bound", "final_dim"):
            fd[k] = tuple(fd[k])
        return SimpleNamespace(**fd)

    @property
    def depth_channels(self) -> int:
        d = self._d["flosp_depth"]["d_bound"]
        return int((d[1] - d[0]) / d[2])

    def class_weights(self) -> np.ndarray:
        """CE weights: 1 / log(freq + 0.001) from class frequencies, or the
        weights as listed."""
        d = self._d
        if "class_frequencies" in d:
            return (1.0 / np.log(np.asarray(d["class_frequencies"])
                                 + 0.001)).astype(np.float32)
        return np.asarray(d["class_weights"], np.float32)

    def class_weights_occ(self) -> np.ndarray:
        d = self._d
        if "class_frequencies" in d:
            f = np.asarray(d["class_frequencies"])
            occ = np.array([f[0], f[1:].sum()])
            return (1.0 / np.log(occ + 0.001)).astype(np.float32)
        return np.asarray(d["class_weights_occ"], np.float32)

    def scene_dims(self, scale: int = 1):
        return tuple(s // scale for s in self._c["full_scene_size"])

    def n_voxels(self, scale: int = 1) -> int:
        return math.prod(self.scene_dims(scale))
