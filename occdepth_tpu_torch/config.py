"""Experiment configuration: a yaml-free copy of `occdepth_tpu/config.py`.

The port imports nothing of the JAX package, so it carries its own copy of
the two config dataclasses.  Fields, types and defaults are pinned to the
JAX package's field for field by `tests/test_torch_port_modules.py`, so the
same YAML files load into both.  PyYAML is imported only inside
`load_config`.

Keys that select TPU-only code paths (`use_pallas`, `unroll_gathers`,
`layout_pin`, `view_vmap`, `remat_*`, `sfa_bwd_stop_scales`,
`stage_barriers`, `eval_unroll`, `mesh_*`) are accepted and ignored: on
CUDA the port always runs K1 and K2.  `dw_conv_grad` (K4 in the encoder
backward) and `decoder_conv_impl` (K3 in the decoder) select paths as in
the JAX package.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class FlospDepthConfig:
    """Per-dataset OAD depth-branch constants (LID depth bins, voxel bounds)."""

    x_bound: Tuple[float, float, float]
    y_bound: Tuple[float, float, float]
    z_bound: Tuple[float, float, float]
    d_bound: Tuple[float, float, float]
    final_dim: Tuple[int, int]
    downsample_factor: int = 8
    mid_channels: int = 128
    disc_mode: str = "LID"
    agg_voxel_mode: str = "mean"

    @property
    def depth_channels(self) -> int:
        return int((self.d_bound[1] - self.d_bound[0]) / self.d_bound[2])


FLOSP_DEPTH_KITTI = FlospDepthConfig(
    x_bound=(0.0, 51.2, 0.2),
    y_bound=(-25.6, 25.6, 0.2),
    z_bound=(-2.0, 4.4, 0.2),
    d_bound=(2.0, 54.0, 0.5),
    final_dim=(370, 1220),
)

FLOSP_DEPTH_NYU = FlospDepthConfig(
    x_bound=(0.0, 4.8, 0.08),
    y_bound=(-2.4, 2.4, 0.08),
    z_bound=(0.0, 2.88, 0.08),
    d_bound=(0.0, 10.0, 0.08),
    final_dim=(480, 640),
)


@dataclasses.dataclass(frozen=True)
class OccDepthConfig:
    """Flat experiment config mirroring the reference YAML schema."""

    # dataset
    dataset: str = "kitti"  # "kitti" | "NYU" | "tartanair"
    n_relations: int = 4
    enable_log: bool = True
    data_root: str = ""
    data_preprocess_root: str = ""
    data_stereo_depth_root: str = ""
    data_lidar_depth_root: str = ""
    logdir: str = "logdir"

    # training
    max_epochs: int = 30
    log_every_n_steps: int = 10
    gradient_clip_val: float = 35.0
    use_stereo_depth_gt: bool = False
    use_lidar_depth_gt: bool = False
    use_depth_gt: bool = False
    depth_loss_weight: float = 1.0
    deterministic: bool = False
    use_strong_img_aug: bool = False
    sem_step_decay_loss: bool = False
    share_2d_backbone_gradient: bool = True
    fp_loss: bool = True
    frustum_size: int = 8
    batch_size_per_gpu: int = 1
    n_gpus: int = 1
    num_workers_per_gpu: int = 0
    accumulate_grad_batches: int = 1
    n_slices: int = 1
    exp_prefix: str = "exp"
    run: int = 1
    lr: float = 2e-4
    weight_decay: float = 1e-4

    # losses
    context_prior: bool = True
    relation_loss: bool = True
    CE_ssc_loss: bool = True
    sem_scal_loss: bool = True
    geo_scal_loss: bool = True

    # projection
    project_1_2: bool = True
    project_1_4: bool = True
    project_1_8: bool = True
    pattern_id: int = 0

    ckpt: str = ""

    # multi-view
    multi_view_mode: bool = True

    # network
    full_scene_size: Tuple[int, int, int] = (256, 256, 32)
    project_scale: int = 2
    feature: int = 32
    feature_2d_oc: int = 32
    n_classes: int = 20
    backbone_2d_name: str = "tf_efficientnet_b3_ns"
    return_up_feats: int = 1
    cascade_cls: bool = True
    occluded_cls: bool = False

    # 2d->3d transformation
    trans_2d_to_3d: str = "flosp_depth"  # "flosp" | "flosp_depth"

    # numerics: params in param_dtype, conv/matmul in compute_dtype
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"

    # JAX-package knobs; the port reads dw_conv_grad and
    # decoder_conv_impl and ignores the rest
    use_pallas: bool = False
    unroll_gathers: bool = True
    decoder_conv_impl: str = "auto"
    dw_conv_grad: str = "xla"
    layout_pin: str = "off"
    view_vmap: bool = False
    mesh_shape: Tuple[int, ...] = (1,)
    mesh_axis_names: Tuple[str, ...] = ("data",)
    remat_backbone: bool = False
    remat_heads: bool = False
    remat_loss: bool = False
    sfa_bwd_stop_scales: Tuple[int, ...] = ()
    stage_barriers: bool = False
    eval_unroll: bool = True

    # Overrides for reduced-size test/debug scenes (None = dataset defaults)
    scene_size_m: Optional[Tuple[float, float, float]] = None
    voxel_size_m: Optional[float] = None
    img_shape_hw: Optional[Tuple[int, int]] = None
    flosp_depth_override: Optional[FlospDepthConfig] = None

    # ------------------------------------------------------------------
    @property
    def project_res(self) -> Tuple[int, ...]:
        """2D scales projected by FLoSP."""
        res = [1]
        if self.project_1_2:
            res.append(2)
        if self.project_1_4:
            res.append(4)
        if self.project_1_8:
            res.append(8)
        return tuple(res)

    @property
    def output_scale(self) -> int:
        return -(-self.project_scale // 2)  # ceil(project_scale / 2)

    @property
    def with_depth_gt(self) -> bool:
        return self.use_stereo_depth_gt or self.use_lidar_depth_gt or self.use_depth_gt

    @property
    def n_views(self) -> int:
        """Camera views fed to the 2D backbone (KITTI/TartanAir stereo)."""
        if self.dataset == "NYU":
            return 1
        return 2 if self.multi_view_mode else 1

    @property
    def n_lift_views(self) -> int:
        """Views entering SFA lifting (NYU adds a virtual right view)."""
        if self.dataset == "NYU" and self.use_depth_gt:
            return 2
        return self.n_views

    @property
    def flosp_depth_conf(self) -> FlospDepthConfig:
        if self.flosp_depth_override is not None:
            return self.flosp_depth_override
        return FLOSP_DEPTH_NYU if self.dataset == "NYU" else FLOSP_DEPTH_KITTI

    @property
    def scene_size_meters(self) -> Tuple[float, float, float]:
        if self.scene_size_m is not None:
            return self.scene_size_m
        if self.dataset == "NYU":
            return (4.8, 4.8, 2.88)
        if self.dataset == "tartanair":
            return (12.0, 4.8, 12.0)
        return (51.2, 51.2, 6.4)

    @property
    def voxel_size_meters(self) -> float:
        if self.voxel_size_m is not None:
            return self.voxel_size_m
        if self.dataset == "NYU":
            return 0.08
        if self.dataset == "tartanair":
            return 0.1
        return 0.2

    @property
    def img_shape(self) -> Tuple[int, int]:
        """(H, W) of the network input image."""
        if self.img_shape_hw is not None:
            return self.img_shape_hw
        if self.dataset in ("NYU", "tartanair"):
            return (480, 640)
        return (370, 1220)

    def scene_dims(self, scale: int = 1) -> Tuple[int, int, int]:
        s = self.full_scene_size
        return (s[0] // scale, s[1] // scale, s[2] // scale)


def _coerce(value: Any, field_type: Any) -> Any:
    """Coerce a YAML value to the dataclass field's type (YAML 1.1 reads a
    dot-less '2e-4' as a string)."""
    if field_type in (float, "float"):
        return float(value)
    if field_type in (int, "int"):
        return int(value)
    if field_type in (bool, "bool") and isinstance(value, str):
        return value.strip().lower() in ("1", "true", "yes", "on")
    if isinstance(value, list):
        return tuple(value)
    return value


def load_config(path: str,
                overrides: Optional[Dict[str, Any]] = None) -> OccDepthConfig:
    """Load a YAML config file plus overrides into OccDepthConfig.

    Unknown file keys are tolerated; unknown override keys raise.
    """
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    fields = {f.name: f for f in dataclasses.fields(OccDepthConfig)}
    if overrides:
        unknown = sorted(set(overrides) - set(fields))
        if unknown:
            raise ValueError(
                f"unknown config override key(s): {', '.join(unknown)}"
            )
        raw.update(overrides)
    kwargs = {
        key: _coerce(value, fields[key].type)
        for key, value in raw.items() if key in fields
    }
    return OccDepthConfig(**kwargs)


def parse_overrides(args) -> Dict[str, Any]:
    """Parse `key=value` CLI overrides; each value is read as YAML."""
    import yaml

    out: Dict[str, Any] = {}
    for arg in args:
        if "=" not in arg:
            raise ValueError(f"override must be key=value, got {arg!r}")
        key, value = arg.split("=", 1)
        out[key] = yaml.safe_load(value)
    return out


def default_config_path(name: str) -> str:
    """Resolve a shipped config by name, e.g. 'semantic_kitti/flospdepth'.

    The port ships its own copies of the YAML files, under this package's
    `configs/` directory, byte for byte those of the JAX package.
    """
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs")
    return os.path.join(root, name + ".yaml")
