"""Port modules vs their JAX counterparts on shared NumPy inputs (CPU).

Covers the config copy, the synthetic batch, the frustum geometry, the
SFA lift (holder of kernel K1) and CPMegaVoxels (holder of kernel K2).
Weights reach the flax modules through the JAX package's own converter.
"""
import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import occdepth_tpu.config as jax_config
from occdepth_tpu.data.batch import make_synthetic_batch as jax_batch
from occdepth_tpu.geometry.depth_bins import bin_depths as jax_bin_depths
from occdepth_tpu.geometry.frustum import FrustumGridSpec as JaxSpec
from occdepth_tpu.geometry.frustum import frustum_grid as jax_frustum_grid
from occdepth_tpu.models.crp3d import CPMegaVoxels as JaxCPMegaVoxels
from occdepth_tpu.models.sfa import sfa_lift as jax_sfa_lift
from occdepth_tpu.models.unet3d_blocks import SegmentationHead as JaxSegHead
from occdepth_tpu.ops.grid_sample import grid_sample_3d_ones as jax_ones
from occdepth_tpu.ops.resize import resize_bilinear as jax_resize
from occdepth_tpu.testing import (
    tiny_kitti_config as jax_tiny_kitti,
    tiny_nyu_config,
    tiny_tartanair_config,
)
from occdepth_tpu.training.convert_torch import (
    _map_crp,
    _map_seg_head,
    _Mapper,
    _nest,
)
import occdepth_tpu_torch.config as port_config
from occdepth_tpu_torch.data.batch import make_synthetic_batch
from occdepth_tpu_torch.geometry.depth_bins import bin_depths
from occdepth_tpu_torch.geometry.frustum import FrustumGridSpec, frustum_grid
from occdepth_tpu_torch.models.crp3d import CPMegaVoxels
from occdepth_tpu_torch.models.sfa import sfa_lift
from occdepth_tpu_torch.models.unet3d_blocks import SegmentationHead
from occdepth_tpu_torch.ops.grid_sample import grid_sample_3d_ones
from occdepth_tpu_torch.ops.resize import resize_bilinear
from occdepth_tpu_torch.testing import randomize_weights, tiny_kitti_config

SHIPPED = [
    "semantic_kitti/multicam_flospdepth_crp_stereodepth_cascadecls",
    "semantic_kitti/multicam_flospdepth_crp_stereodepth_cascadecls_highcap",
    "semantic_kitti/multicam_flospdepth_crp_stereodepth_cascadecls_occluded",
    "semantic_kitti/multicam_flosp_crp_cascadecls_highcap",
    "semantic_kitti/flospdepth",
    "NYU/multicam_flosp_crp_stereodepth_cascadecls",
    "NYU/multicam_flosp_crp_depthgt_b7_v100",
    "tartanair/flosp_crp_cascadecls",
]


@pytest.mark.parametrize("name", ["FlospDepthConfig", "OccDepthConfig"])
def test_config_copy_pins_fields_and_defaults(name):
    ours = dataclasses.fields(getattr(port_config, name))
    ref = dataclasses.fields(getattr(jax_config, name))
    assert [(f.name, str(f.type), f.default) for f in ours] == \
        [(f.name, str(f.type), f.default) for f in ref]
    assert port_config.FLOSP_DEPTH_KITTI == port_config.FlospDepthConfig(
        **dataclasses.asdict(jax_config.FLOSP_DEPTH_KITTI))
    assert port_config.FLOSP_DEPTH_NYU == port_config.FlospDepthConfig(
        **dataclasses.asdict(jax_config.FLOSP_DEPTH_NYU))


@pytest.mark.parametrize("name", SHIPPED)
def test_config_loader_matches(name):
    path = port_config.default_config_path(name)
    assert path == os.path.join(os.path.dirname(port_config.__file__),
                                "configs", name + ".yaml")
    over = {"compute_dtype": "float32", "use_pallas": True}
    ours = port_config.load_config(path, over)
    ref = jax_config.load_config(jax_config.default_config_path(name), over)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    for prop in ("project_res", "output_scale", "with_depth_gt", "n_views",
                 "n_lift_views", "scene_size_meters", "voxel_size_meters",
                 "img_shape"):
        assert getattr(ours, prop) == getattr(ref, prop), prop
    assert dataclasses.asdict(ours.flosp_depth_conf) == \
        dataclasses.asdict(ref.flosp_depth_conf)
    with pytest.raises(ValueError):
        port_config.load_config(path, {"no_such_key": 1})


def test_tiny_config_matches():
    assert dataclasses.asdict(tiny_kitti_config()) == \
        dataclasses.asdict(jax_tiny_kitti())


_JAX_CONFIGS = {
    "tiny_kitti": jax_tiny_kitti,
    "flagship": jax_config.OccDepthConfig,
    "tiny_tartanair": tiny_tartanair_config,
    "tiny_nyu": tiny_nyu_config,
}


def _port_cfg(ref_cfg):
    kw = {f.name: getattr(ref_cfg, f.name)
          for f in dataclasses.fields(ref_cfg)}
    if kw["flosp_depth_override"] is not None:
        kw["flosp_depth_override"] = port_config.FlospDepthConfig(
            **dataclasses.asdict(kw["flosp_depth_override"]))
    return port_config.OccDepthConfig(**kw)


@pytest.mark.parametrize("which", sorted(_JAX_CONFIGS))
def test_synthetic_batch_bit_exact(which):
    ref_cfg = _JAX_CONFIGS[which]()
    ours = make_synthetic_batch(_port_cfg(ref_cfg), batch_size=2, seed=5)
    ref = jax_batch(ref_cfg, batch_size=2, seed=5, with_labels=False)
    for k, v in ours.items():
        assert v.dtype == ref[k].dtype, k
        np.testing.assert_array_equal(v, ref[k], err_msg=k)
    expected = {"img", "projected_pix", "fov_mask", "cam_k", "T_velo_2_cam",
                "ida_mats", "vox_origin", "virtual_bf"}
    assert set(ours) == expected & set(ref)


@pytest.mark.parametrize("mode", ["UD", "LID", "SID"])
def test_bin_depths_matches(mode):
    rng = np.random.RandomState(1)
    depth = rng.uniform(-3.0, 60.0, size=(200,)).astype(np.float32)
    depth[:3] = [np.nan, np.inf, -np.inf]
    ref = jax_bin_depths(depth, mode, 2.0, 54.0, 104, xp=np)
    ours = bin_depths(torch.from_numpy(depth), mode, 2.0, 54.0, 104)
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("flip", [False, True])
def test_frustum_grid_matches(flip):
    H, W = 48, 72
    kw = dict(grid_size=(10, 8, 6), pc_range=(0.0, -3.2, -1.6, 6.4, 3.2, 1.6),
              num_bins=12, depth_min=2.0, depth_max=10.0, mode="LID",
              final_dim=(H, W))
    l2c = np.zeros((2, 2, 4, 4), np.float32)
    for b in range(2):
        for v in range(2):
            l2c[b, v] = np.eye(4)
            l2c[b, v, :3, :3] = [[0, -1, 0], [0, 0, -1], [1, 0, 0]]
            l2c[b, v, :3, 3] = [0.05 - 0.5 * v, 0.8 + 0.1 * b, -0.3]
    cam_k = np.array([[60.0, 0, 36], [0, 58.0, 24], [0, 0, 1]], np.float32)
    c2i = np.broadcast_to(
        np.concatenate([cam_k, np.zeros((3, 1), np.float32)], 1), (2, 2, 3, 4))
    ida = np.broadcast_to(np.eye(4, dtype=np.float32), (2, 2, 4, 4)).copy()
    if flip:
        ida[1, :, 0, 0], ida[1, :, 0, 3] = -1.0, W - 1
    ours = frustum_grid(FrustumGridSpec(**kw), torch.from_numpy(l2c),
                        torch.from_numpy(c2i.copy()), torch.from_numpy(ida))
    assert ours.shape == (2, 2, 10, 8, 6, 3)
    # jitted: one compile for the four (batch, view) grids, not one per op
    grid = jax.jit(functools.partial(jax_frustum_grid, JaxSpec(**kw)))
    for b in range(2):
        for v in range(2):
            ref = grid(jnp.asarray(l2c[b, v]), jnp.asarray(c2i[b, v]),
                       jnp.asarray(ida[b, v]))
            np.testing.assert_allclose(ours[b, v].numpy(), np.asarray(ref),
                                       atol=1e-4)
    ones = grid_sample_3d_ones((12, H // 8, W // 8), ours)
    np.testing.assert_allclose(
        ones[1, 0].numpy(),
        np.asarray(jax_ones((12, H // 8, W // 8), jnp.asarray(ours[1, 0]))),
        atol=1e-6)


@pytest.mark.parametrize("align_corners", [True, False])
def test_resize_bilinear_matches(align_corners):
    rng = np.random.RandomState(2)
    x = rng.randn(2, 5, 7, 3).astype(np.float32)
    ref = jax_resize(jnp.asarray(x), (12, 9), align_corners=align_corners)
    ours = resize_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2), (12, 9),
                           align_corners)
    np.testing.assert_allclose(ours.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("pattern_points", [1, 5])
def test_sfa_lift_matches(pattern_points):
    """sfa_lift (K1's holder: 2-view fusion) vs the JAX lift."""
    rng = np.random.RandomState(3)
    B, V, C, H, W = 2, 2, 8, 32, 48
    scene = (4, 4, 2)
    N = int(np.prod(scene))
    res = (1, 2, 4)
    maps = {}
    for s in res:
        h, w = -(-H // s), -(-W // s)
        maps[f"1_{s}"] = rng.randn(B, V, h, w, C).astype(np.float32)
    pix = np.stack([rng.randint(-4, W + 4, (B, V, N, pattern_points)),
                    rng.randint(-4, H + 4, (B, V, N, pattern_points))], -1)
    fov = ((pix[..., 0] >= 0) & (pix[..., 0] < W) & (pix[..., 1] >= 0)
           & (pix[..., 1] < H) & (rng.rand(B, V, N, pattern_points) > 0.2))
    pix = pix.astype(np.int32)
    ref = jax.jit(jax_sfa_lift, static_argnums=(3, 4, 5))(
        {k: jnp.asarray(v) for k, v in maps.items()}, jnp.asarray(pix),
        jnp.asarray(fov), res, scene, "kitti")
    ours = sfa_lift(
        {k: torch.from_numpy(v).permute(0, 1, 4, 2, 3)
         for k, v in maps.items()},
        torch.from_numpy(pix), torch.from_numpy(fov), res, scene, "kitti")
    assert ours.shape == (B, *scene, C)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)


def test_cp_mega_voxels_matches():
    """CPMegaVoxels (K2's holder) vs the flax module, weights carried by
    the JAX package's converter."""
    feature, size, B = 16, (8, 8, 4), 2
    mod = randomize_weights(CPMegaVoxels(feature, size, n_relations=4,
                                         bn_momentum=0.1), seed=4).eval()
    variables = _flax_variables(mod, _map_crp, 4)
    x = np.random.RandomState(8).randn(B, feature, *size).astype(np.float32)
    with torch.no_grad():
        ours = mod(torch.from_numpy(x))
    ref = jax.jit(JaxCPMegaVoxels(feature, size, n_relations=4,
                                  bn_momentum=0.1).apply, static_argnums=2)(
        variables, jnp.asarray(x.transpose(0, 2, 3, 4, 1)), False)
    np.testing.assert_allclose(ours["x"].numpy().transpose(0, 2, 3, 4, 1),
                               np.asarray(ref["x"]), atol=1e-4)
    np.testing.assert_allclose(ours["P_logits"].numpy(),
                               np.asarray(ref["P_logits"]), atol=1e-4)


def _flax_variables(mod, map_fn, *args):
    """Carry a port module's weights into flax through the converter."""
    sd = {f"m.{k}": v.numpy() for k, v in mod.state_dict().items()}
    m = _Mapper(sd)
    map_fn(m, "m", "m", *args)
    assert not m.missing, m.missing[:5]
    return {"params": _nest(m.params)["m"], "batch_stats": _nest(m.stats)["m"]}


@pytest.mark.parametrize("cascade", [True, False])
def test_segmentation_head_matches(cascade):
    """The full-grid head, with and without the occupancy cascade (the
    shipped `semantic_kitti/flospdepth` config runs without it)."""
    mod = randomize_weights(SegmentationHead(8, 20, cascade_cls=cascade),
                            seed=6).eval()
    variables = _flax_variables(mod, _map_seg_head, cascade)
    x = np.random.RandomState(9).randn(1, 8, 8, 8, 6).astype(np.float32)
    with torch.no_grad():
        ssc, occ = mod(torch.from_numpy(x))
    ref = jax.jit(JaxSegHead(8, 20, cascade_cls=cascade).apply,
                  static_argnums=2)(
        variables, jnp.asarray(x.transpose(0, 2, 3, 4, 1)), False)
    ref_ssc, ref_occ = ref if cascade else (ref, None)
    np.testing.assert_allclose(ssc.numpy().transpose(0, 2, 3, 4, 1),
                               np.asarray(ref_ssc), atol=1e-4)
    assert (occ is None) == (ref_occ is None)
    if cascade:
        np.testing.assert_allclose(occ.numpy().transpose(0, 2, 3, 4, 1),
                                   np.asarray(ref_occ), atol=1e-4)
