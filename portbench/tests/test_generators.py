"""The benchmark's seeded weights and inputs: they repeat by seed, and the
frozen copies of the rig, relation and frustum arithmetic give the
program's own numbers."""
import json
import os

import numpy as np
import pytest
import torch

from portbench.core import inputs, weights
from portbench.core.spec import REPO

HERE = os.path.dirname(os.path.abspath(__file__))
CONFIGS = os.path.join(os.path.dirname(HERE), "configs")
BIG_SEED = 2**31 + 98765


def load(path):
    with open(path) as f:
        return json.load(f)


def test_weights_repeat_by_seed():
    shapes = {"a.weight": ((4, 3, 3, 3), torch.float32),
              "a.bias": ((4,), torch.float32),
              "bn.weight": ((4,), torch.float32),
              "bn.bias": ((4,), torch.float32),
              "bn.running_mean": ((4,), torch.float32),
              "bn.running_var": ((4,), torch.float32),
              "bn.num_batches_tracked": ((), torch.int64)}
    a = weights.make_state_dict(shapes, BIG_SEED, "cpu")
    b = weights.make_state_dict(shapes, BIG_SEED, "cpu")
    c = weights.make_state_dict(shapes, BIG_SEED + 1, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in shapes)
    assert not torch.equal(a["a.weight"], c["a.weight"])
    assert (a["bn.running_var"] > 0).all()
    assert int(a["bn.num_batches_tracked"]) == 0
    # PyTorch's default spread: std 1 / sqrt(3 fan_in)
    big = weights.make_state_dict({"w": ((256, 64, 3, 3), torch.float32)},
                                  3, "cpu")["w"]
    assert abs(float(big.std()) * (3 * 64 * 9) ** 0.5 - 1) < 0.02


def test_inputs_repeat_by_seed():
    spec = load(os.path.join(HERE, "configs", "tiny_kitti.json"))
    rig = inputs.Rig(spec)
    a = inputs.train_batches(spec, rig, 2, 1, BIG_SEED, "cpu")
    b = inputs.train_batches(spec, rig, 2, 1, BIG_SEED, "cpu")
    c = inputs.train_batches(spec, rig, 2, 1, BIG_SEED + 1, "cpu")
    for x, y in zip(a, b):
        assert all(torch.equal(x[k], y[k]) for k in x)
    assert not torch.equal(a[0]["img"], a[1]["img"])  # rows all differ
    assert not torch.equal(a[0]["target"], c[0]["target"])
    f1 = inputs.frames_u8(rig, 3, BIG_SEED, "cpu")
    assert torch.equal(f1, inputs.frames_u8(rig, 3, BIG_SEED, "cpu"))
    assert f1.dtype == torch.uint8


def test_kitti_rig_is_the_programs_synthetic_rig():
    from occdepth_tpu_torch.config import load_config
    from occdepth_tpu_torch.data.batch import make_synthetic_batch

    spec = load(os.path.join(CONFIGS, "kitti_stereo.json"))
    cfg = load_config(os.path.join(REPO, spec["shipped_yaml"]))
    want = make_synthetic_batch(cfg, 1, seed=0)
    got = inputs.Rig(spec).calib(1)
    for k in ("projected_pix", "fov_mask", "cam_k", "T_velo_2_cam",
              "ida_mats"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_tartanair_rig_is_the_synthetic_trees_rig():
    from occdepth_tpu_torch.testing import tartanair_rig_projection

    spec = load(os.path.join(CONFIGS, "tartanair_stereo.json"))
    got = inputs.Rig(spec).calib(1)
    pix, fov = tartanair_rig_projection((120, 48, 120), 0.1)
    np.testing.assert_array_equal(got["projected_pix"], pix)
    np.testing.assert_array_equal(got["fov_mask"], fov)


@pytest.mark.parametrize("binary", [False, True])
def test_relation_matrix_is_the_programs(binary):
    from occdepth_tpu_torch.geometry.relations import compute_cp_mega_matrix

    rs = np.random.RandomState(3)
    t = rs.choice([0, 1, 2, 5, 7, 255], size=(8, 6, 4),
                  p=[0.4, 0.15, 0.15, 0.1, 0.1, 0.1]).astype(np.int32)
    got = inputs.cp_mega_matrix(torch.from_numpy(t), 2 if binary else 4)
    np.testing.assert_array_equal(got.numpy(),
                                  compute_cp_mega_matrix(t, binary))


def test_frustum_histograms_are_the_programs():
    from occdepth_tpu_torch.geometry.frustums_mask import (
        compute_frustum_class_dists_plain,
    )

    spec = load(os.path.join(HERE, "configs", "tiny_kitti.json"))
    rig = inputs.Rig(spec)
    pix, _, z = rig.projection(rig.output_scale)
    rs = np.random.RandomState(4)
    t = rs.choice([0, 3, 9, 255], size=spec["config"]["full_scene_size"])
    want = compute_frustum_class_dists_plain(
        pix, z, t, rig.W, rig.H, "kitti", 20, 2)
    got = inputs.frustum_class_dists(
        torch.from_numpy(pix[:, :, 0, 0]).long(),
        torch.from_numpy(pix[:, :, 0, 1]).long(), torch.from_numpy(z),
        torch.from_numpy(t), rig.W, rig.H, 20, 2)
    np.testing.assert_array_equal(got.numpy(), want)
