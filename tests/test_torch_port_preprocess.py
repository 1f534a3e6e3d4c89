"""The port's offline data path against the JAX package's (CPU).

The port's `preprocess_kitti`, `preprocess_nyu` and
`export_voxels_tartanair` and the JAX scripts run on the same raw files
(the port's raw-file writers in `occdepth_tpu_torch.testing`), and their
outputs are compared exactly, `.npy` arrays and pickled dicts key by key;
the port's KittiDataset reads the tree the port preprocessed as the JAX
one does; the TSDF copy integrates the JAX test's flat wall as JAX does.
Also: the port's YAML configs are byte copies of the JAX package's, and
every new module imports with JAX and the JAX package unimportable.
"""
import filecmp
import os
import pickle
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import occdepth_tpu.config as jax_config
from occdepth_tpu.data.kitti import KittiDataset as JaxKittiDataset
from occdepth_tpu.geometry.tsdf import TSDFVolume as JaxTSDFVolume
from occdepth_tpu.scripts import export_voxels_tartanair as jax_export
from occdepth_tpu.scripts import preprocess_kitti as jax_pre_kitti
from occdepth_tpu.scripts import preprocess_nyu as jax_pre_nyu
from occdepth_tpu_torch.config import OccDepthConfig
from occdepth_tpu_torch.data.kitti import KittiDataset
from occdepth_tpu_torch.geometry.tsdf import TSDFVolume, write_ply_points
from occdepth_tpu_torch.native_ext import downsample_label_plain
from occdepth_tpu_torch.scripts import export_voxels_tartanair as export
from occdepth_tpu_torch.scripts import preprocess_kitti as pre_kitti
from occdepth_tpu_torch.scripts import preprocess_nyu as pre_nyu
from occdepth_tpu_torch.testing import (
    make_kitti_tree,
    make_nyu_tree,
    write_kitti_raw,
    write_nyu_raw,
    write_tartanair_raw,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_DIRS = (os.path.join(REPO, "occdepth_tpu_torch", "configs"),
               os.path.join(REPO, "occdepth_tpu", "configs"))


def _yamls(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files
                  if f.endswith(".yaml"))


def test_port_configs_are_byte_copies():
    ours, ref = (_yamls(d) for d in CONFIG_DIRS)
    assert ours == ref and len(ours) == 8
    for rel in ours:
        assert filecmp.cmp(*(os.path.join(d, rel) for d in CONFIG_DIRS),
                           shallow=False), rel


def _assert_dicts_equal(ours, ref):
    assert set(ours) == set(ref)
    for k, v in ref.items():
        if isinstance(v, np.ndarray):
            assert ours[k].dtype == v.dtype and ours[k].shape == v.shape, k
            np.testing.assert_array_equal(ours[k], v, err_msg=k)
        else:
            assert ours[k] == v, k


@pytest.fixture(scope="module")
def kitti_raw(tmp_path_factory):
    """A one-frame make_kitti_tree tree with raw .label/.invalid files and
    no preprocessed labels; the port preprocesses sequences 00 and 08 into
    `pre` (the dataset's root), the JAX script sequence 00 into
    `pre_jax`."""
    base = str(tmp_path_factory.mktemp("kitti_raw"))
    make_kitti_tree(base, n_frames=1)
    assert write_kitti_raw(base) == 2
    shutil.rmtree(os.path.join(base, "pre", "labels"))
    written = pre_kitti.main([
        "--config", os.path.join(CONFIG_DIRS[0], "semantic_kitti",
                                 "flospdepth.yaml"),
        "--sequences", "00,08", f"data_root={base}/kitti",
        f"data_preprocess_root={base}/pre"])
    jax_pre_kitti.preprocess(f"{base}/kitti", f"{base}/pre_jax", ["00"])
    return base, written


def test_preprocess_kitti_matches_jax(kitti_raw):
    base, written = kitti_raw
    assert [os.path.relpath(p, base) for p in written] == [
        "pre/labels/00/000000_1_1.npy", "pre/labels/08/000000_1_1.npy"]
    for suffix, shape in (("_1_1", (256, 256, 32)), ("_1_8", (32, 32, 4))):
        ours = np.load(f"{base}/pre/labels/00/000000{suffix}.npy")
        ref = np.load(f"{base}/pre_jax/labels/00/000000{suffix}.npy")
        assert ours.dtype == ref.dtype == np.uint8 and ours.shape == shape
        np.testing.assert_array_equal(ours, ref)
    # rerunning skips the frames already written
    assert pre_kitti.preprocess(f"{base}/kitti", f"{base}/pre",
                                ["00"]) == []


def test_preprocess_kitti_remap_and_pool(kitti_raw):
    """_1_1 is the learning-map remap with invalid voxels at 255; _1_8 its
    plain majority pool (a slab of x, to keep the plain one-hot small)."""
    from occdepth_tpu_torch.data import kitti_io

    base, _ = kitti_raw
    vox = f"{base}/kitti/dataset/sequences/08/voxels/000000"
    raw = np.fromfile(vox + ".label", np.uint16)
    invalid = np.unpackbits(np.fromfile(vox + ".invalid", np.uint8))
    lut = kitti_io.get_remap_lut()
    expect = np.where(invalid == 1, 255, lut[raw]).reshape(256, 256, 32)
    t11 = np.load(f"{base}/pre/labels/08/000000_1_1.npy")
    np.testing.assert_array_equal(t11, expect)
    t18 = np.load(f"{base}/pre/labels/08/000000_1_8.npy")
    np.testing.assert_array_equal(t18[:4], downsample_label_plain(t11[:32],
                                                                  8))
    assert len(np.unique(t18)) > 5


def test_kitti_dataset_reads_preprocessed_tree_as_jax(kitti_raw):
    base, _ = kitti_raw
    kw = dict(dataset="kitti", data_root=f"{base}/kitti",
              data_preprocess_root=f"{base}/pre",
              data_stereo_depth_root=f"{base}/stereo_depth",
              use_stereo_depth_gt=True, frustum_size=4)
    ours = KittiDataset(OccDepthConfig(**kw), "val")[0]
    ref = JaxKittiDataset(jax_config.OccDepthConfig(**kw), "val")[0]
    _assert_dicts_equal(ours, ref)
    assert ours["frustums_class_dists"].sum() > 0


def test_preprocess_nyu_matches_jax(tmp_path):
    base = str(tmp_path)
    make_nyu_tree(base, n_frames=1)
    os.remove(os.path.join(base, "NYUtrain", "NYU0001_0000.bin"))
    assert write_nyu_raw(base) == 1
    shutil.rmtree(os.path.join(base, "base"))
    written = pre_nyu.main([
        "--config", os.path.join(CONFIG_DIRS[0], "NYU",
                                 "multicam_flosp_crp_stereodepth_cascadecls"
                                 ".yaml"),
        f"data_root={base}", f"data_preprocess_root={base}/ours"])
    jax_pre_nyu.preprocess(base, f"{base}/ref")
    assert [os.path.relpath(p, base) for p in written] == [
        "ours/base/NYUtest/NYU0001_0000.pkl"]
    with open(written[0], "rb") as f:
        ours = pickle.load(f)
    with open(f"{base}/ref/base/NYUtest/NYU0001_0000.pkl", "rb") as f:
        ref = pickle.load(f)
    _assert_dicts_equal(ours, ref)
    assert ours["target_1_4"].shape == (60, 36, 60)
    assert ours["target_1_16"].shape == (15, 9, 15)
    assert {0, 255} <= set(np.unique(ours["target_1_4"]).tolist())
    np.testing.assert_array_equal(pre_nyu.SEG_CLASS_MAP,
                                  jax_pre_nyu.SEG_CLASS_MAP)


def test_export_voxels_tartanair_matches_jax(tmp_path):
    """The JAX CLI test's 10-frame sequence (identity poses, floor class),
    and the port's raw writer's sequence, through both exports."""
    seq_dir = tmp_path / "office" / "Easy" / "P000"
    (seq_dir / "depth_left").mkdir(parents=True)
    (seq_dir / "seg_left").mkdir()
    H, W = 480, 640
    with open(seq_dir / "pose_left.txt", "w") as f:
        for i in range(10):
            f.write("0 0 0 0 0 0 1\n")
    for i in range(10):
        depth = np.full((H, W), 3.0 + 0.1 * i, np.float32)
        seg = np.full((H, W), 139, np.uint8)
        np.save(seq_dir / "depth_left" / f"{i:06d}_left_depth.npy", depth)
        np.save(seq_dir / "seg_left" / f"{i:06d}_left_seg.npy", seg)
    write_tartanair_raw(str(tmp_path / "w"), "P005", n_frames=6)
    cases = ((str(tmp_path), "P000"), (str(tmp_path / "w" / "ta"), "P005"))
    for root, seq in cases:
        ours = export.export_sequence(root, f"{root}/ours", "office", "Easy",
                                      seq, workers=1)
        jax_export.export_sequence(root, f"{root}/ref", "office", "Easy",
                                   seq, workers=1)
        assert [os.path.basename(p) for p in ours] == ["000000.pkl",
                                                       "000005.pkl"]
        for path in ours:
            with open(path, "rb") as f:
                a = pickle.load(f)
            with open(path.replace("/ours/", "/ref/"), "rb") as f:
                b = pickle.load(f)
            _assert_dicts_equal(a, b)
            assert a["target_1_1"].shape == export.VOX_SHAPE
            assert (a["target_1_1"] > 0).any()
    np.testing.assert_array_equal(export.seg_remap_lut(),
                                  jax_export.seg_remap_lut())


def test_tsdf_flat_wall_matches_jax(tmp_path):
    """tests/test_tsdf.py's flat wall through both TSDF volumes."""
    H, W = 48, 64
    f = 50.0
    intr = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]])
    depth = np.full((H, W), 2.0, np.float32)
    color = np.full((H, W, 3), 128, np.uint8)
    bounds = np.array([[-1.5, 1.5], [-1.5, 1.5], [0.0, 3.0]])
    vols = [cls(bounds, voxel_size=0.1) for cls in (TSDFVolume,
                                                    JaxTSDFVolume)]
    for vol in vols:
        for _ in range(3):
            vol.integrate(color, depth, intr, np.eye(4))
    (tsdf, col), (ref_tsdf, ref_col) = (v.get_volume() for v in vols)
    np.testing.assert_allclose(tsdf, ref_tsdf, rtol=0, atol=1e-6)
    np.testing.assert_allclose(col, ref_col, rtol=0, atol=1e-6)
    ci = tsdf.shape[0] // 2
    assert tsdf[ci, ci, 15] > 0.5 and tsdf[ci, ci, 23] < 0.0
    pts, ref_pts = (v.get_point_cloud() for v in vols)
    np.testing.assert_array_equal(pts, ref_pts)
    assert abs(np.median(pts[:, 2]) - 2.0) < 0.15
    write_ply_points(str(tmp_path / "pc.ply"), pts[:10])
    assert (tmp_path / "pc.ply").read_text().count("\n") == 17
    with pytest.raises(ImportError):
        vols[0].get_mesh()  # scikit-image is not installed


def test_data_path_modules_import_no_jax(tmp_path):
    """The new modules import, a binding runs and bench_loader's argument
    parsing works, with jax, flax and the JAX package unimportable."""
    code = textwrap.dedent("""
        import sys
        for name in ("jax", "flax", "jaxlib", "optax", "occdepth_tpu"):
            sys.modules[name] = None
        import numpy as np
        import occdepth_tpu_torch.data.kitti_io
        import occdepth_tpu_torch.geometry.frustums_mask
        import occdepth_tpu_torch.geometry.tsdf
        import occdepth_tpu_torch.scripts.bench_loader as bench_loader
        import occdepth_tpu_torch.scripts.export_voxels_tartanair
        import occdepth_tpu_torch.scripts.preprocess_kitti
        import occdepth_tpu_torch.scripts.preprocess_nyu
        from occdepth_tpu_torch import native_ext
        assert native_ext.pack_bits(np.ones(8, np.uint8))[0] == 255
        try:
            bench_loader.main(["--frustum", "neither"])
        except SystemExit as e:
            assert e.code == 2
        assert "torch" not in sys.modules
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")
