"""The port's inference and output surfaces vs the JAX package's (CPU, fp32).

infer, generate_output's `dump_records` (KITTI and NYU), the KITTI
submission writer and validator, voxel_vis, dump_batch and export, on
shared weights: one seeded reference-schema state_dict, which the port
loads natively and JAX through `convert_state_dict` (the CLIs through
`--torch-ckpt`).  The registered kernel operators pass `opcheck`, and an
exported program holds them by name.

Bounds: an exported program runs the same operators as the eager model,
so its logits equal the eager ones within 1e-6; against JAX, logits hold
the serving slice's 3e-3 (`test_torch_port_slice.py`), and a predicted
class may differ only where the two best logits are within twice that
(`test_torch_port_eval.py`'s near-tie rule).
"""
import concurrent.futures
import functools
import os
import pickle
import subprocess
import sys
import textwrap
import zipfile

import numpy as np
import pytest
import torch

import occdepth_tpu.config as jax_config
import occdepth_tpu.testing as jax_testing
from occdepth_tpu.scripts import dump_batch as jax_dump_batch
from occdepth_tpu.scripts import export_model as jax_export
from occdepth_tpu.scripts import generate_kitti_submission as jax_submission
from occdepth_tpu.scripts import generate_output as jax_generate_output
from occdepth_tpu.scripts import infer as jax_infer
from occdepth_tpu.scripts import valid_kitti_submission as jax_valid
from occdepth_tpu.scripts.visualization import voxel_vis as jax_voxel_vis
from occdepth_tpu.training.convert_torch import convert_state_dict
from occdepth_tpu_torch.config import load_config, parse_overrides
from occdepth_tpu_torch.data.batch import make_synthetic_batch
from occdepth_tpu_torch.data.kitti_io import TEST_SEQUENCES, get_inv_map
from occdepth_tpu_torch.models import OccDepthModel
from occdepth_tpu_torch.scripts import (
    dump_batch,
    export_model,
    generate_kitti_submission,
    generate_output,
    infer,
    valid_kitti_submission,
)
from occdepth_tpu_torch.scripts.visualization import voxel_vis
from occdepth_tpu_torch.testing import (
    make_kitti_tree,
    randomize_weights,
    tiny_kitti_config,
    tiny_nyu_config,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(
    REPO, "occdepth_tpu", "configs", "semantic_kitti",
    "multicam_flospdepth_crp_stereodepth_cascadecls.yaml")
LOGIT_ATOL = 3e-3  # the serving slice's bound (test_torch_port_slice.py)
EXPORT_ATOL = 1e-6  # the exported program against the eager model
H, W = 64, 96
# the flagship YAML at toy geometry (flosp: the flosp_depth bounds are not
# a YAML override); the JAX infer test's overrides
TINY = ["trans_2d_to_3d=flosp", "full_scene_size=[32,32,16]",
        "scene_size_m=[6.4,6.4,3.2]", "voxel_size_m=0.2",
        f"img_shape_hw=[{H},{W}]", "feature=16", "feature_2d_oc=16",
        "compute_dtype=float32"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tier-1 gate runs six test processes on a few cores; this file's
    tiny-shape torch work takes one thread so it does not crowd them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _shared(cfg, jcfg, seed=7):
    """The port model (eval mode, seeded weights) and the JAX variables of
    the same weights."""
    model = randomize_weights(OccDepthModel(cfg), seed=seed).eval()
    params, stats, missing = convert_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()}, jcfg)
    assert not missing, missing[:10]
    return model, {"params": params, "batch_stats": stats}


def _beside(jax_side, port_side):
    """(jax_side(), port_side()), the JAX side in a thread beside the
    port's: the two share no state, and JAX's first call is mostly XLA's
    compiler."""
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
        ref = pool.submit(jax_side)
        ours = port_side()
        return ref.result(), ours


def _tensors(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()
            if isinstance(v, np.ndarray)}


def _port_logits(model, batch):
    with torch.no_grad():
        return model(_tensors(batch))["ssc_logit"].numpy()


def _assert_pred_matches(ours, ref, logits):
    """Equal classes wherever the two best logits are more than twice the
    logits' bound apart (either side may move by the bound)."""
    top2 = np.sort(logits, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 2 * LOGIT_ATOL
    assert ours.shape == ref.shape and ours.dtype == np.uint8
    flips = ours != ref
    print(f"near ties {int((~clear).sum())} of {clear.size}, "
          f"flips {int(flips.sum())}")
    assert not (flips & clear).any(), "a class flip off the near-ties"


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


# ---- infer ----

def _write_frame(tmp_path):
    """The JAX infer test's inputs (tests/test_cli_tools.py): two PNGs
    larger than the crop and a KITTI calib.txt."""
    from PIL import Image

    rng = np.random.RandomState(42)
    for name in ("l.png", "r.png"):
        Image.fromarray((rng.rand(H + 4, W + 8, 3) * 255).astype(np.uint8)
                        ).save(tmp_path / name)
    f = 0.9 * W
    with open(tmp_path / "calib.txt", "w") as fh:
        fh.write(f"P2: {f} 0 {W/2} 0 0 {f} {H/2} 0 0 0 1 0\n")
        fh.write(f"P3: {f} 0 {W/2} {-0.5*f} 0 {f} {H/2} 0 0 0 1 0\n")
        fh.write("Tr: 0 -1 0 0 0 0 -1 0 1 0 0 -0.27\n")
    return [str(tmp_path / n) for n in ("l.png", "r.png", "calib.txt")]


def test_infer_build_batch_is_bit_equal_to_jax(tmp_path):
    left, right, calib = _write_frame(tmp_path)
    cfg = load_config(FLAGSHIP, parse_overrides(TINY))
    jcfg = jax_config.load_config(FLAGSHIP, jax_config.parse_overrides(TINY))
    ours = infer.build_batch(cfg, [left, left], [right, right], calib)
    ref = jax_infer.build_batch(jcfg, [left, left], [right, right], calib)
    assert set(ours[0]) == set(ref[0])
    for a, b in zip((*ours[0].values(), *ours[1:]),
                    (*(ref[0][k] for k in ours[0]), *ref[1:])):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_infer_cli_matches_jax(tmp_path, monkeypatch, capsys):
    """Both CLIs on the same PNGs, calib.txt and reference-schema .ckpt:
    y_pred equal off the near-ties, fov_mask_1, cam_k and T_velo_2_cam
    bit-equal, and the port's PNG rendered."""
    left, right, calib = _write_frame(tmp_path)
    cfg = load_config(FLAGSHIP, parse_overrides(TINY))
    model = randomize_weights(OccDepthModel(cfg), seed=3).eval()
    ckpt = tmp_path / "ref.ckpt"
    torch.save({"state_dict": model.state_dict()}, ckpt)
    common = ["--config", FLAGSHIP, "--left", left, "--right", right,
              "--calib", calib, "--torch-ckpt", str(ckpt)]
    over = TINY + [f"logdir={tmp_path}/logdir"]
    monkeypatch.setattr(sys, "argv", ["infer"] + common + [
        "--output", str(tmp_path / "jax.pkl")] + over)
    _, written = _beside(jax_infer.main, lambda: infer.main(common + [
        "--output", str(tmp_path / "port.pkl"), "--render",
        str(tmp_path / "port.png"), "--device", "cpu"] + over))
    assert written == [str(tmp_path / "port.pkl")]
    assert "WARNING" not in capsys.readouterr().out
    ours, ref = _load(tmp_path / "port.pkl"), _load(tmp_path / "jax.pkl")
    assert set(ours) == set(ref)
    batch = infer.build_batch(cfg, [left], [right], calib)[0]
    _assert_pred_matches(ours["y_pred"], ref["y_pred"],
                         _port_logits(model, batch)[0])
    for k in ("fov_mask_1", "cam_k", "T_velo_2_cam"):
        assert ours[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    assert (tmp_path / "port.png").stat().st_size > 1000


def test_infer_cli_warns_without_checkpoint(tmp_path, capsys):
    left, right, calib = _write_frame(tmp_path)
    infer.main(["--config", FLAGSHIP, "--left", left, "--right", right,
                "--calib", calib, "--ckpt", "nonexistent", "--output",
                str(tmp_path / "p.pkl"), "--device", "cpu"] + TINY
               + [f"logdir={tmp_path}/logdir"])
    assert "WARNING: no checkpoint found" in capsys.readouterr().out
    assert _load(tmp_path / "p.pkl")["y_pred"].shape == (32, 32, 16)


# ---- generate_output ----

@functools.lru_cache(maxsize=None)
def _dataset_setup(dataset):
    """(port config, JAX config, port model, JAX variables, two labelled
    frames, the eager port's logits) per dataset, shared by dump_records
    and export.  KITTI's decoder runs under `pallas` (K3's plain version
    on the CPU), so its exported program holds all three operators."""
    cfg = {"kitti": lambda: tiny_kitti_config(decoder_conv_impl="pallas"),
           "NYU": tiny_nyu_config}[dataset]()
    jcfg = {"kitti": jax_testing.tiny_kitti_config,
            "NYU": jax_testing.tiny_nyu_config}[dataset]()
    model, variables = _shared(cfg, jcfg)
    batch = make_synthetic_batch(cfg, batch_size=2, seed=5, with_labels=True)
    return cfg, jcfg, model, variables, batch, _port_logits(model, batch)


@pytest.mark.parametrize("dataset", ["kitti", "NYU"])
def test_dump_records_matches_jax(tmp_path, dataset):
    """Two labelled frames at batch 2 through both dump_records: the same
    files and keys; y_pred equal off the near-ties; target, fov_mask_1,
    cam_k, T_velo_2_cam, vox_origin and NYU's cam_pose equal."""
    cfg, jcfg, model, variables, batch, logits = _dataset_setup(dataset)
    loader = [dict(batch, frame_id=["000000", "000005"],
                   sequence=["08", "08"])]
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    ref, ours = _beside(
        lambda: list(jax_generate_output.dump_records(
            jcfg, variables, loader, str(tmp_path / "jax"))),
        lambda: list(generate_output.dump_records(
            cfg, model, loader, str(tmp_path / "port"))))
    assert [os.path.basename(p) for p in ours] == [
        os.path.basename(p) for p in ref] == ["08_000000.pkl",
                                              "08_000005.pkl"]
    for i, (p, q) in enumerate(zip(ours, ref)):
        a, b = _load(p), _load(q)
        assert set(a) == set(b)
        assert ("cam_pose" in a) == (dataset == "NYU")
        assert ("vox_origin" in a) == (dataset == "NYU")
        _assert_pred_matches(a["y_pred"], b["y_pred"], logits[i])
        for k in set(a) - {"y_pred"}:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a["fov_mask_1"].size == a["y_pred"].size


# ---- submission ----

def _submission(root, rng, writer):
    inv_map = get_inv_map()
    for seq in TEST_SEQUENCES:
        y_pred = rng.randint(0, 20, size=(256, 256, 32))
        writer(str(root), seq, "000000", y_pred, inv_map)
    return root


def test_write_prediction_bytes_match_jax(tmp_path):
    y_pred = np.random.RandomState(1).randint(0, 20, size=(256, 256, 32))
    a = generate_kitti_submission.write_prediction(
        str(tmp_path / "a"), "11", "000000", y_pred, get_inv_map())
    b = jax_submission.write_prediction(
        str(tmp_path / "b"), "11", "000000", y_pred, get_inv_map())
    assert os.path.relpath(a, tmp_path / "a") == os.path.relpath(
        b, tmp_path / "b") == "sequences/11/predictions/000000.label"
    assert open(a, "rb").read() == open(b, "rb").read()


def test_validator_matches_jax(tmp_path):
    """Clean on a valid directory and zip; on the JAX test's corrupted
    directory (a truncated file, an invalid raw id, a missing sequence)
    the same errors as JAX's validator."""
    root = _submission(tmp_path / "sub", np.random.RandomState(2),
                       generate_kitti_submission.write_prediction)
    assert valid_kitti_submission.validate_dir(str(root)) == []
    zip_path = tmp_path / "sub.zip"
    with zipfile.ZipFile(zip_path, "w") as zf:
        for dirpath, _, files in os.walk(root):
            for f in files:
                full = os.path.join(dirpath, f)
                zf.write(full, os.path.relpath(full, root))
    assert valid_kitti_submission.validate_zip(str(zip_path)) == []
    valid_kitti_submission.main([str(zip_path)])

    bad = root / "sequences" / "11" / "predictions" / "000000.label"
    bad.write_bytes(bad.read_bytes()[:100])
    bad2 = root / "sequences" / "12" / "predictions" / "000000.label"
    np.full(256 * 256 * 32, 7, np.uint16).tofile(bad2)
    import shutil

    shutil.rmtree(root / "sequences" / "21")
    errors = valid_kitti_submission.validate_dir(str(root))
    assert len(errors) == 3
    assert errors == jax_valid.validate_dir(str(root))
    with pytest.raises(SystemExit):
        valid_kitti_submission.main([str(root)])


@pytest.mark.slow
def test_submission_cli_on_a_test_split_validates(tmp_path):
    """generate_kitti_submission.main over the eleven test sequences (each
    a symlink of a full-size tree's sequence 08, one frame), then the
    validator: clean.  Full resolution (the validator needs 256x256x32
    grids), narrow model."""
    make_kitti_tree(str(tmp_path), n_frames=1)
    seqs = tmp_path / "kitti" / "dataset" / "sequences"
    for seq in TEST_SEQUENCES:
        os.symlink(seqs / "08", seqs / seq)
    out = tmp_path / "submission"
    written = generate_kitti_submission.main([
        "--config", FLAGSHIP, "--output-dir", str(out), "--device", "cpu",
        f"data_root={tmp_path}/kitti", f"logdir={tmp_path}/logdir",
        "feature=8", "feature_2d_oc=8", "compute_dtype=float32",
        "backbone_2d_name=tf_efficientnet_b0_ns", "num_workers_per_gpu=0"])
    assert len(written) == len(TEST_SEQUENCES)
    assert valid_kitti_submission.validate_dir(str(out)) == []


# ---- voxel_vis and dump_batch ----

@pytest.mark.parametrize("dataset,n", [("kitti", 20), ("NYU", 12),
                                       ("tartanair", 14)])
def test_class_colors_match_jax(dataset, n):
    np.testing.assert_array_equal(voxel_vis.class_colors(n, dataset),
                                  jax_voxel_vis.class_colors(n, dataset))


def test_render_frame_writes_png(tmp_path):
    rng = np.random.RandomState(4)
    vol = rng.choice([0, 0, 0, 1, 5, 9, 255], size=(32, 32, 8)).astype(
        np.uint8)
    T = np.eye(4)
    T[:3, :3] = [[0, -1, 0], [0, 0, -1], [1, 0, 0]]
    record = {"y_pred": vol, "target": vol,
              "fov_mask_1": rng.rand(vol.size) > 0.4,
              "cam_k": np.array([[50.0, 0, 48.0], [0, 50.0, 16.0], [0, 0, 1]]),
              "T_velo_2_cam": T, "vox_origin": np.array([0.0, -3.2, -1.0])}
    voxel_vis.render_frame(record, str(tmp_path / "f.png"), with_target=True)
    assert (tmp_path / "f.png").stat().st_size > 1000


def test_dump_batch_synthetic_matches_jax(tmp_path, monkeypatch):
    args = ["--config", FLAGSHIP, "--synthetic", "--batch-size", "2"]
    dump_batch.main(args + ["--out", str(tmp_path / "port.pkl")] + TINY)
    monkeypatch.setattr(sys, "argv", ["dump_batch"] + args + [
        "--out", str(tmp_path / "jax.pkl")] + TINY)
    jax_dump_batch.main()
    ours, ref = _load(tmp_path / "port.pkl"), _load(tmp_path / "jax.pkl")
    assert set(ours) == set(ref)
    for k, v in ref.items():
        assert isinstance(ours[k], np.ndarray) and ours[k].dtype == v.dtype
        np.testing.assert_array_equal(ours[k], v, err_msg=k)


# ---- export and the registered operators ----

def _jax_exported_logits(dataset, variables, batch):
    """JAX's export_forward of the same weights, called (the decoder's
    convs under `shift`, K3's reference)."""
    jcfg = {"kitti": jax_testing.tiny_kitti_config,
            "NYU": jax_testing.tiny_nyu_config}[dataset](
                decoder_conv_impl="shift")
    exported = jax_export.export_forward(jcfg, variables, batch)
    return np.asarray(exported.call(variables, batch))


@pytest.mark.parametrize("dataset", ["kitti", "NYU"])
def test_exported_program_matches_eager_and_jax(tmp_path, dataset):
    """Export, save, load: the graph calls the registered kernels by name
    (the lift and K2 at two lift views, K3 under KITTI's `pallas`), and
    the loaded program's logits equal the eager model's within 1e-6 and
    JAX's exported forward's within 3e-3."""
    cfg, _, model, variables, batch, eager = _dataset_setup(dataset)
    inputs = _tensors(batch)
    ref, exported = _beside(
        lambda: _jax_exported_logits(dataset, variables, batch),
        lambda: export_model.export_forward(cfg, model, inputs))
    targets = {str(n.target) for n in exported.graph.nodes}
    want = {"occdepth.flosp_stereo_lift.default",
            "occdepth.crp_relation_matmul.default"}
    pallas = cfg.decoder_conv_impl == "pallas"
    if pallas:
        want.add("occdepth.conv3x3.default")
    assert want <= targets, sorted(t for t in targets if "occdepth" in t)
    assert ("occdepth.conv3x3.default" in targets) == pallas
    path = str(tmp_path / "model.pt2")
    torch.export.save(exported, path)
    loaded = export_model.load_exported(path).module()
    with torch.no_grad():
        ours = loaded({k: v for k, v in inputs.items()
                       if k in export_model.INPUT_KEYS}).numpy()
    assert ours.shape == (2, *cfg.full_scene_size, cfg.n_classes)
    assert np.abs(ours - eager).max() <= EXPORT_ATOL
    np.testing.assert_allclose(ours, ref, atol=LOGIT_ATOL)


def test_export_cli_writes_a_loadable_program(tmp_path, capsys):
    out = str(tmp_path / "m.pt2")
    export_model.main(["--config", FLAGSHIP, "--out", out, "--device", "cpu"]
                      + TINY + [f"logdir={tmp_path}/logdir"])
    assert "WARNING: no checkpoint found" in capsys.readouterr().out
    cfg = load_config(FLAGSHIP, parse_overrides(TINY))
    inputs = _tensors(make_synthetic_batch(cfg, batch_size=1))
    with torch.no_grad():
        logits = export_model.load_exported(out).module()(inputs)
    assert logits.shape == (1, 32, 32, 16, 20)
    assert torch.isfinite(logits).all()


def _lift_args(requires_grad):
    from occdepth_tpu_torch.testing import lift_inputs

    maps, pix, fov = lift_inputs(np.random.RandomState(0), 2, 64, 1, 8,
                                 (8, 12), (1, 2))
    tm = [torch.from_numpy(m).permute(0, 1, 4, 2, 3).contiguous()
          .requires_grad_(requires_grad) for m in maps.values()]
    return (tm, torch.from_numpy(pix), torch.from_numpy(fov), [1, 2], 1e-8)


@pytest.mark.parametrize("op", ["flosp_stereo_lift", "crp_relation_matmul",
                                "conv3x3"])
def test_registered_ops_pass_opcheck(op):
    """Schema, fake versus real shapes and strides, and the autograd
    registration (the lift and K2 with inputs that require grad; K3 is
    forward-only), on small CPU inputs."""
    g = torch.Generator().manual_seed(1)
    cases = {
        "flosp_stereo_lift": [_lift_args(True)],
        "crp_relation_matmul": [
            (torch.randn(2, 4, 32, 16, generator=g).requires_grad_(),
             torch.randn(2, 16, 8, generator=g).requires_grad_()),
            (torch.randn(2, 32, 16, generator=g).requires_grad_(),
             torch.randn(2, 16, 8, generator=g))],
        "conv3x3": [(torch.randn(2, 5, 6, 7, generator=g),
                     torch.randn(4, 5, 3, 3, generator=g),
                     torch.randn(4, generator=g)),
                    (torch.randn(1, 8, 4, 4, generator=g),
                     torch.randn(3, 8, 3, 3, generator=g), None)],
    }[op]
    for args in cases:
        torch.library.opcheck(getattr(torch.ops.occdepth, op).default, args)


# ---- device and imports ----

@pytest.mark.parametrize("module", ["infer", "generate_output",
                                    "generate_kitti_submission",
                                    "export_model"])
def test_cli_needs_cuda_unless_told_cpu(tmp_path, module):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    argv = {"infer": ["--left", "l.png", "--calib", "c.txt", "--output",
                      str(tmp_path / "p.pkl")],
            "generate_output": ["--output-dir", str(tmp_path / "o")],
            "generate_kitti_submission": ["--output-dir", str(tmp_path)],
            "export_model": ["--out", str(tmp_path / "m.pt2")]}[module]
    main = {"infer": infer, "generate_output": generate_output,
            "generate_kitti_submission": generate_kitti_submission,
            "export_model": export_model}[module].main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--config", FLAGSHIP] + argv + TINY)


def test_output_modules_import_no_jax(tmp_path):
    """Every new module imports, and dump_batch and the validator run,
    with jax, flax and the JAX package unimportable."""
    code = textwrap.dedent(f"""
        import sys
        for name in ("jax", "flax", "jaxlib", "optax", "occdepth_tpu"):
            sys.modules[name] = None
        import occdepth_tpu_torch.scripts.common
        import occdepth_tpu_torch.scripts.dump_batch as dump_batch
        import occdepth_tpu_torch.scripts.export_model
        import occdepth_tpu_torch.scripts.generate_kitti_submission
        import occdepth_tpu_torch.scripts.generate_output
        import occdepth_tpu_torch.scripts.infer
        import occdepth_tpu_torch.scripts.valid_kitti_submission as valid
        import occdepth_tpu_torch.scripts.visualization.voxel_vis
        dump_batch.main(["--config", {FLAGSHIP!r}, "--synthetic", "--out",
                         {str(tmp_path / "b.pkl")!r}] + {TINY!r})
        assert len(valid.validate_dir({str(tmp_path)!r})) == 11
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")

