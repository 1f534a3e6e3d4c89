"""The ported TartanAir slice, project_scale 1 and the occluded-voxel head
vs the JAX package (CPU, fp32).

`Convblock3d` and the occluded head against their flax modules on weights
carried over by the converter; the tiny TartanAir model and the tiny KITTI
model with the occluded head, eval outputs and train-mode loss terms,
against the JAX model on one seeded weight set (port -> `convert_state_dict`
-> JAX -> `state_dict_from_jax` -> port); the TartanAir dataset against the
JAX dataset on the JAX toy tree; the pose helpers; and the train and eval
CLIs on the CPU with JAX blocked.
"""
import functools
import glob
import json
import os
import pickle
import shutil
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import occdepth_tpu.config as jax_config
import occdepth_tpu.testing as jax_testing
from occdepth_tpu.data.tartanair import TartanAirDataset as JaxTartanAir
from occdepth_tpu.data.tartanair import collate as jax_collate
from occdepth_tpu.data.tartanair import quat_to_se3 as jax_quat_to_se3
from occdepth_tpu.data.tartanair import read_poses as jax_read_poses
from occdepth_tpu.models import OccDepthModel as JaxOccDepthModel
from occdepth_tpu.models.unet3d_blocks import Convblock3d as JaxConvblock3d
from occdepth_tpu.models.unet3d_blocks import (
    SegmentationHead as JaxSegmentationHead,
)
from occdepth_tpu.training.convert_torch import (
    _Mapper,
    _map_seg_head,
    _map_upsample,
    _nest,
    convert_state_dict,
)
from occdepth_tpu.training.step import compute_losses as jax_compute_losses
from occdepth_tpu_torch.config import OccDepthConfig, load_config
from occdepth_tpu_torch.data.batch import make_synthetic_batch
from occdepth_tpu_torch.data.tartanair import (
    TartanAirDataset,
    collate,
    quat_to_se3,
    read_poses,
)
from occdepth_tpu_torch.models import OccDepthModel
from occdepth_tpu_torch.models.unet3d_blocks import (
    Convblock3d,
    SegmentationHead,
)
from occdepth_tpu_torch.testing import (
    make_tartanair_tree,
    perturbed_copy,
    randomize_weights,
    tartanair_fov_share,
    tiny_kitti_config,
    tiny_tartanair_config,
)
from occdepth_tpu_torch.training.step import compute_losses
from occdepth_tpu_torch.weights import state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TA_CONFIG = os.path.join(REPO, "occdepth_tpu", "configs", "tartanair",
                         "flosp_crp_cascadecls.yaml")
OCCLUDED_CONFIG = os.path.join(
    REPO, "occdepth_tpu", "configs", "semantic_kitti",
    "multicam_flospdepth_crp_stereodepth_cascadecls_occluded.yaml")
MODULE_ATOL = 1e-5  # one block in fp32, sums reordered
LOGIT_ATOL = 3e-3  # the serving slice's bound (test_torch_port_slice.py)
LOSS_RTOL = 1e-4  # the train step's bound (test_torch_port_train_step.py)
# Train mode at the tiny sizes normalises BatchNorm over a handful of
# elements (TartanAir's 3D bottleneck is 4x2x4 voxels), so the network's
# fp32 loss terms are ill-conditioned: scaling the port's weights by
# (1 + 1e-7 N(0, 1)) moves TartanAir's loss_frustums and relation loss by
# ~3e-4 relative.  A term must agree within LOSS_RTOL, or where the port's
# own change under that perturbation exceeds it, within NOISE_MULT times
# that change (test_torch_port_train_step.py's rule for gradients).
NOISE_MULT, N_PERTURB = 4.0, 3
# the CLI runs: check_resume_determinism's tiny sizes, with the b0
# backbone (b3 at 480x640 takes ~16 s a CPU train step on one thread)
RESUME_OVERRIDES = ["backbone_2d_name=tf_efficientnet_b0_ns"]
BLOCKED = ("jax", "flax", "jaxlib", "optax", "occdepth_tpu")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tier-1 gate runs six test processes on a few cores; this file's
    tiny-shape torch work takes one thread so it does not crowd them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _numpy_sd(module, prefix=""):
    return {prefix + k: v.numpy() for k, v in module.state_dict().items()}


def _jax_block(kind):
    """(port module, flax module, flax variables via the converter)."""
    if kind == "convblock3d":
        port, flax_mod = Convblock3d(8, 4), JaxConvblock3d(4)

        def mapping(m):
            _map_upsample(m, "h", "root")
    else:
        port = SegmentationHead(8, 14, occluded_only=True)
        flax_mod = JaxSegmentationHead(8, 14, (1, 2, 3), occluded_only=True)

        def mapping(m):
            _map_seg_head(m, "h", "root", cascade=False, occluded=True)
    randomize_weights(port, seed=5)
    m = _Mapper(_numpy_sd(port, "root."))
    mapping(m)
    assert not m.missing, m.missing
    return port.eval(), flax_mod, {"params": _nest(m.params)["h"],
                                   "batch_stats": _nest(m.stats)["h"]}


@pytest.mark.parametrize("kind", ["convblock3d", "occluded_head"])
def test_block_matches_jax(kind):
    """Convblock3d (stride-1 transposed conv: the kernel flip and the
    in/out order) and the occluded head, eval mode with random BN
    statistics, on (1, 8, 6, 5, 4) grids."""
    port, flax_mod, variables = _jax_block(kind)
    x = np.random.RandomState(1).randn(1, 8, 6, 5, 4).astype(np.float32)
    with torch.no_grad():
        ours = port(torch.from_numpy(x)).numpy()
    ref = jax.jit(functools.partial(flax_mod.apply, train=False))(
        variables, jnp.asarray(x.transpose(0, 2, 3, 4, 1)))
    ref = np.asarray(ref).transpose(0, 4, 1, 2, 3)
    assert ours.shape == ref.shape == ((1, 4, 6, 5, 4) if kind ==
                                       "convblock3d" else (1, 2, 6, 5, 4))
    np.testing.assert_allclose(ours, ref, atol=MODULE_ATOL)


CONFIGS = {
    "tartanair": (tiny_tartanair_config, jax_testing.tiny_tartanair_config,
                  {}),
    "kitti_occluded": (tiny_kitti_config, jax_testing.tiny_kitti_config,
                       {"occluded_cls": True}),
}


@pytest.fixture(scope="module")
def model_outputs():
    """Per config: port and JAX eval outputs and train-mode loss terms on
    one weight set and one labelled batch (the JAX side jitted once)."""
    results = {}
    for name, (port_cfg_fn, jax_cfg_fn, kw) in CONFIGS.items():
        cfg, jcfg = port_cfg_fn(**kw), jax_cfg_fn(**kw)
        src = randomize_weights(OccDepthModel(cfg), seed=9)
        params, stats, missing = convert_state_dict(_numpy_sd(src), jcfg)
        assert not missing, missing[:10]
        variables = {"params": params, "batch_stats": stats}
        port = OccDepthModel(cfg)
        port.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)
        batch = make_synthetic_batch(cfg, batch_size=1, seed=11,
                                     with_labels=True)
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        with torch.no_grad():
            ours = port.eval()(tb)
            logs = [compute_losses(cfg, m.train()(tb), tb, 0.0)[1] for m in
                    [port] + [perturbed_copy(port, s)
                              for s in range(N_PERTURB)]]
        model = JaxOccDepthModel(cfg=jcfg)

        def run(v, b, model=model, jcfg=jcfg):
            out = model.apply(v, b, train=False)
            tout, _ = model.apply(v, b, train=True, mutable=["batch_stats"])
            _, logs = jax_compute_losses(jcfg, tout, b,
                                         jnp.zeros((), jnp.float32))
            return out, logs

        ref, ref_logs = jax.jit(run)(variables, batch)
        results[name] = (
            {k: v.numpy() for k, v in ours.items()},
            {k: np.asarray(ref[k]) for k in ours},
            [{k: float(v) for k, v in lg.items()} for lg in logs],
            {k: float(v) for k, v in ref_logs.items()})
    return results


@pytest.mark.parametrize("name,key,atol", [
    ("tartanair", "ssc_logit", LOGIT_ATOL),
    ("tartanair", "occ_logit", LOGIT_ATOL),
    ("tartanair", "P_logits", LOGIT_ATOL),
    ("kitti_occluded", "occluded_logit", LOGIT_ATOL),
    ("kitti_occluded", "ssc_logit", LOGIT_ATOL),
    ("kitti_occluded", "P_logits", LOGIT_ATOL),
])
def test_eval_forward_matches_jax(model_outputs, name, key, atol):
    ours, ref = model_outputs[name][:2]
    cfg = CONFIGS[name][0](**CONFIGS[name][2])
    if key.endswith("logit"):  # the full grid at project_scale 1 and 2
        assert ours[key].shape[1:4] == tuple(cfg.full_scene_size), key
    assert ours[key].shape == ref[key].shape, key
    assert ours[key].dtype == np.float32
    np.testing.assert_allclose(ours[key], ref[key], atol=atol)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_train_losses_match_jax(model_outputs, name):
    """Every train-mode loss term (batch statistics), loss_occluded with
    the occluded head, against JAX compute_losses: within LOSS_RTOL, or
    NOISE_MULT times the port's own fp32 noise where that is larger."""
    (ours, *perturbed), ref = model_outputs[name][2:]
    assert set(ours) == set(ref), (sorted(ours), sorted(ref))
    assert ("loss_occluded" in ours) == (name == "kitti_occluded")
    for k, v in ref.items():
        assert np.isfinite(ours[k]), k
        noise = max(abs(ours[k] - q[k]) for q in perturbed)
        tol = max(LOSS_RTOL * abs(v), NOISE_MULT * noise)
        assert abs(ours[k] - v) <= tol, (k, ours[k], v, noise)


@pytest.mark.parametrize("path", [TA_CONFIG, OCCLUDED_CONFIG],
                         ids=["tartanair", "kitti_occluded"])
def test_shipped_config_weight_round_trip(path):
    """The shipped configs build in the port (project_scale 1, the
    occluded head), and port state_dict -> convert_state_dict ->
    state_dict_from_jax is the identity at full width, no key missing."""
    cfg = load_config(path)
    sd = randomize_weights(OccDepthModel(cfg), seed=2).state_dict()
    params, stats, missing = convert_state_dict(
        {k: v.numpy() for k, v in sd.items()}, jax_config.load_config(path))
    assert not missing, missing[:10]
    back = state_dict_from_jax({"params": params, "batch_stats": stats}, cfg)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k


def test_occluded_labels_match_jax():
    """The synthetic batch's occluded labels: the JAX draws, bit for bit."""
    from occdepth_tpu.data.batch import make_synthetic_batch as jax_batch

    kw = {"occluded_cls": True}
    ours = make_synthetic_batch(tiny_kitti_config(**kw), 2, seed=21,
                                with_labels=True)
    ref = jax_batch(jax_testing.tiny_kitti_config(**kw), 2, seed=21,
                    with_labels=True)
    assert ours["occluded"].dtype == ref["occluded"].dtype == np.int32
    np.testing.assert_array_equal(ours["occluded"], ref["occluded"])


@pytest.fixture(scope="module")
def toy_tree(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("ta_toy"))
    jax_testing.make_tartanair_tree(base)
    return base


def _assert_samples_equal(ours, ref):
    assert set(ours) == set(ref)
    for k, v in ref.items():
        if not isinstance(v, np.ndarray):
            assert ours[k] == v, k
        elif v.dtype.kind == "f":
            assert ours[k].dtype == v.dtype and ours[k].shape == v.shape, k
            np.testing.assert_allclose(ours[k], v, rtol=0, atol=1e-6,
                                       err_msg=k)
        else:
            assert ours[k].dtype == v.dtype and ours[k].shape == v.shape, k
            np.testing.assert_array_equal(ours[k], v, err_msg=k)


@pytest.mark.parametrize("split", ["train", "val"])
def test_tartanair_dataset_matches_jax(toy_tree, split):
    """Samples (train: color jitter and flips at fliplr 0.5 over two
    epochs) and their collated batch, on the JAX toy tree: ints exact,
    floats within 1e-6."""
    kw = dict(dataset="tartanair", data_root=os.path.join(toy_tree, "ta"),
              data_preprocess_root=os.path.join(toy_tree, "ta_pre"),
              full_scene_size=(16, 8, 16), voxel_size_m=0.3,
              scene_size_m=(4.8, 2.4, 4.8), frustum_size=2, n_classes=14)
    fliplr = 0.5 if split == "train" else 0.0
    ours = TartanAirDataset(OccDepthConfig(**kw), split, fliplr=fliplr)
    ref = JaxTartanAir(jax_config.OccDepthConfig(**kw), split, fliplr=fliplr)
    assert len(ours) == len(ref) == 2
    flips = set()
    for epoch in (0, 1):
        ours.reseed(epoch)
        ref.reseed(epoch)
        a, b = [ours[i] for i in range(2)], [ref[i] for i in range(2)]
        for x, y in zip(a, b):
            _assert_samples_equal(x, y)
            flips.add(float(x["ida_mats"][0, 0, 0]))
        _assert_samples_equal(collate(a), jax_collate(b))
    assert a[0]["img"].shape == (2, 480, 640, 3)
    assert flips == ({-1.0, 1.0} if split == "train" else {1.0})


def test_make_tartanair_tree_writes_the_jax_toy_tree(tmp_path, toy_tree):
    """The port's make_tartanair_tree writes the JAX one's files (the
    same draws)."""
    from PIL import Image

    make_tartanair_tree(str(tmp_path))
    n = 0
    for dirpath, _, files in os.walk(toy_tree):
        for f in files:
            ref = os.path.join(dirpath, f)
            ours = os.path.join(str(tmp_path),
                                os.path.relpath(ref, toy_tree))
            if f.endswith(".png"):
                assert np.array_equal(np.asarray(Image.open(ours)),
                                      np.asarray(Image.open(ref))), f
            elif f.endswith(".pkl"):
                with open(ours, "rb") as fa, open(ref, "rb") as fb:
                    a, b = pickle.load(fa), pickle.load(fb)
                assert set(a) == set(b)
                for k in b:
                    assert a[k].dtype == b[k].dtype, k
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            else:
                with open(ours) as fa, open(ref) as fb:
                    assert fa.read() == fb.read(), f
            n += 1
    assert n == 2 * (2 + 4 + 2)  # per sequence: poses, images, pickles


def test_full_size_tartanair_rig_sees_the_grid():
    """The full-size tree's rig puts most voxels in both views' FOV (the
    toy rig, the JAX one, sees an eighth)."""
    assert tartanair_fov_share((120, 48, 120), 0.1) > 0.5
    assert tartanair_fov_share((16, 8, 16), 0.3) == pytest.approx(0.1171875)


def test_quat_to_se3_and_read_poses_match_jax(tmp_path):
    """Unit, unnormalised and zero quaternions; a pose file with blank and
    short lines."""
    rs = np.random.RandomState(3)
    quats = [np.r_[rs.randn(3), rs.randn(4)] for _ in range(4)]
    quats += [np.r_[rs.randn(3), q] for q in ([0, 0, 0, 1], [0, 0, 0, 0])]
    for q in quats:
        np.testing.assert_allclose(quat_to_se3(q), jax_quat_to_se3(q),
                                   rtol=0, atol=1e-12)
        rot = quat_to_se3(q)[:3, :3]
        if np.any(q[3:]):
            np.testing.assert_allclose(rot @ rot.T, np.eye(3), atol=1e-12)
    path = tmp_path / "pose.txt"
    path.write_text("\n".join(" ".join(f"{v:.9f}" for v in q)
                              for q in quats) + "\n\n1 2 3\n")
    ours, ref = read_poses(str(path)), jax_read_poses(str(path))
    assert ours.shape == ref.shape == (len(quats), 4, 4)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-12)


@pytest.fixture(scope="module", autouse=True)
def cli_proc(tmp_path_factory):
    """The port's kill/resume determinism check (`check_resume_determinism`:
    the train CLI trains run A 2 epochs straight through and, beside it,
    run B until step 2, where B is SIGKILLed and relaunched to resume) on
    the toy tree of one train and one val frame at the tiny sizes with the
    b0 backbone, then the eval CLI on run A's `last`, on the CPU, with
    JAX and the JAX package unimportable in every process, printing a
    JSON report.  It starts with the module, in one-thread processes
    beside the JAX compiles."""
    base = str(tmp_path_factory.mktemp("ta_resume"))
    blocked = tmp_path_factory.mktemp("jax_blocked")
    for name in BLOCKED:
        (blocked / f"{name}.py").write_text(
            f"raise ImportError('{name} is blocked in this test')\n")
    code = textwrap.dedent("""
        import contextlib, io, json, sys
        from occdepth_tpu_torch.config import default_config_path
        from occdepth_tpu_torch.scripts import check_resume_determinism as rd
        from occdepth_tpu_torch.scripts import eval as eval_cli

        base, *overrides = sys.argv[1:]
        report = {"summary": rd.main([
            "--base", base, "--epochs", "2", "--kill-step", "2",
            "--frames", "1", "--device", "cpu", *overrides])}
        with open(f"{base}/B.log") as f:
            report["B_log"] = f.read()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            eval_cli.main([
                "--config", default_config_path(rd.TA_CONFIG),
                "--device", "cpu", "--ckpt", "last", f"data_root={base}/ta",
                f"data_preprocess_root={base}/ta_pre", f"logdir={base}/A",
                *rd.TOY, *overrides])
        report["eval"] = out.getvalue()
        report["jax_side"] = sorted(
            m for m, mod in sys.modules.items() if mod is not None
            and m.split(".")[0] in ("jax", "flax", "jaxlib", "optax",
                                    "occdepth_tpu"))
        print(json.dumps(report))
    """)
    # the stubs come first on the path, and the processes run outside
    # the repo, whose root would otherwise put `occdepth_tpu` first
    env = dict(os.environ, PYTHONPATH=f"{blocked}{os.pathsep}{REPO}",
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-c", code, base, *RESUME_OVERRIDES],
        cwd=base, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()
    shutil.rmtree(base, ignore_errors=True)  # ~1 GB of checkpoints


@pytest.fixture(scope="module")
def cli_run(cli_proc):
    """(the CLI run's JSON report, its stdout)."""
    stdout, stderr = cli_proc.communicate(timeout=400)
    assert cli_proc.returncode == 0, stdout[-3000:] + stderr[-3000:]
    return json.loads(stdout.strip().splitlines()[-1]), stdout


def _metrics(base, run):
    [path] = glob.glob(os.path.join(base, run, "*", "metrics.jsonl"))
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_train_cli_trains_and_writes_on_cpu(cli_run):
    """Run A: one train record per step, finite losses, validation and a
    `last` checkpoint at each epoch end."""
    base = cli_run[0]["summary"]["base"]
    recs = _metrics(base, "A")
    train = [r for r in recs if "train/loss" in r]
    assert [r["step"] for r in train] == [1, 2]
    assert all(np.isfinite(r[k]) for r in train for k in r
               if k.startswith("train/loss"))
    assert [r["step"] for r in recs if "val/mIoU" in r] == [1, 2]
    assert glob.glob(os.path.join(base, "A", "*", "checkpoints", "last.pt"))


def test_train_cli_resumes(cli_run):
    """Run B, SIGKILLed during its second epoch, resumed at the first
    epoch's checkpoint and finished the run."""
    report, _ = cli_run
    assert report["summary"]["killed_at_step"] == 2
    assert "resumed from step 1" in report["B_log"]
    assert "train: steps 1 -> 2" in report["B_log"]


def test_resume_is_bitwise(cli_run):
    """The resumed run B equals run A bitwise: every logged value at
    every step (train losses, lr, the epochs' val metrics) and every
    tensor of the `last` checkpoints (parameters, BN statistics, AdamW
    state)."""
    summary = cli_run[0]["summary"]
    assert summary["ok"] and summary["bitwise"], summary
    assert summary["resume_exercised"]
    assert summary["records_compared"] == 4  # 2 train + 2 epoch records
    assert summary["values_compared"] > 50
    assert summary["checkpoint_leaves"] > 1000
    assert summary["nondeterministic_ops"] == []


def test_eval_cli_prints_tartanair_classes(cli_run):
    from occdepth_tpu_torch.data.params import TARTANAIR_CLASS_NAMES

    lines = cli_run[0]["eval"].splitlines()
    assert "test======" in lines
    assert f"class IoU: {TARTANAIR_CLASS_NAMES}, " in lines
    assert len(lines[lines.index("test======") + 3].split()) == 14
    assert any(line.startswith("mIoU=") for line in lines)


def test_clis_import_no_jax(cli_run):
    assert cli_run[0]["jax_side"] == []

