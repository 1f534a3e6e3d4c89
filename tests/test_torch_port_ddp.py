"""Data-parallel training and evaluation (torchrun + DDP with cross-rank
BatchNorm) on the CPU: two gloo ranks held to their one-process
emulation.

The two-rank checks run once, in a module-scoped subprocess that starts
with the module: `python -m occdepth_tpu_torch.scripts.check_ddp --device
cpu` launches two ranks under `torchrun --standalone`, computes the
emulation (a forward of the global batch with BatchNorm over all its rows,
then the mean over the ranks' row shards of each shard's losses) beside
them and prints a JSON report, which the cases below read.  JAX and the
JAX package are unimportable in every one of those processes.  The
tolerances are `check_ddp`'s: BN_RTOL (the BatchNorm alone, fp32),
RUNNING_RTOL (BN on running statistics, every gradient leaf), the
fp32-noise-aware bound of `test_torch_port_train_step.py` (BN on batch
statistics, where the tiny network is chaotic) and TIE_MARGIN (eval
counts).  The remaining cases run in this process beside it: the row
split, the slice rule, the Loader's rank rows, the parameters DDP leaves
out and the `deterministic` switch.
"""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from occdepth_tpu_torch.data.batch import make_synthetic_batch
from occdepth_tpu_torch.data.kitti import Loader
from occdepth_tpu_torch.models import OccDepthModel
from occdepth_tpu_torch.parallel import ddp
from occdepth_tpu_torch.scripts import check_ddp
from occdepth_tpu_torch.testing import (
    tiny_kitti_config,
    tiny_nyu_config,
    tiny_tartanair_config,
)
from occdepth_tpu_torch.training.step import compute_losses
from occdepth_tpu_torch.training.trainer import use_deterministic_algorithms

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "flax", "jaxlib", "optax", "occdepth_tpu")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tier-1 gate runs six test processes on a few cores; this file's
    in-process work takes one thread beside its three subprocesses."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def ddp_proc(tmp_path_factory):
    """`check_ddp` on two gloo ranks, started with the module, outside the
    repo and with stub modules that make JAX and the JAX package raise on
    import, first on the path."""
    out = tmp_path_factory.mktemp("check_ddp")
    blocked = tmp_path_factory.mktemp("jax_blocked")
    for name in BLOCKED:
        (blocked / f"{name}.py").write_text(
            f"raise ImportError('{name} is blocked in this test')\n")
    env = dict(os.environ, PYTHONPATH=f"{blocked}{os.pathsep}{REPO}",
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "occdepth_tpu_torch.scripts.check_ddp",
         "--device", "cpu", "--out", str(out / "run")],
        cwd=str(out), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()
    shutil.rmtree(out, ignore_errors=True)  # the ranks' results, ~0.5 GB


@pytest.fixture(scope="module")
def report(ddp_proc):
    stdout, stderr = ddp_proc.communicate(timeout=300)
    assert ddp_proc.returncode == 0, stdout[-3000:] + stderr[-3000:]
    return json.loads(stdout.strip().splitlines()[-1])


# ---- in this process, beside the two ranks ----

def test_rank_rows_and_check_slices_reject_uneven_splits():
    """`shard_batch`'s cases: a global batch the world does not divide and
    a world the slices do not divide are clear errors; a divisible batch
    splits into contiguous rows, metadata lists included."""
    with pytest.raises(ValueError, match="not divisible"):
        ddp.rank_rows({"img": np.zeros((6, 4, 4, 3), np.float32)}, 0, 4)
    with pytest.raises(ValueError, match="not divisible"):
        ddp.check_slices(3, 8)
    ddp.check_slices(2, 8)
    batch = {"img": np.arange(16)[:, None] * np.ones((1, 2)),
             "frame_id": [f"{i:06d}" for i in range(16)]}
    rows = ddp.rank_rows(batch, 3, 8)
    np.testing.assert_array_equal(rows["img"][:, 0], [6, 7])
    assert rows["frame_id"] == ["000006", "000007"]


@pytest.mark.parametrize("drop_last", [True, False])
def test_loader_rank_rows_make_the_one_process_batches(drop_last):
    """Under a world of 2, each rank's Loader yields its rows of every
    global batch in the one-process shuffle order, the ranks together the
    one-process batches; a ragged last global batch is padded with its
    first sample and marked by `sample_valid` on both ranks, so both see
    the same number of batches."""
    ds = [{"i": np.array(i)} for i in range(7)]
    one = Loader(ds, 4, shuffle=True, num_workers=0, drop_last=drop_last)
    ranks = [Loader(ds, 4, shuffle=True, num_workers=0, drop_last=drop_last,
                    rank=r, world=2) for r in range(2)]
    for epoch in range(2):
        ref = [b["i"] for b in one]
        got = [list(r) for r in ranks]
        assert len(got[0]) == len(got[1]) == len(ref) == (1 if drop_last
                                                          else 2)
        for bi, want in enumerate(ref):
            both = np.concatenate([got[r][bi]["i"] for r in range(2)])
            np.testing.assert_array_equal(both[:len(want)], want)
            if len(want) < 4:
                valid = np.concatenate([got[r][bi]["sample_valid"]
                                        for r in range(2)])
                np.testing.assert_array_equal(valid, np.arange(4) < len(want))
                assert (both[len(want):] == want[0]).all()
            else:
                assert "sample_valid" not in got[0][bi]
    with pytest.raises(ValueError, match="not divisible"):
        Loader(ds, 3, shuffle=False, rank=0, world=2)


UNUSED_CONFIGS = {
    "kitti": tiny_kitti_config,
    "flospdepth": lambda: tiny_kitti_config(
        multi_view_mode=False, context_prior=False, relation_loss=False,
        cascade_cls=False, use_stereo_depth_gt=False),
    "tartanair": tiny_tartanair_config,
    "nyu": tiny_nyu_config,
}


@pytest.mark.parametrize("name", list(UNUSED_CONFIGS))
def test_unused_parameter_names_are_the_ones_without_gradient(name):
    """DDP needs every parameter it tracks to get a gradient each step
    (else `find_unused_parameters`, which walks the graph every step).
    `unused_parameter_names` is exactly the set a train-mode step leaves
    without one, in the KITTI stereo, mono (flospdepth.yaml), TartanAir
    and NYU configs."""
    cfg = UNUSED_CONFIGS[name]()
    torch.manual_seed(0)
    model = OccDepthModel(cfg).train()
    batch = {k: torch.as_tensor(v) for k, v in make_synthetic_batch(
        cfg, 1, 0, with_labels=True).items()}
    loss, _ = compute_losses(cfg, model(batch), batch, 0.0)
    loss.backward()
    no_grad = sorted(n for n, p in model.named_parameters() if p.grad is None)
    assert no_grad == sorted(model.unused_parameter_names())
    assert no_grad  # the decoder's 1_16 head at least


def test_deterministic_key_sets_the_deterministic_modes(monkeypatch):
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    try:
        use_deterministic_algorithms()
        assert torch.are_deterministic_algorithms_enabled()
        assert torch.is_deterministic_algorithms_warn_only_enabled()
        assert torch.backends.cudnn.deterministic
        assert not torch.backends.cudnn.benchmark
        assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
        torch.backends.cudnn.deterministic = saved[2]
        torch.backends.cudnn.benchmark = saved[3]


# ---- the two ranks against the emulation ----

def test_cross_rank_batchnorm_matches_one_batchnorm(report):
    """A port BatchNorm3d on 2 ranks x 2 rows against one BN over the 4
    rows: output, input gradient, the ranks' summed weight and bias
    gradients and the running statistics (equal on both ranks), within
    BN_RTOL of each tensor's norm."""
    bn = report["bn"]
    assert bn["bound"] == check_ddp.BN_RTOL
    assert bn["max_rel"] <= check_ddp.BN_RTOL and bn["ok"], bn


@pytest.mark.parametrize("bn_stats", ["running", "batch"])
def test_ddp_gradients_match_the_emulation(report, bn_stats):
    """The tiny KITTI model (fp32, dw_conv_grad=pallas) on 2 ranks, one
    row each, against the emulation at batch 2.

    `running`: BN on running statistics.  Every gradient leaf (642) within
    RUNNING_RTOL of its norm and every loss term of each rank within
    RUNNING_RTOL of its shard's: this holds the row split, the per-rank
    losses and DDP's averaging.

    `batch`: BN on batch statistics, reduced over the ranks.  Each leaf
    within GRAD_RTOL of its norm or NOISE_MULT times the emulation's own
    change under a 1e-7 weight perturbation (N_PERTURB copies), and each
    loss term likewise; the leaves that pass only on the noise bound are
    counted and printed."""
    r = report[bn_stats]
    if bn_stats == "running":
        assert r["bound"] == check_ddp.RUNNING_RTOL
        assert r["max_rel"] <= check_ddp.RUNNING_RTOL, r
        assert r["loss_max_rel"] <= check_ddp.RUNNING_RTOL, r
    else:
        print(f"batch statistics: {r['noise_only_leaves']} of {r['leaves']} "
              f"leaves pass only on the noise bound; worst err / tol "
              f"{r['worst_ratio']:.3f} ({r['worst']})")
        assert r["worst_ratio"] <= 1.0 and r["loss_terms_ok"], r
    assert r["leaves"] > 600 and r["ok"]


def test_running_statistics_and_parameters_equal_on_every_rank(report):
    """After 2 `Trainer.fit` steps under DDP (buffers not broadcast), the
    cross-rank BatchNorm has advanced the running statistics alike: the
    two ranks' state_dicts are equal, parameters and BN buffers."""
    fit = report["fit"]
    assert fit["steps"] == [2, 2]
    assert fit["unequal_state"] == []


def test_accumulation_matches_the_emulation(report):
    """`train_step` with K = 2 microbatches under DDP (the first backward
    under `no_sync`), BN frozen: the clipped gradients within RUNNING_RTOL
    of the emulation's, and equal on both ranks."""
    r = report["accum2"]
    assert r["max_rel"] <= check_ddp.RUNNING_RTOL and r["rank_spread"] == 0
    assert r["ok"]


def test_eval_counts_match_one_process(report):
    """`Trainer.validate` on 2 ranks over 3 val frames (the second global
    batch padded by the Loader) returns, on both ranks, the one-process
    completion and confusion counts and frame count, except at voxels
    whose two best logits lie within TIE_MARGIN."""
    fit = report["fit"]
    assert fit["n_frames"] == [3, 3] and fit["one_process_frames"] == 3
    assert all(fit["ranks_agree"])
    assert fit["conf_flips"] <= fit["near_ties"], fit
    assert fit["completion_diff"] <= 2 * fit["near_ties"], fit
    assert fit["ok"]


def test_rank_zero_writes_the_metrics_once(report):
    """metrics.jsonl holds one record per step and one per epoch: the
    train losses averaged over the ranks, written by rank 0 alone."""
    fit = report["fit"]
    assert fit["train_records"] == [1, 2] and fit["epoch_records"] == 1


def test_ranks_import_no_jax(report):
    assert report["jax_side"] == [] and report["ok"]
