"""The ported evaluation slice vs the JAX package (CPU, fp32).

The decoder's UpSampleBN under `pallas` (K3's plain version on the CPU)
against the JAX UpSampleBN under `shift`; the tiny KITTI model under
`pallas` through `Trainer.validate` (3 samples at batch 2: a ragged last
batch) against the JAX `make_eval_step` under `shift` with the same
padding; the disk dataset against the JAX dataset on the same tree;
best-by-metric checkpoints; the reference-checkpoint loader against the
torch oracle; the eval CLI; and the slice with JAX blocked.
"""
import dataclasses
import io
import os
import subprocess
import sys
import textwrap
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch

import occdepth_tpu.config as jax_config
from occdepth_tpu.data.kitti import KittiDataset as JaxKittiDataset
from occdepth_tpu.data.kitti import collate as jax_collate
from occdepth_tpu.models.unet2d import UpSampleBN as JaxUpSampleBN
from occdepth_tpu.scripts.eval import print_stats as jax_print_stats
from occdepth_tpu.testing import tiny_kitti_config as jax_tiny_kitti
from occdepth_tpu.training.convert_torch import convert_state_dict
from occdepth_tpu.training.step import create_model, make_eval_step
from occdepth_tpu_torch.config import OccDepthConfig, default_config_path
from occdepth_tpu_torch.data.batch import make_synthetic_batch
from occdepth_tpu_torch.data.kitti import KittiDataset, Loader, collate
from occdepth_tpu_torch.data.params import class_names_for
from occdepth_tpu_torch.losses.metrics import SSCMetrics
from occdepth_tpu_torch.models import OccDepthModel
from occdepth_tpu_torch.models.unet2d import UpSampleBN
from occdepth_tpu_torch.scripts import eval as eval_cli
from occdepth_tpu_torch.testing import (
    make_kitti_tree,
    randomize_weights,
    synthetic_dataset,
    tiny_kitti_config,
)
from occdepth_tpu_torch.training import Trainer
from occdepth_tpu_torch.training.checkpoint import CheckpointManager
from occdepth_tpu_torch.training.step import eval_step
from occdepth_tpu_torch.weights import load_reference_checkpoint
from tests.test_data_pipeline import kitti_tree  # noqa: F401  (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGIT_ATOL = 3e-3  # the serving slice's bound (test_torch_port_slice.py)
LOSS_RTOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tier-1 gate runs six test processes on a few cores; this file's
    tiny-shape torch work takes one thread so it does not crowd them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tensors(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _confusion(pred, target, keep, n_classes):
    """NumPy confusion counts over the voxels `keep` marks, with the
    reference's 255 -> class 0 rule: (completion (3,), conf (C, C))."""
    invalid = target == 255
    t = np.where(invalid, 0, target)[keep].astype(np.int64)
    p = np.where(invalid, 0, pred)[keep].astype(np.int64)
    bt, bp = t > 0, p > 0
    completion = np.array([(bt & bp).sum(), (~bt & bp).sum(),
                           (bt & ~bp).sum()])
    conf = np.bincount(t * n_classes + p, minlength=n_classes ** 2)
    return completion, conf.reshape(n_classes, n_classes)


def test_upsample_bn_pallas_matches_jax_shift():
    """The port's UpSampleBN with its 3x3 convs through `conv3x3` (the
    plain version on CPU tensors) vs the JAX UpSampleBN under `shift`, on
    shared weights, eval mode, fp32."""
    rng = np.random.RandomState(21)
    cx, cs, cout = 6, 5, 8
    x = rng.randn(2, cx, 5, 7).astype(np.float32)
    skip = rng.randn(2, cs, 9, 13).astype(np.float32)
    port = randomize_weights(UpSampleBN(cx + cs, cout, "pallas"), seed=3)
    port.eval()
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    params, stats = {}, {}
    for conv, bn, i in (("conv0", "bn0", 0), ("conv1", "bn1", 3)):
        params[conv] = {"kernel": sd[f"_net.{i}.weight"].transpose(2, 3, 1, 0),
                        "bias": sd[f"_net.{i}.bias"]}
        params[bn] = {"BatchNorm_0": {"scale": sd[f"_net.{i + 1}.weight"],
                                      "bias": sd[f"_net.{i + 1}.bias"]}}
        stats[bn] = {"BatchNorm_0": {"mean": sd[f"_net.{i + 1}.running_mean"],
                                     "var": sd[f"_net.{i + 1}.running_var"]}}
    ref = JaxUpSampleBN(cout, conv_impl="shift").apply(
        {"params": params, "batch_stats": stats}, x.transpose(0, 2, 3, 1),
        skip.transpose(0, 2, 3, 1), train=False)
    with torch.no_grad():
        ours = port(torch.from_numpy(x), torch.from_numpy(skip))
    np.testing.assert_allclose(ours.numpy(),
                               np.asarray(ref).transpose(0, 3, 1, 2),
                               atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def eval_slice(tmp_path_factory):
    """Port: the tiny model at decoder_conv_impl=pallas, Trainer.validate
    over 3 labelled samples at batch 2, and its logits per padded batch.
    JAX: the same weights at `shift` through make_eval_step (and its
    forward, for the logits) on the same padded batches, one jit."""
    cfg = tiny_kitti_config(decoder_conv_impl="pallas", batch_size_per_gpu=2)
    jcfg = jax_tiny_kitti(decoder_conv_impl="shift", batch_size_per_gpu=2)
    trainer = Trainer(cfg, str(tmp_path_factory.mktemp("eval")),
                      device="cpu")
    randomize_weights(trainer.model, seed=9)
    params, stats, missing = convert_state_dict(
        {k: v.numpy() for k, v in trainer.model.state_dict().items()}, jcfg)
    assert not missing, missing[:10]
    variables = {"params": params, "batch_stats": stats}
    samples = synthetic_dataset(cfg, 3, seed=13)
    loader = Loader(samples, 2, shuffle=False, drop_last=False, num_workers=0)
    port_stats = trainer.validate(loader)

    jax_eval = make_eval_step(jcfg)
    jmodel = create_model(jcfg)

    @jax.jit
    def run(variables, batch):
        logs, completion, conf = jax_eval(variables["params"],
                                          variables["batch_stats"], batch)
        fwd = {k: v for k, v in batch.items() if k != "sample_valid"}
        out = jmodel.apply(variables, fwd, train=False)
        return logs, completion, conf, out["ssc_logit"], out["occ_logit"]

    batches, port_logits, jax_runs = [], [], []
    for batch in loader:
        batch = {k: v for k, v in batch.items()
                 if k not in ("frame_id", "sequence")}
        bs = batch["img"].shape[0]
        valid = np.arange(2) < bs
        batch = {k: np.concatenate([v] + [v[:1]] * (2 - bs))
                 for k, v in batch.items()}
        batch["sample_valid"] = valid
        batches.append(batch)
        with torch.no_grad():
            port_logits.append(trainer.model(_tensors(
                {k: v for k, v in batch.items() if k != "sample_valid"})
            )["ssc_logit"].numpy())
        jax_runs.append(jax.tree_util.tree_map(np.asarray,
                                               run(variables, batch)))
    return cfg, batches, port_stats, port_logits, jax_runs


def test_eval_slice_logits_match_jax(eval_slice):
    _, batches, _, port_logits, jax_runs = eval_slice
    assert [b["sample_valid"].tolist() for b in batches] == [
        [True, True], [True, False]]
    for ours, (_, _, _, ref, _) in zip(port_logits, jax_runs):
        assert ours.shape == ref.shape and ours.dtype == np.float32
        np.testing.assert_allclose(ours, ref, atol=LOGIT_ATOL)


def test_eval_slice_counts_match_jax(eval_slice):
    """validate's completion and confusion counts equal the JAX eval
    step's exactly.  Voxels whose two best JAX logits lie within twice the
    logits' bound (each may move by the bound) may flip their argmax: any
    flip must be one of them, and they are then excluded from both sides
    (the count of such voxels and of flips is printed)."""
    cfg, batches, port_stats, port_logits, jax_runs = eval_slice
    C = cfg.n_classes
    full = {"port": [], "jax": []}
    kept = {"port": [], "jax": []}
    n_tie = n_flip = 0
    for batch, ours, (_, j_comp, j_conf, ref, _) in zip(
            batches, port_logits, jax_runs):
        rows = batch["sample_valid"]
        target = batch["target"][rows]
        top2 = np.sort(ref[rows], axis=-1)[..., -2:]
        keep = (top2[..., 1] - top2[..., 0]) > 2 * LOGIT_ATOL
        flip = ours[rows].argmax(-1) != ref[rows].argmax(-1)
        assert not (flip & keep).any(), "an argmax flip off the near-ties"
        n_tie += int((~keep).sum())
        n_flip += int(flip.sum())
        for side, logits in (("port", ours), ("jax", ref)):
            pred = logits[rows].argmax(-1)
            full[side].append(_confusion(pred, target, np.ones_like(keep), C))
            kept[side].append(_confusion(pred, target, keep, C))
        # the JAX eval step counts what its own argmax gives
        np.testing.assert_array_equal(j_comp, full["jax"][-1][0])
        np.testing.assert_array_equal(j_conf, full["jax"][-1][1])
    n_vox = sum(int(b["sample_valid"].sum()) for b in batches) * 32 * 32 * 16
    print(f"near-tie voxels: {n_tie} of {n_vox}; argmax flips: {n_flip}")
    # validate counts what the port's argmax gives, padding row excluded
    assert port_stats["n_frames"] == 3
    np.testing.assert_array_equal(port_stats["completion"],
                                  sum(c for c, _ in full["port"]))
    np.testing.assert_array_equal(port_stats["conf"],
                                  sum(c for _, c in full["port"]))
    for i in range(2):
        np.testing.assert_array_equal(sum(x[i] for x in kept["port"]),
                                      sum(x[i] for x in kept["jax"]))
    if n_flip == 0:
        np.testing.assert_array_equal(port_stats["completion"],
                                      sum(r[1] for r in jax_runs))
        np.testing.assert_array_equal(port_stats["conf"],
                                      sum(r[2] for r in jax_runs))


def _ce_float64(logits, target, weights):
    """The JAX package's class-weighted CE (ignore 255, weighted mean)
    evaluated in float64."""
    x = logits.astype(np.float64)
    x = x - x.max(-1, keepdims=True)
    logp = x - np.log(np.exp(x).sum(-1, keepdims=True))
    valid = target != 255
    t = np.where(valid, target, 0)
    nll = -np.take_along_axis(logp, t[..., None], -1)[..., 0]
    w = np.asarray(weights, np.float64)[t] * valid
    return (w * nll).sum() / w.sum()


def test_eval_slice_losses_match_jax(eval_slice):
    """Val losses (full batches only) vs the JAX eval step's logs.

    The two CE terms are held to their float64 value on the JAX logits:
    XLA's CPU reduction sums the 32,768 weighted terms one after another
    in fp32, which moves JAX's loss_ssc ~2.5e-4 relative off it, while the
    port's pairwise sum stays within ~1e-7; JAX's own value is checked to
    lie within that summation error."""
    from occdepth_tpu.data.params import class_weights_for, class_weights_occ_for

    cfg, batches, port_stats, _, jax_runs = eval_slice
    logs, _, _, ssc, occ = jax_runs[0]
    target = batches[0]["target"]
    occ_target = np.where((target != 0) & (target != 255), 1, target)
    ref = {k: float(v) for k, v in logs.items()}
    exact = {"loss_ssc": _ce_float64(ssc, target,
                                     class_weights_for(cfg.dataset)),
             "loss_occ": _ce_float64(occ, occ_target,
                                     class_weights_occ_for(cfg.dataset))}
    for k, v in exact.items():
        assert abs(ref[k] - v) <= 1e-3 * v, (k, ref[k], v)
        ref[k] = v
    ref["loss"] = sum(v for k, v in ref.items() if k != "loss")
    assert set(port_stats["losses"]) == set(ref)
    for k, v in port_stats["losses"].items():
        assert abs(v - ref[k]) <= LOSS_RTOL * abs(ref[k]), (k, v, ref[k])


def test_validate_padding_equals_per_sample_loop(tmp_path):
    """validate over 3 samples at batch 2 (the last padded) equals the
    port's own eval step run on each sample alone."""
    cfg = tiny_kitti_config(batch_size_per_gpu=2)
    trainer = Trainer(cfg, str(tmp_path), device="cpu")
    randomize_weights(trainer.model, seed=4)
    samples = synthetic_dataset(cfg, 3, seed=5)
    stats = trainer.validate(Loader(samples, 2, shuffle=False,
                                    drop_last=False, num_workers=0))
    metrics = SSCMetrics(cfg.n_classes)
    for s in samples:
        _, completion, conf = eval_step(
            cfg, trainer.model, _tensors({k: np.asarray(v)[None]
                                          for k, v in s.items()}))
        metrics.merge(completion, conf)
    ref = metrics.get_stats()
    np.testing.assert_array_equal(stats["completion"], metrics.completion)
    np.testing.assert_array_equal(stats["conf"], metrics.conf)
    for k in ("precision", "recall", "iou", "iou_ssc_mean"):
        assert stats[k] == ref[k], k
    assert stats["n_frames"] == 3
    assert np.isfinite(stats["losses"]["loss"])


def _assert_samples_equal(ours, ref):
    assert set(ours) == set(ref)
    for k, v in ref.items():
        if isinstance(v, np.ndarray):
            assert ours[k].dtype == v.dtype and ours[k].shape == v.shape, k
            np.testing.assert_array_equal(ours[k], v, err_msg=k)
        else:
            assert ours[k] == v, k


def test_kitti_dataset_matches_jax(kitti_tree):  # noqa: F811
    """Val samples and their collated batch, key for key, bit for bit, on
    the JAX data-pipeline test's tree (frustum_size 2)."""
    root, pre, depth_root = kitti_tree
    kw = dict(dataset="kitti", data_root=root, data_preprocess_root=pre,
              data_stereo_depth_root=depth_root, use_stereo_depth_gt=True,
              multi_view_mode=True, frustum_size=2, n_relations=4,
              context_prior=True, pattern_id=0, occluded_cls=True)
    ours = KittiDataset(OccDepthConfig(**kw), "val")
    ref = JaxKittiDataset(jax_config.OccDepthConfig(**kw), "val")
    assert len(ours) == len(ref) == 2
    a, b = [ours[i] for i in range(2)], [ref[i] for i in range(2)]
    for x, y in zip(a, b):
        _assert_samples_equal(x, y)
    _assert_samples_equal(collate(a), jax_collate(b))


def test_kitti_train_sample_with_flip_and_jitter_matches_jax(tmp_path):
    """A train-split sample with a flip and color jitter, on a tree from
    the port's make_kitti_tree: the same augmentation draws as JAX."""
    make_kitti_tree(str(tmp_path), n_frames=1)
    kw = dict(dataset="kitti", data_root=str(tmp_path / "kitti"),
              data_preprocess_root=str(tmp_path / "pre"),
              data_stereo_depth_root=str(tmp_path / "stereo_depth"),
              use_stereo_depth_gt=True, frustum_size=2)
    ours = KittiDataset(OccDepthConfig(**kw), "train", fliplr=1.0)
    ref = JaxKittiDataset(jax_config.OccDepthConfig(**kw), "train",
                          fliplr=1.0)
    assert len(ours) == len(ref) == 10
    ours.reseed(3)
    ref.reseed(3)
    a, b = ours[4], ref[4]
    assert a["ida_mats"][0, 0, 0] == -1.0  # flipped
    _assert_samples_equal(a, b)


def test_checkpoint_manager_keeps_best_by_monitor(tmp_path):
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save({"step": 1}, 1, {"val/mIoU": 0.2, "val/IoU": 0.5})
    assert ckpt.has("best_val_mIoU") and ckpt.has("best_val_IoU")
    # mIoU improves, IoU regresses
    ckpt.save({"step": 2}, 2, {"val/mIoU": 0.3, "val/IoU": 0.4})
    assert ckpt.restore("best_val_mIoU")["step"] == 2
    assert ckpt.restore("best_val_IoU")["step"] == 1
    assert ckpt.restore("last")["step"] == 2
    again = CheckpointManager(str(tmp_path))  # a restart reads meta.json
    assert again.best == {"val/mIoU": 0.3, "val/IoU": 0.5}
    again.save({"step": 3}, 3, {"val/mIoU": 0.25, "val/IoU": 0.45})
    assert again.restore("best_val_mIoU")["step"] == 2
    assert again.restore("best_val_IoU")["step"] == 1
    assert again.restore("last")["step"] == 3
    assert not again.has("best_val_Recall") and again.restore("nope") is None


@pytest.mark.parametrize("prefix", ["model.", ""], ids=["lightning", "plain"])
def test_load_reference_checkpoint_matches_oracle(tmp_path, capsys, prefix):
    """A reference-schema checkpoint saved from the torch oracle loads
    with no missing key, and the port's forward equals the oracle's."""
    from tests.torch_oracle import TorchOccDepth, randomize_bn

    cfg = tiny_kitti_config()
    torch.manual_seed(5)
    oracle = TorchOccDepth(cfg).eval()
    randomize_bn(oracle, seed=5)
    path = tmp_path / "ref.ckpt"
    torch.save({"state_dict": {prefix + k: v
                               for k, v in oracle.state_dict().items()}},
               path)
    model = OccDepthModel(cfg).eval()
    assert load_reference_checkpoint(model, str(path)) == []
    assert "WARNING" not in capsys.readouterr().out
    b = make_synthetic_batch(cfg, batch_size=1, seed=6)
    with torch.no_grad():
        ours = model(_tensors(b))["ssc_logit"]
        t = _tensors(b)
        ref = oracle(t["img"].permute(0, 1, 4, 2, 3).contiguous(),
                     t["projected_pix"].long(), t["fov_mask"], t["cam_k"],
                     t["T_velo_2_cam"], t["ida_mats"])["ssc_logit"]
    np.testing.assert_allclose(ours.numpy(),
                               ref.permute(0, 2, 3, 4, 1).numpy(),
                               atol=LOGIT_ATOL)


def test_load_reference_checkpoint_warns_on_missing_keys(tmp_path, capsys):
    cfg = tiny_kitti_config()
    sd = OccDepthModel(cfg).state_dict()
    dropped = "net_rgb.decoder.up1._net.0.weight"
    del sd[dropped]
    torch.save(sd, tmp_path / "partial.pt")
    missing = load_reference_checkpoint(OccDepthModel(cfg),
                                        str(tmp_path / "partial.pt"))
    assert missing == [dropped]
    assert "WARNING: 1 torch keys not found" in capsys.readouterr().out


def _table(fn, stats, names):
    buf = io.StringIO()
    with redirect_stdout(buf):
        fn(stats, names)
    return buf.getvalue()


def test_print_stats_matches_jax():
    stats = {"precision": 0.51234, "recall": 0.25, "iou": 0.2000049,
             "iou_ssc": np.linspace(0.0, 0.97, 20), "iou_ssc_mean": 0.4321}
    names = class_names_for("kitti")
    assert (_table(eval_cli.print_stats, stats, names)
            == _table(jax_print_stats, stats, names))


def test_eval_cli_prints_the_table_on_cpu(tmp_path, monkeypatch, capsys):
    """`main` with --device cpu and --torch-ckpt at the tiny config (the
    config loader and the datasets replaced by in-memory ones)."""
    cfg = tiny_kitti_config(batch_size_per_gpu=2, logdir=str(tmp_path))
    sd = randomize_weights(OccDepthModel(cfg), seed=7).state_dict()
    path = tmp_path / "ref.ckpt"
    torch.save({"state_dict": {"model." + k: v for k, v in sd.items()}}, path)
    monkeypatch.setattr(eval_cli, "load_config",
                        lambda _, overrides: dataclasses.replace(cfg,
                                                                 **overrides))
    monkeypatch.setattr(eval_cli, "make_datasets",
                        lambda c: (None, synthetic_dataset(c, 3, seed=8)))
    eval_cli.main(["--config", "tiny.yaml", "--torch-ckpt", str(path),
                   "--device", "cpu", "decoder_conv_impl=pallas"])
    out = capsys.readouterr().out
    assert "WARNING" not in out
    lines = out.splitlines()
    assert lines[0] == "test======" and lines[1].startswith("Precision=")
    assert lines[-1].startswith("mIoU=")


def test_eval_cli_needs_a_device_choice_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eval_cli.main(["--config", default_config_path(
            "semantic_kitti/multicam_flospdepth_crp_stereodepth_cascadecls")])


def test_eval_slice_imports_no_jax(tmp_path):
    """The eval CLI and the data modules import, and a CPU validate runs
    at decoder_conv_impl=pallas, with jax, flax, optax and the JAX package
    unimportable."""
    code = textwrap.dedent("""
        import sys
        for name in ("jax", "flax", "jaxlib", "optax", "occdepth_tpu"):
            sys.modules[name] = None
        import occdepth_tpu_torch.data.augment
        import occdepth_tpu_torch.data.kitti
        import occdepth_tpu_torch.data.kitti_io
        import occdepth_tpu_torch.ops.conv2d_shift
        import occdepth_tpu_torch.scripts.eval
        from occdepth_tpu_torch.data.kitti import Loader
        from occdepth_tpu_torch.testing import synthetic_dataset, tiny_kitti_config
        from occdepth_tpu_torch.training import Trainer

        cfg = tiny_kitti_config(batch_size_per_gpu=2,
                                decoder_conv_impl="pallas")
        trainer = Trainer(cfg, sys.argv[1], device="cpu")
        stats = trainer.validate(Loader(synthetic_dataset(cfg, 3, seed=2), 2,
                                        shuffle=False, drop_last=False,
                                        num_workers=0))
        assert stats["n_frames"] == 3, stats["n_frames"]
        assert stats["conf"].sum() == 3 * 32 * 32 * 16, stats["conf"].sum()
        jax_side = sorted(
            m for m, mod in sys.modules.items() if mod is not None
            and (m.split(".")[0] in ("jax", "flax", "jaxlib", "optax",
                                     "occdepth_tpu")))
        assert not jax_side, jax_side
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("ok")
