"""The ported serving slice as a whole vs the JAX package (CPU, fp32).

One module-scoped fixture: a port model with seeded random weights goes
through `convert_state_dict` into the JAX `OccDepthModel`, and back through
`state_dict_from_jax` into a fresh port model (`strict=True`); both
frameworks then run the same tiny KITTI batch.
"""
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

import occdepth_tpu.config as jax_config
from occdepth_tpu.models import OccDepthModel as JaxOccDepthModel
from occdepth_tpu.testing import tiny_kitti_config as jax_tiny_kitti
from occdepth_tpu.training.convert_torch import convert_state_dict
from occdepth_tpu_torch.config import load_config
from occdepth_tpu_torch.data.batch import make_synthetic_batch
from occdepth_tpu_torch.models import OccDepthModel
from occdepth_tpu_torch.testing import randomize_weights, tiny_kitti_config
from occdepth_tpu_torch.weights import state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tier-1 gate runs six test processes on a few cores; this file's
    tiny-shape torch work (and its subprocesses, by OMP_NUM_THREADS) takes
    one thread so it does not crowd the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _numpy_sd(model):
    return {k: v.numpy() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def slice_outputs():
    cfg = tiny_kitti_config()
    src = randomize_weights(OccDepthModel(cfg), seed=9).eval()
    params, stats, missing = convert_state_dict(_numpy_sd(src),
                                                jax_tiny_kitti())
    assert not missing, missing[:10]
    variables = {"params": params, "batch_stats": stats}

    port = OccDepthModel(cfg).eval()
    port.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)

    batch = make_synthetic_batch(cfg, batch_size=1, seed=11)
    with torch.no_grad():
        ours = port({k: torch.from_numpy(v) for k, v in batch.items()})
    # jitted: one compile costs less than eager JAX's per-op dispatch
    model = JaxOccDepthModel(cfg=jax_tiny_kitti())
    ref = jax.jit(lambda v, b: model.apply(v, b, train=False))(variables,
                                                                batch)
    return ({k: v.numpy() for k, v in ours.items()},
            {k: np.asarray(v) for k, v in ref.items()})


@pytest.mark.parametrize("key,atol", [
    ("ssc_logit", 3e-3), ("occ_logit", 3e-3), ("P_logits", 3e-3),
    ("depth_pred", 1e-4),
])
def test_slice_matches_jax(slice_outputs, key, atol):
    ours, ref = slice_outputs
    assert ours[key].shape == ref[key].shape, key
    assert ours[key].dtype == np.float32
    np.testing.assert_allclose(ours[key], ref[key], atol=atol)


def test_flagship_width_weight_round_trip():
    """Port state_dict -> convert_state_dict -> state_dict_from_jax is the
    identity at the full flagship width, with no key missing either way."""
    path = jax_config.default_config_path(
        "semantic_kitti/multicam_flospdepth_crp_stereodepth_cascadecls")
    cfg = load_config(path)
    sd = randomize_weights(OccDepthModel(cfg), seed=2).state_dict()
    params, stats, missing = convert_state_dict(
        {k: v.numpy() for k, v in sd.items()}, jax_config.load_config(path))
    assert not missing, missing[:10]
    back = state_dict_from_jax({"params": params, "batch_stats": stats}, cfg)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k


def test_serving_imports_no_jax():
    """Every slice module imports, and the tiny ServingPipeline serves on
    the CPU, with jax and flax unimportable."""
    code = textwrap.dedent("""
        import sys
        for name in ("jax", "flax", "jaxlib"):
            sys.modules[name] = None
        import numpy as np
        import occdepth_tpu_torch.config
        import occdepth_tpu_torch.data.batch
        import occdepth_tpu_torch.geometry.depth_bins
        import occdepth_tpu_torch.geometry.frustum
        import occdepth_tpu_torch.geometry.projection
        import occdepth_tpu_torch.models.crp3d
        import occdepth_tpu_torch.models.efficientnet
        import occdepth_tpu_torch.models.flosp_depth
        import occdepth_tpu_torch.models.layers
        import occdepth_tpu_torch.models.occdepth
        import occdepth_tpu_torch.models.sfa
        import occdepth_tpu_torch.models.unet2d
        import occdepth_tpu_torch.models.unet3d
        import occdepth_tpu_torch.models.unet3d_blocks
        import occdepth_tpu_torch.ops.crp_matmul
        import occdepth_tpu_torch.ops.cuda_lib
        import occdepth_tpu_torch.ops.flosp_gather
        import occdepth_tpu_torch.ops.grid_sample
        import occdepth_tpu_torch.ops.resize
        import occdepth_tpu_torch.ops.stereo_fuse
        import occdepth_tpu_torch.weights
        from occdepth_tpu_torch.data.batch import make_synthetic_batch
        from occdepth_tpu_torch.models import OccDepthModel
        from occdepth_tpu_torch.serving import ServingPipeline
        from occdepth_tpu_torch.testing import (
            randomize_weights, tiny_kitti_config)

        cfg = tiny_kitti_config()
        model = randomize_weights(OccDepthModel(cfg), seed=0)
        pipe = ServingPipeline(cfg, model, make_synthetic_batch(cfg),
                               batch_size=2, max_in_flight=2, device="cpu")
        rs = np.random.RandomState(0)
        H, W = cfg.img_shape
        frames = [rs.randint(0, 256, (2, H, W, 3)).astype(np.uint8)
                  for _ in range(5)]
        preds = list(pipe.run(frames))
        assert len(preds) == 5, len(preds)
        for p in preds:
            assert p.shape == cfg.full_scene_size and p.dtype == np.uint8
            assert int(p.max()) < cfg.n_classes
        # the padded tail batch serves frame 4 as a full batch would
        again = list(pipe.run(frames[4:] + frames[:1]))
        assert np.array_equal(again[0], preds[4])
        jax_side = sorted(
            m for m, mod in sys.modules.items() if mod is not None
            and (m.split(".")[0] in ("jax", "flax", "jaxlib", "occdepth_tpu")))
        assert not jax_side, jax_side
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_training_imports_no_jax(tmp_path):
    """Every training-slice module and the kernel probe scripts import, and
    the tiny Trainer takes 2 CPU steps (K4's path included) over a 2-sample
    dataset, validates, keeps the best-by-val/mIoU checkpoint and resumes,
    with jax, flax and the JAX package unimportable."""
    code = textwrap.dedent("""
        import sys
        for name in ("jax", "flax", "jaxlib", "optax", "occdepth_tpu"):
            sys.modules[name] = None
        import json
        import occdepth_tpu_torch.data.params
        import occdepth_tpu_torch.geometry.frustums_mask
        import occdepth_tpu_torch.geometry.relations
        import occdepth_tpu_torch.losses
        import occdepth_tpu_torch.losses.crp
        import occdepth_tpu_torch.losses.depth
        import occdepth_tpu_torch.losses.fp_device
        import occdepth_tpu_torch.losses.metrics
        import occdepth_tpu_torch.losses.ssc
        import occdepth_tpu_torch.ops.dw_conv
        import occdepth_tpu_torch.ops.matmul_probe
        import occdepth_tpu_torch.ops.row_gather
        import occdepth_tpu_torch.scripts.bench_conv2d
        import occdepth_tpu_torch.scripts.bench_dwconv
        import occdepth_tpu_torch.scripts.bench_gather
        import occdepth_tpu_torch.scripts.bench_head_pallas
        import occdepth_tpu_torch.scripts.bench_timing
        import occdepth_tpu_torch.training.checkpoint
        import occdepth_tpu_torch.training.logging
        import occdepth_tpu_torch.training.optim
        import occdepth_tpu_torch.training.step
        import occdepth_tpu_torch.training.trainer
        from occdepth_tpu_torch.testing import synthetic_dataset, tiny_kitti_config
        from occdepth_tpu_torch.training import Trainer

        cfg = tiny_kitti_config(dw_conv_grad="pallas", log_every_n_steps=1)
        train_ds = synthetic_dataset(cfg, 2, seed=0)
        val_ds = synthetic_dataset(cfg, 1, seed=1)
        trainer = Trainer(cfg, sys.argv[1], device="cpu").fit(
            train_ds, val_ds, max_steps=2)
        assert trainer.step == 2, trainer.step
        with open(trainer.metrics_logger.path) as f:
            recs = [json.loads(line) for line in f]
        assert [r["step"] for r in recs if "train/loss" in r] == [1, 2]
        assert [r["step"] for r in recs if "val/mIoU" in r] == [2]
        assert trainer.ckpt.has("best_val_mIoU")
        assert Trainer(cfg, sys.argv[1], device="cpu").step == 2
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


def test_trainer_needs_a_device_choice_without_cuda(tmp_path, monkeypatch):
    """device=None means CUDA: without a GPU the Trainer raises rather
    than fall back to the CPU."""
    from occdepth_tpu_torch.training import Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(tiny_kitti_config(), str(tmp_path))


def test_serving_needs_a_device_choice_without_cuda(monkeypatch):
    """device=None means CUDA: without a GPU the ServingPipeline raises
    rather than serve on the CPU."""
    from occdepth_tpu_torch.serving import ServingPipeline

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tiny_kitti_config()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingPipeline(cfg, OccDepthModel(cfg), make_synthetic_batch(cfg))
