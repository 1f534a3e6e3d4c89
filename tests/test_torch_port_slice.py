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
    ref = JaxOccDepthModel(cfg=jax_tiny_kitti()).apply(variables, batch,
                                                       train=False)
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
                               batch_size=2, max_in_flight=2)
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
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("ok")
