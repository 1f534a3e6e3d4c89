"""The port's full-resolution fp32 forwards held to the golden digests.

`tests/test_fullres_parity.py` pushes one frame at the released-checkpoint
resolutions through the JAX package and its torch oracle, and digests the
JAX outputs into `tests/golden/fullres_{kitti,nyu}.npz` (mean, std,
per-channel mean and 2,048 probes of each head).  Here the port runs the
same two forwards on the CPU, from the same weights (the oracle's
state_dict, seeds 17 and 19 with `randomize_bn`, loaded into the port
natively) and the same batches (the JAX package's `make_synthetic_batch`
at seeds 31 and 32), and its digests must match those fixtures within the
golden test's own tolerances (2e-4 for mean, std and chan_mean, 5e-3 for
probes):

  * KITTI flagship: 370x1220 stereo -> 256x256x32, b3, feature 32,
    flosp_depth + CRP + cascade;
  * NYU virtual stereo: 480x640 RGB-D -> 60x36x60, b4, feature 100, flosp
    + CRP.

The full resolution is the point: the shapes at which the CRP's mega
voxels, the lift's four scales and the decoder's ragged sizes are the
released ones.  Slow (one full forward each on the CPU), so out of tier-1:

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_port_fullres.py \
        -m slow -q
"""
import numpy as np
import pytest
import torch

from occdepth_tpu.data.batch import make_synthetic_batch
from occdepth_tpu_torch.config import OccDepthConfig
from occdepth_tpu_torch.models import OccDepthModel
from tests.test_fullres_parity import (
    GOLDEN_DIR,
    KITTI_HEADS,
    NYU_HEADS,
    _digest,
    fullres_kitti_config,
    fullres_nyu_config,
)

DIGEST_ATOL = 2e-4  # mean, std, chan_mean (test_fullres_parity._check)
PROBE_ATOL = 5e-3  # probes


def _port_config(jcfg) -> OccDepthConfig:
    """The port's config with the JAX fixture config's fields."""
    keys = ("dataset", "full_scene_size", "project_scale", "feature",
            "feature_2d_oc", "n_classes", "n_relations", "multi_view_mode",
            "use_stereo_depth_gt", "use_depth_gt", "cascade_cls",
            "context_prior", "trans_2d_to_3d", "backbone_2d_name",
            "compute_dtype")
    return OccDepthConfig(**{k: getattr(jcfg, k) for k in keys})


def _port_model(jcfg, oracle_cls, seed):
    """The oracle at `seed` with randomized BN (as the golden test builds
    it), its state_dict loaded into the port."""
    from tests.torch_oracle import randomize_bn

    torch.manual_seed(seed)
    oracle = oracle_cls(jcfg).eval()
    randomize_bn(oracle, seed=seed)
    sd = oracle.state_dict()
    del oracle
    model = OccDepthModel(_port_config(jcfg)).eval()
    own = model.state_dict()
    missing = [k for k in own if k not in sd
               and not k.endswith("num_batches_tracked")]
    assert not missing, missing[:10]
    model.load_state_dict({k: v for k, v in sd.items() if k in own},
                          strict=False)
    return model


def _hold_to_golden(out, heads, name):
    g = np.load(f"{GOLDEN_DIR}/fullres_{name}.npz")
    digests = {}
    for head in sorted(heads):
        _digest(head, out[head].numpy(), digests)
    worst = {}
    for k in sorted(digests):
        atol = PROBE_ATOL if k.endswith(".probe") else DIGEST_ATOL
        err = float(np.abs(digests[k] - g[k]).max())
        worst[k] = err
        np.testing.assert_allclose(digests[k], g[k], atol=atol, err_msg=k)
    print(f"{name}: worst digest error " + ", ".join(
        f"{k} {v:.2e}" for k, v in worst.items()))


@pytest.mark.slow
def test_fullres_kitti_flagship_matches_golden():
    from tests.torch_oracle import TorchOccDepth

    jcfg = fullres_kitti_config()
    model = _port_model(jcfg, TorchOccDepth, seed=17)
    batch = make_synthetic_batch(jcfg, batch_size=1, seed=31,
                                 with_labels=False)
    with torch.inference_mode():
        out = model({k: torch.from_numpy(np.asarray(v))
                     for k, v in batch.items()})
    _hold_to_golden(out, KITTI_HEADS, "kitti")


@pytest.mark.slow
def test_fullres_nyu_matches_golden():
    from tests.torch_oracle import TorchOccDepthNYU

    jcfg = fullres_nyu_config()
    model = _port_model(jcfg, TorchOccDepthNYU, seed=19)
    batch = make_synthetic_batch(jcfg, batch_size=1, seed=32)
    with torch.inference_mode():
        out = model({k: torch.from_numpy(np.asarray(v))
                     for k, v in batch.items()})
    _hold_to_golden(out, NYU_HEADS, "nyu")
