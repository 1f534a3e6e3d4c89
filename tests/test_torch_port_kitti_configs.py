"""The shipped KITTI configs' shapes that no other test holds, vs the JAX
package (CPU, fp32), at tiny widths.

`semantic_kitti/flospdepth.yaml`: one view, no CRP, no cascade, OAD on
(the one-view lift is the per-scale gather, not the fused lift); and
`semantic_kitti/multicam_flosp_crp_cascadecls_highcap.yaml`: the b7
encoder with `trans_2d_to_3d: flosp` and `share_2d_backbone_gradient:
false`.  Each tiny model's eval logits and train-mode loss terms are held
to the JAX model's on one seeded weight set (port -> `convert_state_dict`
-> JAX -> `state_dict_from_jax` -> port) and one labelled batch.  The
`share_2d_backbone_gradient: false` train step is held in
`test_torch_port_train_step.py`.

Bounds.  The eval logits agree to ~5e-6 (fp32 sums in another order):
LOGIT_ATOL = 2e-5.  Train-mode loss terms run BatchNorm on batch
statistics over a handful of elements, so they carry the network's fp32
noise (~1e-4 relative): each term must agree within LOSS_RTOL = 5e-4, or
within NOISE_MULT times the port's own change under a 1e-7 weight
perturbation where that is larger (`test_torch_port_train_step.py`'s
rule).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import occdepth_tpu.testing as jax_testing
from occdepth_tpu.models import OccDepthModel as JaxOccDepthModel
from occdepth_tpu.training.convert_torch import convert_state_dict
from occdepth_tpu.training.step import compute_losses as jax_compute_losses
from occdepth_tpu_torch.data.batch import make_synthetic_batch
from occdepth_tpu_torch.models import OccDepthModel
from occdepth_tpu_torch.testing import (
    perturbed_copy,
    randomize_weights,
    tiny_kitti_config,
)
from occdepth_tpu_torch.training.step import compute_losses
from occdepth_tpu_torch.weights import state_dict_from_jax

LOGIT_ATOL = 2e-5
LOSS_RTOL = 5e-4
NOISE_MULT = 4.0
N_PERTURB = 2

CONFIGS = {
    # flospdepth.yaml: mono, no CRP, no cascade, no stereo depth
    "flospdepth": dict(multi_view_mode=False, context_prior=False,
                       relation_loss=False, cascade_cls=False,
                       use_stereo_depth_gt=False),
    # multicam_flosp_crp_cascadecls_highcap.yaml: b7, flosp, no OAD
    "flosp_b7_highcap": dict(backbone_2d_name="tf_efficientnet_b7_ns",
                             trans_2d_to_3d="flosp",
                             use_stereo_depth_gt=False,
                             share_2d_backbone_gradient=False),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tier-1 gate runs six test processes on a few cores; this file's
    tiny-shape torch work takes one thread so it does not crowd them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=list(CONFIGS))
def outputs(request):
    """(config, port eval outputs, JAX's, port loss terms and those of its
    perturbed copies, JAX's loss terms); the JAX side jitted once."""
    kw = CONFIGS[request.param]
    cfg, jcfg = tiny_kitti_config(**kw), jax_testing.tiny_kitti_config(**kw)
    src = randomize_weights(OccDepthModel(cfg), seed=9)
    params, stats, missing = convert_state_dict(
        {k: v.numpy() for k, v in src.state_dict().items()}, jcfg)
    assert not missing, missing[:10]
    variables = {"params": params, "batch_stats": stats}
    port = OccDepthModel(cfg)
    port.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)
    batch = make_synthetic_batch(cfg, batch_size=1, seed=11, with_labels=True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        ours = port.eval()(tb)
        logs = [compute_losses(cfg, m.train()(tb), tb, 0.0)[1] for m in
                [port] + [perturbed_copy(port, s) for s in range(N_PERTURB)]]
    model = JaxOccDepthModel(cfg=jcfg)

    def run(v, b):
        out = model.apply(v, b, train=False)
        tout, _ = model.apply(v, b, train=True, mutable=["batch_stats"])
        _, jlogs = jax_compute_losses(jcfg, tout, b,
                                      jnp.zeros((), jnp.float32))
        return out, jlogs

    ref, ref_logs = jax.jit(run)(variables, batch)
    return (cfg, {k: v.numpy() for k, v in ours.items()},
            {k: np.asarray(v) for k, v in ref.items()},
            [{k: float(v) for k, v in lg.items()} for lg in logs],
            {k: float(v) for k, v in ref_logs.items()})


def test_eval_outputs_match_jax(outputs):
    cfg, ours, ref = outputs[:3]
    assert set(ours) <= set(ref), (sorted(ours), sorted(ref))
    assert ("P_logits" in ours) == cfg.context_prior
    assert ("occ_logit" in ours) == cfg.cascade_cls
    assert ours["ssc_logit"].shape[1:4] == tuple(cfg.full_scene_size)
    for k in ours:
        assert ours[k].shape == ref[k].shape and ours[k].dtype == np.float32
        err = np.abs(ours[k] - ref[k]).max()
        print(f"{k}: max |port - jax| = {err:.3g}")
        assert err <= LOGIT_ATOL, (k, err)


def test_train_losses_match_jax(outputs):
    cfg, (ours, *perturbed), ref = outputs[0], *outputs[3:]
    assert set(ours) == set(ref), (sorted(ours), sorted(ref))
    for k, v in ref.items():
        assert np.isfinite(ours[k]), k
        noise = max(abs(ours[k] - q[k]) for q in perturbed)
        tol = max(LOSS_RTOL * abs(v), NOISE_MULT * noise)
        print(f"{k}: rel err {abs(ours[k] - v) / abs(v):.3g}, "
              f"noise {noise / abs(v):.3g}")
        assert abs(ours[k] - v) <= tol, (k, ours[k], v, noise)
