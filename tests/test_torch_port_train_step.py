"""The ported train step as a whole vs the JAX package (CPU, fp32).

At `tiny_kitti_config`, a port model with seeded random weights goes
through `convert_state_dict` into the JAX `OccDepthModel`; both frameworks
then take one optimizer step on the same labelled synthetic batches.  The
JAX side is `compute_losses` after `apply(train=True)` under `jax.grad`,
jitted once in a module-scoped fixture (the accumulate_grad_batches=2 case
calls the same compiled function once per microbatch), then optax's
clip + AdamW update.  JAX gradients, running statistics and updated
parameters come back to port parameter names through `state_dict_from_jax`.

The port runs `dw_conv_grad='pallas'`, so its 22 stride-1 depthwise convs
take the filter gradient from K4's plain version; the JAX side runs its
stock autodiff ('xla'), whose Pallas path `tests/test_dw_conv.py` holds to
the same reference.

Gradient tolerance.  Loss terms agree to 1e-4, and the gradients of the
output heads to ~1e-4 of their size, but through the ~100 BatchNorm layers
(many over a handful of elements at this size: the encoder's last stage is
2x3 pixels, the 3D bottleneck 4x4x2 voxels) this network's fp32 gradients
are ill-conditioned: scaling the port's weights by (1 + 1e-7 * N(0, 1)),
an fp32 rounding-sized change, moves the port's own encoder gradients by
~10%.  Two frameworks that sum in different orders differ by the same
kind of rounding.  So each parameter's gradient (and one-step update) must
agree within 1e-3 * max|g_jax| + 1e-6 where that holds, and otherwise
within NOISE_MULT times the port's own change under that perturbation
(the approach of tests/test_grad_parity.py, which measures torch's fp32
self-noise against float64).  A missing stop_gradient, a dropped loss term
or a wrong layout moves gradients by far more than that noise.
"""
import functools

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree
import numpy as np
import optax
import pytest
import torch

from occdepth_tpu.models import OccDepthModel as JaxOccDepthModel
from occdepth_tpu.testing import tiny_kitti_config as jax_tiny_kitti
from occdepth_tpu.training.convert_torch import convert_state_dict
from occdepth_tpu.training.optim import make_optimizer as jax_make_optimizer
from occdepth_tpu.training.step import compute_losses as jax_compute_losses
from occdepth_tpu_torch.data.batch import make_synthetic_batch
from occdepth_tpu_torch.models import OccDepthModel
from occdepth_tpu_torch.testing import (
    count_flips,
    noise_aware_worst,
    perturbed_copy,
    randomize_weights,
    tiny_kitti_config,
)
from occdepth_tpu_torch.training.optim import lr_at, make_optimizer
from occdepth_tpu_torch.training.step import train_step
from occdepth_tpu_torch.weights import state_dict_from_jax

STEPS_PER_EPOCH = 10
LOSS_RTOL = 1e-4
GRAD_RTOL = 1e-3  # x max|g_jax| per parameter where it holds
NOISE_MULT = 4.0  # x the port's own change under a 1e-7 weight perturbation
N_PERTURB = 3
FLIP_MULT = 2.0
STATS_RTOL = 1e-5



@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tier-1 gate runs six test processes on a few cores; this file's
    tiny-shape torch work takes one thread so it does not crowd the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

@functools.lru_cache(maxsize=None)
def _jax_grad_fn(share_2d_backbone_gradient):
    cfg = jax_tiny_kitti(share_2d_backbone_gradient=share_2d_backbone_gradient)
    model = JaxOccDepthModel(cfg=cfg)

    def loss_fn(params, batch_stats, batch):
        out, state = model.apply(
            {"params": params, "batch_stats": batch_stats}, batch,
            train=True, mutable=["batch_stats"])
        loss, logs = jax_compute_losses(cfg, out, batch,
                                        jnp.zeros((), jnp.float32))
        return loss, (logs, state["batch_stats"])

    return jax.jit(jax.grad(loss_fn, has_aux=True))


@pytest.fixture(scope="module")
def jax_update_fn():
    """optax clip + AdamW as one jitted call: (clipped grads, new params).

    The trees go through as one raveled vector (clipping takes the global
    norm and AdamW is elementwise, so the math is the tree's): a 644-leaf
    tree would take most of this file's compile time."""
    cfg = jax_tiny_kitti()
    clip = optax.clip_by_global_norm(cfg.gradient_clip_val)
    tx = jax_make_optimizer(cfg, STEPS_PER_EPOCH)

    @jax.jit
    def update_flat(grads, params):
        clipped, _ = clip.update(grads, clip.init(params))
        updates, _ = tx.update(grads, tx.init(params), params)
        return clipped, optax.apply_updates(params, updates)

    def update(grads, params):
        flat_p, unravel = ravel_pytree(params)
        clipped, new = update_flat(ravel_pytree(grads)[0], flat_p)
        return unravel(clipped), unravel(new)

    return update


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_step(cfg, model, batches):
    """One port train_step; returns (logs, grads by name, state_dict,
    parameters before the step, completion, conf, backbone calls whose
    features received a gradient)."""
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = make_optimizer(model.parameters(), cfg)
    calls, reached = [], set()

    def hook(module, inputs, feats):
        call = len(calls)
        calls.append(call)
        for feat in feats.values():
            if feat.requires_grad:
                feat.register_hook(lambda g, call=call: reached.add(call))

    handle = model.net_rgb.register_forward_hook(hook)
    try:
        logs, completion, conf = train_step(
            cfg, model, opt,
            [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches],
            progress=0.0, lr=lr_at(cfg, STEPS_PER_EPOCH, 0),
        )
    finally:
        handle.remove()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return (logs, grads, model.state_dict(), before, completion, conf,
            (len(calls), sorted(reached)))


@pytest.fixture(scope="module", params=[(1, True), (2, True), (1, False)],
                ids=["accum1", "accum2", "unshared_backbone_grad"])
def step_results(request, jax_update_fn):
    """accum1/accum2: the tiny config, one and two microbatches per step;
    unshared_backbone_grad: `share_2d_backbone_gradient: false` (both
    `*_highcap.yaml`), where view 1's backbone pass is differentiated too."""
    accum, share = request.param
    jax_grad_fn = _jax_grad_fn(share)
    cfg = tiny_kitti_config(dw_conv_grad="pallas",
                            share_2d_backbone_gradient=share)
    port = randomize_weights(OccDepthModel(cfg), seed=21)
    # copies: the port's step updates its tensors in place
    sd = {k: v.numpy().copy() for k, v in port.state_dict().items()}
    params, stats, missing = convert_state_dict(sd, jax_tiny_kitti())
    assert not missing, missing[:10]
    batches = [make_synthetic_batch(cfg, batch_size=1, seed=30 + i,
                                    with_labels=True) for i in range(accum)]

    # ---- JAX: grad per microbatch (BN stats threaded), mean, update ----
    grad_sum, logs_all, batch_stats = None, [], stats
    for b in batches:
        g, (logs, batch_stats) = jax_grad_fn(params, batch_stats, b)
        g = _numpy_tree(g)
        grad_sum = g if grad_sum is None else jax.tree_util.tree_map(
            np.add, grad_sum, g)
        logs_all.append({k: float(v) for k, v in logs.items()})
    grads = jax.tree_util.tree_map(lambda t: t / np.float32(accum), grad_sum)
    clipped, new_params = jax_update_fn(grads, params)
    ref_logs = {k: np.mean([lg[k] for lg in logs_all]) for k in logs_all[0]}
    ref_grads = state_dict_from_jax(
        {"params": _numpy_tree(clipped), "batch_stats": stats}, cfg)
    ref_after = state_dict_from_jax(
        {"params": _numpy_tree(new_params),
         "batch_stats": _numpy_tree(batch_stats)}, cfg)

    # ---- port: one train_step over the same microbatches, and again
    # from rounding-sized perturbed weights (the noise yardstick) ----
    perturbed = [perturbed_copy(port, seed) for seed in range(N_PERTURB)]
    logs, grads, after, before, completion, conf, views = _port_step(
        cfg, port, batches)
    update = {n: after[n] - before[n] for n in before}
    grads_p, update_p, stats_p = [], [], []
    stat_keys = [k for k in after if k.endswith(("running_mean",
                                                 "running_var"))]
    for m in perturbed:
        _, g_p, after_p, before_p, _, _, _ = _port_step(cfg, m, batches)
        grads_p.append(g_p)
        update_p.append({n: after_p[n] - before_p[n] for n in before})
        stats_p.append({k: after_p[k] for k in stat_keys})
    ref_update = {n: ref_after[n] - torch.from_numpy(sd[n]) for n in before}

    # optax's update on the port's own (clipped) gradients
    port_grad_sd = dict(sd, **{n: g.numpy() for n, g in grads.items()})
    g_tree, _, _ = convert_state_dict(port_grad_sd, jax_tiny_kitti())
    _, from_ours = jax_update_fn(g_tree, params)
    from_ours = state_dict_from_jax(
        {"params": _numpy_tree(from_ours), "batch_stats": stats}, cfg)
    return {
        "logs": ({k: float(v) for k, v in logs.items()}, ref_logs),
        "grads": (grads, ref_grads, grads_p),
        "updates": (update, ref_update, update_p),
        "optax_on_port_grads": {n: from_ours[n] - torch.from_numpy(sd[n])
                                for n in before},
        "lr": lr_at(cfg, STEPS_PER_EPOCH, 0),
        "stats": ({k: after[k] for k in stat_keys}, ref_after, stats_p),
        "counts": (completion, conf, batches),
        "views": (cfg, views),
    }


def _noise_aware_worst(ours, ref, perturbed, rtol=GRAD_RTOL):
    return noise_aware_worst(ours, ref, perturbed, rtol, NOISE_MULT)


def test_loss_terms_match(step_results):
    ours, ref = step_results["logs"]
    assert set(ours) == set(ref)
    assert len(ours) == 8  # the 7 terms the tiny config enables + total
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], rtol=LOSS_RTOL,
                                   err_msg=k)


def test_gradients_match(step_results):
    ours, ref, perturbed = step_results["grads"]
    assert set(ours) <= set(ref)
    worst = _noise_aware_worst(ours, ref, perturbed)
    assert worst[0][0] <= 1.0, worst[:5]
    # the output heads hold the fixed bound, up to the global clip scale
    # (the clipped norm divides by the whole net's noisy gradient norm)
    for name in ("net_3d_decoder.ssc_head.conv_classes.weight",
                 "net_3d_decoder.ssc_head.occ_classes.weight"):
        g, g_ref = ours[name].numpy(), ref[name].numpy()
        err = np.abs(g / np.linalg.norm(g) - g_ref / np.linalg.norm(g_ref))
        assert err.max() <= GRAD_RTOL * np.abs(g_ref).max() / np.linalg.norm(
            g_ref), name


def test_running_stats_match(step_results):
    """Running statistics after the step: noise-aware as the gradients,
    with the fixed bound STATS_RTOL of each statistic vector's size (the
    deep encoder's statistics are over 6 pixels per channel at this size,
    and carry the forward's accumulated fp32 rounding)."""
    ours, ref, perturbed = step_results["stats"]
    assert ours
    worst = _noise_aware_worst(ours, ref, perturbed, STATS_RTOL)
    assert worst[0][0] <= 1.0, worst[:5]


def test_updated_params_match(step_results):
    """The parameters after one step.

    AdamW's first update is ~lr * sign(g), so every element whose gradient
    lies inside the fp32 noise can flip its update (~2.5% of the elements
    here, about as many between the port and a perturbed copy of itself as
    between the port and JAX).  So: (1) the port's update is exactly
    optax's clip + AdamW applied to the port's own gradients, and (2) the
    elements whose update differs from JAX's by more than lr / 2 are no
    more than FLIP_MULT times those that differ so between the port and
    its perturbed copies.
    """
    ours, ref, perturbed = step_results["updates"]
    optax_on_ours = step_results["optax_on_port_grads"]
    for n, u in ours.items():
        # p_new - p_old in fp32: one rounding of p_new, ~1e-7 at |p| ~ 1
        np.testing.assert_allclose(u.numpy(), optax_on_ours[n].numpy(),
                                   rtol=1e-5, atol=1.2e-7, err_msg=n)
    half_lr = 0.5 * step_results["lr"]
    noise = max(count_flips(ours, q, half_lr) for q in perturbed)
    flips = count_flips(ours, ref, half_lr)
    assert flips <= FLIP_MULT * noise, (flips, noise)


def test_confusion_counts_cover_the_batches(step_results):
    completion, conf, batches = step_results["counts"]
    n_vox = sum(b["target"].size for b in batches)
    assert int(conf.sum()) == n_vox
    assert int(completion.sum()) <= n_vox


def test_backbone_views_receive_gradients(step_results):
    """The backbone runs once per view and microbatch; the features of
    view 0 always receive a gradient, those of view 1 only with
    `share_2d_backbone_gradient: false` (under `true` view 1 runs under
    no_grad, JAX's stop_gradient)."""
    cfg, (n_calls, reached) = step_results["views"]
    n_micro = len(step_results["counts"][2])
    assert n_calls == 2 * n_micro
    want = [c for c in range(n_calls)
            if c % 2 == 0 or not cfg.share_2d_backbone_gradient]
    assert reached == want, (reached, want)
