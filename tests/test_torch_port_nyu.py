"""The ported NYU RGB-D slice vs the JAX package and the torch oracle (CPU,
fp32).

The virtual right view and `UNet3DNYU` against their flax counterparts;
the tiny NYU model's eval outputs at batch 2 (the sample-0 disparity
broadcast at work) and train-mode loss terms against the JAX model on one
seeded weight set (port -> `convert_state_dict` -> JAX ->
`state_dict_from_jax` -> port); its gradients against
`tests/torch_oracle.py::TorchOccDepthNYU` in float64, whose state_dict the
port loads directly; `flosp_depth` with NYU's dynamic voxel bounds and
`agg_voxel_mode: sum` against JAX; NYU's frustum-proportion loss; the
weight round trip of both shipped NYU configs; the NYU dataset on a
full-size synthetic tree against the JAX dataset; and the train and eval
CLIs on the CPU with JAX blocked.

Gradients are held to the torch oracle, not to JAX: the JAX NYU gradients
miss the oracle's (tests/test_grad_parity.py, ROADMAP Queue 3 F1).
"""
import dataclasses
import json
import os
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
from occdepth_tpu.data.nyu import NYUDataset as JaxNYUDataset
from occdepth_tpu.data.nyu import collate as jax_collate
from occdepth_tpu.data.nyu import load_depth_png as jax_load_depth_png
from occdepth_tpu.losses.fp_device import (
    frustum_proportion_loss_device as jax_fp_loss,
)
from occdepth_tpu.models import OccDepthModel as JaxOccDepthModel
from occdepth_tpu.models.crp3d import CPMegaVoxels as JaxCPMegaVoxels
from occdepth_tpu.models.occdepth import _virtual_view as jax_virtual_view
from occdepth_tpu.models.unet3d import UNet3DNYU as JaxUNet3DNYU
from occdepth_tpu.training.convert_torch import (
    _Mapper,
    _map_crp,
    _nest,
    convert_state_dict,
)
from occdepth_tpu.training.step import compute_losses as jax_compute_losses
from occdepth_tpu_torch.config import (
    FlospDepthConfig,
    OccDepthConfig,
    load_config,
)
from occdepth_tpu_torch.data.batch import make_synthetic_batch
from occdepth_tpu_torch.data.nyu import NYUDataset, collate, load_depth_png
from occdepth_tpu_torch.losses.fp_device import frustum_proportion_loss_device
from occdepth_tpu_torch.models.crp3d import CPMegaVoxels
from occdepth_tpu_torch.models import OccDepthModel
from occdepth_tpu_torch.models.occdepth import _virtual_view
from occdepth_tpu_torch.testing import (
    make_nyu_tree,
    noise_aware_worst,
    nyu_fov_share,
    perturbed_copy,
    randomize_weights,
    tiny_kitti_config,
    tiny_nyu_config,
)
from occdepth_tpu_torch.training.step import compute_losses
from occdepth_tpu_torch.weights import state_dict_from_jax
from tests.torch_oracle import TorchOccDepthNYU, randomize_bn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NYU_CONFIGS = [os.path.join(REPO, "occdepth_tpu", "configs", "NYU", name)
               for name in ("multicam_flosp_crp_stereodepth_cascadecls.yaml",
                            "multicam_flosp_crp_depthgt_b7_v100.yaml")]
# the whole 3D decoder (~40 conv layers, logits up to ~5) in fp32, sums
# reordered by XLA's fusion (measured 1.05e-5 at worst on one of 4,096)
DECODER_ATOL = 1e-4
CRP_RTOL = 1e-5  # x max|ref|: fp32 sums over up to 196 mega-voxels reordered
# the warp's sample coordinate is ((x + 1) w - 1) / 2: an fp32 rounding of
# x (or of the resized depth it comes from) moves it by ~w / 2 * 1.2e-7
# pixels, ~5e-6 at w = 80, times a neighbour difference of up to ~6 in
# N(0, 1) features
WARP_ATOL = 5e-5
LOGIT_ATOL = 3e-3  # the serving slice's bound (test_torch_port_slice.py)
LOSS_RTOL = 1e-4  # the train step's bound (test_torch_port_train_step.py)
FP_LOSS_RTOL = 1e-5  # one KL over per-frustum sums of ~1k softmax rows
# Train-mode losses and gradients at the tiny size go through BatchNorm
# over a handful of elements (the 2D encoder's last stages see 2x3 pixels
# of 2 images, the 3D bottleneck 4x2x4 voxels), so they are
# ill-conditioned in fp32: a term or a gradient must agree within its
# fixed bound, or where the port's own change under a (1 + 1e-7 N(0, 1))
# weight perturbation exceeds it, within NOISE_MULT times that change
# (test_torch_port_train_step.py's rule).
NOISE_MULT, N_PERTURB = 4.0, 3
GRAD_RTOL = 1e-3  # x the leaf's L2 norm, where the noise is smaller
ORACLE_MULT = 2.0  # x the oracle's own float32 - float64 gradient distance
# With BN on its running statistics the network is well conditioned: the
# port's fp32 gradients sit within 1.5e-5 of the float64 oracle's norm at
# worst (median 6e-7) over the 604 leaves, so each leaf is held to this
# fixed bound alone, with no noise branch.
RUNNING_GRAD_RTOL = 1e-4  # x the leaf's L2 norm
# the tiny config's OAD branch: world (X, Y, Z_up) = (16, 16, 8) at 0.3 m
TINY_FD_NYU = dict(x_bound=(0.0, 4.8, 0.3), y_bound=(-2.4, 2.4, 0.3),
                   z_bound=(0.0, 2.4, 0.3), d_bound=(0.5, 8.0, 0.25),
                   final_dim=(64, 80), mid_channels=16)
# the shipped NYU YAML, narrowed and on b0 (the dataset fixes the 480x640
# image and the 60x36x60 grid)
SMALL_NYU_OVERRIDES = [
    "feature=16", "feature_2d_oc=16", "backbone_2d_name=tf_efficientnet_b0_ns",
    "frustum_size=2", "compute_dtype=float32", "num_workers_per_gpu=0",
    "max_epochs=1", "log_every_n_steps=1"]


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


def _port_and_jax(cfg, jcfg, seed):
    """A port model with seeded random weights, its JAX variables through
    the converter, and the port model rebuilt from them."""
    src = randomize_weights(OccDepthModel(cfg), seed=seed)
    params, stats, missing = convert_state_dict(_numpy_sd(src), jcfg)
    assert not missing, missing[:10]
    variables = {"params": params, "batch_stats": stats}
    port = OccDepthModel(cfg)
    port.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)
    return port, variables


def test_virtual_view_matches_jax():
    """The warp at two scales of a 64x80 image, batch 2: border padding,
    the arange grid, zero-depth holes (infinite disparity -> 0), sample 0's
    disparity for both samples."""
    rs = np.random.RandomState(4)
    depth = rs.uniform(0.3, 6.0, (2, 1, 64, 80)).astype(np.float32)
    depth[rs.rand(2, 1, 64, 80) < 0.1] = 0.0
    bf = np.float32(0.1 * 518.8579)
    # jitted per scale: one compile each, not one per op
    warp = jax.jit(jax_virtual_view, static_argnums=2)
    for scale in (1, 4):
        feat = rs.randn(2, 16, 64 // scale, 80 // scale).astype(np.float32)
        ours = _virtual_view(torch.from_numpy(feat), torch.from_numpy(depth),
                             scale, torch.tensor(bf)).numpy()
        ref = np.asarray(warp(
            jnp.asarray(feat.transpose(0, 2, 3, 1)), jnp.asarray(depth),
            scale, jnp.asarray(bf))).transpose(0, 3, 1, 2)
        assert ours.shape == feat.shape and ours.dtype == np.float32
        np.testing.assert_allclose(ours, ref, atol=WARP_ATOL)
        # sample 1 is warped by sample 0's disparity, not its own
        own = _virtual_view(torch.from_numpy(feat[1:]),
                            torch.from_numpy(depth[1:]), scale,
                            torch.tensor(bf)).numpy()
        assert np.abs(own - ours[1:]).max() > 1e-3


def test_unet3d_nyu_matches_jax():
    """UNet3DNYU (no full-resolution stage, the head at `feature`, CRP at
    the ceil(s / 4) bottleneck) in eval mode with random BN statistics,
    on the tiny NYU grid, weights through the converter."""
    cfg = tiny_nyu_config()
    port, variables = _port_and_jax(cfg, jax_testing.tiny_nyu_config(), 3)
    x = np.random.RandomState(2).randn(1, 16, 16, 8, 16).astype(np.float32)
    with torch.no_grad():
        ours = port.net_3d_decoder.eval()(torch.from_numpy(x))
    flax_mod = JaxUNet3DNYU(n_classes=12, feature=16,
                            full_scene_size=(16, 8, 16))
    ref = jax.jit(lambda v, x: flax_mod.apply(v, x, train=False))(
        {k: v["net_3d_decoder"] for k, v in variables.items()},
        jnp.asarray(x.transpose(0, 2, 3, 4, 1)))
    assert set(ours) == {"ssc_logit", "occ_logit", "P_logits"}
    assert ours["P_logits"].shape == (1, 4, 4 * 2 * 4 // 8, 4 * 2 * 4)
    for k in ("ssc_logit", "occ_logit"):
        r = np.asarray(ref[k]).transpose(0, 4, 1, 2, 3)
        assert ours[k].shape == r.shape == (1, r.shape[1], 16, 8, 16), k
        np.testing.assert_allclose(ours[k].numpy(), r, atol=DECODER_ATOL,
                                   err_msg=k)
    np.testing.assert_allclose(ours["P_logits"].numpy(),
                               np.asarray(ref["P_logits"]), atol=DECODER_ATOL)


@pytest.mark.parametrize("size", [(4, 2, 4), (15, 9, 15)],
                         ids=["tiny", "nyu"])
def test_crp_bottleneck_matches_jax(size):
    """CPMegaVoxels at the tiny NYU bottleneck and at NYU's odd 15x9x15
    one (the mega conv pads (s + 1) % 2 per dim: M = 7 * 4 * 7 = 196
    mega-voxels for N = 2,025 voxels), eval mode, 16 channels in, weights
    through the converter; K2 runs its plain version here."""
    port = randomize_weights(CPMegaVoxels(16, size, n_relations=4), seed=6)
    m = _Mapper(_numpy_sd(port, "root."))
    _map_crp(m, "h", "root", 4)
    assert not m.missing, m.missing
    x = np.random.RandomState(8).randn(1, 16, *size).astype(np.float32)
    with torch.no_grad():
        ours = port.eval()(torch.from_numpy(x))
    flax_mod = JaxCPMegaVoxels(16, size, n_relations=4)
    ref = jax.jit(lambda v, x: flax_mod.apply(v, x, train=False))(
        {"params": _nest(m.params)["h"], "batch_stats": _nest(m.stats)["h"]},
        jnp.asarray(x.transpose(0, 2, 3, 4, 1)))
    n, mm = int(np.prod(size)), int(np.prod([s // 2 for s in size]))
    assert ours["P_logits"].shape == (1, 4, mm, n)
    np.testing.assert_allclose(ours["P_logits"].numpy(),
                               np.asarray(ref["P_logits"]), atol=DECODER_ATOL)
    # the block's output reaches ~140 (sums over the 196 mega-voxels)
    ref_x = np.asarray(ref["x"]).transpose(0, 4, 1, 2, 3)
    np.testing.assert_allclose(ours["x"].numpy(), ref_x, rtol=0,
                               atol=CRP_RTOL * np.abs(ref_x).max())


def _tiny_fd_nyu():
    return (tiny_nyu_config(trans_2d_to_3d="flosp_depth",
                            flosp_depth_override=FlospDepthConfig(
                                **TINY_FD_NYU)),
            jax_testing.tiny_nyu_config(
                trans_2d_to_3d="flosp_depth",
                flosp_depth_override=jax_config.FlospDepthConfig(
                    **TINY_FD_NYU)))


def _tiny_kitti_sum():
    port, ref = tiny_kitti_config(), jax_testing.tiny_kitti_config()
    return (dataclasses.replace(port, flosp_depth_override=dataclasses.replace(
        port.flosp_depth_conf, agg_voxel_mode="sum")),
        dataclasses.replace(ref, flosp_depth_override=dataclasses.replace(
            ref.flosp_depth_conf, agg_voxel_mode="sum")))


CONFIGS = {
    "nyu": lambda: (tiny_nyu_config(), jax_testing.tiny_nyu_config()),
    "nyu_flosp_depth": _tiny_fd_nyu,
    "kitti_sum": _tiny_kitti_sum,
}


@pytest.fixture(scope="module")
def model_outputs():
    """Per config: port and JAX eval outputs at batch 2 on one weight set;
    for "nyu" also the train-mode loss terms (the port's, those of
    N_PERTURB perturbed copies, and JAX's).  The NYU flosp_depth batch's
    voxel origins are moved off the spec's bounds, each sample its own,
    so the first sample's origin must set the bounds."""
    results = {}
    for name, make in CONFIGS.items():
        cfg, jcfg = make()
        port, variables = _port_and_jax(cfg, jcfg, seed=9)
        batch = make_synthetic_batch(cfg, batch_size=2, seed=11,
                                     with_labels=True)
        if name == "nyu_flosp_depth":
            batch["vox_origin"] = batch["vox_origin"] + np.array(
                [[0.3, 0.45, 0.15], [-0.6, 0.3, 0.6]], np.float32)
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        with torch.no_grad():
            ours = port.eval()(tb)
        model = JaxOccDepthModel(cfg=jcfg)
        if name != "nyu":
            ref = jax.jit(lambda v, b: model.apply(v, b, train=False))(
                variables, batch)
            results[name] = ({k: v.numpy() for k, v in ours.items()},
                             {k: np.asarray(ref[k]) for k in ours})
            continue
        with torch.no_grad():
            logs = [compute_losses(cfg, m.train()(tb), tb, 0.0)[1] for m in
                    [port] + [perturbed_copy(port, s)
                              for s in range(N_PERTURB)]]

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


@pytest.mark.parametrize("name,key", [
    ("nyu", "ssc_logit"), ("nyu", "occ_logit"), ("nyu", "P_logits"),
    ("nyu_flosp_depth", "ssc_logit"), ("nyu_flosp_depth", "depth_pred"),
    ("kitti_sum", "ssc_logit"), ("kitti_sum", "P_logits"),
])
def test_eval_forward_matches_jax(model_outputs, name, key):
    """Eval outputs at batch 2 against JAX within LOGIT_ATOL: the tiny
    NYU model (virtual view, (X, Z, Y) lift, UNet3DNYU), with flosp_depth
    (NYU's dynamic bounds and (X, Z, Y) weight volume), and the tiny KITTI
    stereo model with agg_voxel_mode sum."""
    ours, ref = model_outputs[name][:2]
    cfg = CONFIGS[name]()[0]
    if key.endswith("logit"):
        assert ours[key].shape[1:4] == tuple(cfg.full_scene_size), key
    assert ours[key].shape == ref[key].shape, key
    assert ours[key].dtype == np.float32
    np.testing.assert_allclose(ours[key], ref[key], atol=LOGIT_ATOL)


def test_nyu_train_losses_match_jax(model_outputs):
    """Every train-mode loss term of the tiny NYU model (batch
    statistics; the fp loss with the virtual camera's frustums) against
    JAX compute_losses: within LOSS_RTOL, or NOISE_MULT times the port's
    own fp32 noise where that is larger."""
    (ours, *perturbed), ref = model_outputs["nyu"][2:]
    assert set(ours) == set(ref) == {
        "loss", "loss_relation_ce_super", "loss_ssc", "loss_occ",
        "loss_sem_scal", "loss_geo_scal", "loss_frustums"}
    for k, v in ref.items():
        assert np.isfinite(ours[k]), k
        noise = max(abs(ours[k] - q[k]) for q in perturbed)
        tol = max(LOSS_RTOL * abs(v), NOISE_MULT * noise)
        assert abs(ours[k] - v) <= tol, (k, ours[k], v, noise)


def _oracle_grads(cfg, batch, cots, double, train):
    """TorchOccDepthNYU (BN on batch statistics if `train`, else on its
    seeded running statistics) in float64 or float32: its float32
    state_dict and the gradients of sum(out * cot) per parameter."""
    torch.manual_seed(23)
    oracle = TorchOccDepthNYU(cfg).train(train)
    randomize_bn(oracle, seed=23)
    sd = {k: v.clone() for k, v in oracle.state_dict().items()}
    dt = torch.float64 if double else torch.float32
    oracle = oracle.to(dt)
    f = lambda x: torch.from_numpy(np.asarray(x)).to(dt)
    default = torch.get_default_dtype()
    torch.set_default_dtype(dt)  # the oracle's arange grid in dt too
    try:
        out = oracle(f(batch["img"]).permute(0, 1, 4, 2, 3).contiguous(),
                     torch.from_numpy(batch["projected_pix"]).long(),
                     torch.from_numpy(batch["fov_mask"]),
                     f(batch["gt_depth"]),
                     float(batch["virtual_bf"].reshape(-1)[0]))
    finally:
        torch.set_default_dtype(default)
    loss = sum((out[k] * f(c)).sum() for k, c in cots.items())
    loss.backward()
    return sd, {n: p.grad.float() for n, p in oracle.named_parameters()
                if p.grad is not None}


def _port_grads(model, batch, cots, train):
    out = model.train(train)({k: torch.from_numpy(v)
                              for k, v in batch.items()})
    loss = sum((out[k] if k == "P_logits" else
                out[k].permute(0, 4, 1, 2, 3)).mul(torch.from_numpy(c)).sum()
               for k, c in cots.items())
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    return {n: g for n, g in zip(params, grads) if g is not None}


@pytest.mark.parametrize("bn_stats", ["running", "batch"])
def test_gradients_match_torch_oracle(bn_stats):
    """A TorchOccDepthNYU state_dict loads into the port directly, and the
    port's fp32 gradients of a random cotangent on ssc_logit, occ_logit
    and P_logits at batch 2 (gradients flow through the virtual view into
    the backbone; sample 0's disparity warps both samples) match the
    oracle's float64 gradients.  The port casts to float32 in BN, the lift
    and the warp, so it cannot run in float64 itself.

    `running`: BN on the seeded running statistics.  Every leaf within
    RUNNING_GRAD_RTOL of its norm, with no noise branch: this is the case
    that holds the backward through the virtual view's sample, the (X, Z,
    Y) transpose and UNet3DNYU.

    `batch`: BN on batch statistics (the train step's mode).  At the tiny
    size this is chaotic in fp32: a 1e-7 weight perturbation moves the
    outputs by ~6e-4 and the gradients by ~10% of their norm, so a leaf
    passes within GRAD_RTOL of its norm or NOISE_MULT times the port's
    own change under such a perturbation, and the leaves that need the
    noise branch are counted and printed with their ratios.  The output
    heads' weights, next to the cotangent, are also no further from
    float64 than ORACLE_MULT times the oracle's own float32 gradients are
    (~1e-3 of their norm)."""
    train = bn_stats == "batch"
    cfg = tiny_nyu_config()
    batch = make_synthetic_batch(cfg, batch_size=2, seed=21, with_labels=True)
    rs = np.random.RandomState(7)
    X, Y, Z = cfg.full_scene_size
    cots = {"ssc_logit": rs.randn(2, 12, X, Y, Z).astype(np.float32),
            "occ_logit": rs.randn(2, 2, X, Y, Z).astype(np.float32),
            "P_logits": rs.randn(2, 4, 4, 32).astype(np.float32)}
    sd, ref = _oracle_grads(cfg, batch, cots, double=True, train=train)
    port = OccDepthModel(cfg)
    port.load_state_dict(sd, strict=True)
    ours = _port_grads(port, batch, cots, train)
    assert set(ours) == set(ref) and len(ours) > 400
    if not train:
        # the port itself as the only "perturbed" copy: a noise of 0
        worst = noise_aware_worst(ours, ref, [ours], RUNNING_GRAD_RTOL, 0.0)
        print(f"running statistics: worst err / tol {worst[0][0]:.3e} "
              f"({worst[0][1]})")
        assert worst[0][0] <= 1.0, worst[:5]
        return
    perturbed = [_port_grads(perturbed_copy(port, s), batch, cots, train)
                 for s in range(N_PERTURB)]
    worst = noise_aware_worst(ours, ref, perturbed, GRAD_RTOL, NOISE_MULT)
    assert worst[0][0] <= 1.0, worst[:5]
    fixed = {n: GRAD_RTOL * float(torch.linalg.vector_norm(ref[n].double()))
             + 1e-6 for n in ref}
    noisy = [(err / fixed[name], ratio, name)
             for ratio, name, err, _ in worst if err > fixed[name]]
    print(f"batch statistics: {len(noisy)} of {len(ours)} leaves pass only "
          "on the noise branch; worst err / fixed tol, err / noise tol:")
    for over, ratio, name in sorted(noisy, reverse=True)[:10]:
        print(f"  {over:.3e}  {ratio:.3f}  {name}")
    _, ref32 = _oracle_grads(cfg, batch, cots, double=False, train=train)
    for name in ("net_3d_decoder.ssc_head_1_4.conv_classes.weight",
                 "net_3d_decoder.ssc_head_1_4.occ_classes.weight"):
        err = torch.linalg.vector_norm(ours[name] - ref[name])
        own = torch.linalg.vector_norm(ref32[name] - ref[name])
        assert err <= ORACLE_MULT * own, (name, err, own)


def test_fp_loss_matches_jax():
    """NYU's frustum-proportion loss alone, on random logits at batch 2:
    world (X, Y, Z_up) voxel order and the virtual camera's frustums; and
    without depth, the real camera's only."""
    for use_depth in (True, False):
        kw = {"use_depth_gt": use_depth}
        cfg = tiny_nyu_config(**kw)
        batch = make_synthetic_batch(cfg, batch_size=2, seed=5,
                                     with_labels=True)
        logits = np.random.RandomState(6).randn(
            2, *cfg.full_scene_size, 12).astype(np.float32)
        ours = float(frustum_proportion_loss_device(
            cfg, torch.from_numpy(logits),
            {k: torch.from_numpy(v) for k, v in batch.items()}))
        jcfg = jax_testing.tiny_nyu_config(**kw)
        ref = float(jax.jit(lambda x, b: jax_fp_loss(jcfg, x, b))(
            jnp.asarray(logits), batch))
        assert np.isfinite(ours) and ours > 0
        np.testing.assert_allclose(ours, ref, rtol=FP_LOSS_RTOL)


@pytest.mark.parametrize("path", NYU_CONFIGS, ids=["b4", "b7"])
def test_shipped_nyu_config_weight_round_trip(path):
    """Both shipped NYU configs build in the port at full width, and port
    state_dict -> convert_state_dict -> state_dict_from_jax is the
    identity, no key missing."""
    cfg = load_config(path)
    sd = randomize_weights(OccDepthModel(cfg), seed=2).state_dict()
    params, stats, missing = convert_state_dict(
        {k: v.numpy() for k, v in sd.items()}, jax_config.load_config(path))
    assert not missing, missing[:10]
    back = state_dict_from_jax({"params": params, "batch_stats": stats}, cfg)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k


@pytest.fixture(scope="module")
def nyu_tree(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("nyu_tree"))
    make_nyu_tree(base, n_frames=2)
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


@pytest.mark.parametrize("split", ["train", "test"])
def test_nyu_dataset_matches_jax(nyu_tree, split):
    """Samples (train: color jitter and flips at fliplr 0.5 over two
    epochs) and their collated batch on the full-size tree: ints exact,
    floats within 1e-6; the real and the virtual view's projections."""
    kw = dict(dataset="NYU", data_root=nyu_tree, data_preprocess_root=nyu_tree,
              use_depth_gt=True, multi_view_mode=False, frustum_size=8,
              full_scene_size=(60, 36, 60), project_scale=1, n_classes=12,
              trans_2d_to_3d="flosp")
    fliplr = 0.5 if split == "train" else 0.0
    ours = NYUDataset(OccDepthConfig(**kw), split, fliplr=fliplr)
    ref = JaxNYUDataset(jax_config.OccDepthConfig(**kw), split,
                        fliplr=fliplr)
    assert len(ours) == len(ref) == 2
    flips = set()
    for epoch in (0, 1) if split == "train" else (0,):
        ours.reseed(epoch)
        ref.reseed(epoch)
        a, b = [ours[i] for i in range(2)], [ref[i] for i in range(2)]
        for x, y in zip(a, b):
            _assert_samples_equal(x, y)
            flips.add(float(x["ida_mats"][0, 0, 0]))
        _assert_samples_equal(collate(a), jax_collate(b))
    s = a[0]
    assert s["img"].shape == (1, 480, 640, 3)
    assert s["projected_pix"].shape == (2, 60 * 60 * 36, 1, 2)
    assert s["target"].shape == (60, 36, 60)
    assert s["CP_mega_matrices"].shape == (4, 15 * 9 * 15, 7 * 4 * 7)
    assert s["gt_depth"].shape == (1, 480, 640)
    assert flips == ({-1.0, 1.0} if split == "train" else {1.0})


def test_nyu_tree_rig_and_depth(nyu_tree):
    """The tree's rig puts most voxels in both views; its depth PNGs read
    back as the JAX reader reads them."""
    assert nyu_fov_share() > 0.5
    path = os.path.join(nyu_tree, "NYUtest", "NYU0001_0000.png")
    ours, ref = load_depth_png(path), jax_load_depth_png(path)
    assert ours.shape == (480, 640) and ours.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)
    assert (ours == 0).any() and ours.max() <= 10.0


@pytest.fixture(scope="module", autouse=True)
def cli_proc(nyu_tree, tmp_path_factory):
    """The train CLI (2 steps, then a rerun) and the eval CLI on the tree,
    on the CPU, at the shipped b4 config narrowed to feature 16 on b0,
    with JAX and the JAX package unimportable, printing a JSON report.  It
    starts with the module, in a one-thread process beside the JAX
    compiles."""
    logdir = str(tmp_path_factory.mktemp("nyu_logdir"))
    code = textwrap.dedent("""
        import contextlib, io, json, sys
        for name in ("jax", "flax", "jaxlib", "optax", "occdepth_tpu"):
            sys.modules[name] = None
        from occdepth_tpu_torch.scripts import eval as eval_cli
        from occdepth_tpu_torch.scripts import train as train_cli

        config, data, logdir = sys.argv[1:4]
        args = ["--config", config, "--device", "cpu", f"data_root={data}",
                f"data_preprocess_root={data}", f"logdir={logdir}",
                *sys.argv[4:]]
        report = {}
        first = train_cli.main(args + ["--max-steps", "2"])
        report["first"] = [first.step, first.metrics_logger.path,
                           first.ckpt.has("last")]
        again = train_cli.main(args + ["--max-steps", "2"])
        report["again"] = again.step
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            eval_cli.main(args + ["--ckpt", "last"])
        report["eval"] = out.getvalue()
        report["jax_side"] = sorted(
            m for m, mod in sys.modules.items() if mod is not None
            and m.split(".")[0] in ("jax", "flax", "jaxlib", "optax",
                                    "occdepth_tpu"))
        print(json.dumps(report))
    """)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-c", code, NYU_CONFIGS[0], nyu_tree, logdir,
         *SMALL_NYU_OVERRIDES],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def cli_run(cli_proc):
    """(the CLI run's JSON report, its stdout)."""
    stdout, stderr = cli_proc.communicate(timeout=300)
    assert cli_proc.returncode == 0, stdout[-3000:] + stderr[-3000:]
    return json.loads(stdout.strip().splitlines()[-1]), stdout


def test_train_cli_trains_and_resumes_on_cpu(cli_run):
    report, stdout = cli_run
    step, metrics_path, has_last = report["first"]
    assert step == 2 and has_last
    with open(metrics_path) as f:
        recs = [json.loads(line) for line in f]
    train = [r for r in recs if "train/loss" in r]
    assert [r["step"] for r in train] == [1, 2]
    assert all(np.isfinite(r[k]) for r in train for k in r
               if k.startswith("train/loss"))
    assert "train/loss_frustums" in train[0]
    assert [r["step"] for r in recs if "val/mIoU" in r] == [2]
    assert report["again"] == 2 and "resumed from step 2" in stdout


def test_eval_cli_prints_nyu_classes(cli_run):
    from occdepth_tpu_torch.data.params import NYU_CLASS_NAMES

    lines = cli_run[0]["eval"].splitlines()
    assert "test======" in lines
    assert f"class IoU: {NYU_CLASS_NAMES}, " in lines
    assert len(lines[lines.index("test======") + 3].split()) == 12
    assert any(line.startswith("mIoU=") for line in lines)
    assert cli_run[0]["jax_side"] == []
