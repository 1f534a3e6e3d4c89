"""Training-slice modules of the port vs the JAX package (CPU, fp32).

Each loss (value and gradient), the confusion counts, train-mode
BatchNorm, the K1/K2 autograd on the CPU path, the LR schedule at its
milestones, one clip + AdamW update, and the NumPy label-side copies, on
the same seeded NumPy inputs through both.  JAX runs eagerly here (small
shapes); the whole train step is tests/test_torch_port_train_step.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import occdepth_tpu.config as jax_config
from occdepth_tpu.data import params as jax_params
from occdepth_tpu.data.batch import make_synthetic_batch as jax_batch
from occdepth_tpu.geometry import frustums_mask as jax_frustums
from occdepth_tpu.geometry import relations as jax_relations
from occdepth_tpu.losses import crp as jax_crp_loss
from occdepth_tpu.losses import depth as jax_depth
from occdepth_tpu.losses import fp_device as jax_fp
from occdepth_tpu.losses import metrics as jax_metrics
from occdepth_tpu.losses import ssc as jax_ssc
from occdepth_tpu.models.layers import _BNCore
from occdepth_tpu.ops.pallas_kernels import (
    crp_relation_matmul_reference as jax_crp,
    stereo_cosine_fuse_reference as jax_fuse,
)
from occdepth_tpu.ops.resize import resize_nearest as jax_resize_nearest
from occdepth_tpu.testing import tiny_kitti_config as jax_tiny_kitti
from occdepth_tpu.training import optim as jax_optim
import occdepth_tpu_torch.config as port_config
from occdepth_tpu_torch.data import params
from occdepth_tpu_torch.data.batch import make_synthetic_batch
from occdepth_tpu_torch.geometry import frustums_mask, relations
from occdepth_tpu_torch.losses import (
    ce_ssc_loss,
    confusion_update,
    depth_cls_loss,
    frustum_proportion_loss_device,
    geo_scal_loss,
    relation_loss,
    sem_scal_loss,
)
from occdepth_tpu_torch.losses.metrics import SSCMetrics
from occdepth_tpu_torch.models.layers import batch_norm2d, batch_norm3d
from occdepth_tpu_torch.ops.crp_matmul import crp_relation_matmul
from occdepth_tpu_torch.ops.resize import resize_nearest
from occdepth_tpu_torch.ops.stereo_fuse import stereo_cosine_fuse
from occdepth_tpu_torch.testing import tiny_kitti_config
from occdepth_tpu_torch.training.optim import (
    clip_by_global_norm_,
    lr_at,
    make_optimizer,
)

VALUE_RTOL = 1e-5
GRAD_ATOL = 1e-6  # fp32 reductions over a few hundred voxels



@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tier-1 gate runs six test processes on a few cores; this file's
    tiny-shape torch work takes one thread so it does not crowd the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _logits_target(seed, shape=(2, 6, 5, 4), C=20, zero_class=None):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(*shape, C) * 2).astype(np.float32)
    classes = list(range(C)) + [255]
    p = np.full(len(classes), 0.4 / (C - 1))
    p[0], p[-1] = 0.45, 0.15
    p /= p.sum()
    target = rng.choice(classes, size=shape, p=p).astype(np.int32)
    if zero_class is not None:
        target[target == zero_class] = 0
    return logits, target


def _value_and_grad_torch(fn, logits, *args):
    x = torch.from_numpy(logits).requires_grad_()
    val = fn(x, *args)
    val.backward()
    return float(val.detach()), x.grad.numpy()


def _value_and_grad_jax(fn, logits, *args):
    # one compile of the whole loss beats eager JAX's per-op dispatch
    val, grad = jax.jit(jax.value_and_grad(lambda x: fn(x, *args)))(
        jnp.asarray(logits))
    return float(val), np.asarray(grad)


def _check(ours, ref):
    np.testing.assert_allclose(ours[0], ref[0], rtol=VALUE_RTOL)
    np.testing.assert_allclose(ours[1], ref[1], rtol=1e-4, atol=GRAD_ATOL)


@pytest.mark.parametrize("n_classes", [20, 2])
def test_ce_ssc_loss_ignores_255(n_classes):
    logits, target = _logits_target(1, C=n_classes)
    w = np.random.RandomState(2).uniform(0.1, 3.0, n_classes).astype(np.float32)
    ours = _value_and_grad_torch(ce_ssc_loss, logits, torch.from_numpy(target),
                                 torch.from_numpy(w))
    ref = _value_and_grad_jax(jax_ssc.ce_ssc_loss, logits,
                              jnp.asarray(target), jnp.asarray(w))
    _check(ours, ref)
    assert np.all(ours[1][target == 255] == 0)


@pytest.mark.parametrize("zero_class", [None, 3])  # 3: a class absent
def test_sem_scal_loss(zero_class):
    logits, target = _logits_target(3, zero_class=zero_class)
    ours = _value_and_grad_torch(sem_scal_loss, logits,
                                 torch.from_numpy(target))
    ref = _value_and_grad_jax(jax_ssc.sem_scal_loss, logits,
                              jnp.asarray(target))
    _check(ours, ref)


def test_geo_scal_loss():
    logits, target = _logits_target(4)
    ours = _value_and_grad_torch(geo_scal_loss, logits,
                                 torch.from_numpy(target))
    ref = _value_and_grad_jax(jax_ssc.geo_scal_loss, logits,
                              jnp.asarray(target))
    _check(ours, ref)


def test_safe_neg_log_finite_gradient_at_zero():
    """The clamp's gradient is 0 at an underflowed probability (torch's
    F.binary_cross_entropy gives a huge one there, a plain clamp NaN)."""
    from occdepth_tpu_torch.losses.depth import clamped_log
    from occdepth_tpu_torch.losses.ssc import safe_neg_log

    x = torch.tensor([0.0, 1e-38, 0.5], requires_grad=True)
    (safe_neg_log(x).sum() + clamped_log(x).sum()).backward()
    assert torch.equal(x.grad[:2], torch.zeros(2))
    ref = jax.grad(lambda v: jnp.sum(jax_ssc._safe_neg_log(v))
                   + jnp.sum(jax_depth._clamped_log(v)))(
        jnp.asarray(x.detach().numpy()))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref), rtol=1e-6)


def test_relation_loss():
    rng = np.random.RandomState(5)
    B, R, M, N = 2, 4, 16, 40
    p_logits = rng.randn(B, R, M, N).astype(np.float32)
    cp = (rng.rand(B, R, N, M) > 0.7).astype(np.uint8)
    ours = _value_and_grad_torch(relation_loss, p_logits, torch.from_numpy(cp))
    ref = _value_and_grad_jax(jax_crp_loss.relation_loss, p_logits,
                              jnp.asarray(cp))
    _check(ours, ref)


def test_depth_cls_loss():
    """Nearest resize, min-pool with 0 -> 1e5, the uniform bins and the
    clamped log, with some predicted bins exactly 0 and 1."""
    rng = np.random.RandomState(6)
    d_bound, ds = (2.0, 10.0, 0.5), 4
    D = int((d_bound[1] - d_bound[0]) / d_bound[2])
    B, n_cam, h, w = 2, 1, 5, 7
    logits = rng.randn(B, n_cam, h, w, D).astype(np.float32) * 3
    logits[0, 0, 0, 0] = -1e4  # softmax underflows to exact 0 / 1
    logits[0, 0, 0, 0, 2] = 1e4
    gt = rng.uniform(0.0, 12.0, size=(B, n_cam, h * ds + 3, w * ds - 2))
    gt[gt < 2.5] = 0.0
    gt = gt.astype(np.float32)

    def ours_fn(x):
        return depth_cls_loss(torch.from_numpy(gt), torch.softmax(x, -1), ds,
                              d_bound)

    def ref_fn(x):
        return jax_depth.depth_cls_loss(jnp.asarray(gt),
                                        jax.nn.softmax(x, -1), ds, d_bound)

    ours = _value_and_grad_torch(ours_fn, logits)
    ref = _value_and_grad_jax(ref_fn, logits)
    assert np.all(np.isfinite(ours[1]))
    _check(ours, ref)


def test_resize_nearest():
    rng = np.random.RandomState(7)
    x = rng.randn(2, 13, 29).astype(np.float32)
    resize = jax.jit(jax_resize_nearest, static_argnums=1)
    for size in ((20, 28), (13, 29), (6, 50)):
        ours = resize_nearest(torch.from_numpy(x), size).numpy()
        ref = np.asarray(resize(jnp.asarray(x)[..., None], size))[..., 0]
        np.testing.assert_array_equal(ours, ref)


def _jax_cfg(cfg):
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    if kw["flosp_depth_override"] is not None:
        kw["flosp_depth_override"] = jax_config.FlospDepthConfig(
            **dataclasses.asdict(kw["flosp_depth_override"]))
    return jax_config.OccDepthConfig(**kw)


@pytest.mark.parametrize("frustum_size", [2, 4])
def test_frustum_proportion_loss_device(frustum_size):
    cfg = tiny_kitti_config(frustum_size=frustum_size)
    batch = make_synthetic_batch(cfg, batch_size=2, seed=8, with_labels=True)
    logits = np.random.RandomState(9).randn(
        2, *cfg.full_scene_size, cfg.n_classes).astype(np.float32)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    ours = _value_and_grad_torch(
        lambda x: frustum_proportion_loss_device(cfg, x, tb), logits)
    ref = _value_and_grad_jax(
        lambda x: jax_fp.frustum_proportion_loss_device(_jax_cfg(cfg), x, jb),
        logits)
    assert ours[0] > 0
    _check(ours, ref)


def test_confusion_update_and_metrics():
    rng = np.random.RandomState(10)
    C = 20
    y_true = rng.choice(list(range(C)) + [255], size=(2, 9, 8, 5)).astype(np.int32)
    y_pred = rng.randint(0, C, size=y_true.shape).astype(np.int32)
    valid = np.array([True, False])
    update = jax.jit(jax_metrics.confusion_update, static_argnums=2)
    for sv in (None, valid):
        comp, conf = confusion_update(
            torch.from_numpy(y_pred), torch.from_numpy(y_true), C,
            None if sv is None else torch.from_numpy(sv))
        rc, rf = update(jnp.asarray(y_pred), jnp.asarray(y_true), C,
                        None if sv is None else jnp.asarray(sv))
        np.testing.assert_array_equal(comp.numpy(), np.asarray(rc))
        np.testing.assert_array_equal(conf.numpy(), np.asarray(rf))
    ours, ref = SSCMetrics(C), jax_metrics.SSCMetrics(C)
    ours.add_batch(torch.from_numpy(y_pred), torch.from_numpy(y_true))
    ref.add_batch(y_pred, y_true)
    a, b = ours.get_stats(), ref.get_stats()
    for k in ("precision", "recall", "iou", "iou_ssc_mean"):
        assert a[k] == pytest.approx(b[k], rel=1e-12), k
    np.testing.assert_allclose(a["iou_ssc"], b["iou_ssc"], rtol=1e-12)


@pytest.mark.parametrize("dims,dtype", [
    (2, torch.float32), (3, torch.float32), (2, torch.bfloat16)])
def test_train_mode_batchnorm_matches_bncore(dims, dtype):
    """Output, and the running statistics advanced twice, vs the JAX
    package's _BNCore; the running variance is the biased one."""
    rng = np.random.RandomState(11)
    C, eps, m = 6, 1e-3, 0.1
    shape = (3, C, 5, 7) if dims == 2 else (2, C, 4, 3, 5)
    bn = batch_norm2d(C, eps=eps, momentum=m) if dims == 2 else \
        batch_norm3d(C, momentum=m)
    eps = bn.eps
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(rng.rand(C).astype(np.float32) + 0.5))
        bn.bias.copy_(torch.from_numpy(rng.randn(C).astype(np.float32)))
        bn.running_mean.copy_(torch.from_numpy(rng.randn(C).astype(np.float32)))
        bn.running_var.copy_(torch.from_numpy(rng.rand(C).astype(np.float32) + 1))
    variables = {
        "params": {"scale": bn.weight.detach().numpy().copy(),
                   "bias": bn.bias.detach().numpy().copy()},
        "batch_stats": {"mean": bn.running_mean.numpy().copy(),
                        "var": bn.running_var.numpy().copy()},
    }
    core = _BNCore(momentum=1.0 - m, epsilon=eps)
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    bn.train()
    for step in range(2):
        x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
        xt = torch.from_numpy(x).to(dtype)
        y = bn(xt)
        # channels-last for flax
        xj = jnp.asarray(np.moveaxis(xt.float().numpy(), 1, -1)).astype(jdtype)
        yj, new = core.apply(variables, xj, use_running_average=False,
                             mutable=["batch_stats"])
        variables = {"params": variables["params"], **new}
        assert y.dtype == dtype
        tol = 1e-5 if dtype == torch.float32 else 1e-2
        np.testing.assert_allclose(
            y.float().detach().numpy(),
            np.moveaxis(np.asarray(yj.astype(jnp.float32)), -1, 1),
            rtol=tol, atol=tol)
        np.testing.assert_allclose(bn.running_mean.numpy(),
                                   np.asarray(new["batch_stats"]["mean"]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(bn.running_var.numpy(),
                                   np.asarray(new["batch_stats"]["var"]),
                                   rtol=1e-6, atol=1e-7)
    # stock nn.BatchNorm would have used the unbiased variance
    stock = torch.nn.BatchNorm2d(C, momentum=m) if dims == 2 else \
        torch.nn.BatchNorm3d(C, momentum=m)
    stock.train()(torch.from_numpy(x))
    ours_bn = (batch_norm2d(C, momentum=m) if dims == 2
               else batch_norm3d(C, momentum=m)).train()
    ours_bn(torch.from_numpy(x))
    assert not torch.allclose(stock.running_var, ours_bn.running_var)


def test_kernel_autograd_on_cpu_matches_jax_grad():
    """K1 and K2 through the wrappers on the CPU (plain versions with
    autograd) vs jax.grad of the JAX references, same cotangents."""
    rng = np.random.RandomState(12)
    # unmasked features: the JAX reference's norm has a NaN gradient at an
    # all-zero row, where the port's gives 0
    f0, f1 = (rng.randn(300, 16).astype(np.float32) for _ in range(2))
    m0, m1 = ((rng.rand(300) > 0.3).astype(np.float32) for _ in range(2))
    cot = rng.randn(300, 16).astype(np.float32)
    t = [torch.from_numpy(a).requires_grad_(i < 2)
         for i, a in enumerate((f0, f1, m0, m1))]
    stereo_cosine_fuse(*t).backward(torch.from_numpy(cot))
    ref = jax.jit(jax.grad(lambda a, b: jnp.sum(jax_fuse(
        a, b, jnp.asarray(m0), jnp.asarray(m1)) * cot), argnums=(0, 1)))(
        jnp.asarray(f0), jnp.asarray(f1))
    for ours, r in zip(t[:2], ref):
        np.testing.assert_allclose(ours.grad.numpy(), np.asarray(r),
                                   rtol=1e-5, atol=1e-5)

    p = rng.randn(64, 32).astype(np.float32)
    mega = rng.randn(32, 24).astype(np.float32)
    cot = rng.randn(64, 24).astype(np.float32)
    tp, tm = (torch.from_numpy(a).requires_grad_() for a in (p, mega))
    crp_relation_matmul(tp, tm).backward(torch.from_numpy(cot))
    ref = jax.jit(jax.grad(lambda a, b: jnp.sum(jax_crp(a, b) * cot),
                           argnums=(0, 1)))(jnp.asarray(p), jnp.asarray(mega))
    for ours, r in zip((tp, tm), ref):
        np.testing.assert_allclose(ours.grad.numpy(), np.asarray(r),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dataset", ["kitti", "tartanair"])
def test_lr_at_milestone_edges(dataset):
    """The LR switches at step >= milestone * steps_per_epoch, as optax's
    piecewise_constant_schedule does; checked at each edge +-1."""
    spe = 7
    cfg = port_config.OccDepthConfig(dataset=dataset)
    schedule = jax_optim.lr_schedule(jax_config.OccDepthConfig(
        dataset=dataset), spe)
    milestones = (20,) if dataset == "tartanair" else (18, 24)
    steps = [0] + [m * spe + d for m in milestones for d in (-1, 0, 1)]
    for step in steps:
        assert lr_at(cfg, spe, step) == pytest.approx(
            float(schedule(step)), rel=1e-6), step
    assert lr_at(cfg, spe, milestones[0] * spe - 1) == cfg.lr
    assert lr_at(cfg, spe, milestones[0] * spe) < cfg.lr


@pytest.mark.parametrize("grad_scale", [100.0, 0.01])  # clipped, unclipped
def test_adamw_clip_update_matches_optax(grad_scale):
    """Three clip + AdamW updates of a small parameter set vs
    make_optimizer (decay on every parameter, bias correction, LR from the
    schedule at each step)."""
    rng = np.random.RandomState(13)
    shapes = {"w": (5, 4), "b": (4,), "bn": (3,)}
    init = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.randn(*s) * grad_scale).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    cfg = port_config.OccDepthConfig(gradient_clip_val=35.0, lr=1e-2,
                                     weight_decay=0.1)
    spe = 1  # the first milestone at step 18: the LR stays at cfg.lr here

    tx = jax_optim.make_optimizer(jax_config.OccDepthConfig(
        gradient_clip_val=35.0, lr=1e-2, weight_decay=0.1), spe)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(jp)

    @jax.jit
    def step(g, state, jp):
        upd, state = tx.update(g, state, jp)
        return optax.apply_updates(jp, upd), state

    for g in grads:
        jp, state = step({k: jnp.asarray(v) for k, v in g.items()}, state, jp)

    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in init.items()}
    opt = make_optimizer(tp.values(), cfg)
    for step, g in enumerate(grads):
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        norm = clip_by_global_norm_([p.grad for p in tp.values()], 35.0)
        assert (float(norm) >= 35.0) == (grad_scale > 1.0)
        for group in opt.param_groups:
            group["lr"] = lr_at(cfg, spe, step)
        opt.step()
    for k in shapes:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)


def test_dataset_constants_copy():
    for ds in ("kitti", "NYU", "tartanair"):
        np.testing.assert_array_equal(params.class_weights_for(ds),
                                      jax_params.class_weights_for(ds))
        np.testing.assert_array_equal(params.class_weights_occ_for(ds),
                                      jax_params.class_weights_occ_for(ds))
        assert params.class_names_for(ds) == jax_params.class_names_for(ds)


@pytest.mark.parametrize("binary", [False, True])
def test_cp_mega_matrix_copy(binary):
    rng = np.random.RandomState(14)
    target = rng.choice([0, 1, 2, 5, 255], size=(8, 6, 4)).astype(np.int32)
    np.testing.assert_array_equal(
        relations.compute_cp_mega_matrix(target, binary),
        jax_relations.compute_cp_mega_matrix(target, binary))
    wide = target.copy()
    wide[0, 0, 0] = 40  # labels >= 32 take the broadcast form
    np.testing.assert_array_equal(
        relations.compute_cp_mega_matrix(wide, binary),
        jax_relations.compute_cp_mega_matrix(wide, binary))


def test_frustum_class_dists_copy():
    rng = np.random.RandomState(15)
    V, N, W, H = 2, 6 * 5 * 4, 40, 30
    pix = rng.randint(-5, 45, size=(V, N, 1, 2)).astype(np.int64)
    pz = rng.uniform(-1, 5, size=(V, N)).astype(np.float32)
    target = rng.choice([0, 1, 3, 255], size=(6, 5, 4)).astype(np.int32)
    for ds in ("kitti", "NYU"):
        tgt = target if ds == "kitti" else target.transpose(0, 2, 1).copy()
        np.testing.assert_array_equal(
            frustums_mask.compute_frustum_class_dists(
                pix, pz, tgt, W, H, ds, 4, 2),
            jax_frustums.compute_frustum_class_dists(
                pix, pz, tgt, W, H, ds, 4, 2))


def test_labelled_synthetic_batch_bit_exact():
    cfg = tiny_kitti_config()
    ours = make_synthetic_batch(cfg, batch_size=2, seed=16, with_labels=True)
    ref = jax_batch(jax_tiny_kitti(), batch_size=2, seed=16, with_labels=True)
    assert set(ours) == set(ref)
    for k, v in ours.items():
        assert v.dtype == ref[k].dtype, k
        np.testing.assert_array_equal(v, ref[k], err_msg=k)
